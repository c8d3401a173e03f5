"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library for ``sm_90a``, loaded with
``ctypes``. Builds happen at first use, all sources at once (one ``nvcc``
process each, started together), into ``<repo>/build/kernels/`` — a
directory ``.gitignore`` lists — under a file name keyed by a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header rebuilds and an unchanged one is reused. A missing ``nvcc`` or a failed build raises; nothing falls
back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("zone_prune", "box_scan_seg", "box_scan", "l2dist",
           "flash_attention", "flash_attention_bwd")
# -Xptxas -v: each kernel's registers, shared memory and spills, kept in
# <library>.log beside the library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: every pointer and the stream are c_void_p (a bare Python
# int would be passed as a 32-bit int and cut the pointer), and row counts
# that may pass 2^31 are c_longlong; flash attention's scale is a c_float.
# Per source, its C entries; the first is the source's launch entry.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
ENTRIES = {
    "zone_prune": {
        "zone_prune_launch": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
        "zone_candidates_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                                   _P, _L, _P]},
    "box_scan_seg": {"box_scan_seg_launch": [_P, _P, _P, _I, _P, _P, _P, _I,
                                             _I, _I, _I, _P, _P]},
    "box_scan": {"box_scan_launch": [_P, _P, _P, _L, _I, _I, _P, _P],
                 "box_scan_pruned_launch": [_P, _P, _P, _I, _I, _I, _I, _P,
                                            _P, _I, _P, _P]},
    "l2dist": {"l2dist_launch": [_P, _P, _L, _I, _I, _P, _P]},
    "flash_attention": {"flash_attention_launch": [_P, _P, _P, _P, _P, _P,
                                                   _I, _I, _I, _I, _I, _I,
                                                   _F, _I, _I, _P]},
    "flash_attention_bwd": {
        "flash_attention_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                       _I, _P],
        "flash_attention_bwd_splits": [_I, _I, _I, _I, _I]},
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "of repro_torch cannot be built, and there is no fallback")


def library_path(name: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source's key
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, in parallel;
    returns {name: library path}. Raises with nvcc's output on failure."""
    names = list(names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{n}.cu:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            out[n].with_suffix(".log").write_bytes(log)
            os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building every source on
    the first call."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            for n, path in build().items():
                lib = ctypes.CDLL(str(path))
                for fn_name, argtypes in ENTRIES[n].items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _libs[n] = lib
        return _libs[name]


def launch_fn(name: str, entry: str = ""):
    """The C entry ``entry`` of ``csrc/<name>.cu``; by default its launch
    entry, ``<name>_launch``."""
    return getattr(load(name), entry or f"{name}_launch")
