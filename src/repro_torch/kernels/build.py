"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library for ``sm_90a``, loaded with
``ctypes``. Builds happen at first use, all sources at once (one ``nvcc``
process each, started together), into ``<repo>/build/kernels/`` — a
directory ``.gitignore`` lists — under a file name keyed by a hash of the
source and the flags, so an edited ``.cu`` rebuilds and an unchanged one
is reused. A missing ``nvcc`` or a failed build raises; nothing falls
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
SOURCES = ("zone_prune", "box_scan_seg")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# C signatures: every pointer and the stream are c_void_p (a bare Python
# int would be passed as a 32-bit int and cut the pointer)
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    "zone_prune": ("zone_prune_launch",
                   [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P]),
    "box_scan_seg": ("box_scan_seg_launch",
                     [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P]),
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
    src = (CSRC / f"{name}.cu").read_bytes()
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
                fn_name, argtypes = ARGTYPES[n]
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _libs[n] = lib
        return _libs[name]


def launch_fn(name: str):
    """The C launch entry of ``csrc/<name>.cu``."""
    return getattr(load(name), ARGTYPES[name][0])
