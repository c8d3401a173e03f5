"""Durable live catalog: WAL, checksummed checkpoints, crash recovery —
a copy of ``repro.core.persist`` (DESIGN.md §15). The port imports
nothing of the JAX package, so it keeps its own copy of this numpy-only
module. The file format is the reference's byte for byte (file names,
JSON keys, ``.npy`` headers, the record layout), so a data directory
written by either package recovers in the other.

This module is the persistence subsystem under ``SegmentedCatalog`` —
pure bytes, files and numpy (the catalog layer reassembles the
device-facing objects):

  WRITE-AHEAD LOG   every append/delete serialises its rows/tombstones
                    as one length-prefixed, checksummed record and
                    reaches disk (per the ``sync`` policy) BEFORE the
                    in-memory snapshot swap. A record either replays
                    bitwise or is detected as torn/corrupt — never
                    half-applied.
  SEGMENT FILES     sealed segments checkpoint as immutable column
                    files (features, permutation, zone maps) plus a
                    ``meta.json`` carrying per-file byte counts and
                    checksums; rows are reconstructed bitwise from
                    features + permutation on load.
  MANIFEST          a JSON file naming the exact segment set, epoch,
                    compaction generation, validity overlay and WAL
                    horizon, committed via temp file + fsync +
                    ``os.replace`` + directory fsync — the only commit
                    point. Compaction becomes a two-phase commit: new
                    segment files land first, the manifest flip is
                    atomic, and the in-memory swap happens last, so a
                    crash at ANY point leaves a recoverable state.
  RECOVERY          ``recover()`` loads the newest manifest that fully
                    validates, then replays the WAL tail. Torn tails,
                    checksum mismatches and short reads stop the replay
                    at the last good record; the bad bytes are moved to
                    ``quarantine/`` and the damage is surfaced as a
                    typed ``RecoveryError`` carrying the salvage report
                    — never as silently wrong results.

Sync policy (``sync=``): ``"always"`` fsyncs after every record
(power-loss durable), ``"batch"`` flushes to the OS per record and
defers fsync to checkpoints/close (process-crash durable — survives
``kill -9``; the mode the recovery benchmark prices at <= 1.5x the
in-memory append), ``"none"`` buffers in-process and flushes only at
checkpoints/close (durable only across clean restarts).

Checksums: CRC32C (Castagnoli) via the ``crc32c`` package when the
container has it, else zlib's CRC-32 at C speed. The algorithm is
recorded in every WAL file header and manifest, so recovery always
verifies with the algorithm the bytes were written under and mixed
directories fail loudly instead of "verifying" with the wrong
polynomial.

Directory layout::

    data_dir/
      manifest-0000000001.json      newest valid id wins
      valid-0000000001.npy          validity overlay at that horizon
      seg-0000000001/               immutable column files
        meta.json  features.npy  perm_00.npy  zlo_00.npy  zhi_00.npy ...
      wal-000000000001.log          name = first LSN in the file
      quarantine/                   bytes recovery refused to trust
      LOCK                          single-writer lock (holder's pid)

A data directory has exactly ONE writer at a time: ``Persistence`` and
``recover()`` take an exclusive ``fcntl`` lock on ``LOCK`` (reentrant
within a process, kernel-released at process death) and a second
process fails with a typed ``PersistenceError`` instead of interleaving
WAL/manifest writes with the holder.

Fault seams (duck-typed ``faults.check(site)`` — core never imports
serve): ``wal_write`` (torn-write point), ``wal_commit`` (kill between
WAL append and snapshot swap — fired by the catalog), ``wal_fsync``
(fsync failure -> atomic rollback), ``wal_read`` / ``segment_read``
(short reads during recovery), ``segment_write`` and
``manifest_commit`` (the compaction two-phase-commit steps).
"""
from __future__ import annotations

import io
import json
import os
import shutil
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.errors import (InjectedCrash, PersistenceError,
                                     RecoveryError)

try:                                  # POSIX record locks (single-writer)
    import fcntl
except ImportError:                   # platform without fcntl: no locking
    fcntl = None                      # type: ignore[assignment]

__all__ = ["atomic_write_bytes", "fsync_dir", "checksum", "has_state",
           "npy_bytes", "npy_load", "DirLock",
           "Persistence", "RecoveryReport", "RecoveredState", "WalRecord",
           "recover", "WAL_MAGIC", "SYNC_MODES", "DEFAULT_ALGO"]

WAL_MAGIC = b"REWAL1\n"
_HDR = struct.Struct("<II")          # payload length, payload checksum
_REC = struct.Struct("<BQ")          # op byte, lsn
_OP_APPEND, _OP_DELETE = ord("A"), ord("D")
SYNC_MODES = ("always", "batch", "none")

try:                                  # real CRC32C when the image has it
    from crc32c import crc32c as _crc32c  # type: ignore

    DEFAULT_ALGO = "crc32c"
except ImportError:                   # no new deps: zlib's CRC-32 at C speed
    _crc32c = None
    DEFAULT_ALGO = "crc32-zlib"

_ALGO_CODES = {"crc32c": 0, "crc32-zlib": 1}
_ALGO_NAMES = {v: k for k, v in _ALGO_CODES.items()}


def checksum(data: bytes, algo: str = DEFAULT_ALGO) -> int:
    """Checksum ``data`` under the named algorithm. Raises
    ``PersistenceError`` when asked for an algorithm this host cannot
    compute (verifying with the wrong polynomial would 'detect'
    corruption in perfectly good bytes)."""
    if algo == "crc32-zlib":
        return zlib.crc32(data) & 0xFFFFFFFF
    if algo == "crc32c":
        if _crc32c is None:
            raise PersistenceError(
                "these files were written with CRC32C but the crc32c "
                "package is unavailable on this host")
        return int(_crc32c(data)) & 0xFFFFFFFF
    raise PersistenceError(f"unknown checksum algorithm {algo!r}")


# ----------------------------------------------------------------------
# atomic file primitives (shared with train/checkpoint.py)
# ----------------------------------------------------------------------

_tmp_counter = [0]
_tmp_lock = threading.Lock()


def fsync_dir(path) -> None:
    """fsync a DIRECTORY so a rename/replace inside it is durable — the
    half of atomic-rename discipline that is easy to forget (the file's
    bytes are synced but the directory entry pointing at them is not).
    Silently a no-op on platforms that cannot open directories."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path, data: bytes, *, fsync_file: bool = True,
                       fsync_parent: bool = True) -> None:
    """The one atomic-publish idiom every durable artifact goes
    through: write to a unique temp name in the same directory, flush,
    fsync the FILE, ``os.replace`` onto the final name, fsync the
    DIRECTORY. A reader never observes a partial file under ``path``,
    and after return the bytes survive power loss."""
    path = Path(path)
    with _tmp_lock:
        _tmp_counter[0] += 1
        n = _tmp_counter[0]
    tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}-{n}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            if fsync_file:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync_parent:
        fsync_dir(path.parent)


def npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def npy_load(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


# ----------------------------------------------------------------------
# single-writer directory lock
# ----------------------------------------------------------------------

_dirlock_mu = threading.Lock()
# (st_dev, st_ino) of a LOCK file -> [fd, refcount]. One fd per inode
# per process: POSIX record locks are released when ANY fd to the file
# closes, so every in-process acquirer must share the same descriptor.
_dirlock_fds: Dict[Tuple[int, int], List[int]] = {}


class DirLock:
    """Advisory EXCLUSIVE inter-process lock on a catalog directory
    (``<root>/LOCK``), enforcing the single-writer assumption: two
    processes pointed at the same ``data_dir`` must never interleave
    WAL/manifest writes (one recovering while the other checkpoints
    corrupts the directory). Taken by ``Persistence`` for the life of
    the handle and by ``recover()`` for the duration of the scan; a
    second PROCESS fails loudly with ``PersistenceError`` naming the
    holder's pid. Within one process acquisition is reentrant (a shared
    per-inode fd with a refcount), so recovery handing off to a fresh
    ``Persistence`` — or a reopen after a crash-simulating ``del`` —
    never self-deadlocks. The kernel releases the lock when the holder
    dies, so a ``kill -9``'d writer cannot wedge recovery. No-op on
    platforms without ``fcntl``.

    The fd registry is this module's own: in one process that imports
    both packages, the reference's ``DirLock`` and this one do not see
    each other's holds, and closing either's descriptor drops the
    process's lock. Close one package's catalog before the other opens
    the directory."""

    def __init__(self, root):
        root = Path(root)
        self._key: Optional[Tuple[int, int]] = None
        if fcntl is None:
            return
        root.mkdir(parents=True, exist_ok=True)
        path = root / "LOCK"
        with _dirlock_mu:
            try:
                st = os.stat(path)
                ent = _dirlock_fds.get((st.st_dev, st.st_ino))
            except OSError:
                ent = None
            if ent is not None:          # this process already holds it
                ent[1] += 1
                self._key = (st.st_dev, st.st_ino)
                return
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
            try:
                fcntl.lockf(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError as e:
                holder = ""
                try:
                    holder = os.pread(fd, 64, 0).decode(
                        "ascii", "replace").strip()
                except OSError:
                    pass
                os.close(fd)             # we hold no lock on this inode
                raise PersistenceError(
                    f"{root} is locked by another process"
                    + (f" (pid {holder})" if holder else "")
                    + " — a durable catalog directory has exactly one "
                    "writer at a time") from e
            st = os.fstat(fd)
            os.ftruncate(fd, 0)
            os.pwrite(fd, f"{os.getpid()}\n".encode(), 0)
            key = (st.st_dev, st.st_ino)
            _dirlock_fds[key] = [fd, 1]
            self._key = key

    def release(self) -> None:
        key, self._key = self._key, None
        if key is None:
            return
        with _dirlock_mu:
            ent = _dirlock_fds.get(key)
            if ent is None:
                return
            ent[1] -= 1
            if ent[1] <= 0:
                del _dirlock_fds[key]
                try:
                    fcntl.lockf(ent[0], fcntl.LOCK_UN)
                except OSError:
                    pass
                os.close(ent[0])

    # refcount drops with the owner (a catalog dropped without close()),
    # so an abandoned handle does not pin the lock for process lifetime
    def __del__(self):
        try:
            self.release()
        except Exception:                # interpreter-shutdown safety
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False


# ----------------------------------------------------------------------
# WAL record codec
# ----------------------------------------------------------------------

@dataclass
class WalRecord:
    """One decoded mutation: ``op`` is "append" (``features`` [m, D]
    float32) or "delete" (``ids`` int64)."""
    op: str
    lsn: int
    features: Optional[np.ndarray] = None
    ids: Optional[np.ndarray] = None

    @property
    def rows(self) -> int:
        return 0 if self.features is None else int(self.features.shape[0])


def encode_append(lsn: int, features: np.ndarray) -> bytes:
    x = np.ascontiguousarray(np.asarray(features), dtype="<f4")
    return (_REC.pack(_OP_APPEND, int(lsn))
            + struct.pack("<II", x.shape[0], x.shape[1]) + x.tobytes())


def encode_delete(lsn: int, ids: Sequence[int]) -> bytes:
    a = np.ascontiguousarray(np.asarray(ids), dtype="<i8")
    return (_REC.pack(_OP_DELETE, int(lsn))
            + struct.pack("<I", a.shape[0]) + a.tobytes())


def decode_record(payload: bytes) -> WalRecord:
    op, lsn = _REC.unpack_from(payload, 0)
    body = payload[_REC.size:]
    if op == _OP_APPEND:
        m, d = struct.unpack_from("<II", body, 0)
        x = np.frombuffer(body, dtype="<f4", offset=8)
        if x.size != m * d:
            raise ValueError("append record body length mismatch")
        return WalRecord("append", lsn,
                         features=x.reshape(m, d).astype(np.float32))
    if op == _OP_DELETE:
        (k,) = struct.unpack_from("<I", body, 0)
        ids = np.frombuffer(body, dtype="<i8", offset=4)
        if ids.size != k:
            raise ValueError("delete record body length mismatch")
        return WalRecord("delete", lsn, ids=ids.astype(np.int64))
    raise ValueError(f"unknown WAL op byte {op}")


# ----------------------------------------------------------------------
# persistence handle (the catalog's write side)
# ----------------------------------------------------------------------

def _manifest_name(mid: int) -> str:
    return f"manifest-{mid:010d}.json"


def _valid_name(mid: int) -> str:
    return f"valid-{mid:010d}.npy"


def _seg_name(sid: int) -> str:
    return f"seg-{sid:010d}"


def _wal_name(first_lsn: int) -> str:
    return f"wal-{first_lsn:012d}.log"


def has_state(root) -> bool:
    """True when ``root`` holds at least one manifest — the test
    ``SearchEngine(live=True, data_dir=...)`` uses to decide between
    genesis (fresh catalog, write checkpoint 0) and recovery."""
    root = Path(root)
    return root.is_dir() and any(root.glob("manifest-*.json"))


def _scan_ids(root: Path, prefix: str, suffix: str) -> List[int]:
    out = []
    for p in root.glob(f"{prefix}*{suffix}"):
        digits = p.name[len(prefix):len(p.name) - len(suffix)]
        if digits.isdigit():
            out.append(int(digits))
    return sorted(out)


class Persistence:
    """The write side: owns the data directory, the open WAL file and
    the checkpoint/GC machinery. WAL appends are called under the
    catalog's mutation lock (LSN order == commit order); checkpoint and
    manifest commits may run on background threads and take this
    object's own lock for the WAL handle and id counters."""

    KEEP_MANIFESTS = 2

    def __init__(self, root, *, sync: str = "batch", faults=None,
                 algo: str = DEFAULT_ALGO):
        if sync not in SYNC_MODES:
            raise ValueError(f"sync must be one of {SYNC_MODES}, "
                             f"got {sync!r}")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        # single-writer enforcement: held until close() (or the kernel
        # reclaims it at process death) — a second process touching this
        # directory fails here instead of corrupting it
        self._dirlock = DirLock(self.root)
        self.sync = sync
        self.algo = algo
        self.faults = faults
        self._lock = threading.Lock()
        self._wal_f = None
        self._wal_path: Optional[Path] = None
        self._wal_last = 0                 # last lsn written to the open file
        self._wal_unsynced = False
        self._poisoned = ""
        self._next_manifest = (max(_scan_ids(self.root, "manifest-",
                                             ".json"), default=0) + 1)
        self._next_seg = (max(_scan_ids(self.root, "seg-", ""),
                              default=0) + 1)
        self.stats = {"wal_records": 0, "wal_bytes": 0, "wal_fsyncs": 0,
                      "wal_sync_s": 0.0, "wal_rollbacks": 0,
                      "segments_written": 0, "segment_bytes": 0,
                      "manifests_committed": 0, "checkpoints": 0}

    # ------------------------------------------------------------------
    def _fault(self, site: str) -> None:
        if self.faults is not None:
            self.faults.check(site)

    def _check_poisoned(self) -> None:
        if self._poisoned:
            raise PersistenceError(
                f"write-ahead log is poisoned ({self._poisoned}); "
                "reopen the catalog to resume durable mutations")

    # -------------------------------- WAL ----------------------------
    def _open_wal(self, first_lsn: int):
        path = self.root / _wal_name(first_lsn)
        hdr = (WAL_MAGIC + bytes([_ALGO_CODES[self.algo]])
               + struct.pack("<Q", first_lsn))
        # A header-only file legitimately survives recovery (crash
        # between the header write and the first record, or a rolled-
        # back first append followed by a clean close), and the reopened
        # catalog hands out the SAME first LSN — so this name can
        # already exist. Appending a second header would be parsed as a
        # record frame by the next recovery, quarantining the file and
        # every later one: write the header only into an empty file,
        # validate it otherwise.
        try:
            existing = os.path.getsize(path)
        except OSError:
            existing = 0
        if existing:
            with open(path, "rb") as rf:
                found = rf.read(len(hdr))
            if found != hdr:
                raise PersistenceError(
                    f"{path.name}: existing WAL header does not match "
                    "(truncated header, or algo/first-LSN drift) — "
                    "refusing to append after it")
        f = open(path, "ab", buffering=0 if self.sync == "always"
                 else io.DEFAULT_BUFFER_SIZE)
        if not existing:
            f.write(hdr)
            f.flush()
            if self.sync == "always":
                os.fsync(f.fileno())
            fsync_dir(self.root)      # the new file's directory entry
        self._wal_f, self._wal_path = f, path
        return f

    def _wal_append(self, lsn: int, payload: bytes) -> None:
        """Frame, checksum and write one record, honouring the sync
        policy. Atomic under failure: a failed fsync (including the
        injected-fault seam) truncates the file back to the record's
        start offset before raising, so a mutation that reports failure
        can never replay on recovery."""
        self._check_poisoned()
        buf = _HDR.pack(len(payload),
                        checksum(payload, self.algo)) + payload
        with self._lock:
            f = self._wal_f if self._wal_f is not None \
                else self._open_wal(lsn)
            start = f.tell()
            try:
                # torn-write seam: a fired fault leaves a PREFIX of the
                # record on disk and tears through like process death
                try:
                    self._fault("wal_write")
                except InjectedCrash as e:
                    f.write(buf[:int(len(buf) * e.fraction)])
                    f.flush()
                    raise
                f.write(buf)
                if self.sync != "none":
                    f.flush()
                if self.sync == "always":
                    t0 = time.perf_counter()
                    self._fault("wal_fsync")
                    os.fsync(f.fileno())
                    self.stats["wal_fsyncs"] += 1
                    dt = time.perf_counter() - t0
                    self.stats["wal_sync_s"] += dt
                else:
                    self._wal_unsynced = True
            except InjectedCrash:
                raise                 # simulated process death: no rollback
            except Exception as e:    # noqa: BLE001 — make failure atomic
                try:
                    f.flush()
                    os.ftruncate(f.fileno(), start)
                    f.seek(start)
                    self.stats["wal_rollbacks"] += 1
                except OSError as e2:
                    self._poisoned = f"rollback failed: {e2}"
                raise PersistenceError(
                    f"WAL append failed and was rolled back: {e}") from e
            self._wal_last = lsn
            self.stats["wal_records"] += 1
            self.stats["wal_bytes"] += len(buf)

    def log_append(self, lsn: int, features: np.ndarray) -> None:
        self._wal_append(lsn, encode_append(lsn, features))

    def log_delete(self, lsn: int, ids) -> None:
        self._wal_append(lsn, encode_delete(lsn, ids))

    def wal_sync(self) -> None:
        """Force the deferred fsync (batch/none modes); the checkpoint
        path calls this so a committed manifest never depends on WAL
        bytes that are still in flight."""
        with self._lock:
            if self._wal_f is not None and self._wal_unsynced:
                t0 = time.perf_counter()
                self._wal_f.flush()
                os.fsync(self._wal_f.fileno())
                self._wal_unsynced = False
                self.stats["wal_fsyncs"] += 1
                dt = time.perf_counter() - t0
                self.stats["wal_sync_s"] += dt

    def close(self) -> None:
        with self._lock:
            if self._wal_f is not None:
                try:
                    self._wal_f.flush()
                    os.fsync(self._wal_f.fileno())
                except OSError:
                    pass
                self._wal_f.close()
                self._wal_f = None
        self._dirlock.release()

    # ---------------------------- segments ---------------------------
    def write_segment(self, features: np.ndarray, indexes,
                      *, offset: int, rows: int, shard: int,
                      block: int) -> Dict:
        """Phase 1 of the checkpoint/compaction commit: write one
        sealed segment as immutable column files (features + per-subset
        permutation and zone maps) under a fresh ``seg-<id>/`` dir,
        each file published atomically and checksummed in ``meta.json``
        (written LAST — a dir without a valid meta is an uncommitted
        orphan, GC'd on recovery). Returns the manifest entry."""
        self._fault("segment_write")
        with self._lock:
            sid = self._next_seg
            self._next_seg += 1
        name = _seg_name(sid)
        d = self.root / name
        d.mkdir(parents=True, exist_ok=True)
        files: Dict[str, Dict] = {}

        def put(fname: str, arr: np.ndarray) -> None:
            data = npy_bytes(arr)
            atomic_write_bytes(d / fname, data, fsync_parent=False)
            files[fname] = {"bytes": len(data),
                            "crc": checksum(data, self.algo)}
            self.stats["segment_bytes"] += len(data)

        put("features.npy", np.ascontiguousarray(features, np.float32))
        for k, ix in enumerate(indexes):
            put(f"perm_{k:02d}.npy", np.asarray(ix.perm, np.int64))
            put(f"zlo_{k:02d}.npy", np.asarray(ix.zlo, np.float32))
            put(f"zhi_{k:02d}.npy", np.asarray(ix.zhi, np.float32))
        meta = json.dumps({"offset": int(offset), "rows": int(rows),
                           "shard": int(shard), "block": int(block),
                           "n_subsets": len(indexes), "algo": self.algo,
                           "files": files}, indent=1).encode()
        atomic_write_bytes(d / "meta.json", meta, fsync_parent=False)
        fsync_dir(d)
        fsync_dir(self.root)
        self.stats["segments_written"] += 1
        return {"dir": name, "offset": int(offset), "rows": int(rows),
                "shard": int(shard), "meta_bytes": len(meta),
                "meta_crc": checksum(meta, self.algo)}

    # ---------------------------- manifest ---------------------------
    def commit_manifest(self, *, epoch: int, geom: int, lsn: int,
                        next_shard: int, n_rows: int, live_rows: int,
                        frange, valid: np.ndarray, config: Dict,
                        segments: List[Dict]) -> int:
        """Phase 2: the commit point. Writes the validity overlay, then
        atomically replaces the manifest naming the exact segment set +
        WAL horizon; everything referenced is already durable (segment
        files fsync'd in phase 1, WAL fsync'd here). Afterwards GCs
        manifests/segments/WAL files no retained manifest needs."""
        self.wal_sync()               # horizon bytes must not be in flight
        self._fault("manifest_commit")
        with self._lock:
            mid = self._next_manifest
            self._next_manifest += 1
        vdata = npy_bytes(np.asarray(valid, bool))
        atomic_write_bytes(self.root / _valid_name(mid), vdata)
        doc = {
            "format": 1,
            "manifest_id": mid,
            "algo": self.algo,
            "epoch": int(epoch),
            "geom": int(geom),
            "lsn": int(lsn),
            "next_shard": int(next_shard),
            "n_rows": int(n_rows),
            "live_rows": int(live_rows),
            # float32 -> python float -> float32 is exact, so the live
            # feature range survives the JSON round trip bitwise
            "frange_lo": [float(v) for v in np.asarray(frange[0])],
            "frange_hi": [float(v) for v in np.asarray(frange[1])],
            "config": config,
            "valid": {"file": _valid_name(mid), "bytes": len(vdata),
                      "crc": checksum(vdata, self.algo)},
            "segments": segments,
        }
        atomic_write_bytes(self.root / _manifest_name(mid),
                           json.dumps(doc, indent=1).encode())
        self.stats["manifests_committed"] += 1
        self._gc(keep_from=mid)
        return mid

    def _gc(self, keep_from: int) -> None:
        """Drop manifests older than the newest KEEP_MANIFESTS, every
        segment dir / validity file none of the kept manifests
        reference, and WAL files whose records all fall at or below the
        OLDEST kept horizon (an older kept manifest must stay fully
        replayable — its WAL suffix is its recovery path)."""
        with self._lock:
            mids = _scan_ids(self.root, "manifest-", ".json")
            keep = [m for m in mids if m > keep_from - self.KEEP_MANIFESTS]
            drop = [m for m in mids if m not in keep]
            referenced, horizons = set(), []
            for m in keep:
                try:
                    doc = json.loads(
                        (self.root / _manifest_name(m)).read_text())
                except (OSError, ValueError):
                    continue
                referenced.update(s["dir"] for s in doc.get("segments", ()))
                referenced.add(doc.get("valid", {}).get("file", ""))
                horizons.append(int(doc.get("lsn", 0)))
            for m in drop:
                for p in (self.root / _manifest_name(m),
                          self.root / _valid_name(m)):
                    if p.name not in referenced:
                        p.unlink(missing_ok=True)
            for p in self.root.glob("seg-*"):
                if p.is_dir() and p.name not in referenced:
                    shutil.rmtree(p, ignore_errors=True)
            for p in self.root.glob("valid-*.npy"):
                if p.name not in referenced:
                    p.unlink(missing_ok=True)
            if horizons:
                h = min(horizons)
                wals = _scan_ids(self.root, "wal-", ".log")
                for first, nxt in zip(wals, wals[1:]):
                    # file [first, nxt) is fully obsolete iff nxt <= h+1
                    path = self.root / _wal_name(first)
                    if nxt <= h + 1 and path != self._wal_path:
                        path.unlink(missing_ok=True)
            fsync_dir(self.root)


# ----------------------------------------------------------------------
# recovery (the read side)
# ----------------------------------------------------------------------

@dataclass
class RecoveryReport:
    """What recovery found, salvaged and refused — the payload of a
    typed ``RecoveryError`` and the ``recovery`` attribute of a
    reopened catalog. ``clean`` means the directory recovered with no
    detected damage (a crash at a record boundary is clean; a torn or
    corrupt record is not)."""
    manifest_id: int = -1
    horizon_lsn: int = 0
    last_lsn: int = 0
    replayed_appends: int = 0
    replayed_deletes: int = 0
    replayed_rows: int = 0
    torn_tail: bool = False
    quarantined: List[str] = field(default_factory=list)
    orphans_removed: List[str] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def clean(self) -> bool:
        return not self.errors


@dataclass
class RecoveredState:
    """Everything the catalog layer needs to reassemble: the chosen
    manifest's config + counters, per-segment raw columns, the validity
    overlay, and the decoded WAL tail (records past the horizon, in
    LSN order) to replay through the real mutation code paths."""
    config: Dict
    epoch: int
    geom: int
    lsn: int
    next_shard: int
    n_rows: int
    live_rows: int
    frange_lo: np.ndarray
    frange_hi: np.ndarray
    valid: np.ndarray
    # per segment: (entry dict, features [m, D], [(perm, zlo, zhi)] per subset)
    segments: List[Tuple[Dict, np.ndarray, List[Tuple[np.ndarray, ...]]]]
    tail: List[WalRecord]
    report: RecoveryReport


def _read_file(path: Path, faults, site: str) -> bytes:
    """Read a whole file through the short-read fault seam: a fired
    ``torn`` fault truncates the buffer exactly like a short read or a
    truncated-on-disk file would, and flows into the same checksum
    detection path."""
    data = path.read_bytes()
    if faults is not None:
        try:
            faults.check(site)
        except InjectedCrash as e:
            data = data[:int(len(data) * e.fraction)]
    return data


def _quarantine(root: Path, rel: str, data: Optional[bytes],
                report: RecoveryReport) -> None:
    """Move suspect bytes out of the data path (never delete evidence):
    ``data=None`` moves the file wholesale, else writes the given tail
    bytes under a unique name."""
    qdir = root / "quarantine"
    qdir.mkdir(exist_ok=True)
    base = rel.replace("/", "__")
    dest = qdir / base
    k = 0
    while dest.exists():
        k += 1
        dest = qdir / f"{base}.{k}"
    src = root / rel
    if data is None:
        if src.exists():
            os.replace(src, dest)
    else:
        dest.write_bytes(data)
    report.quarantined.append(str(dest.relative_to(root)))


def _load_manifest(root: Path, mid: int, faults) -> Tuple[Dict, np.ndarray]:
    """Parse + fully verify one manifest: JSON shape, validity overlay
    and every referenced column file's length and checksum. Raises
    ValueError with a precise reason on the first mismatch."""
    raw = (root / _manifest_name(mid)).read_bytes()
    doc = json.loads(raw)
    if doc.get("format") != 1:
        raise ValueError(f"unsupported manifest format {doc.get('format')}")
    algo = doc["algo"]
    v = doc["valid"]
    vdata = _read_file(root / v["file"], faults, "segment_read")
    if len(vdata) != v["bytes"] or checksum(vdata, algo) != v["crc"]:
        raise ValueError(f"validity overlay {v['file']} failed its "
                         "checksum (truncated or corrupt)")
    valid = npy_load(vdata)
    if valid.shape[0] != doc["n_rows"]:
        raise ValueError("validity overlay length != manifest n_rows")
    return doc, valid


def _load_segment(root: Path, entry: Dict, n_subsets: int, algo: str,
                  faults) -> Tuple[np.ndarray, List[Tuple[np.ndarray, ...]]]:
    d = root / entry["dir"]
    meta_raw = _read_file(d / "meta.json", faults, "segment_read")
    if (len(meta_raw) != entry["meta_bytes"]
            or checksum(meta_raw, algo) != entry["meta_crc"]):
        raise ValueError(f"{entry['dir']}/meta.json failed its checksum")
    meta = json.loads(meta_raw)

    def get(fname: str) -> np.ndarray:
        info = meta["files"][fname]
        data = _read_file(d / fname, faults, "segment_read")
        if len(data) != info["bytes"] or checksum(data, algo) != info["crc"]:
            raise ValueError(f"{entry['dir']}/{fname} failed its checksum "
                             "(truncated or corrupt column file)")
        return npy_load(data)

    features = get("features.npy")
    if features.shape[0] != entry["rows"]:
        raise ValueError(f"{entry['dir']} features rows != manifest rows")
    cols = [(get(f"perm_{k:02d}.npy"), get(f"zlo_{k:02d}.npy"),
             get(f"zhi_{k:02d}.npy")) for k in range(n_subsets)]
    return features, cols


def _scan_wal(root: Path, horizon: int, algo: str, faults,
              report: RecoveryReport) -> List[WalRecord]:
    """Decode every WAL file in LSN order, verifying framing, checksum
    and LSN continuity. Stops at the FIRST bad byte: a torn tail or a
    checksum mismatch quarantines the rest of that file AND every later
    file (records after a hole cannot be ordered against the mutations
    the hole swallowed), then physically truncates the file back to its
    salvaged prefix so the next boot is clean."""
    tail: List[WalRecord] = []
    files = _scan_ids(root, "wal-", ".log")
    expected = None
    broken = False
    for i, first in enumerate(files):
        rel = _wal_name(first)
        if broken:
            _quarantine(root, rel, None, report)
            continue
        data = _read_file(root / rel, faults, "wal_read")
        hlen = len(WAL_MAGIC) + 1 + 8
        if (len(data) < hlen or data[:len(WAL_MAGIC)] != WAL_MAGIC
                or data[len(WAL_MAGIC)] not in _ALGO_NAMES):
            report.errors.append(f"{rel}: bad or truncated WAL header")
            _quarantine(root, rel, None, report)
            broken = True
            continue
        falgo = _ALGO_NAMES[data[len(WAL_MAGIC)]]
        (file_first,) = struct.unpack_from("<Q", data, len(WAL_MAGIC) + 1)
        if file_first != first:
            report.errors.append(f"{rel}: header LSN {file_first} != "
                                 "filename LSN")
            _quarantine(root, rel, None, report)
            broken = True
            continue
        off, good_off = hlen, hlen
        while True:
            if off == len(data):
                break                         # clean record boundary
            if off + _HDR.size > len(data):
                report.torn_tail = True
                report.errors.append(
                    f"{rel}: torn record header at byte {off}")
                break
            length, crc = _HDR.unpack_from(data, off)
            if off + _HDR.size + length > len(data):
                report.torn_tail = True
                report.errors.append(
                    f"{rel}: torn record payload at byte {off} "
                    f"(need {length} bytes)")
                break
            payload = data[off + _HDR.size: off + _HDR.size + length]
            if checksum(payload, falgo) != crc:
                report.errors.append(
                    f"{rel}: record checksum mismatch at byte {off}")
                break
            try:
                rec = decode_record(payload)
            except (ValueError, struct.error) as e:
                report.errors.append(f"{rel}: undecodable record at "
                                     f"byte {off}: {e}")
                break
            if expected is not None and rec.lsn != expected:
                report.errors.append(
                    f"{rel}: LSN gap (got {rec.lsn}, expected {expected})")
                break
            expected = rec.lsn + 1
            off = good_off = off + _HDR.size + length
            report.last_lsn = rec.lsn
            if rec.lsn > horizon:
                tail.append(rec)
        if good_off < len(data):
            # quarantine the refused suffix, truncate the file to its
            # salvaged prefix (atomically — the original moved aside
            # first, so no evidence is lost), drop every later file
            _quarantine(root, rel, data[good_off:], report)
            if good_off > hlen:
                atomic_write_bytes(root / rel, data[:good_off])
            else:
                _quarantine(root, rel, None, report)
            broken = True
    return tail


def recover(root, *, faults=None) -> RecoveredState:
    """Load the newest fully-valid manifest, replay-decode the WAL
    tail, quarantine anything that fails validation. Raises
    ``RecoveryError`` (with ``catalog=None``) only when NO manifest is
    serviceable; partial damage is returned in the report so the
    caller can decide how loudly to surface it. Holds the directory's
    single-writer lock for the scan — recovery mutates the directory
    (quarantine moves, tail truncation, orphan GC) and must never race
    a live writer in another process."""
    root = Path(root)
    with DirLock(root):
        return _recover_locked(root, faults)


def _recover_locked(root: Path, faults) -> RecoveredState:
    t0 = time.perf_counter()
    report = RecoveryReport()
    mids = _scan_ids(root, "manifest-", ".json")
    if not mids:
        raise RecoveryError(f"no manifest under {root} — nothing to "
                            "recover", report=report)
    doc = valid = None
    for mid in sorted(mids, reverse=True):
        try:
            doc, valid = _load_manifest(root, mid, faults)
            n_sub = len(doc["config"]["subsets"])
            segments = [(e, *_load_segment(root, e, n_sub, doc["algo"],
                                           faults))
                        for e in doc["segments"]]
            report.manifest_id = mid
            break
        except (OSError, ValueError, KeyError) as e:
            report.errors.append(f"{_manifest_name(mid)}: {e}")
            _quarantine(root, _manifest_name(mid), None, report)
            doc = None
    if doc is None:
        report.wall_s = time.perf_counter() - t0
        raise RecoveryError(
            "every manifest failed validation — nothing serviceable "
            f"under {root}", report=report)
    horizon = int(doc["lsn"])
    report.horizon_lsn = report.last_lsn = horizon
    tail = _scan_wal(root, horizon, doc["algo"], faults, report)
    for rec in tail:
        if rec.op == "append":
            report.replayed_appends += 1
            report.replayed_rows += rec.rows
        else:
            report.replayed_deletes += 1
    # GC uncommitted orphans — but only TRUE phase-1 debris. A dir
    # without meta.json is a checkpoint/compaction that died mid-files
    # and can never be referenced (meta.json is written last): remove
    # it silently. A dir WITH a valid-looking meta.json that no
    # surviving manifest references may be evidence — e.g. its manifest
    # just failed validation (possibly a transient read error) and was
    # quarantined above — so it is quarantined alongside, never
    # deleted: a retry of the newer state stays possible.
    referenced = {e["dir"] for m in mids if m != report.manifest_id
                  for e in _safe_manifest_segments(root, m)}
    referenced.update(e["dir"] for e in doc["segments"])
    for p in sorted(root.glob("seg-*")):
        if not p.is_dir() or p.name in referenced:
            continue
        if (p / "meta.json").exists():
            _quarantine(root, p.name, None, report)
        else:
            shutil.rmtree(p, ignore_errors=True)
            report.orphans_removed.append(p.name)
    report.wall_s = time.perf_counter() - t0
    return RecoveredState(
        config=doc["config"], epoch=int(doc["epoch"]),
        geom=int(doc["geom"]), lsn=horizon,
        next_shard=int(doc["next_shard"]), n_rows=int(doc["n_rows"]),
        live_rows=int(doc["live_rows"]),
        frange_lo=np.asarray(doc["frange_lo"], np.float32),
        frange_hi=np.asarray(doc["frange_hi"], np.float32),
        valid=np.asarray(valid, bool), segments=segments, tail=tail,
        report=report)


def _safe_manifest_segments(root: Path, mid: int) -> List[Dict]:
    try:
        return json.loads(
            (root / _manifest_name(mid)).read_text()).get("segments", [])
    except (OSError, ValueError):
        return []
