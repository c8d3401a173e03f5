"""Fault-tolerant checkpoints — counterpart of ``repro.train.checkpoint``,
with its contract and its files.

  * **atomic AND durable**: write to ``step_N.tmpK/``, fsync every leaf
    file and the directory, then ``os.replace`` + parent-directory fsync
    (``core.persist.atomic_write_bytes``, the catalog's own discipline);
  * **async**: ``save_async`` snapshots to host memory synchronously and
    writes in a background thread (at most one in flight);
  * **self-describing**: ``manifest.json`` lists every leaf's shape and
    dtype and is written last, its presence marking a complete step;
  * keep-N garbage collection; ``restore`` of the latest or a given step.

Format: one ``.npy`` per leaf, named by the leaf's tree path with "/" as
"__", plus the manifest — the reference's, byte for byte, so either
package restores the other's checkpoint. A tree is nested dicts, named
tuples, lists / tuples and numpy leaves, flattened as JAX flattens them
(dict keys sorted, tuple fields in order, None an empty subtree). The
port's ``launch.steps.TrainState`` is saved as the reference's
``TrainState`` (``core.convert.train_state_to_numpy``: leaves stacked
over blocks, e.g. ``params/blocks/slot0/attn/wq``) and restored into one.

On a mesh (``mesh=``, a state placed on it): every rank of the mesh
calls ``save`` / ``save_async`` / ``wait`` / ``restore`` at the same
points. A save gathers every leaf to its full logical array (every rank
takes part), the mesh's first rank writes the files, and the ranks wait
for it (``launch.mesh.mesh_barrier``) before any of them goes on; a
restore reads the files memory-mapped and each rank copies its shard
only. The files are the single device's: a state saved on one mesh
restores onto another, or onto one device.

A bfloat16 leaf: the reference's ``np.save`` of an ml_dtypes bfloat16
array writes the descr ``'<V2'`` and the raw 2-byte bits, and its
manifest says ``"bfloat16"``; the port writes the same bytes from the
bits (``convert.BF16_BITS``) without ml_dtypes, and reads such a leaf
back as bfloat16.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch.core.convert import (BF16_BITS, load_train_state_, nest,
                                      train_state_to_numpy)
from repro_torch.core.persist import atomic_write_bytes, fsync_dir, npy_bytes


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs in JAX's flatten order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _flatten_with_names(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix or "leaf", tree)]
    out = []
    for k, c in kids:
        out.extend(_flatten_with_names(c, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, dict):
        return {k: _unflatten(c, leaves) for k, c in kids}
    vals = [_unflatten(c, leaves) for _, c in kids]
    return type(like)(*vals) if _is_namedtuple(like) else type(like)(vals)


def _leaf_file(name: str) -> str:
    return name.replace("/", "__") + ".npy"


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_BITS else str(arr.dtype)


def _leaf_bytes(arr: np.ndarray) -> bytes:
    """``np.save``'s bytes; bfloat16 bits with the descr the reference's
    ml_dtypes array gets (``'<V2'``)."""
    if arr.dtype != BF16_BITS:
        return npy_bytes(arr)
    arr = np.ascontiguousarray(arr)
    head = np.lib.format.header_data_from_array_1_0(arr)
    head["descr"] = "<V2"
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, head)
    buf.write(arr.tobytes())
    return buf.getvalue()


def _host_tree(tree):
    """A port TrainState as the reference's numpy tree; any other tree
    with its leaves as numpy arrays."""
    from repro_torch.launch.steps import TrainState
    if isinstance(tree, TrainState):
        return train_state_to_numpy(tree, tree.model.cfg)
    leaves = [np.asarray(a) for _, a in _flatten_with_names(tree)]
    return _unflatten(tree, iter(leaves))


class CheckpointManager:
    """Directory layout: ``{dir}/step_{N:08d}/`` with manifest + leaf
    files."""

    def __init__(self, directory, *, keep: int = 3, shard_id: int = 0,
                 num_shards: int = 1, mesh=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.mesh = mesh
        coord = None if mesh is None else mesh.get_coordinate()
        self.writer = mesh is None or (coord is not None
                                       and not any(coord))
        self._pending: Optional[threading.Thread] = None

    def _barrier(self) -> None:
        if self.mesh is not None:
            from repro_torch.launch.mesh import mesh_barrier
            mesh_barrier(self.mesh)

    # ------------------------------------------------------------------
    def save(self, step: int, tree) -> Path:
        """Synchronous atomic save."""
        host_tree = _host_tree(tree)
        final = self._write(step, host_tree) if self.writer \
            else self.dir / f"step_{step:08d}"
        self._barrier()
        return final

    def save_async(self, step: int, tree) -> None:
        """Snapshot now (a host copy), write in the background. Joins any
        previous pending write first (at most one in flight)."""
        self.wait()
        host_tree = _host_tree(tree)
        if self.writer:
            self._pending = threading.Thread(
                target=self._write, args=(step, host_tree), daemon=True)
            self._pending.start()

    def wait(self) -> None:
        """Join the pending write; on a mesh every rank then waits for
        the writer."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._barrier()

    # ------------------------------------------------------------------
    def _write(self, step: int, host_tree) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp{self.shard_id}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "shard_id": self.shard_id,
                    "num_shards": self.num_shards,
                    "leaves": {}}
        # every leaf lands via the shared write+fsync+replace helper, and
        # the manifest is written LAST: its presence is the completeness
        # marker list_steps()/restore() key off
        for name, leaf in _flatten_with_names(host_tree):
            arr = np.asarray(leaf)
            atomic_write_bytes(tmp / _leaf_file(name), _leaf_bytes(arr),
                               fsync_parent=False)
            manifest["leaves"][name] = {
                "shape": list(arr.shape), "dtype": _dtype_name(arr)}
        atomic_write_bytes(tmp / "manifest.json",
                           json.dumps(manifest, indent=1).encode(),
                           fsync_parent=False)
        fsync_dir(tmp)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        fsync_dir(self.dir)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if ".tmp" in p.name or not p.is_dir():
                continue
            if not (p / "manifest.json").exists():
                continue   # incomplete (crashed mid-write before rename)
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: Optional[int] = None):
        """Restore into the structure of ``tree_like``; a port TrainState
        is loaded in place (shapes and dtypes must match: nothing is cast;
        on a mesh each rank reads its shards) and returned with the
        checkpoint's steps. A bfloat16 leaf comes
        back as its bits (``BF16_BITS``) in a numpy tree. Raises
        FileNotFoundError if nothing exists."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        load = lambda name: np.load(d / _leaf_file(name))
        from repro_torch.launch.steps import TrainState
        if isinstance(tree_like, TrainState):
            load = lambda name: np.load(d / _leaf_file(name), mmap_mode="r")
            manifest = json.loads((d / "manifest.json").read_text())
            tree = nest({n: load(n) for n in manifest["leaves"]}, "/")
            return load_train_state_(tree_like, tree, tree_like.model.cfg)
        names = [n for n, _ in _flatten_with_names(tree_like)]
        return _unflatten(tree_like, iter([load(n) for n in names]))
