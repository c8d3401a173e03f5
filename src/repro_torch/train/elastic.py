"""Elastic scaling + failure handling — counterpart of
``repro.train.elastic``.

On node loss the job restarts on the surviving ranks: the mesh is
rebuilt with ``elastic_mesh_shape`` over a sub-group of the world (world
ranks 0 .. n - 1) and the latest checkpoint is resharded onto it.
Because checkpoints are stored as full logical arrays (host tensors,
topology-independent) the reshard is a placement, ``sharding.place``
with the new mesh's shardings: each rank cuts its own shard, no per-shard
stitching. A whole ``launch.steps.TrainState`` takes the same path: its
leaves gathered to the reference's full arrays
(``core.convert.train_state_to_numpy``) and loaded into a state placed
on the new mesh, each rank its shards (as ``Trainer.init_or_restore``
restores a checkpoint onto any mesh).

Also here: straggler/preemption utilities used by the Trainer:
  * ``Heartbeat``   — per-step deadline monitor (straggler detection);
  * ``Preemption``  — SIGTERM-triggered save-and-exit flag.
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Any, Callable, Tuple

import torch

from repro_torch.compat import DeviceMesh
from repro_torch.launch import sharding
from repro_torch.launch.mesh import elastic_mesh_shape, mesh_of
from repro_torch.models.common import gather_placed


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (named
    ones too), ``rest`` trees of the same structure alongside."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def remesh(n_devices: int, model_axis: int = 16,
           device_type: str = "cuda") -> DeviceMesh:
    """The largest (data, model) mesh from the surviving ranks 0 ..
    n_devices - 1 of the world (every rank of the world calls it)."""
    return mesh_of(elastic_mesh_shape(n_devices, model_axis),
                   ("data", "model"), device_type)


def reshard_state(state: Any, shardings: Any) -> Any:
    """Place a host-side (full logical) tree onto new shardings (a tree
    of ``sharding.NamedSharding`` of the same structure) — the elastic-
    restart data path. Leaves become DTensors on the shardings' mesh
    (None on a rank outside it). A TrainState's host arrays
    (``train_state_to_numpy``'s) go into ``shardings`` given as a
    TrainState placed on the new mesh (``init_train_state(..., mesh=)``),
    each rank its shards; that state is returned with their steps."""
    from repro_torch.launch.steps import TrainState
    if isinstance(shardings, TrainState):
        from repro_torch.core.convert import load_train_state_
        return load_train_state_(shardings, state, shardings.model.cfg)

    def put(x, sh):
        return sharding.place(x, sh, device=torch.device(
            sh.mesh.device_type))
    return _tree_map(put, state, shardings)


def simulate_failure_and_restart(
    state: Any,
    make_shardings: Callable[[DeviceMesh], Any],
    *,
    old_mesh: DeviceMesh,
    surviving_devices: int,
    model_axis: int = 1,
) -> Tuple[DeviceMesh, Any]:
    """Test harness for the elastic path: take a sharded state (a tree of
    DTensors, or a TrainState), 'lose' ranks, rebuild a smaller mesh and
    reshard. Returns (mesh, state); every rank of the old mesh calls it.
    For a TrainState ``make_shardings(new_mesh)`` gives the placed state
    to load into (``reshard_state``), and a rank outside the new mesh
    gets None."""
    from repro_torch.launch.steps import TrainState
    if isinstance(state, TrainState):
        from repro_torch.core.convert import train_state_to_numpy
        host_state = train_state_to_numpy(state, state.model.cfg)
        new_mesh = remesh(surviving_devices, model_axis,
                          old_mesh.device_type)
        if new_mesh.get_coordinate() is None:
            return new_mesh, None
        return new_mesh, reshard_state(host_state, make_shardings(new_mesh))
    host_state = _tree_map(lambda x: gather_placed(x).cpu(), state)
    new_mesh = remesh(surviving_devices, model_axis, old_mesh.device_type)
    return new_mesh, reshard_state(host_state, make_shardings(new_mesh))


class Preemption:
    """SIGTERM/SIGINT -> ``requested`` flag; the train loop checkpoints
    and exits cleanly at the next step boundary."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:      # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


class Heartbeat:
    """Step-deadline monitor. ``beat()`` each step; if a step exceeds
    ``deadline_s`` the ``on_straggler`` callback fires (log + metrics in
    production; the trainer also counts skips)."""

    def __init__(self, deadline_s: float,
                 on_straggler: Callable[[float], None]):
        self.deadline = deadline_s
        self.on_straggler = on_straggler
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired_for_step = False
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def beat(self):
        self._last = time.monotonic()
        self._fired_for_step = False

    def _watch(self):
        while not self._stop.wait(min(self.deadline / 4, 1.0)):
            dt = time.monotonic() - self._last
            if dt > self.deadline and not self._fired_for_step:
                self._fired_for_step = True
                self.on_straggler(dt)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
