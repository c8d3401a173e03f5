"""Failure handling — counterpart of ``repro.train.elastic``.

Straggler / preemption utilities used by the Trainer:
  * ``Heartbeat``   — per-step deadline monitor (straggler detection);
  * ``Preemption``  — SIGTERM-triggered save-and-exit flag.

The elastic half (``remesh``, ``reshard_state``,
``simulate_failure_and_restart``: rebuild a smaller mesh from the
surviving devices and reshard the checkpoint onto it) needs a mesh, which
is ROADMAP A13c; each raises NotImplementedError.
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Callable

_MESH = ("{} rebuilds or reshards onto a device mesh; the port trains on "
         "one device (the mesh is ROADMAP A13c)")


def remesh(n_devices: int, model_axis: int = 16):
    raise NotImplementedError(_MESH.format("remesh"))


def reshard_state(state, shardings):
    raise NotImplementedError(_MESH.format("reshard_state"))


def simulate_failure_and_restart(state, make_shardings, *, old_mesh,
                                 surviving_devices: int,
                                 model_axis: int = 1):
    raise NotImplementedError(_MESH.format("simulate_failure_and_restart"))


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
