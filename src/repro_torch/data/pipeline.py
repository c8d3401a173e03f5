"""Deterministic, shardable, resumable data pipeline.

Production contract (1000+ nodes):
  * every host computes its own shard from (step, host_id) — no data
    server, no coordination, no skew;
  * resuming from step S reproduces exactly the batches S, S+1, ... that
    a never-interrupted run would have seen (checkpoint-restart safety);
  * a background prefetch thread hides host-side generation latency.

Two sources:
  * TokenSource      — synthetic LM token streams (structured Zipf n-gram
    process, so the loss actually decreases during example training runs)
  * PatchSource      — image patches + labels from data/synthetic.py
    (feature-extractor training / engine catalogs)

A numpy copy of ``repro.data.pipeline`` (the port imports nothing of
``repro``); its outputs are bitwise the reference's.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data.synthetic import PatchDatasetConfig, generate_patches


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    vocab_size: int = 256
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class TokenSource:
    """Synthetic LM stream: a fixed random bigram automaton with Zipfian
    emissions. Learnable structure (bigram entropy << uniform) so example
    training shows a real loss curve."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed ^ 0xA5A5)
        v = cfg.vocab_size
        # sparse bigram transition table: each token prefers ~8 successors
        k = min(8, v)
        self.succ = rng.integers(0, v, (v, k)).astype(np.int32)
        probs = 1.0 / np.arange(1, k + 1)
        self.succ_p = (probs / probs.sum()).astype(np.float64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for ``step`` on this host — pure function of (cfg, step)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 64 + cfg.host_id)
        b, s = cfg.host_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, b)
        choices = rng.choice(self.succ.shape[1], (b, s), p=self.succ_p)
        for t in range(s):
            toks[:, t + 1] = self.succ[toks[:, t], choices[:, t]]
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


class PatchSource:
    """Image patch batches for extractor training (one epoch = catalog)."""

    def __init__(self, cfg: DataConfig, patch_cfg: PatchDatasetConfig):
        self.cfg = cfg
        data = generate_patches(patch_cfg)
        self.images = data["images"]
        self.labels = data["labels"]

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 64 + cfg.host_id)
        idx = rng.integers(0, len(self.images), cfg.host_batch)
        return {"images": self.images[idx], "labels": self.labels[idx],
                "ids": idx.astype(np.int32)}


class Prefetcher:
    """Background thread pulling ``source.batch(step)`` ahead of the
    training loop. Deterministic: batches come out in step order
    regardless of thread timing; ``close()`` is idempotent."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.source.batch(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            step, batch = self.q.get()
            if step == self._step:       # drop anything stale after restart
                self._step += 1
                return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
