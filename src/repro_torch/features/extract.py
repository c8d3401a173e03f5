"""Bulk feature extraction — the offline catalog-embedding pass (paper
§3); counterpart of ``repro.features.extract``.

Embeds the whole patch catalog with the extractor in fixed-size batches
and returns a [N, F] float32 matrix that feeds the index builder. Any
backbone works as the extractor (DESIGN.md §5): the paper's own ViT
plugs in through ``vit_feature_fn``, the assigned LM architectures
through ``lm_feature_fn`` (mean-pooled final hidden state).
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.features.vit import ViT, extract_features
from repro_torch.models import lm


def vit_feature_fn(model: ViT) -> Callable[[torch.Tensor], torch.Tensor]:
    """images [B, H, W, 3] on the model's device -> features [B, 2d]."""

    def fn(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return extract_features(model, images)
    return fn


def lm_feature_fn(model: lm.LM, ctx=None
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """tokens [B, S] on the model's device -> features [B, d_model] in
    the compute dtype: the final hidden state (after the final norm) of
    the causal LM, mean-pooled over the sequence — the arch-agnostic
    feature head of the assigned architectures. ``ctx``: a
    ``ParallelCtx`` with a mesh for a model placed on it; every rank
    passes the whole batch and gets the whole [B, d_model]."""

    def fn(tokens: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return lm.features(model, tokens, ctx)
    return fn


def extract_catalog(inputs: np.ndarray, feature_fn: Callable, *,
                    batch: int = 128, device=None) -> np.ndarray:
    """Run ``feature_fn`` over the full catalog in batches of ``batch``
    rows uploaded to ``device`` (default CUDA). The tail batch is padded
    by repeating its last row, as the reference does so that every call
    sees one shape, and trimmed after. Returns [N, F] float32 (numpy);
    the features stay on the device until the one copy at the end."""
    dev = resolve_device(device)
    n = inputs.shape[0]
    outs = []
    for i in range(0, n, batch):
        chunk = inputs[i:i + batch]
        pad = batch - chunk.shape[0]
        if pad:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], pad, axis=0)], axis=0)
        f = feature_fn(torch.from_numpy(np.ascontiguousarray(chunk)).to(dev))
        outs.append(f[: batch - pad])
    return torch.cat(outs).to(torch.float32).cpu().numpy()


def extraction_throughput(feature_fn: Callable, sample: np.ndarray, *,
                          batch: int = 128, iters: int = 5,
                          device=None) -> Dict:
    """Patches/second of the extractor on one resident batch (the first
    sample repeated), host clock around ``iters`` calls ending in a
    device synchronise; one warm-up call first."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.repeat(sample[:1], batch, axis=0)).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    feature_fn(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        feature_fn(x)
    sync()
    dt = (time.perf_counter() - t0) / iters
    return {"batch": batch, "s_per_batch": dt, "patches_per_s": batch / dt}
