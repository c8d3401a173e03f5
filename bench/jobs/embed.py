"""The catalog's embedding pass: ``extract_catalog`` with the ViT's
feature function over a pool of patches in host memory, again and again.

Set-up: the ViT is built and handed the seeded weights; the pool is
drawn on the card from the seed and copied to pageable host memory, so
each batch is uploaded as an embedding pass uploads it; one batch warms
every shape. The window runs ``extract_catalog`` over the whole pool, a
unit, until ``--seconds`` have passed. Then a sample of the window's
features, drawn from the seed, is compared with the reference's features
of the same patches.
"""
from __future__ import annotations

import time

import numpy as np

from bench import common
from bench.harness import (Context, JobResult, checks, free, peak_bytes,
                           sync, traced_window, window)

# the keys of a configuration file that are the port's ModelConfig fields
MODEL_KEYS = ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "d_ff", "mlp_activation",
              "mlp_gated", "vocab_size", "input_mode", "norm_eps",
              "param_dtype", "compute_dtype")
REF_ROWS = 64            # patches a reference call embeds


def run(ctx: Context) -> JobResult:
    import torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.features import extract
    from repro_torch.features.vit import ViT

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    if torch.get_float32_matmul_precision() != cfg["matmul_precision"]:
        raise RuntimeError(
            f"float32 matmul precision is "
            f"{torch.get_float32_matmul_precision()!r}, the configuration "
            f"states {cfg['matmul_precision']!r}")
    mc = ModelConfig(**{k: cfg[k] for k in MODEL_KEYS})
    leaves = common.vit_leaves(cfg)
    model = ViT(mc, image_size=cfg["image_size"],
                patch_size=cfg["patch_size"], device=dev)
    common.load_weights(dict(model.named_parameters()), leaves, ctx.seed,
                        dev)
    pool = _pool(cfg, tr, ctx.seed, dev)
    fn = extract.vit_feature_fn(model)
    fn = ctx.hooks.get("feature_fn", lambda f: f)(fn)
    batch = tr["batch"]
    outputs = []

    def unit():
        outputs.append(extract.extract_catalog(pool, fn, batch=batch,
                                               device=dev))
    extract.extract_catalog(pool[:batch], fn, batch=batch, device=dev)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    metrics, reduced = {}, None
    if ctx.trace:
        reduced = traced_window(unit, tr["trace_units"])
    else:
        w = window(unit, ctx.seconds)
        metrics = {"patches_per_s": w.units * len(pool) / w.seconds,
                   "setup_s": setup_s}
    peak = peak_bytes(dev)
    del model, fn
    free(dev)
    failed = int(sum((~np.isfinite(o)).any(axis=1).sum() for o in outputs))
    gap = feature_gap(ctx, leaves, pool, outputs)
    return JobResult(metrics=metrics, attempted=len(outputs) * len(pool),
                     failed=failed, memory_peak_bytes=peak,
                     checks=checks(tr, {"feature_gap": gap}),
                     work={"patches": len(outputs) * len(pool)},
                     trace=reduced)


def _pool(cfg: dict, tr: dict, seed: int, dev) -> np.ndarray:
    """[pool, H, W, 3] float32 pixels in [0, 1), drawn on the device and
    copied to (pageable) host memory."""
    import torch
    s = cfg["image_size"]
    x = torch.rand((tr["pool"], s, s, 3),
                   generator=common.generator(seed, common.INPUTS_KEY, dev),
                   dtype=torch.float32, device=dev)
    host = x.cpu().numpy()
    del x
    return host


def sample(ctx: Context, n_outputs: int, pool: int) -> np.ndarray:
    """Indices into the window's features (unit * pool + row), drawn
    from the seed: ``sample`` of them, or all where there are fewer."""
    rng = np.random.default_rng(common.derive_seed(ctx.seed,
                                                   common.SAMPLE_KEY))
    total = n_outputs * pool
    k = min(ctx.traffic["sample"], total)
    return np.sort(rng.choice(total, size=k, replace=False))


def feature_gap(ctx: Context, leaves, pool: np.ndarray, outputs) -> float:
    """The widest gap between a sampled patch's features and the
    reference's, against the largest magnitude of the reference's
    features of that patch."""
    import torch
    dev = ctx.device
    idx = sample(ctx, len(outputs), len(pool))
    rows = np.unique(idx % len(pool))
    w = common.weights(leaves, ctx.seed, dev)
    ref = {}
    for i in range(0, len(rows), REF_ROWS):
        r = rows[i:i + REF_ROWS]
        f = ctx.reference.features(
            w, torch.from_numpy(pool[r]).to(dev), ctx.config)
        for j, row in enumerate(r):
            ref[int(row)] = f[j].cpu().numpy().astype(np.float64)
    del w
    gap = 0.0
    for k in idx:
        got = outputs[k // len(pool)][k % len(pool)].astype(np.float64)
        want = ref[int(k % len(pool))]
        d = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        gap = max(gap, d) if np.isfinite(d) else float("inf")
    return gap



def controls(ctx: Context) -> dict:
    """The control's readings: the reference computed with TF32 products
    (the precision below the configuration's float32), in the program's
    place, on ``sample`` patches of the cell's pool, against the float32
    reference."""
    import torch
    dev = ctx.device
    leaves = common.vit_leaves(ctx.config)
    pool = _pool(ctx.config, ctx.traffic, ctx.seed, dev)
    rows = sample(ctx, 1, len(pool))
    w = common.weights(leaves, ctx.seed, dev)
    gap = 0.0
    for i in range(0, len(rows), REF_ROWS):
        x = torch.from_numpy(pool[rows[i:i + REF_ROWS]]).to(dev)
        want = ctx.reference.features(w, x, ctx.config).double()
        got = ctx.reference.features(w, x, ctx.config, "tf32").double()
        gap = max(gap, float(((got - want).abs().amax(1)
                              / want.abs().amax(1)).max()))
    return {"tf32": {"feature_gap": gap}}
