#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA
card: build the hand-written kernels, hold each against its plain PyTorch
version, check the GPU engine against the port's own CPU engine, then
drive the engine's main path (``SearchEngine.query_batch`` with the numpy
fit, survivor-sparse scoring and device ranking) at full size.

    python3 chip_smoke.py

Phases print one JSON line each. The line before the last two is
``{"kernels": [...]}`` (per kernel: launches on the main path, exactness,
kernel / plain times by CUDA events, device-only times by torch.profiler,
bound time); then the card's name and power limit as
nvidia-smi reports them; the last line is the ``{"ok": true, ...}``
record. Any failure raises and exits nonzero. Without CUDA, or without
the rest of the repository beside it, it exits nonzero and prints no
result. Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and the f32
# lane-instruction rate outside the tensor cores. The sheet's 67 TFLOP/s
# f32 counts an FMA as two FLOPs (132 SMs x 128 f32 lanes x 2 x 1.98 GHz);
# a compare is one instruction per lane, so compares run at half that.
# The bound is the larger of bytes/rate and compares/rate.
HBM_BYTES_PER_S = 3.35e12
F32_LANE_OPS_PER_S = 67e12 / 2

# the repo's defaults and its scale gate (engine.py:177-179,
# benchmarks/query_time.py:489); 384 = the feature extractor's width
FULL_N, FULL_D = 1_048_576, 384
MID_N = 65_536
N_CLUSTERS = 1024
TIME_ITERS = 30
LIBRARY_NOTE = ("no single PyTorch call computes an interval-overlap or "
                "half-open box-membership count; library_ms is null")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def clustered(n: int, d: int, seed: int):
    """Clustered Gaussians in the manner of benchmarks/query_time.py
    run_scale: 1024 centres ~ N(0, 5^2), rows = centre + N(0, 0.3^2)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 5.0, (N_CLUSTERS, d)).astype(np.float32)
    assign = rng.integers(0, N_CLUSTERS, n)
    x = centers[assign]
    x += rng.standard_normal((n, d), dtype=np.float32) * np.float32(0.3)
    return x, assign


def make_requests(assign, n_req: int, k, seed: int):
    """n_req requests, alternating dbranch/dbens, 15 positives from one
    cluster and 80 negatives from the rest."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_req):
        c = i % 4
        in_c = np.nonzero(assign == c)[0]
        out_c = np.nonzero(assign != c)[0]
        reqs.append({"pos_ids": rng.choice(in_c, 15, replace=False),
                     "neg_ids": rng.choice(out_c, 80, replace=False),
                     "model": "dbranch" if i % 2 == 0 else "dbens",
                     "max_results": k})
    return reqs


STAT_KEYS = ("n_host_syncs", "retried_subsets", "blocks_touched",
             "blocks_gathered", "bytes_touched", "host_bytes_transferred",
             "score_buffer_bytes_peak", "score_rows")


def same_results(a, b, batched: bool = True) -> None:
    """ids, scores and the integer stats bitwise equal."""
    if len(a) != len(b):
        raise AssertionError("result counts differ")
    for i, (ra, rb) in enumerate(zip(a, b)):
        for r in (ra, rb):
            if isinstance(r, Exception):
                raise r
        if not (np.array_equal(ra.ids, rb.ids)
                and np.array_equal(ra.scores, rb.scores)):
            raise AssertionError(f"request {i}: ids/scores differ")
        keys = [("batch_" + k if batched else k) for k in STAT_KEYS]
        keys.append("n_boxes")
        for k in keys:
            if ra.stats[k] != rb.stats[k]:
                raise AssertionError(f"request {i}: stat {k} differs: "
                                     f"{ra.stats[k]} != {rb.stats[k]}")


def time_ms(fn, iters: int = TIME_ITERS, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def device_ms(fn, iters: int = TIME_ITERS, warmup: int = 3) -> float:
    """Device-only time of one call: the summed self time of the device
    events torch.profiler records over ``iters`` calls, over ``iters``.
    Unlike ``time_ms`` it leaves out the host's launch path."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(_self_device_us(e) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us * 1e-3 / iters


def _self_device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def compare(kernel_fn, plain_fn, name: str) -> dict:
    """Run a kernel and its plain version on the same inputs; exact
    equality is required (the outputs are bool or int32)."""
    import torch
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    exact = bool(torch.equal(got, want))
    err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max()
                ) if got.numel() else 0.0
    if not exact:
        raise AssertionError(f"{name}: kernel != plain version "
                             f"(max abs err {err})")
    return {"exact": exact, "max_abs_err": err}


def zone_prune_bound(nz: int, nb: int, d: int):
    byts = nz * d * 8 + nb * d * 8 + nz
    ops = nz * nb * d * 2
    return _bound(byts, ops)


def box_scan_bound(rows: int, c_rows: int, nb: int, d: int, nq: int):
    """rows: rows the data needs tested (min(n_hit, C) * block); c_rows:
    C * block output rows written."""
    byts = rows * d * 4 + c_rows * nq * 4 + nb * d * 8 + nb * nq * 4
    ops = rows * nb * d * 2
    return _bound(byts, ops)


def _bound(byts: int, ops: int):
    tb, to = byts / HBM_BYTES_PER_S, ops / F32_LANE_OPS_PER_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def measure_kernels(rows3, zlo, zhi, lo, hi, onehot, capacity: int) -> dict:
    """Hold both path kernels against their plain versions on one probe's
    inputs (zone_hits -> compaction -> gathered box scan) and time them."""
    import torch
    from repro_torch.kernels import box_scan, ops, ref, zone_prune
    nz, block, d = rows3.shape
    nb, nq = lo.shape[0], onehot.shape[1]
    hit = zone_prune.zone_hits(zlo, zhi, lo, hi)
    n_hit = hit.sum(dtype=torch.int32)
    cand = ops._compact(hit, capacity)
    res = {"zone_prune": compare(
        lambda: zone_prune.zone_hits(zlo, zhi, lo, hi),
        lambda: ref.zone_hits_ref(zlo, zhi, lo, hi), "zone_prune hits")}
    mask_chk = compare(lambda: zone_prune.zone_prune(zlo, zhi, lo, hi),
                       lambda: ref.zone_prune_ref(zlo, zhi, lo, hi),
                       "zone_prune mask")
    res["zone_prune"]["mask_exact"] = mask_chk["exact"]
    res["box_scan_seg"] = compare(
        lambda: box_scan.box_scan_seg_gather(rows3, cand, n_hit, lo, hi,
                                             onehot),
        lambda: ref.box_scan_seg_gather_ref(rows3, cand, n_hit, lo, hi,
                                            onehot), "box_scan_seg gather")
    x = rows3[cand.long()].reshape(-1, d)
    flat_chk = compare(lambda: box_scan.box_scan_seg(x, lo, hi, onehot),
                       lambda: ref.box_scan_seg_ref(x, lo, hi, onehot),
                       "box_scan_seg")
    res["box_scan_seg"]["flat_exact"] = flat_chk["exact"]
    nh = int(n_hit)
    shapes = {"nz": nz, "d": d, "boxes": nb, "queries": nq,
              "capacity": capacity, "block": block, "n_hit": nh}
    res["zone_prune"]["shape"] = {k: shapes[k] for k in ("nz", "d", "boxes")}
    res["box_scan_seg"]["shape"] = shapes
    fns = {"zone_prune": (
        lambda: zone_prune.zone_hits(zlo, zhi, lo, hi),
        lambda: ref.zone_hits_ref(zlo, zhi, lo, hi)),
        "box_scan_seg": (
        lambda: box_scan.box_scan_seg_gather(rows3, cand, n_hit, lo, hi,
                                             onehot),
        lambda: ref.box_scan_seg_gather_ref(rows3, cand, n_hit, lo, hi,
                                            onehot))}
    for name, (kern, plain) in fns.items():
        res[name]["ms"] = time_ms(kern)
        res[name]["plain_ms"] = time_ms(plain)
        res[name]["device_ms"] = device_ms(kern)
        res[name]["plain_device_ms"] = device_ms(plain)
    bz = zone_prune_bound(nz, nb, d)
    bb = box_scan_bound(min(nh, capacity) * block, capacity * block, nb, d,
                        nq)
    res["zone_prune"]["bound_ms"], res["zone_prune"]["bound_by"] = bz
    res["box_scan_seg"]["bound_ms"], res["box_scan_seg"]["bound_by"] = bb
    return res


def synthetic_probe(nb: int, capacity: int, seed: int, device):
    """A probe at the main path's shapes (NZ = 1024 zones of 1024 rows,
    d' = 6, Q = 8) with the path's edge cases: +inf padded rows in the
    last block, a NaN row, (+inf, -inf) padded boxes, boxes touching
    zone bounds exactly."""
    import torch
    rng = np.random.default_rng(seed)
    nz, block, d, nq = 1024, 1024, 6, 8
    x, _ = clustered(nz * block, d, seed)
    x = np.sort(x.reshape(nz, block, d), axis=1)     # tighter zones
    x[-1, -100:] = np.inf
    x[3, 5, 2] = np.nan
    zlo = np.where(np.isfinite(x), x, np.inf).min(1)
    zhi = np.where(np.isfinite(x), x, -np.inf).max(1)
    centers = x[rng.integers(0, nz - 1, nb), rng.integers(0, block, nb)]
    lo = (centers - rng.uniform(0.2, 2.0, (nb, d))).astype(np.float32)
    hi = (centers + rng.uniform(0.2, 2.0, (nb, d))).astype(np.float32)
    lo[0] = zhi[7]                                   # zone max == box lo
    hi[1] = zlo[9]                                   # zone min == box hi
    lo[-4:], hi[-4:] = np.inf, -np.inf               # impossible padding
    owner = rng.integers(0, nq, nb)
    onehot = (owner[:, None] == np.arange(nq)[None]).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(x.astype(np.float32)), t(zlo.astype(np.float32)),
            t(zhi.astype(np.float32)), t(lo), t(hi), t(onehot), capacity)


def phase_kernels(device) -> None:
    out = [measure_kernels(*synthetic_probe(nb, cap, seed, device))
           for nb, cap, seed in ((64, 64, 1), (512, 256, 2))]
    emit({"phase": "kernels_synthetic", "library_ms": None,
          "library_note": LIBRARY_NOTE, "runs": out})


def phase_gpu_vs_cpu(device, n: int = MID_N, d: int = FULL_D) -> None:
    from repro_torch.core import SearchEngine
    x, assign = clustered(n, d, seed=5)
    reqs = make_requests(assign, 8, 100, seed=6)
    t0 = time.perf_counter()
    for cf in (0.25, 1 / 64):                 # 1/64 forces overflow retry
        eg = SearchEngine(x, device=device, capacity_frac=cf)
        ec = SearchEngine(x, device="cpu", capacity_frac=cf)
        for mr in (100, None):
            rq = [{**r, "max_results": mr} for r in reqs]
            same_results(eg.query_batch(rq), ec.query_batch(rq))
        for r in reqs[:2]:
            kw = dict(model=r["model"], max_results=100)
            same_results([eg.query(r["pos_ids"], r["neg_ids"], **kw)],
                         [ec.query(r["pos_ids"], r["neg_ids"], **kw)],
                         batched=False)
    emit({"phase": "gpu_vs_cpu", "rows": n, "dims": d, "requests": 8,
          "bitwise_equal": True, "seconds": time.perf_counter() - t0})


def profile_batch(eng, reqs) -> dict:
    """One more warm query_batch under torch.profiler: device busy time
    (the sum of kernel self times on the card) against the host wall,
    and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.query_batch(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only: a CPU op's device total repeats the
        # time of the kernels it launched
        us = _self_device_us(e)
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    # each path kernel's device self time per launch in this batch
    per_launch = {}
    for name in KERNELS:
        mine = [(us, c) for us, k, c in rows if f"{name}_kernel" in k]
        if mine:
            per_launch[name] = {
                "device_ms_per_launch": sum(u for u, _ in mine) * 1e-3
                / sum(c for _, c in mine),
                "count": sum(c for _, c in mine)}
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall if wall else None,
            "path_kernels": per_launch,
            "top_device": [{"name": k[:60], "ms": us * 1e-3, "count": c}
                           for us, k, c in rows[:8]]}


def phase_full(device, n: int = FULL_N, d: int = FULL_D, k: int = 100):
    """The main path at full size. Returns the kernel launch counts of
    the timed query_batch and the inputs of its largest probe."""
    import torch
    from repro_torch.core import SearchEngine
    from repro_torch.core.index import sparse_probe
    from repro_torch.kernels import box_scan, zone_prune
    t0 = time.perf_counter()
    x, assign = clustered(n, d, seed=0)
    gen_s = time.perf_counter() - t0
    reqs = make_requests(assign, 8, k, seed=1)
    t0 = time.perf_counter()
    eng = SearchEngine(x, device=device)
    build_s = time.perf_counter() - t0
    if eng.subsets.shape != (32, 6) or eng.indexes[0].block != 1024:
        raise AssertionError("not the engine's default geometry")
    eng.query_batch(reqs)                     # warm: mirrors, hints
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zone_prune.launches = box_scan.launches = 0
    t0 = time.perf_counter()
    outs = eng.query_batch(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"zone_prune": zone_prune.launches,
                "box_scan_seg": box_scan.launches}
    peak = torch.cuda.max_memory_allocated()
    for o in outs:
        if isinstance(o, Exception):
            raise o
    if min(launches.values()) <= 0:
        raise AssertionError(f"a path kernel never launched: {launches}")
    st = outs[0].stats
    prof = profile_batch(eng, reqs)
    # device-ranked == the first k of the host-ranked results
    full = eng.query_batch([{**r, "max_results": None} for r in reqs])
    for i, (a, b) in enumerate(zip(outs, full)):
        if not (np.array_equal(a.ids, b.ids[:k])
                and np.array_equal(a.scores, b.scores[:k])):
            raise AssertionError(f"request {i}: device ranking != host")
        if len(a.ids) == 0 or not np.all(np.isfinite(a.scores)):
            raise AssertionError(f"request {i}: empty or non-finite result")
    # one round's probes with the boxes already uploaded, under the sync
    # debugger: nothing on the dispatch path may synchronise
    fits = [eng._fit_boxes(r["model"], x[r["pos_ids"]], x[r["neg_ids"]],
                           max_depth=12, n_models=25, seed=0,
                           frange=eng.frange) for r in reqs]
    jobs, _ = eng._make_jobs(
        [(bs, q) for q, f in enumerate(fits) for bs in f], len(reqs))
    inputs = [(eng.indexes[sid], *eng._probe_inputs(m, o, len(reqs)),
               eng._initial_capacity(eng.indexes[sid], m.n_boxes))
              for sid, m, o in jobs]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        probes = [sparse_probe(ix, lo, hi, oh, capacity=cap)
                  for ix, lo, hi, oh, cap in inputs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit({"phase": "full_size", "rows": n, "dims": d,
          "subsets": int(eng.subsets.shape[0]),
          "subset_dim": int(eng.subsets.shape[1]), "block": 1024,
          "data_gen_s": gen_s, "build_s": build_s,
          "device_mirror_bytes_resident":
              eng.index_stats()["device_bytes"]["total"],
          "device_mirror_bytes_all_subsets": int(sum(
              ix.rows.nbytes + ix.zlo.nbytes + ix.zhi.nbytes
              + ix.perm.size * 4 for ix in eng.indexes)),
          "batch": len(reqs), "query_batch_wall_s": wall,
          "per_query_wall_s": wall / len(reqs),
          "fit_s": st["batch_fit_s"], "score_rank_s": outs[0].query_time_s,
          "profile": prof,
          "n_host_syncs": st["batch_n_host_syncs"],
          "retried_subsets": st["batch_retried_subsets"],
          "host_bytes_transferred": st["batch_host_bytes_transferred"],
          "n_boxes": [o.stats["n_boxes"] for o in outs],
          "n_found": [o.n_found for o in outs],
          "max_memory_allocated": peak, "launches": launches,
          "device_ranked_equals_host": True,
          "sync_free_probes": len(probes)})
    big = max(inputs, key=lambda t: t[1].shape[0])
    ix, lo, hi, oh, cap = big
    rows3, zlo, zhi = ix.device_arrays()
    return launches, (rows3, zlo, zhi, lo, hi, oh, cap)


KERNELS = {
    "zone_prune": ("src/repro_torch/kernels/csrc/zone_prune.cu",
                   "src/repro/kernels/zone_prune.py:33"),
    "box_scan_seg": ("src/repro_torch/kernels/csrc/box_scan_seg.cu",
                     "src/repro/kernels/box_scan.py:74"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": card, "device_name": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    libs = build.build()
    for name in libs:
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()}})
    dev = torch.device("cuda", 0)
    phase_kernels(dev)
    phase_gpu_vs_cpu(dev)
    launches, probe = phase_full(dev)
    res = measure_kernels(*probe)
    emit({"phase": "kernels_main_path", "card": card, "runs": [res]})
    rows = []
    for name, (src, replaces) in KERNELS.items():
        r = res[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "exact": r["exact"],
                     "ms": r["ms"], "kernel_ms": r["ms"],
                     "plain_ms": r["plain_ms"], "device_ms": r["device_ms"],
                     "plain_device_ms": r["plain_device_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": None, "shape": r["shape"]})
    emit({"kernels": rows, "library_note": LIBRARY_NOTE})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
