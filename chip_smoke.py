#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA
card: build the hand-written kernels, hold each against its plain PyTorch
version, check the GPU engine against the port's own CPU engine (the
default engine, the numpy-fit one and the dense one), then drive the
engine's paths at full size: the main path (``SearchEngine.query_batch``
of the default engine: the batched device fit, survivor-sparse scoring
and device ranking; beside it the same batch with the numpy fit and with
``score_mode="dense"``), the device fit alone (GPU against the port's CPU
engine and the numpy trainers), the dtree/rforest full scan and the knn
search
(``SearchEngine.query``), the use_fused=False host oracle
(``query_batch`` through ``query_index``), the live catalog (a
``live=True`` engine over the same rows: three appends, bitwise the
static engine; 1 % tombstoned, bitwise a static engine over the
survivors; a background compaction under load; and the same schedule at
65,536 rows GPU against CPU), the durable live catalog (a ``live=True,
data_dir=...`` engine under build/: a wal_commit crash mid-ingest and its
recovery, a checkpoint, a background compaction's two-phase commit,
close() and recovery onto the card bitwise the engine before it, a
SIGKILLed child process's directory recovered to a consistent prefix,
and the three WAL sync modes timed), and the feature-extraction path: 16,384
synthetic patches through the full-width ViT-T (``extract_catalog``,
flash attention in every layer) into a ``SearchEngine`` and a query
batch, GPU against CPU, and 512 patches at the paper's 400x400 (626
tokens). DINO training of that ViT-T (``dino``, ROADMAP A12's
remainder): ``init_dino`` and ``make_dino_step`` at 64x64 with a batch
of 64 and at 400x400, one step's loss, gradients and new state against
the CPU's, the attention forward of teacher and student on the flash
kernel (48 launches a step) and the student's backward on the backward
kernel under an autograd Function (24 a step, no plain backward), timed
steps, a profiled one, the backward kernel held to its plain version and
timed beside it and SDPA's backward alone, and the trained student
embedding the catalog for a query batch. Then the quantized mirror
(``quantized``: full_size's catalog and batch on
``mirror="quantized"``, bitwise the f32 engine, resident
bytes of both, walls in turns) and the sharded catalogs (``sharded``:
``n_shards`` 1, 2, 4 and 8 flat on the card, bitwise S = 1, and an engine
on a device list naming the card four times: the mesh leg's code path,
not a multi-card figure); ``gpu_vs_cpu`` holds both, and a live catalog
with two shards, against the CPU engine. Last, the serving layer
(``serve``): full_size's engine behind
``QueryServer`` and ``HttpFrontEnd`` on 127.0.0.1, 64 requests from 8
clients bitwise the engine's direct ``query_batch`` with every kernel
call on the serving thread, repeats served from the cache with no device
work, a warm trace's span coverage and profile sites, closed-loop
throughput at 1, 8 and 32 clients, an open loop at 50-150 % of its peak,
the obs layer's overhead; GPU and CPU servers at 65,536 rows giving equal
bodies; and /ingest append, delete and checkpoint on a durable live
engine (build/serve_durable, removed at the end). The LM backbones'
serving path (``lm``, ROADMAP A13a): llama3-8b at full width and depth
(8.03 B bf16 parameters drawn on the card) prefills 4,096 tokens with one
flash kernel launch a layer (32), decodes 32 greedy tokens with none, and
runs ``lm_feature_fn`` on 4 x 4,096 tokens; the kernel is held to its
plain version at layer 0's inputs; its first layer prefills on the
card and on the CPU alike; and every other assigned architecture at full
width (cut to one repeat of its layer pattern where it is large) checks
prefill + 4 decode steps against a prefill of 4 more tokens. LM training
(``lm_train``, ROADMAP A13b): internlm2-1.8b at full width and depth
(1.89 B float32 parameters, bf16 compute) takes 2 + 5 steps of
``Trainer.run`` at 2 x 4,096 tokens (remat "full": 48 flash launches and
24 backward kernel launches a step, no plain backward), one profiled
step and one with remat "none"; one of its layers trains one step on the
card and on the CPU alike; both kernels are held to their plain versions
and timed at the step's own attention inputs, the backward twice bitwise
equal and its peak memory beside the plain version's; a reduced model's
checkpoint resumes bitwise. The LM
on a mesh (``lm_mesh``, ROADMAP A13c-1): one world of 4 processes on the
one card (gloo; NCCL refuses two ranks on one device) serves
internlm2-1.8b at full width and depth through make_prefill_step /
make_decode_step / lm_feature_fn on (1, 4) in head mode (the flash kernel
on each rank's 4 heads), on 3 ranks at (1, 3) in qseq mode, on (1, 4)
with seq_parallel (ctxpar) and on (2, 2) with batch 2, and qwen3-moe cut
to 2 layers with its experts split over 4 ranks, each against the
single-rank run on the card. LM training on that mesh (``lm_mesh_train``,
ROADMAP A13c-2): the same world trains through ``Trainer(mesh=...)``
internlm2-1.8b at full width (2 layers) in its own zero3 config on (2, 2)
and in fsdp_tp on (2, 2), and qwen3-moe (2 layers, 32 experts a rank) on
(1, 4), 1 timed step each after a check step whose loss, grad norm and
every gradient shard are held to the single rank's on the card (the
MoE's dispatch counts bitwise); the flash kernel and the backward kernel
run on every rank's heads and are held to their plain versions at rank
0's training inputs. The
dry-run tools (``dryrun``, ROADMAP A13d): ``launch/dryrun.py`` predicts
those three check steps on meta tensors in a fake world of 4 ranks (each
rank's collective calls and bytes by kind, forward and backward, and its
state bytes must equal the measured ones) and lm_train's step (its
dispatched FLOPs and its model FLOPs against the measured s/step: the
hardware- and model-FLOPs shares of the bf16 peak), and traces
internlm2-1.8b train_4k on the 16 x 16 fake world; the paper catalog's
local search steps (``launch/search_dryrun.py``) run for real with the
boxes the engine's trainers fit for the main path's batch:
``pruned_local_step`` over 90,429,772 rows x 6 dims in build_index's
order on one card (held bitwise to its plain version and to the
unpruned zone_hits + box_scan counts) and the full scan of a 16-card
shard (the main path's rows tiled to 5,652,480 x 384, 128 rforest
boxes; bitwise box_scan_ref), each timed beside its bound and the
reference's kernel model. The flash library's SASS must hold
wgmma (HGMMA) and TMA loads (UTMALDG) in every instantiation, the flash
backward's mma.sync (HMMA) in every function, and the box scans'
bulk-copy kernels cp.async.bulk (UBLKCP). The backward kernel is held to
its plain version at every flash shape, causal and not. box_scan_seg, the
probe's one-launch zone_candidates and l2dist are timed warm and with the
L2 flushed before each launch, as the fused batch finds their inputs;
zone_candidates beside the launch chain it replaced and an empty launch;
zone_prune's [NZ, B] mask at the use_fused=False batch's largest call,
two calls bitwise equal to the plain version's bytes. The per-index fused
query (``fused_oracle``): ``query_index_fused`` on every request's fitted
boxes of every subset bitwise ``query_index``, ``query_index_fused_multi``
over the batch bitwise each request alone, an overflowing capacity held
to the first-capacity rule, one zone_candidates and one box_scan_seg
launch a call. Each phase's wall seconds print on a line of their own.

    python3 chip_smoke.py
    python3 chip_smoke.py --only flash,extraction_400   # those phases
    python3 chip_smoke.py --only box_scan    # the box scans at full size
    python3 chip_smoke.py --only zone_prune  # zone_prune.cu's entries
    python3 chip_smoke.py --only fused_oracle  # query_index_fused(_multi)
    python3 chip_smoke.py --only l2dist      # l2dist's times, every way
    python3 chip_smoke.py --only fit         # the batched device fit
    python3 chip_smoke.py --only live        # the live catalog
    python3 chip_smoke.py --only durable     # the durable live catalog
    python3 chip_smoke.py --only main_wall   # the main path's warm wall
    python3 chip_smoke.py --only quantized   # the quantized mirror
    python3 chip_smoke.py --only sharded     # n_shards 1, 2, 4, 8
    python3 chip_smoke.py --only serve       # the serving layer
    python3 chip_smoke.py --only dino        # DINO training of the ViT-T
    python3 chip_smoke.py --only lm          # the LM backbones' serving
    python3 chip_smoke.py --only lm_train    # LM training (internlm2-1.8b)
    python3 chip_smoke.py --only lm_mesh     # the LM on a mesh (4 ranks)
    python3 chip_smoke.py --only lm_mesh_train  # LM training on the mesh
    python3 chip_smoke.py --only dryrun      # the dry-run tools
    python3 chip_smoke.py --only lm_train,lm_mesh_train,dryrun  # held

Phases print one JSON line each and one of their wall seconds; all the
walls come together on one line before the last three. The line before
the last two is
``{"kernels": [...]}`` (per kernel: launches on its path, exactness,
kernel / plain times by CUDA events, device-only times by torch.profiler,
bound time, the library call's time where one exists); then the card's
name and power limit as
nvidia-smi reports them; the last line is the ``{"ok": true, ...}``
record. Any failure raises and exits nonzero. Without CUDA, or without
the rest of the repository beside it, it exits nonzero and prints no
result. Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

START = time.perf_counter()
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
# attention's two products on the tensor cores, dense (NVIDIA data
# sheet): bf16, and TF32 for the f32 route (3xTF32)
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
LIBRARY_NOTE = ("no single PyTorch call computes an interval-overlap or "
                "half-open box-membership count, so library_ms is null for "
                "zone_prune, box_scan_seg and box_scan; for l2dist it is "
                "torch.cdist(x, q), which returns the root of the same "
                "function; for flash_attention it is "
                "torch.nn.functional.scaled_dot_product_attention "
                "(enable_gqa where G > 1)")
PLAIN_ITERS = 5          # the plain full scans take ~0.1 s a call

# the extraction path: ViT-T at the paper config over the synthetic
# catalog at 64x64 (configs/rapidearth_vit.py), batch 128 as in
# examples/train_extractor.py; the CPU re-extracts the first 512
EXTRACT_N = 16_384
EXTRACT_BATCH = 128
CPU_CHECK_N = 512
FEATURE_TOL = 1e-4
# the same extractor at the paper's own patch size (paper §3: 400x400,
# /16 plus CLS = 626 tokens); the CPU re-extracts the first 8
EXTRACT400_N = 512
EXTRACT400_SIZE = 400
CPU_CHECK400_N = 8
# flash attention, model layout (b, s, hq, hkv, d, causal, dtype): the
# shapes of tests/test_kernels.py, the ViT's own (batch 128 x 3 heads, 16
# patches + CLS), the paper's 400x400 patches at /16 plus CLS, a long
# causal GQA case whose upper key tiles are skipped, and llama3-8b's
# 4,096-token prefill (the lm phase's own shape: BH 8, G 4, D 128)
FLASH_CASES = (
    (2, 256, 8, 2, 32, True, "float32"),
    (1, 128, 4, 4, 64, True, "float32"),
    (1, 128, 4, 1, 32, True, "float32"),
    (2, 128, 4, 2, 32, False, "float32"),
    (1, 128, 4, 2, 32, True, "float32"),
    (1, 128, 4, 2, 32, True, "bfloat16"),
    (128, 17, 3, 3, 64, False, "float32"),
    (128, 626, 3, 3, 64, False, "float32"),
    (2, 2048, 16, 4, 128, True, "bfloat16"),
    (1, 4096, 32, 8, 128, True, "bfloat16"),
)
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# the forward's lse against the plain lse: f32 sums of f32 scores in
# both dtypes (about log S in size), so an absolute limit far below
# the outputs'
LSE_TOL = 1e-4
# ROADMAP C1's catalog: 4,096 x 12 normal rows (seed 0), row 7 +inf and
# row 9 -inf, four subsets of 6 dims, blocks of 256; knn with 16
# neighbours. The reference's ids and scores (tests/test_torch_models.py
# holds the JAX engine's to these): a +inf query against the +inf row is
# inf - inf, a negative NaN, which ranks first
C1_POS, C1_NEG = (7, 1, 2, 9), (3, 4, 5)
C1_KNN_IDS = (172, 801, 1125, 1281, 1448, 1880, 2154, 2809, 3003, 3448,
              3752, 3789, 3852, 4006, 112, 201, 305, 425, 459, 498, 718,
              726, 1206, 1480, 1664, 1733, 1754, 1963, 2126, 2221, 2264,
              2378, 2595, 2645, 2741, 2789, 3099, 3127, 3194, 3324, 3432,
              3613, 3702, 3794, 3859)
C1_KNN_SCORES = (2.0,) * 14 + (1.0,) * 31


def c1_catalog():
    x = np.random.default_rng(0).standard_normal((4096, 12)).astype(
        np.float32)
    x[7], x[9] = np.inf, -np.inf
    return x


# the search over the ViT features asks for each object class in turn
VIT_QUERY_CLASSES = (1, 2, 3, 4)    # solar_panel, forest, water, building


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cluster_draws(n: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 5.0, (N_CLUSTERS, d)).astype(np.float32)
    return rng, centers, rng.integers(0, N_CLUSTERS, n)


def cluster_assign(n: int, d: int, seed: int) -> np.ndarray:
    """clustered's cluster of each row, without the rows."""
    return _cluster_draws(n, d, seed)[2]


def clustered(n: int, d: int, seed: int):
    """Clustered Gaussians in the manner of benchmarks/query_time.py
    run_scale: 1024 centres ~ N(0, 5^2), rows = centre + N(0, 0.3^2)."""
    rng, centers, assign = _cluster_draws(n, d, seed)
    x = centers[assign]
    x += rng.standard_normal((n, d), dtype=np.float32) * np.float32(0.3)
    return x, assign


def make_requests(assign, n_req: int, k, seed: int, groups=(0, 1, 2, 3)):
    """n_req requests, alternating dbranch/dbens, 15 positives from one
    cluster (or class) of ``groups`` in turn and 80 negatives from the
    rest."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_req):
        c = groups[i % len(groups)]
        in_c = np.nonzero(assign == c)[0]
        out_c = np.nonzero(assign != c)[0]
        reqs.append({"pos_ids": rng.choice(in_c, 15, replace=False),
                     "neg_ids": rng.choice(out_c, 80, replace=False),
                     "model": "dbranch" if i % 2 == 0 else "dbens",
                     "max_results": k})
    return reqs


def deep_requests(reqs) -> list:
    """make_requests' batch with each request's negatives led by the
    positives of the request four on (the same cluster) that it does not
    hold itself, still 80 in all: an analyst marking look-alikes as
    negatives. The roots are no longer pure, so lanes outlive the fit's
    first round and the trees grow deep."""
    out = []
    for i, r in enumerate(reqs):
        other = reqs[(i + 4) % len(reqs)]["pos_ids"]
        near = other[~np.isin(other, r["pos_ids"])]
        out.append({**r, "neg_ids": np.concatenate(
            [near, r["neg_ids"][:80 - len(near)]])})
    return out


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


def same_all(a, b) -> None:
    """ids, scores and every stat but the wall-clock ones bitwise equal
    (the scan, knn and use_fused=False paths)."""
    for i, (ra, rb) in enumerate(zip(a, b)):
        for r in (ra, rb):
            if isinstance(r, Exception):
                raise r
        if not (ra.model == rb.model and np.array_equal(ra.ids, rb.ids)
                and np.array_equal(ra.scores, rb.scores)):
            raise AssertionError(f"{ra.model} {i}: ids/scores differ")
        sa = {k: v for k, v in ra.stats.items() if not k.endswith("_s")}
        sb = {k: v for k, v in rb.stats.items() if not k.endswith("_s")}
        if sa != sb:
            raise AssertionError(f"{ra.model} {i}: stats differ: {sa} != "
                                 f"{sb}")


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


def device_ms(fn, iters: int = TIME_ITERS, warmup: int = 3):
    """(ms, source): the device-only time of one call, the summed self
    time of the device events torch.profiler records over ``iters`` calls,
    over ``iters`` (source "profiler"). Unlike ``time_ms`` it leaves out
    the host's launch path. The profiler has been seen on the H100 to stop
    recording device events after some twenty profiling contexts in one
    process, and to record only some of them before that; unless it
    records every call's events, the time is taken by CUDA events around
    one replay of a CUDA graph of ``iters`` calls instead (source
    "graph"), which leaves out the host's launch path too."""
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
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(_self_device_us(e) for e in evs)
    if us > 0 and _all_recorded(evs, iters):
        return us * 1e-3 / iters, "profiler"
    return graph_ms(fn, iters=iters), "graph"


def _all_recorded(events, iters: int) -> bool:
    """Whether torch.profiler recorded every call's device events: each
    kind of event ``iters`` times or a multiple of it. Late in a process
    it has been seen to record only some of them (l2dist on an H100:
    0.0509 and 0.1006 ms where CUDA events and graphs read 0.12)."""
    return all(e.count >= iters and e.count % iters == 0 for e in events)


def graph_ms(fn, iters: int = TIME_ITERS, stream=None) -> float:
    """CUDA events around one replay of a CUDA graph that holds ``iters``
    calls of ``fn``, over ``iters``: device time with the launches
    back to back and no host launch path between them. Captured on
    ``stream`` where given (a backward whose forward ran there), else on
    a new one."""
    import torch
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured after the warm call, so what a wrapper allocates at first
    # use (zone_candidates' scratch) is in place before the capture
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dev_ms(fn, profile: bool, iters: int = TIME_ITERS, warmup: int = 3):
    """device_ms where ``profile``, else a CUDA graph's (graph_ms): each
    torch.profiler context counts against the twenty or so a process
    records, so the synthetic shapes take graphs and the main path's
    inputs the profiler."""
    if profile:
        return device_ms(fn, iters=iters, warmup=warmup)
    return graph_ms(fn, iters=iters), "graph"


def _self_device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def compare(kernel_fn, plain_fn, name: str) -> dict:
    """Run a kernel and its plain version on the same inputs; exact
    equality is required (bool and int32 outputs, and l2dist's f32, which
    both versions sum in the same order with the same roundings)."""
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
    """The [NZ, B] mask's: zones and boxes read once, the NZ x B mask
    bytes written, 2 compares a dim a (zone, box) pair."""
    byts = nz * d * 8 + nb * d * 8 + nz * nb
    ops = nz * nb * d * 2
    return _bound(byts, ops)


def zone_candidates_bound(nz: int, nb: int, d: int, capacity: int):
    """zone_prune_bound's reads and compares, with cand [capacity] and
    n_hit written in place of the mask."""
    byts = nz * d * 8 + nb * d * 8 + 4 * (capacity + 1)
    return _bound(byts, nz * nb * d * 2)


def box_scan_bound(rows: int, c_rows: int, nb: int, d: int, nq: int,
                   compares: int):
    """rows: rows the data needs tested (min(n_hit, C) * block); c_rows:
    C * block output rows written; ``compares`` as this run's data needs
    them (scan_compares over the tested rows)."""
    byts = rows * d * 4 + c_rows * nq * 4 + nb * d * 8 + nb * nq * 4
    return _bound(byts, compares)


def scan_bound(n: int, d: int, nb: int, compares: int):
    """box_scan: x read once, boxes read once, counts written once;
    ``compares`` as this run's data needs them."""
    return _bound(n * d * 4 + nb * d * 8 + n * 4, compares)


def scan_compares(x, lo, hi) -> tuple:
    """(compares the data needs, the earlier count) for box_scan. The
    earlier count (``compares_upper``): per (row, box), two a dim up to
    and including the first failing dim in ascending order (all D when
    the row is inside), what the dense kernel tests and what D <= 8 still
    needs. For D > 8 the kernel needs less: per (row, box), two a
    constrained dim ((lo, hi) != (-inf, +inf)) up to and including the
    first failing one, and the row check (x > -inf on every dim: D
    compares) only for a row inside some box by those lists. Counted on
    the card in row chunks."""
    import torch
    n, d = x.shape
    nb = lo.shape[0]
    inf = float("inf")
    cons = ~((lo == -inf) & (hi == inf))                      # [B, D]
    upto = cons.to(torch.int64).cumsum(1)    # constrained dims up to k
    boxes = torch.arange(nb, device=x.device)[None]
    step = max(1, (1 << 25) // max(nb * d, 1))
    dense = lists = 0
    for r0 in range(0, n, step):
        xr = x[r0:r0 + step]
        fail = ~((xr[:, None] > lo[None]) & (xr[:, None] <= hi[None]))
        last = torch.full_like(fail[..., 0], d - 1, dtype=torch.int64)
        first = torch.where(fail.any(-1), fail.to(torch.int8).argmax(-1),
                            last)                             # [c, B]
        dense += int((first + 1).sum()) * 2
        fail &= cons[None]
        inside = ~fail.any(-1)
        first = torch.where(inside, last, fail.to(torch.int8).argmax(-1))
        lists += int(upto[boxes, first].sum()) * 2
        lists += d * int(inside.any(1).sum())
    return (lists if d > 8 else dense), dense


def l2dist_bound(n: int, d: int, nq: int):
    """l2dist: x and q read once, [N, Q] written once; 3 f32 ops (sub,
    mul, add) per (row, query, dim), none an FMA."""
    return _bound(n * d * 4 + nq * d * 4 + n * nq * 4, n * nq * d * 3)


def flash_bound(bh: int, s: int, g: int, d: int, causal: bool,
                dtype: str):
    """q, k, v read once and out written once, against 4 BH G S^2 D FLOPs
    (two products, an FMA counted as two), halved when causal, on the
    tensor cores by the kernel's own route: bf16 at the bf16 peak; f32 as
    3xTF32 (each product three TF32 products: hi.hi + hi.lo + lo.hi), so
    3x the FLOPs at the TF32 peak."""
    item = 2 if dtype == "bfloat16" else 4
    byts = (2 * bh * s * g * d + 2 * bh * s * d) * item
    flops = 4 * bh * g * s * s * d / (2 if causal else 1)
    tb = byts / HBM_BYTES_PER_S
    to = (flops / BF16_FLOPS_PER_S if dtype == "bfloat16"
          else 3 * flops / TF32_FLOPS_PER_S)
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def _bound(byts: int, ops: int):
    tb, to = byts / HBM_BYTES_PER_S, ops / F32_LANE_OPS_PER_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


# written between cold launches: more than the H100's 50 MB L2
L2_FLUSH_BYTES = 128 << 20


def cold_device_ms(fn, kernel: str, iters: int = TIME_ITERS,
                   use_profiler: bool = True):
    """(ms, source): the device time of one call of ``fn`` with the L2
    flushed before it by a 128 MB write, as the path finds its inputs
    (the fused batch's probes each read another subset's index mirror).
    torch.profiler's self time of the device events whose name holds
    ``kernel`` (the flush left out), over ``iters``; where the profiler
    misses any, the difference of two CUDA graphs, ``iters`` x (flush,
    call) less ``iters`` x flush (source "graph_diff"), which is also
    taken without ``use_profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")

    def cold():
        flush.fill_(1.0)
        fn()
    for _ in range(3):
        cold()
    torch.cuda.synchronize()
    us = 0
    if use_profiler:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                cold()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and kernel in e.key]
        if _all_recorded(evs, iters):
            us = sum(_self_device_us(e) for e in evs)
    if us > 0:
        return us * 1e-3 / iters, "profiler"
    return (graph_ms(cold, iters=iters)
            - graph_ms(lambda: flush.fill_(1.0), iters=iters)), "graph_diff"


def earlier_chain(zlo, zhi, lo, hi, capacity: int):
    """The probe's front end as it was before zone_candidates, from the
    package's own functions: the [NZ] hit vector (zone_prune.zone_hits),
    its sum and the prefix-sum compaction (ops._compact) — eleven to
    fourteen launches where zone_candidates makes one."""
    import torch
    from repro_torch.kernels import ops, zone_prune
    hit = zone_prune.zone_hits(zlo, zhi, lo, hi)
    return ops._compact(hit, int(capacity)), hit.sum(dtype=torch.int32)


def device_kernels(fn) -> dict:
    """Device work of one warm call of ``fn`` by torch.profiler: kernels,
    and memory copies / sets, counted apart."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = mem = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if e.key.startswith(("Memcpy", "Memset")):
                mem += e.count
            else:
                kernels += e.count
    if kernels == 0:              # the profiler records nothing any more
        return {"kernels": None, "memcpy_memset": None}
    return {"kernels": kernels, "memcpy_memset": mem}


def empty_launch_ms(profile: bool = True) -> dict:
    """The practical floor of a launch, measured: an empty kernel
    (torch.cuda._sleep(0)), its device time by torch.profiler (where
    ``profile``) and by a CUDA graph of 30 back-to-back launches."""
    import torch
    fn = lambda: torch.cuda._sleep(0)
    out = {"what": "torch.cuda._sleep(0), measured",
           "graph_ms": graph_ms(fn), "profiler_ms": None}
    if profile:
        ms, by = device_ms(fn)
        out["profiler_ms"] = ms if by == "profiler" else None
    return out


def measure_candidates(zlo, zhi, lo, hi, capacity: int,
                       profile: bool = True) -> dict:
    """zone_candidates against zone_candidates_ref (cand and n_hit
    bitwise) and the earlier launch chain on the same inputs; event,
    device (warm, and cold: the L2 flushed before each launch) and
    CUDA-graph times of each, the bound and the floor of one launch."""
    import torch
    from repro_torch.kernels import ref, zone_prune
    nz, d = zlo.shape
    nb = lo.shape[0]
    kern = lambda: zone_prune.zone_candidates(zlo, zhi, lo, hi, capacity)
    plain = lambda: ref.zone_candidates_ref(zlo, zhi, lo, hi, capacity)
    chain = lambda: earlier_chain(zlo, zhi, lo, hi, capacity)
    (gc, gn), (wc, wn), (ec, en) = kern(), plain(), chain()
    torch.cuda.synchronize()
    cand_exact, n_exact = bool(torch.equal(gc, wc)), bool(torch.equal(gn, wn))
    if not (cand_exact and n_exact):
        raise AssertionError(f"zone_candidates NZ={nz}: kernel != plain "
                             f"version (cand {cand_exact}, n_hit {n_exact})")
    if not (torch.equal(ec, wc) and torch.equal(en, wn)):
        raise AssertionError("the earlier chain != zone_candidates_ref")
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=zlo.device)
    fill = lambda: flush.fill_(1.0)
    flush_ms = time_ms(fill)
    res = {"exact": True, "cand_exact": cand_exact, "n_hit_exact": n_exact,
           "max_abs_err": 0.0,
           "shape": {"nz": nz, "d": d, "boxes": nb, "capacity": capacity,
                     "n_hit": int(wn)},
           "ctas": "one" if nz <= ONE_CTA_ZONES else "several",
           "ms": time_ms(kern), "plain_ms": time_ms(plain),
           "ms_cold": time_ms(lambda: (fill(), kern())) - flush_ms,
           "device_ms_graph": graph_ms(kern)}
    res["device_ms"], res["device_ms_by"] = dev_ms(kern, profile)
    res["device_ms_cold"], res["device_ms_cold_by"] = cold_device_ms(
        kern, "zone_candidates_kernel", use_profiler=profile)
    res["plain_device_ms"] = res["plain_device_ms_by"] = None
    if profile:
        res["plain_device_ms"], res["plain_device_ms_by"] = device_ms(plain)
    res["bound_ms"], res["bound_by"] = zone_candidates_bound(nz, nb, d,
                                                             capacity)
    res["library_ms"] = None
    cold_chain = lambda: (fill(), chain())
    res["earlier"] = {
        "what": "zone_prune.zone_hits + sum + ops._compact",
        "ms": time_ms(chain),
        "ms_cold": time_ms(cold_chain) - flush_ms,
        "device_ms_graph": graph_ms(chain),
        "device_ms_cold_graph": graph_ms(cold_chain) - graph_ms(fill)}
    res["device_ms_cold_graph"] = (graph_ms(lambda: (fill(), kern()))
                                   - graph_ms(fill))
    if profile:
        res["device_work"] = device_kernels(kern)
        res["earlier"]["device_work"] = device_kernels(chain)
    return res


def measure_kernels(rows3, zlo, zhi, lo, hi, onehot, capacity: int,
                    profile: bool = True, mask_in=None) -> dict:
    """Hold the probe's kernels against their plain versions on one
    probe's inputs (zone_candidates -> gathered box scan; the [NZ] and
    [NZ, B] zone_prune entries beside them) and time them: device ms warm
    (the same inputs back to back) and cold (the L2 flushed before each
    launch, as on the path). The mask is timed at ``mask_in`` (zlo, zhi,
    lo, hi: the use_fused=False batch's largest call) where given."""
    from repro_torch.kernels import box_scan, ref, zone_prune
    nz, block, d = rows3.shape
    nb, nq = lo.shape[0], onehot.shape[1]
    res = {"zone_candidates": measure_candidates(zlo, zhi, lo, hi, capacity,
                                                 profile=profile)}
    cand, n_hit = zone_prune.zone_candidates(zlo, zhi, lo, hi, capacity)
    hits_chk = compare(lambda: zone_prune.zone_hits(zlo, zhi, lo, hi),
                       lambda: ref.zone_hits_ref(zlo, zhi, lo, hi),
                       "zone_prune hits")
    probe_mask = compare(lambda: zone_prune.zone_prune(zlo, zhi, lo, hi),
                         lambda: ref.zone_prune_ref(zlo, zhi, lo, hi),
                         "zone_prune mask at the probe")
    res["zone_prune"] = measure_mask(*(mask_in or (zlo, zhi, lo, hi)),
                                     profile=profile)
    res["zone_prune"]["hits_exact"] = hits_chk["exact"]
    res["zone_prune"]["probe_mask_exact"] = probe_mask["exact"]
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
    res["box_scan_seg"]["shape"] = shapes
    fns = {"box_scan_seg": (
        lambda: box_scan.box_scan_seg_gather(rows3, cand, n_hit, lo, hi,
                                             onehot),
        lambda: ref.box_scan_seg_gather_ref(rows3, cand, n_hit, lo, hi,
                                            onehot))}
    for name, (kern, plain) in fns.items():
        res[name]["ms"] = time_ms(kern)
        res[name]["plain_ms"] = time_ms(plain)
        res[name]["device_ms"], res[name]["device_ms_by"] = dev_ms(
            kern, profile)
        (res[name]["device_ms_cold"],
         res[name]["device_ms_cold_by"]) = cold_device_ms(
             kern, f"{name}_kernel", use_profiler=profile)
        res[name]["plain_device_ms"] = res[name]["plain_device_ms_by"] = None
        if profile:
            (res[name]["plain_device_ms"],
             res[name]["plain_device_ms_by"]) = device_ms(plain)
    tested = rows3[cand[:min(nh, capacity)].long()].reshape(-1, d)
    bb = box_scan_bound(tested.shape[0], capacity * block, nb, d, nq,
                        scan_compares(tested, lo, hi)[0])
    res["box_scan_seg"]["bound_ms"], res["box_scan_seg"]["bound_by"] = bb
    return res


def host_us(fn, calls: int = 100, repeats: int = 5) -> float:
    """Host microseconds a call of ``fn`` takes to return: its launch path
    alone (checks, allocation, the launch), ``calls`` calls back to back
    with no sync between them, the median of ``repeats``."""
    import torch
    fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return float(np.median(out))


def measure_mask(zlo, zhi, lo, hi, profile: bool = True) -> dict:
    """zone_prune's [NZ, B] mask entry held to zone_prune_ref (the bytes
    equal, and two calls equal) and timed: event ms, device ms warm
    (torch.profiler where ``profile``, else a CUDA graph; the graph's
    always) and cold (the L2 flushed before each launch), the plain
    version's, the host microseconds a call (host_us), the bound (the
    mask's NZ x B bytes written) and the floor of one launch."""
    import torch
    from repro_torch.kernels import ref, zone_prune
    nz, d = zlo.shape
    nb = lo.shape[0]
    kern = lambda: zone_prune.zone_prune(zlo, zhi, lo, hi)
    plain = lambda: ref.zone_prune_ref(zlo, zhi, lo, hi)
    first, second, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    as_bytes = lambda t: t.view(torch.uint8)
    if not torch.equal(as_bytes(first), as_bytes(want)):
        raise AssertionError(f"zone_prune mask NZ={nz} B={nb} d={d}: "
                             f"kernel != plain version")
    if not torch.equal(as_bytes(second), as_bytes(first)):
        raise AssertionError(f"zone_prune mask NZ={nz} B={nb}: two calls "
                             f"differ")
    res = {"exact": True, "twice_equal": True, "max_abs_err": 0.0,
           "shape": {"nz": nz, "d": d, "boxes": nb,
                     "overlaps": int(want.sum())},
           "ms": time_ms(kern), "plain_ms": time_ms(plain),
           "host_us": host_us(kern), "device_ms_graph": graph_ms(kern)}
    res["device_ms"], res["device_ms_by"] = dev_ms(kern, profile)
    res["device_ms_cold"], res["device_ms_cold_by"] = cold_device_ms(
        kern, "zone_prune_kernel", use_profiler=profile)
    res["plain_device_ms"] = res["plain_device_ms_by"] = None
    if profile:
        res["plain_device_ms"], res["plain_device_ms_by"] = device_ms(plain)
    res["bound_ms"], res["bound_by"] = zone_prune_bound(nz, nb, d)
    res["floor"] = empty_launch_ms(profile=False)
    return res


def measure_one(name: str, kern, plain, bound, library=None,
                plain_iters: int = TIME_ITERS,
                plain_device: bool = True, profile: bool = True) -> dict:
    """Exactness against the plain version, then event / device times of
    the kernel, the plain version (device time only with
    ``plain_device``) and the library call (dev_ms: torch.profiler where
    ``profile``, else CUDA graphs)."""
    res = compare(kern, plain, name)
    res["ms"] = time_ms(kern)
    res["device_ms"], res["device_ms_by"] = dev_ms(kern, profile)
    res["plain_ms"] = time_ms(plain, iters=plain_iters, warmup=1)
    res["plain_device_ms"] = res["plain_device_ms_by"] = None
    if plain_device:
        res["plain_device_ms"], res["plain_device_ms_by"] = dev_ms(
            plain, profile, iters=plain_iters, warmup=1)
    res["library_ms"] = res["library_device_ms"] = None
    res["library_device_ms_by"] = None
    if library is not None:
        res["library_ms"] = time_ms(library)
        res["library_device_ms"], res["library_device_ms_by"] = dev_ms(
            library, profile)
    res["bound_ms"], res["bound_by"] = bound
    return res


def measure_scan(x, lo, hi, plain_device: bool = True,
                 profile: bool = True) -> dict:
    """box_scan on (x, lo, hi) against box_scan_ref."""
    from repro_torch.kernels import box_scan, ref
    need, upper = scan_compares(x, lo, hi)
    n, d = x.shape
    nb = lo.shape[0]
    res = measure_one("box_scan", lambda: box_scan.box_scan(x, lo, hi),
                      lambda: ref.box_scan_ref(x, lo, hi),
                      scan_bound(n, d, nb, need), plain_iters=PLAIN_ITERS,
                      plain_device=plain_device, profile=profile)
    res["bound_ms_upper"], res["bound_by_upper"] = scan_bound(n, d, nb, upper)
    res["compares_needed"], res["compares_upper"] = need, upper
    res["shape"] = {"n": n, "d": d, "boxes": nb}
    return res


def measure_l2dist(x, q, plain_device: bool = True,
                   profile: bool = True) -> dict:
    """l2dist on (x, q) against l2dist_ref; torch.cdist as the library."""
    import torch
    from repro_torch.kernels import l2dist, ref
    n, d = x.shape
    kern = lambda: l2dist.l2dist(x, q)
    res = measure_one("l2dist", kern, lambda: ref.l2dist_ref(x, q),
                      l2dist_bound(n, d, q.shape[0]),
                      library=lambda: torch.cdist(x, q),
                      plain_device=plain_device, profile=profile)
    res["device_ms_cold"], res["device_ms_cold_by"] = cold_device_ms(
        kern, "l2dist", use_profiler=profile)
    res["device_ms_graph"] = graph_ms(kern)
    res["shape"] = {"n": n, "d": d, "queries": q.shape[0]}
    return res


def synthetic_scan(n: int, d: int, nb: int, seed: int, device):
    """Rows ~ N(0, 1) made on the card, with a NaN, a -inf and a +inf row;
    boxes around random rows. Full width (D = 384): 12 constrained dims a
    box, the rest (-inf, +inf) as a tree leaf leaves them. Narrow (d' = 6):
    every dim constrained, the last 4 boxes (+inf, -inf) padding."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, d, device=device, generator=g)
    x[1, d - 1], x[2, 0], x[3, 0] = float("nan"), -float("inf"), float("inf")
    rows = torch.randint(0, n, (nb,), device=device, generator=g)
    c = x[rows]
    w_lo = torch.rand(nb, d, device=device, generator=g) * 1.8 + 0.2
    w_hi = torch.rand(nb, d, device=device, generator=g) * 1.8 + 0.2
    lo, hi = c - w_lo, c + w_hi
    if d > 8:
        keep = torch.rand(nb, d, device=device, generator=g).argsort(1) < 12
        lo = torch.where(keep, lo, -float("inf"))
        hi = torch.where(keep, hi, float("inf"))
    else:
        lo[-4:], hi[-4:] = float("inf"), -float("inf")
    return x, lo.contiguous(), hi.contiguous()


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


def measure_flash(q, k, v, causal: bool, profile: bool = False) -> dict:
    """flash_attention on kernel-layout inputs (q [BH, S, G, D], k/v
    [BH, S, D]) against flash_attention_ref, within 2e-4 (f32) or 2e-2
    (bf16), and its lse within LSE_TOL of the plain lse; event and device times of the kernel, the plain version and
    SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    bh, s, g, d = q.shape
    dt = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    tol = FLASH_TOL[dt]
    kern = lambda: fa.flash_attention(q, k, v, causal=causal)
    plain = lambda: ref.flash_attention_ref(q, k, v, causal=causal)
    # SDPA in its [B, H, S, D] layout: the G query heads of a kv head
    ql = q.permute(0, 2, 1, 3).contiguous()
    kl, vl = k[:, None], v[:, None]
    lib = lambda: F.scaled_dot_product_attention(
        ql, kl, vl, is_causal=causal, enable_gqa=g > 1)
    got, want = kern().float(), plain().float()
    lib_out = lib().permute(0, 2, 1, 3).float()
    # the forward that also writes lse (the backward's residual)
    lse = fwd_residuals(q, k, v, causal)[1]
    lse_want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       return_lse=True)[1]
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    lse_err = float((lse - lse_want).abs().max())
    if not torch.allclose(got, want, rtol=tol, atol=tol) \
            or not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_attention {tuple(q.shape)} {dt} "
                             f"causal={causal}: kernel != plain version "
                             f"(max abs err {err}, tol {tol}; lse {lse_err}, "
                             f"tol {LSE_TOL})")
    del lse, lse_want
    res = {"shape": {"bh": bh, "s": s, "g": g, "d": d}, "dtype": dt,
           "causal": causal, "max_abs_err": err, "lse_max_abs_err": lse_err,
           "tol": tol, "lse_tol": LSE_TOL,
           "library_max_abs_err": float((lib_out - want).abs().max()),
           "ms": time_ms(kern),
           "plain_ms": time_ms(plain, iters=10, warmup=1),
           "library_ms": time_ms(lib)}
    # device times of the kernel, the plain version and SDPA, by one
    # helper for all three (at the ViT shape event times are the launch
    # path): torch.profiler where asked (it records device events for
    # only some twenty contexts a process), else a CUDA graph of
    # back-to-back calls
    def dev(f, iters=TIME_ITERS):
        return (device_ms(f, iters=iters) if profile
                else (graph_ms(f, iters=iters), "graph"))
    res["device_ms"], res["device_ms_by"] = dev(kern)
    res["library_device_ms"], res["library_device_ms_by"] = dev(lib)
    res["plain_device_ms"], res["plain_device_ms_by"] = dev(plain, iters=10)
    res["bound_ms"], res["bound_by"] = flash_bound(bh, s, g, d, causal, dt)
    return res


def flash_case(b, s, hq, hkv, d, causal, dtype, seed, device):
    """Seeded N(0, 1) q, k, v in model layout, repacked to the kernel
    layout by ops.kernel_layout."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, device=device, generator=gen)
               .to(getattr(torch, dtype)) for h in (hq, hkv, hkv))
    return ops.kernel_layout(q, k, v)


def synthetic_zones(nz: int, nb: int, seed: int, device):
    """Zone maps made directly, as the main path's Morton-ordered blocks
    give them (d' = 6: bounds that drift along the zones, a NaN zone, a
    +inf padded last zone), and boxes around some of the zones."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    d = 6
    centres = torch.sort(torch.randn(nz, device=device, generator=g) * 3)[0]
    zlo = centres[:, None] + torch.randn(nz, d, device=device, generator=g)
    zhi = zlo + torch.randn(nz, d, device=device, generator=g).abs() * 0.5
    zlo[nz // 3, 2] = float("nan")
    zlo[-1], zhi[-1] = float("inf"), float("inf")
    pick = torch.randint(0, nz, (nb,), device=device, generator=g)
    lo = zlo[pick] - 0.2
    hi = lo + torch.rand(nb, d, device=device, generator=g) * 1.5 + 0.5
    return zlo.contiguous(), zhi.contiguous(), lo.contiguous(), hi.contiguous()


# zone_candidates takes one CTA up to 1,024 zones (256 threads x 4 zones,
# csrc/zone_prune.cu), several joined by a look-back scan beyond
ONE_CTA_ZONES = 1024


def zone_rows(device) -> dict:
    """zone_candidates on zone maps made directly, held to the plain
    version and timed beside the earlier chain: at the most one CTA takes
    and a zone either side of it, at 8,192 and at 131,072 zones."""
    rows = [measure_candidates(*synthetic_zones(nz, 16, 20 + i, device),
                               capacity=nz // 4, profile=False)
            for i, nz in enumerate((ONE_CTA_ZONES - 1, ONE_CTA_ZONES,
                                    ONE_CTA_ZONES + 1, 8192, 131072))]
    return {"one_cta_zones": ONE_CTA_ZONES, "runs": rows}

def l2dist_nan_check(device) -> dict:
    """The CUDA l2dist's NaN bits against l2dist_ref on CPU copies of the
    inputs (torch's CUDA ops give 0x7FFFFFFF for every NaN): the NaN
    rule's edge cases (inf - inf, -inf - -inf, NaN in x, in q, in both
    with opposite signs, a NaN after an earlier inf - inf), every row
    against every query, on the tiled route (D = 3) and the D-chunked
    one (D = 130)."""
    import torch
    from repro_torch.kernels import l2dist, ref
    inf = float("inf")
    bits = lambda w: np.array([w], np.uint32).view(np.float32)[0]
    cases = [([inf, 0, 0], [inf, 0, 0]), ([-inf, 1, 0], [-inf, 1, 0]),
             ([0, bits(0x7FC00123), 0], [0, 0, 0]),
             ([1, 2, 3], [1, bits(0xFFC00042), 3]),
             ([bits(0xFFC00001), 0, 0], [bits(0x7FC00123), 0, 0]),
             ([inf, 0, bits(0x7FC00123)], [inf, 0, 0])]
    out = {}
    for d in (3, 130):
        xs = np.zeros((len(cases) + 1, d), np.float32)
        qs = np.zeros((len(cases), d), np.float32)
        for i, (xr, qr) in enumerate(cases):
            xs[i, :3], qs[i, :3] = xr, qr
        xs[-1] = np.arange(d)
        x, q = torch.from_numpy(xs), torch.from_numpy(qs)
        got = l2dist.l2dist(x.to(device), q.to(device)).cpu()
        want = ref.l2dist_ref(x, q)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"l2dist D={d}: NaN bits != the CPU "
                                 f"plain version's")
        out[f"d{d}"] = [hex(int(v) & 0xFFFFFFFF) for v in
                        got.view(torch.int32).diagonal().tolist()]
    return {"bitwise_equal_cpu": True, "diagonal_bits": out}


def phase_kernels(device) -> None:
    import torch
    # device times by CUDA graphs here and plain device times only at the
    # main path's inputs: each torch.profiler context counts against the
    # twenty or so that record device events
    out = [measure_kernels(*synthetic_probe(nb, cap, seed, device),
                           profile=False)
           for nb, cap, seed in ((64, 64, 1), (512, 256, 2))]
    scans = [measure_scan(*synthetic_scan(n, d, nb, seed, device),
                          plain_device=False, profile=False)
             for n, d, nb, seed in ((FULL_N, FULL_D, 16, 3),
                                    (FULL_N, FULL_D, 64, 4),
                                    (256 * 1024, 6, 64, 5))]
    dists = []
    for n, d, nq, seed in ((FULL_N, 6, 15, 6), (MID_N, FULL_D, 8, 7),
                           (FULL_N, 6, 16, 8), (FULL_N, 6, 33, 9)):
        g = torch.Generator(device=device).manual_seed(seed)
        dists.append(measure_l2dist(
            torch.randn(n, d, device=device, generator=g),
            torch.randn(nq, d, device=device, generator=g),
            plain_device=False, profile=False))
    emit({"phase": "kernels_synthetic", "library_note": LIBRARY_NOTE,
          "runs": out, "zone_candidates": zone_rows(device),
          "empty_launch": empty_launch_ms(profile=False),
          "box_scan": scans, "l2dist": dists,
          "l2dist_nan": l2dist_nan_check(device),
          "flash_attention": flash_rows(device),
          "flash_attention_bwd": flash_bwd_rows(device)})


def flash_rows(device) -> list:
    """flash_attention at every FLASH_CASES shape (measure_flash)."""
    return [measure_flash(*flash_case(*case, seed=10 + i, device=device),
                          causal=case[5])
            for i, case in enumerate(FLASH_CASES)]


def sass_check(lib: Path) -> dict:
    """Per kernel function of a built library (cuobjdump -sass): its
    HGMMA (wgmma on the tensor cores, by operand type), HMMA (mma.sync on
    the tensor cores), UTMALDG (TMA load), UBLKCP (cp.async.bulk) and
    SETMAXREG (setmaxnreg) instructions."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), {"HGMMA": 0, "HGMMA_BF16": 0,
                                                 "HGMMA_TF32": 0, "HMMA": 0,
                                                 "UTMALDG": 0, "UBLKCP": 0,
                                                 "SETMAXREG": 0})
        elif cur is not None:
            if "HGMMA." in line:
                cur["HGMMA"] += 1
                cur["HGMMA_BF16"] += ".BF16" in line
                cur["HGMMA_TF32"] += ".TF32" in line
            cur["HMMA"] += "HMMA." in line
            cur["UTMALDG"] += "UTMALDG" in line
            cur["UBLKCP"] += "UBLKCP" in line
            cur["SETMAXREG"] += "SETMAXREG" in line
    if not counts:
        raise AssertionError(f"cuobjdump found no kernel in {lib}")
    return demangled(counts)


def ptxas_stats(lib: Path) -> dict:
    """Per kernel function, registers, spill bytes, stack frame and static
    shared memory (the box scans' is all dynamic, set at launch) from the
    ``-Xptxas -v`` output that build.py keeps beside the library (none
    for a library built without it)."""
    import re
    log = lib.with_suffix(".log")
    stats, cur = {}, None
    for line in (log.read_text() if log.exists() else "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = stats.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            cur["stack_frame"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
    return demangled(stats)


def demangled(by_name: dict) -> dict:
    """``by_name`` with its C++ symbol names demangled (c++filt), where
    the host has c++filt."""
    import shutil
    filt = shutil.which("c++filt")
    if not filt or not by_name:
        return by_name
    names = subprocess.run([filt], input="\n".join(by_name),
                           capture_output=True, text=True,
                           check=True).stdout.split("\n")
    return dict(zip(names, by_name.values()))


# the kernels designed around bulk copies, which must hold cp.async.bulk
# (UBLKCP): box_scan's full-width route, box_scan_pruned (also box_scan's
# narrow route, D <= 8) and box_scan_seg; box_scan's widest route keeps
# the earlier kernel without it
BULK_KERNELS = ("box_scan_kernel_lists", "box_scan_pruned_kernel",
                "box_scan_seg_kernel")


def bulk_sass(libs: dict) -> dict:
    """The box_scan_sass record: per function of the two box-scan
    libraries, its UBLKCP count, registers, spills and stack frame, and
    the bulk-copy kernels that hold no UBLKCP."""
    funcs = {}
    for name in ("box_scan", "box_scan_seg"):
        stats = ptxas_stats(libs[name])
        for f, c in sass_check(libs[name]).items():
            funcs[f] = {"UBLKCP": c["UBLKCP"], **stats.get(f, {})}
    missing = [f for f, c in funcs.items()
               if any(k in f for k in BULK_KERNELS) and not c["UBLKCP"]]
    return {"phase": "box_scan_sass", "functions": funcs, "missing": missing}


def _sass_functions(lib: Path, keys: tuple) -> dict:
    """Per function of a built library, its ``keys`` counts of
    ``sass_check`` with its ``ptxas_stats`` (registers, spills, stack
    frame)."""
    stats = ptxas_stats(lib)
    return {f: {k: c[k] for k in keys} | stats.get(f, {})
            for f, c in sass_check(lib).items()}


def _spilled(funcs: dict) -> list:
    """The functions that spill, or that have no ptxas record."""
    return [f for f, c in funcs.items()
            if c.get("spill_stores") or c.get("spill_loads")
            or "spill_stores" not in c]


def flash_fwd_sass(libs: dict) -> dict:
    """The flash_sass record: per function of the forward's library, its
    HGMMA (wgmma), UTMALDG (TMA) and SETMAXREG (setmaxnreg) counts with
    its registers, spills and stack frame; the product kernels (bf16 and
    f32; the f32 pre-pass and the splits' combine move data only) without
    wgmma or TMA loads (``no_wgmma``), the bf16 kernels without setmaxnreg
    (``no_setmaxnreg``), and every function that spills (``spills``)."""
    funcs = _sass_functions(libs["flash_attention"],
                            ("HGMMA", "HGMMA_BF16", "HGMMA_TF32", "UTMALDG",
                             "SETMAXREG"))
    products = [f for f in funcs if "kernel_bf16" in f or "kernel_f32" in f]
    return {"phase": "flash_sass", "functions": funcs,
            "no_wgmma": [f for f in products if not (
                funcs[f]["HGMMA"] and funcs[f]["UTMALDG"])],
            "no_setmaxnreg": [f for f in products if "kernel_bf16" in f
                              and not funcs[f]["SETMAXREG"]],
            "spills": _spilled(funcs)}


def flash_bwd_sass(libs: dict) -> dict:
    """The flash_bwd_sass record: per function of the backward's library,
    its HMMA (mma.sync), HGMMA (wgmma) and UTMALDG (TMA) counts with its
    registers, spills and stack frame; the bf16 route's kernels without
    wgmma or TMA loads (``no_wgmma``), the f32 route's without mma.sync
    (``no_mma``), and every function that spills (``spills``)."""
    funcs = _sass_functions(libs["flash_attention_bwd"],
                            ("HMMA", "HGMMA", "UTMALDG"))
    products = [f for f in funcs if "reduce" not in f]
    return {"phase": "flash_bwd_sass", "functions": funcs,
            "no_wgmma": [f for f in products if "bf16" in f and not (
                funcs[f]["HGMMA"] and funcs[f]["UTMALDG"])],
            "no_mma": [f for f in products
                       if "f32" in f and not funcs[f]["HMMA"]],
            "spills": _spilled(funcs)}


# the engine configurations gpu_vs_cpu holds GPU against CPU: the default
# (the batched device fit, survivor tiles), the numpy trainers, the dense
# score oracle; set on the same two engines, which keeps their capacity
# hints in step
ENGINE_MODES = {"default": {"use_jax_fit": True, "score_mode": "sparse"},
                "numpy_fit": {"use_jax_fit": False, "score_mode": "sparse"},
                "dense": {"use_jax_fit": True, "score_mode": "dense"}}


def set_mode(engines, mode: str) -> None:
    for e in engines:
        for k, v in ENGINE_MODES[mode].items():
            setattr(e, k, v)


def phase_gpu_vs_cpu(device, n: int = MID_N, d: int = FULL_D) -> None:
    from repro_torch.core import SearchEngine
    x, assign = clustered(n, d, seed=5)
    reqs = make_requests(assign, 8, 100, seed=6)
    t0 = time.perf_counter()
    for cf in (0.25, 1 / 64):                 # 1/64 forces overflow retry
        eg = SearchEngine(x, device=device, capacity_frac=cf)
        ec = SearchEngine(x, device="cpu", capacity_frac=cf)
        for mode in ENGINE_MODES:
            set_mode((eg, ec), mode)
            for mr in (100, None):
                rq = [{**r, "max_results": mr} for r in reqs]
                same_results(eg.query_batch(rq), ec.query_batch(rq))
            for r in reqs[:2]:
                kw = dict(model=r["model"], max_results=100)
                same_results([eg.query(r["pos_ids"], r["neg_ids"], **kw)],
                             [ec.query(r["pos_ids"], r["neg_ids"], **kw)],
                             batched=False)
        set_mode((eg, ec), "default")
    # the last pair's state: the scan and knn models, and use_fused=False
    # engines carrying it over
    n_found = {}
    for model in ("dtree", "rforest", "knn"):
        for r in reqs[:2]:
            for mr in (100, None):
                kw = dict(model=model, max_results=mr, max_depth=12,
                          n_models=25, k_neighbors=1000)
                a = eg.query(r["pos_ids"], r["neg_ids"], **kw)
                same_all([a], [ec.query(r["pos_ids"], r["neg_ids"], **kw)])
                n_found[model] = a.n_found
    ug, uc = (host_oracle_engine(e, e.device) for e in (eg, ec))
    for mr in (100, None):
        rq = [{**r, "max_results": mr} for r in reqs]
        same_all(ug.query_batch(rq), uc.query_batch(rq))
    # ROADMAP C1: knn over +-inf rows, on the card and the CPU, equal to
    # the reference's ids and scores
    geo = dict(n_subsets=4, subset_dim=6, block=256)
    xc = c1_catalog()
    c1g = SearchEngine(xc, device=device, **geo)
    c1c = SearchEngine(xc, device="cpu", **geo)
    for mr in (None, 100):
        kw = dict(model="knn", k_neighbors=16, max_results=mr)
        a = c1g.query(C1_POS, C1_NEG, **kw)
        same_all([a], [c1c.query(C1_POS, C1_NEG, **kw)])
        if not (a.ids.tolist() == list(C1_KNN_IDS)
                and a.scores.tolist() == list(C1_KNN_SCORES)):
            raise AssertionError(f"C1 catalog, max_results={mr}: knn ids "
                                 f"!= the reference's")
    live = live_gpu_vs_cpu(device, n, d)
    quantized = quantized_gpu_vs_cpu(device, x, reqs)
    sharded = sharded_gpu_vs_cpu(device, x, reqs, eg)
    live_sharded = live_gpu_vs_cpu(device, n, d, n_shards=LIVE_SHARDS)
    emit({"phase": "gpu_vs_cpu", "rows": n, "dims": d, "requests": 8,
          "engine_modes": list(ENGINE_MODES),
          "models": ["dbranch", "dbens", "dtree", "rforest", "knn"],
          "use_fused_false": True, "n_found_scan_knn": n_found,
          "c1_inf_catalog_knn": {"rows": int(xc.shape[0]),
                                 "ids": len(C1_KNN_IDS),
                                 "gpu_equals_cpu_equals_reference": True},
          "live": live, "quantized": quantized, "sharded": sharded,
          "live_sharded": live_sharded,
          "bitwise_equal": True, "seconds": time.perf_counter() - t0})


INDEX_FIELDS = ("dims", "perm", "rows", "zlo", "zhi", "block", "n_rows",
                "subset_id")


def host_oracle_engine(eng, device):
    """A use_fused=False engine over ``eng``'s host state (from_arrays:
    no second index build)."""
    from repro_torch.core import SearchEngine
    return SearchEngine.from_arrays(
        eng.x, eng.subsets,
        [{f: getattr(ix, f) for f in INDEX_FIELDS} for ix in eng.indexes],
        eng.frange, device=device, use_fused=False)


# the runtime calls that launch one kernel each, as torch.profiler names
# them on the host side (PyTorch's own kernels go through these)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC")


# profile_batch's classes of device time
KERNEL_CLASSES = ("flash_attention", "flash_attention_bwd", "cublas",
                  "other")


def _kernel_class(name: str) -> str:
    """flash attention's forward kernels (the main one, its f32 pre-pass
    and its splits' combine), its backward's kernels, cuBLAS's products
    or the rest, by kernel name (cuBLAS's bf16 products on the H100 are
    its ``nvjet`` kernels)."""
    low = name.lower()
    return ("flash_attention" if any(
                w in name for w in ("flash_attention_kernel",
                                    "flash_attention_presplit",
                                    "flash_attention_combine")) else
            "flash_attention_bwd" if "flash_bwd_" in name else
            "cublas" if any(w in low for w in ("gemm", "xmma", "cutlass",
                                               "nvjet"))
            else "other")


def _range_kernels(events, name: str) -> list:
    """(kernel name, device us) of every kernel launched inside the
    torch.profiler ranges (record_function) called ``name``: the kernels
    of the range's CPU event and of every op under it."""
    from torch.autograd import DeviceType
    out = []

    def walk(e):
        out.extend((k.name, k.duration) for k in e.kernels)
        for ch in e.cpu_children:
            walk(ch)
    for e in events:
        if e.name == name and e.device_type == DeviceType.CPU:
            walk(e)
    return out


def _top_kernels(per_name: dict, n: int) -> list:
    """The ``n`` kernels of most device time in {name: [us, count]}."""
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:200], "class": _kernel_class(k), "ms": us * 1e-3,
             "count": c} for k, (us, c) in top]


def profile_batch(fn, counters=None, graph_fallback: bool = False,
                  ranges=(), top_by_class: int = 0) -> dict:
    """One more warm call of ``fn`` (a query batch, a batched fit, an
    extraction batch) under torch.profiler: device busy time (the sum of
    kernel self times on the card) against the host wall, and the kernels
    that take it. Late in a process the profiler drops device events, so
    the record must hold every launch: ``counters`` maps a kernel's name
    to a function that reads its wrapper's launch counter, and the
    profiler's count of that kernel must equal the counter's move; and no
    fewer device kernels than the host-side launch calls it recorded
    (``LAUNCH_CALLS``; equal where every kernel is PyTorch's, as in the
    fit). Where either fails, the launch count is None, and the busy time
    is None too unless ``graph_fallback``: then it is one replay of a
    CUDA graph of ``fn`` (only for a ``fn`` with no host sync). Each name
    in ``ranges`` is a record_function range inside ``fn``: the device
    time of the kernels launched under it is its own class in
    ``device_ms_by_class``, taken out of the others. ``top_by_class`` >
    0 lists that many kernels of most device time in each class (outside
    the ranges, under ``top_by_class``) and in each range."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    counters = counters or {}
    before = {k: read() for k, read in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = {k: read() - before[k] for k, read in counters.items()}
    rows, launch_calls = [], 0
    for e in prof.key_averages():
        # device-side events only: a CPU op's device total repeats the
        # time of the kernels it launched
        us = _self_device_us(e)
        if e.device_type == DeviceType.CUDA and us > 0 \
                and e.key not in ranges:      # a range's device-side span
            rows.append((us, e.key, e.count))
        elif e.device_type != DeviceType.CUDA and e.key in LAUNCH_CALLS:
            launch_calls += e.count
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    kernels = sum(c for _, k, c in rows
                  if not k.startswith(("Memcpy", "Memset")))
    recorded = {k: sum(c for _, key, c in rows if k in key) for k in counted}
    all_recorded = recorded == counted and kernels >= launch_calls
    busy_by = "profiler"
    if not all_recorded:
        kernels = None
        busy, busy_by = None, None
        if graph_fallback:
            busy, busy_by = graph_ms(fn, iters=3) * 1e-3, "graph"
    # each path kernel's device self time per launch in this batch
    per_launch = {}
    for name in KERNELS:
        mine = [(us, c) for us, k, c in rows if f"{name}_kernel" in k]
        if mine:
            per_launch[name] = {
                "device_ms_per_launch": sum(u for u, _ in mine) * 1e-3
                / sum(c for _, c in mine),
                "count": sum(c for _, c in mine)}
    # flash attention, cuBLAS's products and the rest
    by_class = {c: 0.0 for c in KERNEL_CLASSES}
    for us, k, _ in rows:
        by_class[_kernel_class(k)] += us * 1e-3
    outside = {k: [us, c] for us, k, c in rows}
    in_range = {}
    for name in ranges:
        under = _range_kernels(prof.events(), name)
        mine = {c: 0.0 for c in KERNEL_CLASSES}
        per_name = {}
        for k, us in under:
            mine[_kernel_class(k)] += us * 1e-3
            agg = per_name.setdefault(k, [0.0, 0])
            agg[0] += us
            agg[1] += 1
            if k in outside:
                outside[k][0] -= us
                outside[k][1] -= 1
        for c, ms in mine.items():
            by_class[c] -= ms
        by_class[name] = sum(mine.values())
        in_range[name] = {"kernels": len(under), "device_ms_by_class": mine}
        if top_by_class:
            in_range[name]["top"] = _top_kernels(per_name, top_by_class)
    tops = {}
    if top_by_class:
        for c in KERNEL_CLASSES:
            tops[c] = _top_kernels({k: v for k, v in outside.items()
                                    if _kernel_class(k) == c and v[1] > 0},
                                   top_by_class)
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_by": busy_by,
            "device_idle_share": (1.0 - busy / wall
                                  if wall and busy is not None else None),
            "device_kernel_launches": kernels,
            "host_launch_calls": launch_calls,
            "device_memcpy_memset": sum(
                c for _, k, c in rows if k.startswith(("Memcpy", "Memset"))),
            "launches_counted": counted, "launches_recorded": recorded,
            "all_recorded": all_recorded,
            "path_kernels": per_launch, "device_ms_by_class": by_class,
            **({"ranges": in_range} if ranges else {}),
            **({"top_by_class": tops} if top_by_class else {}),
            "top_device": [{"name": k[:60], "ms": us * 1e-3, "count": c}
                           for us, k, c in rows[:8]]}


def full_engine(device, n: int, d: int, k: int):
    """The main path's catalog (clustered, seed 0), its batch of 8
    requests and the engine over it at its default geometry; returns
    (engine, requests, data seconds, build seconds)."""
    from repro_torch.core import SearchEngine
    t0 = time.perf_counter()
    x, assign = clustered(n, d, seed=0)
    gen_s = time.perf_counter() - t0
    reqs = make_requests(assign, 8, k, seed=1)
    t0 = time.perf_counter()
    eng = SearchEngine(x, device=device)
    build_s = time.perf_counter() - t0
    if eng.subsets.shape != (32, 6) or eng.indexes[0].block != 1024:
        raise AssertionError("not the engine's default geometry")
    return eng, reqs, gen_s, build_s


def request_fits(eng, reqs, use_jax=None) -> list:
    """Each request's box sets as query() fits them (the engine's trainer
    unless ``use_jax`` says; the device fit's boxes are CUDA tensors)."""
    return [eng._fit_boxes(r["model"], eng.x[r["pos_ids"]],
                           eng.x[r["neg_ids"]], max_depth=12, n_models=25,
                           seed=0, use_jax=use_jax, frange=eng.frange)
            for r in reqs]


def fit_specs(eng, reqs) -> list:
    """The batched fit's specs as query_batch builds them (depth 12, 25
    dbens models, seed 0)."""
    return [(r["model"], eng.x[r["pos_ids"]], eng.x[r["neg_ids"]], 25, 0)
            for r in reqs]


def batched_fit(eng, reqs):
    """query_batch's fit phase: (lo_c, hi_c, entries) on the engine's
    device."""
    return eng._fit_boxes_batched(fit_specs(eng, reqs), max_depth=12,
                                  return_device=True, frange=eng.frange)


@contextlib.contextmanager
def fit_recorder():
    """Record each batched fit made inside: its lanes T, groups, worklist
    size, round 2's survivor bucket (0 where no lane outlived round 1),
    the bytes it uploads (the packed inputs, and round 2's lane index)
    and fit_select's outputs (lo_c, hi_c, meta [2, G])."""
    from repro_torch.core import dbranch, engine
    fits, bucket = [], []
    fit_select, grow_round = engine.fit_select, dbranch._grow_round

    def rec_grow(x_all, m_all, tables, state=None, **kw):
        if state is not None:
            bucket.append(int(x_all.shape[0]))
        return grow_round(x_all, m_all, tables, state, **kw)

    def rec_fit(*args, **kw):
        bucket.clear()
        out = fit_select(*args, **kw)
        b = bucket[0] if bucket else 0
        fits.append({"lanes": int(args[0].shape[0]),
                     "rows_per_lane": int(args[0].shape[1]),
                     "dims": int(args[0].shape[2]), "p_cnt": kw["p_cnt"],
                     "n_groups": kw["n_groups"],
                     "max_nodes": kw["max_nodes"], "round2_bucket": b,
                     "upload_bytes": int(sum(a.nbytes for a in args)) + 8 * b,
                     "out": out})
        return out
    engine.fit_select, dbranch._grow_round = rec_fit, rec_grow
    try:
        yield fits
    finally:
        engine.fit_select, dbranch._grow_round = fit_select, grow_round


def sync_warnings(fn):
    """(fn's result, {"file:line": warnings}): torch's sync debug mode
    warns "called a synchronizing CUDA operation" at each synchronising
    call (a blocking copy, .item(), nonzero, a stream sync), put to the
    line of Python that made the call."""
    import os
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = {}
    for w in caught:
        if "called a synchronizing" in str(w.message):
            k = f"{os.path.basename(w.filename)}:{w.lineno}"
            where[k] = where.get(k, 0) + 1
    return out, where


def host_syncs(fn):
    """(fn's result, its host syncs: {"file:line": warnings}) by
    sync_warnings. The syncs are the call sites, and every site must warn
    as often as one device->host copy does (counted first on one .cpu():
    once in torch 2.11); a site that warns more syncs more than once."""
    import torch
    _, one = sync_warnings(lambda: torch.zeros(1, device="cuda").cpu())
    per_copy = sum(one.values())
    out, where = sync_warnings(fn)
    if per_copy < 1 or any(n != per_copy for n in where.values()):
        raise AssertionError(f"sync warnings by call site {where}: not "
                             f"{per_copy} a site, as one device->host "
                             f"copy ({one})")
    return out, where


def sorted_boxes(lo, hi):
    """A box set in one order (the trainers emit in different orders:
    numpy DFS, the device worklist BFS)."""
    lo = lo.cpu().numpy() if hasattr(lo, "cpu") else np.asarray(lo)
    hi = hi.cpu().numpy() if hasattr(hi, "cpu") else np.asarray(hi)
    key = np.lexsort(np.concatenate([lo, hi], 1).T[::-1])
    return lo[key], hi[key]


def same_fit_as_numpy(eng, reqs):
    """Each request's device-fit winners against the numpy trainers': the
    same subsets, and the same boxes bitwise as a set per winner. Returns
    (the number of winners compared, the numpy trainers' seconds)."""
    dev = request_fits(eng, reqs, use_jax=True)
    t0 = time.perf_counter()
    npy = request_fits(eng, reqs, use_jax=False)
    numpy_s = time.perf_counter() - t0
    n = 0
    for i, (a, b) in enumerate(zip(dev, npy)):
        if len(a) != len(b):
            raise AssertionError(f"request {i}: {len(a)} device winners, "
                                 f"{len(b)} numpy ones")
        for u, v in zip(a, b):
            if u.subset_id != v.subset_id or not all(
                    np.array_equal(p, q) for p, q in zip(
                        sorted_boxes(u.lo, u.hi), sorted_boxes(v.lo, v.hi))):
                raise AssertionError(f"request {i}: device fit != numpy "
                                     f"fit (subset {u.subset_id} / "
                                     f"{v.subset_id})")
            n += 1
    return n, numpy_s


def probe_inputs(eng, reqs) -> list:
    """One round of the fused batch's probes, boxes uploaded: (index, lo,
    hi, onehot, capacity) for each, as query_batch builds them."""
    fits = request_fits(eng, reqs)
    jobs, _ = eng._make_jobs(
        [(bs, q) for q, f in enumerate(fits) for bs in f], len(reqs))
    geom = eng._view().geom
    return [(eng.indexes[sid], *eng._probe_inputs(m, o, len(reqs)),
             eng._initial_capacity(eng.indexes[sid], m.n_boxes, geom=geom))
            for sid, m, o in jobs]


def largest_probe(inputs) -> tuple:
    """measure_kernels' inputs at the probe with the most boxes."""
    ix, lo, hi, oh, cap = max(inputs, key=lambda t: t[1].shape[0])
    rows3, zlo, zhi = ix.device_arrays()
    return rows3, zlo, zhi, lo, hi, oh, cap


def largest_query_index(eng, reqs) -> tuple:
    """The use_fused=False batch's largest query_index calls: box_scan's
    inputs (rows, lo, hi) at the largest by rows x boxes, and the zone
    mask's (zlo, zhi, lo, hi) at the largest by boxes; each request's
    boxes of one subset merged, the hit blocks' rows gathered, as
    query_index does."""
    from repro_torch.core.index import to_device_f32
    from repro_torch.kernels import ops
    best, size, mask_in = None, -1, None
    for fits in request_fits(eng, reqs, use_jax=False):
        by_subset = {}
        for bs in fits:
            by_subset.setdefault(bs.subset_id, []).append(bs)
        for sid, group in by_subset.items():
            merged = group[0]
            for g in group[1:]:
                merged = merged.concatenate(g)
            ix = eng.indexes[sid]
            rows3, zlo, zhi = ix.device_arrays()
            lo = to_device_f32(merged.lo, ix.device)
            hi = to_device_f32(merged.hi, ix.device)
            hit = ops.zone_prune(zlo, zhi, lo, hi).any(1).nonzero().flatten()
            if hit.numel() * ix.block * merged.n_boxes > size:
                size = hit.numel() * ix.block * merged.n_boxes
                best = (rows3.index_select(0, hit).reshape(
                    -1, rows3.shape[-1]), lo, hi)
            if mask_in is None or merged.n_boxes > mask_in[2].shape[0]:
                mask_in = (zlo, zhi, lo, hi)
    return best, mask_in


def fit_measure(eng, reqs, iters: int = 10) -> dict:
    """The batched fit of ``reqs`` alone on ``eng``'s card, warm: the wall
    of one call (host clock to a synchronize), the median of ``iters`` by
    CUDA events, its host syncs (which must be 2: round 1's flags and the
    [2, G] meta), the bytes it uploads, its lanes and round 2's survivor
    bucket, and one call under torch.profiler (device busy time and
    kernel launches, None where the profiler dropped events)."""
    import torch
    batched_fit(eng, reqs)                   # warm: pinned staging buffers
    torch.cuda.synchronize()
    with fit_recorder() as fits:
        t0 = time.perf_counter()
        batched_fit(eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, sync_sites = host_syncs(lambda: batched_fit(eng, reqs))
    syncs = len(sync_sites)
    if syncs != 2:
        raise AssertionError(f"the batched fit made {syncs} host syncs, "
                             f"not 2: {sync_sites}")
    prof = profile_batch(lambda: batched_fit(eng, reqs))
    return {**{k: v for k, v in fits[0].items() if k != "out"},
            "host_s": host_split(lambda: batched_fit(eng, reqs)),
            "fit_wall_s": wall, "host_syncs": syncs,
            "host_sync_sites": sync_sites,
            "event_ms": time_ms(lambda: batched_fit(eng, reqs), iters=iters,
                                warmup=1),
            "device_busy_ms": (None if prof["device_busy_s"] is None
                               else prof["device_busy_s"] * 1e3),
            "device_kernel_launches": prof["device_kernel_launches"],
            "host_launch_calls": prof["host_launch_calls"],
            "all_recorded": prof["all_recorded"],
            "device_idle_share": prof["device_idle_share"],
            "top_device": prof["top_device"]}


# the stages of the batched fit whose host time host_split reports
FIT_STAGES = ("_fit_boxes_batched", "dbens_draws", "split_tables",
              "to_device_async", "fit_select", "_grow_lanes",
              "_select_expand")


def host_split(fn, stages=FIT_STAGES) -> dict:
    """Host seconds of one call of ``fn`` by stage (``stages``, FIT_STAGES
    by default, cumulative as cProfile reports them; ``_fit_boxes_batched``
    is the whole fit, and what its stages leave is the packing of the lane
    stack in numpy). cProfile slows Python calls, not the numpy and torch
    calls inside."""
    import cProfile
    import pstats
    import torch
    pr = cProfile.Profile()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    out = {}
    for (_, _, name), row in pstats.Stats(pr).stats.items():
        if name in stages:
            out[name] = out.get(name, 0.0) + row[3]
    return out


def rank_methods(eng, reqs, k: int) -> dict:
    """The dense [N, Q] score buffer of the batch, ranked by each
    rank_topk method at the engine's k and score bound: the three results
    bitwise equal, each timed by CUDA events around a call and by a CUDA
    graph of 30 calls (device time)."""
    import torch
    from repro_torch.kernels import ops
    lo_c, hi_c, ent = batched_fit(eng, reqs)
    jobs, bound = eng._make_jobs_flat(
        [(lo_c, hi_c, g, sid, cnt, q) for q, e in enumerate(ent)
         for g, sid, cnt in e], len(reqs))
    scores, _ = eng._device_scores(jobs, len(reqs), eng._view())
    n = eng.n
    kk = min(eng._pow2ceil(k), n)
    tr = [np.concatenate([r["pos_ids"], r["neg_ids"]]) for r in reqs]
    tids = np.full((len(reqs), -(-max(map(len, tr)) // 16) * 16), n,
                   np.int32)
    for q, t in enumerate(tr):
        tids[q, :len(t)] = t
    tids = torch.from_numpy(tids).to(eng.device)
    outs, times = {}, {}
    for m in ("topk", "sort", "threshold"):
        fn = (lambda m=m: ops.rank_topk(scores, tids, k=kk,
                                        score_bound=bound, method=m,
                                        scores_transposed=True))
        outs[m] = fn()
        times[m] = {"ms": time_ms(fn), "device_ms": graph_ms(fn)}
    for m in ("sort", "threshold"):
        if not all(torch.equal(a, b) for a, b in zip(outs[m], outs["topk"])):
            raise AssertionError(f"rank_topk {m} != topk on the dense batch")
    return {"buffer": [n, len(reqs)], "k": kk, "score_bound": bound,
            "methods": times, "equal": True,
            "fastest": min(times, key=lambda m: times[m]["device_ms"]),
            "cuda_default": ops.CUDA_RANK_METHOD}


def same_ranked(a, b, what: str) -> None:
    """ids and scores bitwise equal (results of two engine modes)."""
    for i, (ra, rb) in enumerate(zip(a, b)):
        for r in (ra, rb):
            if isinstance(r, Exception):
                raise r
        if not (np.array_equal(ra.ids, rb.ids)
                and np.array_equal(ra.scores, rb.scores)):
            raise AssertionError(f"{what}, request {i}: ids/scores differ")


def timed_batch(eng, reqs):
    """(results, wall s, peak device bytes) of one warm query_batch."""
    import torch
    eng.query_batch(reqs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = eng.query_batch(reqs)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def phase_full(device, n: int = FULL_N, d: int = FULL_D, k: int = 100):
    """The main path at full size. Returns the kernel launch counts of
    the timed query_batch and the inputs of its largest probe."""
    import torch
    from repro_torch.core.index import sparse_probe
    from repro_torch.kernels import box_scan, ops, zone_prune
    eng, reqs, gen_s, build_s = full_engine(device, n, d, k)
    x = eng.x
    eng.query_batch(reqs)                     # warm: mirrors, hints
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zone_prune.launches = zone_prune.candidates_launches = 0
    box_scan.seg_launches = 0
    t0 = time.perf_counter()
    outs = eng.query_batch(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"zone_candidates": zone_prune.candidates_launches,
                "box_scan_seg": box_scan.seg_launches}
    if zone_prune.launches != zone_prune.candidates_launches:
        raise AssertionError("the fused batch launched zone_prune's mask "
                             "or hit-vector entry")
    peak = torch.cuda.max_memory_allocated()
    for o in outs:
        if isinstance(o, Exception):
            raise o
    if min(launches.values()) <= 0:
        raise AssertionError(f"a path kernel never launched: {launches}")
    st = outs[0].stats
    counters = {
        "zone_candidates_kernel": lambda: zone_prune.candidates_launches,
        "zone_prune_kernel":
            lambda: zone_prune.launches - zone_prune.candidates_launches,
        "box_scan_seg_kernel": lambda: box_scan.seg_launches}
    prof = profile_batch(lambda: eng.query_batch(reqs), counters)
    # the same batch with each probe's front end as the launch chain that
    # zone_candidates replaced, for the drop in device launches
    fused_front = ops.zone_candidates
    ops.zone_candidates = earlier_chain
    try:
        prof_earlier = profile_batch(lambda: eng.query_batch(reqs),
                                     counters)
        same_results(eng.query_batch(reqs), outs)
    finally:
        ops.zone_candidates = fused_front
    probes = launches["zone_candidates"]
    # device-ranked == the first k of the host-ranked results
    full = eng.query_batch([{**r, "max_results": None} for r in reqs])
    for i, (a, b) in enumerate(zip(outs, full)):
        if not (np.array_equal(a.ids, b.ids[:k])
                and np.array_equal(a.scores, b.scores[:k])):
            raise AssertionError(f"request {i}: device ranking != host")
        if len(a.ids) == 0 or not np.all(np.isfinite(a.scores)):
            raise AssertionError(f"request {i}: empty or non-finite result")
    if st["fit_path"] != "jax":
        raise AssertionError("the default engine did not run the device fit")
    fit = fit_measure(eng, reqs)
    # the same batch on the numpy trainers, and on the dense score buffer
    set_mode([eng], "numpy_fit")
    try:
        outs_np, wall_np, _ = timed_batch(eng, reqs)
    finally:
        set_mode([eng], "default")
    same_results(outs_np, outs)
    set_mode([eng], "dense")
    try:
        outs_d, wall_d, peak_d = timed_batch(eng, reqs)
        full_d = eng.query_batch([{**r, "max_results": None} for r in reqs])
        ranking = rank_methods(eng, reqs, k)
    finally:
        set_mode([eng], "default")
    same_ranked(outs_d, outs, "dense != sparse")
    same_ranked(full_d, full, "dense != sparse, max_results=None")
    st_d = outs_d[0].stats
    dense_bytes = st_d["batch_score_buffer_bytes_peak"]
    if dense_bytes != n * len(reqs) * 4:
        raise AssertionError(f"dense buffer of {dense_bytes} bytes, not "
                             f"{n} x {len(reqs)} x 4")
    # one round's probes with the boxes already uploaded, under the sync
    # debugger: nothing on the dispatch path may synchronise
    inputs = probe_inputs(eng, reqs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sync_free = [sparse_probe(ix, lo, hi, oh, capacity=cap)
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
          "fit_path": st["fit_path"],
          "fit_s": st["batch_fit_s"], "score_rank_s": outs[0].query_time_s,
          "fit": fit,
          "numpy_fit": {"fit_s": outs_np[0].stats["batch_fit_s"],
                        "query_batch_wall_s": wall_np,
                        "per_query_wall_s": wall_np / len(reqs),
                        "bitwise_equal_device_fit": True},
          "dense": {"query_batch_wall_s": wall_d,
                    "per_query_wall_s": wall_d / len(reqs),
                    "score_buffer_bytes_peak":
                        st_d["batch_score_buffer_bytes_peak"],
                    "sparse_score_bytes_peak":
                        st["batch_score_buffer_bytes_peak"],
                    "max_memory_allocated": peak_d,
                    "n_host_syncs": st_d["batch_n_host_syncs"],
                    "bitwise_equal_sparse": True,
                    "bitwise_equal_sparse_max_results_none": True,
                    "rank_topk": ranking},
          "profile": prof,
          "device_kernel_launches": {
              "batch": prof["device_kernel_launches"],
              "batch_with_earlier_chain":
                  prof_earlier["device_kernel_launches"],
              "probes": probes,
              "drop_per_probe": (
                  (prof_earlier["device_kernel_launches"]
                   - prof["device_kernel_launches"]) / max(probes, 1)
                  if prof["all_recorded"] and prof_earlier["all_recorded"]
                  else None)},
          "n_host_syncs": st["batch_n_host_syncs"],
          "retried_subsets": st["batch_retried_subsets"],
          "host_bytes_transferred": st["batch_host_bytes_transferred"],
          "n_boxes": [o.stats["n_boxes"] for o in outs],
          "n_found": [o.n_found for o in outs],
          "max_memory_allocated": peak, "launches": launches,
          "device_ranked_equals_host": True,
          "sync_free_probes": len(sync_free)})
    return launches, largest_probe(inputs), (eng, reqs, full), fit


def phase_full_scan_knn(eng, reqs, full, k: int = 100):
    """The scan and knn paths, and the use_fused=False host oracle, on
    the full-size engine of phase_full (no second index build). Returns
    the launch counts of each path and the main-path inputs of box_scan
    (rforest's scan, and the host oracle's largest query_index call) and
    l2dist."""
    import torch
    from repro_torch.core.boxes import boxes_contain
    from repro_torch.core.convert import index_from_arrays
    from repro_torch.core.knn import knn_subset, knn_vote
    from repro_torch.kernels import box_scan, l2dist, zone_prune
    pos, neg = reqs[0]["pos_ids"], reqs[0]["neg_ids"]
    kw = dict(max_results=k, max_depth=12, n_models=25, k_neighbors=1000)
    models = ("dtree", "rforest", "knn")
    for m in models:                          # warm: the feature copy
        eng.query(pos, neg, model=m, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    box_scan.scan_launches = l2dist.launches = 0
    res, walls = {}, {}
    for m in models:
        t0 = time.perf_counter()
        res[m] = eng.query(pos, neg, model=m, **kw)
        torch.cuda.synchronize()
        walls[m] = time.perf_counter() - t0
    launches = {"box_scan": box_scan.scan_launches,
                "l2dist": l2dist.launches}
    peak = torch.cuda.max_memory_allocated()
    if min(launches.values()) <= 0:
        raise AssertionError(f"a scan/knn kernel never launched: {launches}")
    # right by the repo's own means: the scan scores are the host
    # oracle's box counts; knn equals the same search on the CPU
    lo_rf, hi_rf = rforest_boxes(eng.x, pos, neg)
    r = res["rforest"]
    if r.n_found == 0 or not np.array_equal(
            r.scores, boxes_contain(eng.x[r.ids], lo_rf, hi_rf)):
        raise AssertionError("rforest scores != host box counts")
    if res["dtree"].n_found == 0 or res["dtree"].stats["n_boxes"] <= 0:
        raise AssertionError("dtree found nothing")
    ix0 = eng.indexes[0]
    cpu0 = index_from_arrays(**{f: getattr(ix0, f) for f in INDEX_FIELDS},
                             device="cpu")
    ids_k, _ = knn_subset(cpu0, eng.x[pos], k=1000)
    want = eng._rank(knn_vote(ids_k, eng.n), pos, neg, False)
    if not (np.array_equal(res["knn"].ids, want[0][:k])
            and np.array_equal(res["knn"].scores, want[1][:k])):
        raise AssertionError("knn on the card != knn on the CPU")
    # use_fused=False: the 8 main-path requests, host-ranked
    uf = host_oracle_engine(eng, eng.device)
    rq = [{**q, "max_results": None} for q in reqs]
    uf.query_batch(rq)                        # warm: index mirrors
    torch.cuda.synchronize()
    box_scan.scan_launches = zone_prune.launches = 0
    zone_prune.candidates_launches = 0
    t0 = time.perf_counter()
    outs = uf.query_batch(rq)
    torch.cuda.synchronize()
    uf_wall = time.perf_counter() - t0
    uf_launches = {"box_scan": box_scan.scan_launches,
                   "zone_prune": zone_prune.launches
                   - zone_prune.candidates_launches}
    if min(uf_launches.values()) <= 0:
        raise AssertionError(f"host oracle kernels never launched: "
                             f"{uf_launches}")
    for i, (a, b) in enumerate(zip(outs, full)):
        if isinstance(a, Exception):
            raise a
        if not (np.array_equal(a.ids, b.ids)
                and np.array_equal(a.scores, b.scores)):
            raise AssertionError(f"request {i}: use_fused=False != fused")
    emit({"phase": "full_size_scan_knn", "rows": eng.n, "dims": eng.d,
          "per_query_wall_s": walls,
          "fit_s": {m: res[m].train_time_s for m in models},
          "query_s": {m: res[m].query_time_s for m in models},
          "n_boxes": {m: res[m].stats.get("n_boxes") for m in models},
          "n_found": {m: res[m].n_found for m in models},
          "launches": launches, "max_memory_allocated": peak,
          "feature_mirror_bytes": eng.feature_mirror_bytes(),
          "host_oracle": {"batch": len(rq), "query_batch_wall_s": uf_wall,
                          "per_query_wall_s": uf_wall / len(rq),
                          "launches": uf_launches,
                          "blocks_touched": [o.stats["blocks_touched"]
                                             for o in outs],
                          "ids_equal_fused": True}})
    rows3, _, _ = ix0.device_arrays()
    q0 = torch.from_numpy(np.ascontiguousarray(
        eng.x[pos][:, ix0.dims])).to(eng.device)
    scan_in = (eng._device_features(), *(torch.from_numpy(a).to(eng.device)
                                         for a in (lo_rf, hi_rf)))
    knn_in = (rows3.reshape(-1, rows3.shape[-1])[:ix0.n_rows], q0)
    return ({**launches, "host_oracle": uf_launches}, scan_in, knn_in,
            largest_query_index(eng, reqs))


# ----------------------------------------------------------------------
# the per-index fused query (query_index_fused / _multi)
# ----------------------------------------------------------------------

FUSED_CALLS = {"zone_candidates": 1, "box_scan_seg": 1, "zone_prune": 0,
               "box_scan": 0, "box_scan_pruned": 0, "l2dist": 0,
               "flash_attention": 0}


def subset_boxes(eng, reqs) -> dict:
    """{subset: {request: its fitted boxes on that subset, merged}}, as
    the engine's trainer fits them for query()."""
    out = {}
    for q, fits in enumerate(request_fits(eng, reqs)):
        for bs in fits:
            per_q = out.setdefault(bs.subset_id, {})
            per_q[q] = per_q[q].concatenate(bs) if q in per_q else bs
    return out


def first_capacity_counts(ix, bs, capacity: int) -> tuple:
    """tests/test_fused_query.py's reckoning of an overflowed fused query,
    on the host: the box counts of the first ``capacity`` surviving
    blocks in zone order, in original row order, and the survivors."""
    from repro_torch.core.boxes import boxes_contain
    lo, hi = (a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
              for a in (bs.lo, bs.hi))
    hit_ids = np.nonzero(((ix.zhi[:, None, :] > lo[None])
                          & (ix.zlo[:, None, :] <= hi[None])).all(-1)
                         .any(1))[0]
    rows3 = ix.rows.reshape(ix.n_blocks, ix.block, -1)
    counts = np.zeros((ix.n_blocks, ix.block), np.int32)
    for b in hit_ids[:capacity]:
        counts[b] = boxes_contain(rows3[b], lo, hi)
    counts = counts.reshape(-1)
    want = np.zeros(ix.n_rows, np.int32)
    valid = ix.perm >= 0
    want[ix.perm[valid]] = counts[valid]
    return want, len(hit_ids)


def phase_fused_oracle(eng, reqs) -> dict:
    """query_index_fused / query_index_fused_multi (DESIGN.md §6) on
    full_size's engine, for the batch's fitted boxes on every subset: each
    request's boxes alone bitwise query_index (counts, blocks touched);
    the 8 requests' boxes in one multi call bitwise each alone (zeros for
    a request with no box there); at half the survivors of the call that
    has the most, "overflowed" and the first-capacity survivors'
    counts. Each call's launches must be FUSED_CALLS; its host syncs
    by call site and its wall are recorded."""
    import torch
    from repro_torch.core.index import (query_index, query_index_fused,
                                        query_index_fused_multi)
    by_subset = subset_boxes(eng, reqs)
    nq = len(reqs)
    walls = {"single": [], "multi": []}
    launch_sets, alone, busiest = [], {}, (None, None, -1)

    def call(kind, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts = counted(fn)
        walls[kind].append(time.perf_counter() - t0)
        launch_sets.append(counts)
        return out
    for sid, per_q in sorted(by_subset.items()):
        ix = eng.indexes[sid]
        for q, bs in sorted(per_q.items()):
            want, st_h = query_index(ix, bs)
            got, st = call("single", lambda: query_index_fused(ix, bs))
            if not np.array_equal(got, want) or st["overflowed"] \
                    or st["blocks_touched"] != st_h["blocks_touched"]:
                raise AssertionError(f"query_index_fused != query_index "
                                     f"(subset {sid}, request {q})")
            alone[sid, q] = got
            if st["survivors"] > busiest[2]:
                busiest = (ix, bs, st["survivors"])
        qs = sorted(per_q)
        merged = per_q[qs[0]]
        for q in qs[1:]:
            merged = merged.concatenate(per_q[q])
        owner = np.concatenate([np.full(per_q[q].n_boxes, q, np.int32)
                                for q in qs])
        got, st = call("multi", lambda: query_index_fused_multi(
            ix, merged, owner, nq))
        for q in range(nq):
            want = alone[sid, q] if q in per_q else 0
            if not np.array_equal(got[q], np.broadcast_to(want,
                                                          got[q].shape)):
                raise AssertionError(f"query_index_fused_multi request {q} "
                                     f"!= alone (subset {sid})")
    bad = [c for c in launch_sets if c != FUSED_CALLS]
    if bad:
        raise AssertionError(f"fused calls launched {bad[0]}, not "
                             f"{FUSED_CALLS}")
    ix, bs, survivors = busiest
    if survivors < 2:
        raise AssertionError("no call with two survivors to overflow")
    cap = survivors // 2
    got, st = query_index_fused(ix, bs, capacity=cap)
    want, n_hit = first_capacity_counts(ix, bs, cap)
    if not (st["overflowed"] and st["survivors"] == n_hit == survivors
            and st["blocks_touched"] == cap and np.array_equal(got, want)):
        raise AssertionError(f"query_index_fused at capacity {cap} of "
                             f"{survivors}: not the first-capacity rule "
                             f"({st})")
    (_, _), syncs = host_syncs(lambda: query_index_fused(ix, bs))
    med = lambda v: float(np.median(v))
    out = {"phase": "fused_oracle", "subsets": len(by_subset),
           "single_calls": len(walls["single"]),
           "multi_calls": len(walls["multi"]),
           "launches_per_call": FUSED_CALLS,
           "host_syncs_per_call": sum(syncs.values()),
           "host_syncs_by_site": syncs,
           "wall_s_median": {k: med(v) for k, v in walls.items()},
           "wall_s_max": {k: max(v) for k, v in walls.items()},
           "overflow": {"capacity": cap, "survivors": survivors,
                        "subset": int(bs.subset_id), "first_capacity": True},
           "bitwise_equal_query_index": True,
           "multi_bitwise_equal_alone": True}
    emit(out)
    return out


def phase_fused_oracle_only(device) -> None:
    """``--only fused_oracle``: full_size's static engine, then the fused
    oracle."""
    eng, reqs, _, _ = full_engine(device, FULL_N, FULL_D, 100)
    phase_fused_oracle(eng, reqs)


# ----------------------------------------------------------------------
# the live catalog (append / delete / compact)
# ----------------------------------------------------------------------

# the reference's benchmarks/query_time.py run_live at full_size's
# catalog: a base of 75 % (a delta fraction of 25 %), the rest appended
# in 3 passes, 1 % of the rows tombstoned from a seed outside the
# training ids plus each request's top 3 hits
LIVE_BASE_FRAC = 0.75
LIVE_PASSES = 3
LIVE_DELETE_FRAC = 0.01
LIVE_TOP_DELETES = 3
LIVE_DELETE_SEED = 11
# full_size's live catalog: 768 base blocks + 3 x 86 delta blocks
LIVE_FULL_ZONES = 1026
# warm batches each of the live and the static engine, in turns
LIVE_WALL_ROUNDS = 5           # 11 before the 1,000 s cut
# seconds between the batches issued while a background compaction runs
LIVE_COMPACT_PACE_S = 0.1
# the kernel entry points whose calling thread a background compaction
# is checked on
KERNEL_ENTRIES = (("zone_prune", "zone_candidates"),
                  ("zone_prune", "zone_prune"), ("zone_prune", "zone_hits"),
                  ("box_scan", "box_scan"), ("box_scan", "box_scan_pruned"),
                  ("box_scan", "box_scan_seg"),
                  ("box_scan", "box_scan_seg_gather"), ("l2dist", "l2dist"))


def live_split(n: int):
    """(base rows, [the append passes' row ranges])."""
    base = int(n * LIVE_BASE_FRAC)
    return base, [(int(c[0]), int(c[-1]) + 1) for c in np.array_split(
        np.arange(base, n), LIVE_PASSES)]


def live_deletes(n: int, reqs, outs) -> np.ndarray:
    """1 % of the rows drawn outside every request's training ids, plus
    each request's top LIVE_TOP_DELETES hits outside them (a request's
    hits may hold another's training rows, which a static engine over the
    survivors could not be given)."""
    train = np.unique(np.concatenate(
        [np.concatenate([r["pos_ids"], r["neg_ids"]]) for r in reqs]))
    cand = np.setdiff1d(np.arange(n), train)
    rng = np.random.default_rng(LIVE_DELETE_SEED)
    drawn = rng.choice(cand, int(round(n * LIVE_DELETE_FRAC)), replace=False)
    top = [o.ids[~np.isin(o.ids, train)][:LIVE_TOP_DELETES] for o in outs]
    return np.unique(np.concatenate([drawn, *top]).astype(np.int64))


def base_requests(reqs, base: int) -> list:
    """The requests with only their training ids below ``base``: the
    first batch after each append asks with the base's rows only (the
    others are not in the catalog yet)."""
    return [{**r, "pos_ids": r["pos_ids"][r["pos_ids"] < base],
             "neg_ids": r["neg_ids"][r["neg_ids"] < base]} for r in reqs]


def append_pass(live, rows, reqs_base) -> tuple:
    """One append to a live engine: its wall, the host build_index within
    it, and the first batch after it (its mirrors apart). Returns (that
    record, the first batch's results)."""
    cat = live._catalog
    builds = []
    build_segment = cat._build_segment

    def timed_build(*a, **kw):
        t = time.perf_counter()
        out = build_segment(*a, **kw)
        builds.append(time.perf_counter() - t)
        return out
    cat._build_segment = timed_build
    n0 = live.n
    try:
        t0 = time.perf_counter()
        ids = live.append(rows)
        append_s = time.perf_counter() - t0
    finally:
        del cat._build_segment
    if not np.array_equal(ids, np.arange(n0, n0 + len(rows))):
        raise AssertionError("append ids are not the tail range")
    mirror_s, q_s, outs = first_query(live, reqs_base)
    return ({"rows": int(len(rows)), "append_s": append_s,
             "build_index_s": builds[-1], "first_query_mirrors_s": mirror_s,
             "first_query_batch_s": q_s}, outs)


def first_query(eng, reqs):
    """The first batch after a mutation, in two parts: the snapshot's
    device mirrors (uploads, concatenations, the validity mask), synced;
    then the batch. Returns (mirror s, batch s, results)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    view = eng._view()
    for ix in view.indexes:
        ix.device_arrays()
        ix.device_gids()
        ix.device_seg_blocks()
    torch.cuda.synchronize()
    mirror_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = eng.query_batch(reqs)
    torch.cuda.synchronize()
    for o in outs:
        if isinstance(o, Exception):
            raise o
    return mirror_s, time.perf_counter() - t0, outs


@contextlib.contextmanager
def kernel_threads():
    """Record the thread of every call of a kernel entry point made
    inside: [(entry, thread ident)]."""
    import threading
    from repro_torch import kernels
    calls, saved = [], []
    for mod_name, fn_name in KERNEL_ENTRIES:
        mod = getattr(kernels, mod_name)
        fn = getattr(mod, fn_name)

        def rec(*a, _fn=fn, _name=fn_name, **kw):
            calls.append((_name, threading.get_ident()))
            return _fn(*a, **kw)
        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, rec)
    try:
        yield calls
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def turn_walls(engines: dict, reqs, rounds: int = None) -> dict:
    """Per-query wall of a warm query_batch on each named engine, timed in
    turns (each round starts one engine later: live, static, static,
    live, ... for two): the median of ``rounds`` batches each."""
    import torch
    names = list(engines)
    walls = {name: [] for name in names}
    for i in range(rounds or LIVE_WALL_ROUNDS):
        j = i % len(names)
        for name in names[j:] + names[:j]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engines[name].query_batch(reqs)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / len(reqs))
    return {name: float(np.median(v)) for name, v in walls.items()}


def paired_walls(live, static, reqs, rounds: int = None) -> dict:
    """turn_walls of a live and a static engine."""
    return {f"{k}_per_query_wall_s": v for k, v in turn_walls(
        {"live": live, "static": static}, reqs, rounds).items()}


def mapped_requests(reqs, live_ids) -> list:
    """The requests with their training ids mapped into a catalog of the
    rows ``live_ids`` only."""
    return [{**r, "pos_ids": np.searchsorted(live_ids, r["pos_ids"]),
             "neg_ids": np.searchsorted(live_ids, r["neg_ids"])}
            for r in reqs]


def same_as_mapped(outs, outs_m, live_ids, what: str) -> None:
    """A live engine's results equal a monolithic engine's over the
    survivors, ids mapped through the live-id list."""
    for i, (a, b) in enumerate(zip(outs, outs_m)):
        for r in (a, b):
            if isinstance(r, Exception):
                raise r
        if not (np.array_equal(a.ids, live_ids[b.ids])
                and np.array_equal(a.scores, b.scores)):
            raise AssertionError(f"{what}, request {i}: ids/scores differ")


def measure_live_probe(rows3, zlo, zhi, lo, hi, onehot, capacity: int
                       ) -> dict:
    """zone_candidates and box_scan_seg at the live batch's largest probe
    (NZ = the virtual block count): bitwise against their plain versions,
    event ms, device ms warm (a CUDA graph of 30 calls) and cold (the L2
    flushed before each launch), and bounds."""
    import torch
    from repro_torch.kernels import box_scan, ref, zone_prune
    nz, block, d = rows3.shape
    nb, nq = lo.shape[0], onehot.shape[1]
    kz = lambda: zone_prune.zone_candidates(zlo, zhi, lo, hi, capacity)
    pz = lambda: ref.zone_candidates_ref(zlo, zhi, lo, hi, capacity)
    (cand, n_hit), (wc, wn) = kz(), pz()
    torch.cuda.synchronize()
    if not (torch.equal(cand, wc) and torch.equal(n_hit, wn)):
        raise AssertionError(f"zone_candidates NZ={nz}: kernel != plain")
    ks = lambda: box_scan.box_scan_seg_gather(rows3, cand, n_hit, lo, hi,
                                              onehot)
    ps = lambda: ref.box_scan_seg_gather_ref(rows3, cand, n_hit, lo, hi,
                                             onehot)
    seg = compare(ks, ps, f"box_scan_seg NZ={nz}")
    nh = int(n_hit)
    shape = {"nz": nz, "d": d, "boxes": nb, "queries": nq,
             "capacity": capacity, "block": block, "n_hit": nh,
             "ctas": "one" if nz <= ONE_CTA_ZONES else "several"}
    tested = rows3[cand[:min(nh, capacity)].long()].reshape(-1, d)
    bounds = {"zone_candidates": zone_candidates_bound(nz, nb, d, capacity),
              "box_scan_seg": box_scan_bound(
                  tested.shape[0], capacity * block, nb, d, nq,
                  scan_compares(tested, lo, hi)[0])}
    out = {}
    for name, kern, plain, err in (
            ("zone_candidates", kz, pz, 0.0),
            ("box_scan_seg", ks, ps, seg["max_abs_err"])):
        cold, cold_by = cold_device_ms(kern, f"{name}_kernel",
                                       use_profiler=False)
        out[name] = {"exact": True, "max_abs_err": err, "shape": shape,
                     "ms": time_ms(kern), "plain_ms": time_ms(plain),
                     "device_ms": graph_ms(kern), "device_ms_by": "graph",
                     "device_ms_cold": cold, "device_ms_cold_by": cold_by,
                     "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1]}
    return out


def live_knn_inputs(live, pos) -> dict:
    """l2dist's inputs on the live knn path (core/knn._knn_segmented):
    subset 0's queries (the request's positives on its dims) and the live
    rows of its largest segment and of its last delta, gathered from each
    segment's rows3 mirror by the positions the host picks from
    ``valid_host`` and ``perm``."""
    import torch
    view = live._view()
    ix = view.indexes[0]
    q = torch.from_numpy(np.ascontiguousarray(
        view.x[pos][:, ix.dims])).to(live.device)
    sizes = [seg.n_rows for seg in ix.segs]
    out = {}
    for name, j in (("largest_segment", int(np.argmax(sizes))),
                    ("last_delta", len(ix.segs) - 1)):
        seg, off = ix.segs[j], int(ix.offsets[j])
        rows3, _, _ = seg.device_arrays()
        rows = rows3.reshape(-1, rows3.shape[-1])[:seg.n_rows]
        keep = view.valid_host[seg.perm[:seg.n_rows] + off]
        pos_live = torch.from_numpy(np.nonzero(keep)[0]).to(live.device)
        out[name] = (rows.index_select(0, pos_live), q)
    return out


def live_gpu_vs_cpu(device, n: int = MID_N, d: int = FULL_D,
                    n_shards: int = 1) -> dict:
    """The live schedule at ``n`` rows on a GPU engine and the port's CPU
    engine (``n_shards`` of them: the base ceil-split, appends on
    per-shard tails): after the appends, the deletes and the compaction,
    query batches in the default, numpy-fit and dense modes and with
    use_fused=False, and the dtree / rforest / knn queries, bitwise
    (stats included)."""
    from repro_torch.core import SearchEngine
    t0 = time.perf_counter()
    x, assign = clustered(n, d, seed=5)
    reqs = make_requests(assign, 8, 100, seed=6)
    base, passes = live_split(n)
    eg = SearchEngine(x[:base], device=device, live=True, n_shards=n_shards)
    ec = SearchEngine(x[:base], device="cpu", live=True, n_shards=n_shards)

    def check(dead=()):
        for mode in ENGINE_MODES:
            set_mode((eg, ec), mode)
            for mr in (100, None):
                rq = [{**r, "max_results": mr} for r in reqs]
                a = eg.query_batch(rq)
                same_results(a, ec.query_batch(rq))
                if any(np.isin(o.ids, dead).any() for o in a):
                    raise AssertionError(f"{mode}: a tombstoned id came "
                                         f"back")
        set_mode((eg, ec), "default")
        for e in (eg, ec):
            e.use_fused = False
        try:
            rq = [{**r, "max_results": None} for r in reqs]
            same_all(eg.query_batch(rq), ec.query_batch(rq))
        finally:
            for e in (eg, ec):
                e.use_fused = True
        for model in ("dtree", "rforest", "knn"):
            kw = dict(model=model, max_results=None, k_neighbors=1000)
            a = eg.query(reqs[0]["pos_ids"], reqs[0]["neg_ids"], **kw)
            same_all([a], [ec.query(reqs[0]["pos_ids"], reqs[0]["neg_ids"],
                                    **kw)])
            if np.isin(a.ids, dead).any():
                raise AssertionError(f"{model}: a tombstoned id came back")
    for r0, r1 in passes:
        if not np.array_equal(eg.append(x[r0:r1]), ec.append(x[r0:r1])):
            raise AssertionError("append ids differ")
    check()
    dead = live_deletes(n, reqs, eg.query_batch(reqs))
    if eg.delete(dead) != ec.delete(dead):
        raise AssertionError("delete counts differ")
    check(dead)
    for e in (eg, ec):
        e.compact()
    check(dead)
    stg, stc = eg.index_stats(), ec.index_stats()
    for k in ("epoch", "geom", "n_segments", "rows_live", "rows_tombstoned",
              "segments", "n_shards"):
        if stg[k] != stc[k]:
            raise AssertionError(f"live index_stats {k} differ")
    return {"rows": n, "base_rows": base, "appends": len(passes),
            "n_shards": n_shards, "shard_tail_segments":
                stg["shard_tail_segments"],
            "deleted": int(len(dead)), "epoch": stg["epoch"],
            "checked_after": ["appends", "deletes", "compaction"],
            "engine_modes": list(ENGINE_MODES), "use_fused_false": True,
            "models": ["dbranch", "dbens", "dtree", "rforest", "knn"],
            "bitwise_equal": True, "seconds": time.perf_counter() - t0}


def phase_live(device, eng, reqs, k: int = 100):
    """The live catalog at full width (the reference's
    benchmarks/query_time.py run_live): full_size's rows, the first 75 %
    as the base of a live=True engine and the rest appended in 3 passes,
    then held bitwise to the static engine ``eng`` over the same rows;
    1 % tombstoned plus each request's top 3, held to a static engine
    over the survivors, and the scan / knn / use_fused=False paths over
    the tombstones; a background compaction with batches on the old
    snapshot meanwhile, held again. Returns the live path's launch counts
    and the kernels measured at its largest probe."""
    import torch
    from repro_torch.core import SearchEngine
    from repro_torch.kernels import box_scan, l2dist, zone_prune
    t_phase = time.perf_counter()
    x = eng.x
    n, d = x.shape
    base, passes = live_split(n)
    t0 = time.perf_counter()
    live = SearchEngine(x[:base], device=device, live=True)
    base_build_s = time.perf_counter() - t0
    cat = live._catalog
    reqs_base = base_requests(reqs, base)
    mirror_s, q_s, _ = first_query(live, reqs_base)
    appends = [{"pass": 0, "rows": base, "build_s": base_build_s,
                "first_query_mirrors_s": mirror_s,
                "first_query_batch_s": q_s}]
    outs_after = []
    for i, (r0, r1) in enumerate(passes, 1):
        rec, outs = append_pass(live, x[r0:r1], reqs_base)
        appends.append({"pass": i, **rec})
        outs_after.append(outs)
    nz = live.indexes[0].n_blocks
    if n == FULL_N and nz != LIVE_FULL_ZONES:
        raise AssertionError(f"{nz} virtual zones, not {LIVE_FULL_ZONES}")
    # 1. after the appends: bitwise the static engine over the same rows
    outs_a, _, peak_a = timed_batch(live, reqs)
    outs_s, _, peak_s = timed_batch(eng, reqs)
    same_ranked(outs_a, outs_s, "live after the appends != static")
    walls_a = paired_walls(live, eng, reqs)
    _, syncs_live = host_syncs(lambda: live.query_batch(reqs))
    _, syncs_static = host_syncs(lambda: eng.query_batch(reqs))
    if syncs_live != syncs_static:
        raise AssertionError(f"host syncs of a warm batch: live "
                             f"{syncs_live} != static {syncs_static}")
    # the live path's launches: counts set to 0 just before the batch
    torch.cuda.synchronize()
    zone_prune.launches = zone_prune.candidates_launches = 0
    box_scan.seg_launches = 0
    live.query_batch(reqs)
    torch.cuda.synchronize()
    launches = {"zone_candidates": zone_prune.candidates_launches,
                "box_scan_seg": box_scan.seg_launches}
    if min(launches.values()) <= 0 or \
            zone_prune.launches != zone_prune.candidates_launches:
        raise AssertionError(f"live batch launches {launches}")
    prof = profile_batch(lambda: live.query_batch(reqs), {
        "zone_candidates_kernel": lambda: zone_prune.candidates_launches,
        "box_scan_seg_kernel": lambda: box_scan.seg_launches})
    bytes_appended = live.index_stats()["device_bytes"]
    probe = measure_live_probe(*largest_probe(probe_inputs(live, reqs)))
    # 2. the deletes: bitwise a static engine over the survivors
    dead = live_deletes(n, reqs, outs_a)
    t0 = time.perf_counter()
    n_dead = live.delete(dead)
    delete_s = time.perf_counter() - t0
    mirror_s, q_s, _ = first_query(live, reqs)
    after_delete = {"first_query_mirrors_s": mirror_s,
                    "first_query_batch_s": q_s}
    outs_d, _, peak_d = timed_batch(live, reqs)
    walls_d = paired_walls(live, eng, reqs)
    full_d = live.query_batch([{**r, "max_results": None} for r in reqs])
    for o in outs_d + full_d:
        if np.isin(o.ids, dead).any():
            raise AssertionError("a tombstoned id came back")
    live_ids = np.nonzero(live._catalog.snapshot().valid_host)[0]
    t0 = time.perf_counter()
    mono = SearchEngine(x[live_ids], device=device)
    mono_build_s = time.perf_counter() - t0
    mreqs = mapped_requests(reqs, live_ids)
    same_as_mapped(outs_d, mono.query_batch(mreqs), live_ids,
                   "live after the deletes != static over the survivors")
    same_as_mapped(full_d, mono.query_batch(
        [{**r, "max_results": None} for r in mreqs]), live_ids,
        "live after the deletes != static over the survivors, "
        "max_results=None")
    # the scan and knn models over the tombstones, held to the survivor
    # engine too, and use_fused=False
    pos, neg = reqs[0]["pos_ids"], reqs[0]["neg_ids"]
    kw = dict(max_results=k, n_models=25, k_neighbors=1000)
    box_scan.scan_launches = l2dist.launches = 0
    scan_knn, scan_res = {}, []
    for m in ("dtree", "rforest", "knn"):
        t0 = time.perf_counter()
        r = live.query(pos, neg, model=m, **kw)
        torch.cuda.synchronize()
        if r.n_found == 0 or np.isin(r.ids, dead).any():
            raise AssertionError(f"{m}: empty, or a tombstoned id")
        scan_knn[m] = {"wall_s": time.perf_counter() - t0,
                       "n_found": r.n_found}
        scan_res.append(r)
    scan_launches = {"box_scan": box_scan.scan_launches,
                     "l2dist": l2dist.launches}
    if min(scan_launches.values()) <= 0:
        raise AssertionError(f"live scan/knn launches {scan_launches}")
    for m, r in zip(("dtree", "rforest", "knn"), scan_res):
        same_as_mapped([r], [mono.query(mreqs[0]["pos_ids"],
                                        mreqs[0]["neg_ids"], model=m, **kw)],
                       live_ids, f"live {m} != static over the survivors")
    del mono
    # l2dist bitwise against its plain version at the live knn's shapes
    probe["l2dist"] = {name: measure_l2dist(*inp, plain_device=False,
                                            profile=False)
                       for name, inp in live_knn_inputs(live, pos).items()}
    live.use_fused = False
    box_scan.scan_launches = zone_prune.launches = 0
    zone_prune.candidates_launches = 0
    try:
        t0 = time.perf_counter()
        oracle = live.query_batch([{**r, "max_results": None}
                                   for r in reqs])
        oracle_s = time.perf_counter() - t0
    finally:
        live.use_fused = True
    oracle_launches = {"zone_prune": zone_prune.launches
                       - zone_prune.candidates_launches,
                       "box_scan": box_scan.scan_launches}
    if min(oracle_launches.values()) <= 0:
        raise AssertionError(f"live oracle launches {oracle_launches}")
    same_ranked(oracle, full_d, "live use_fused=False != fused")
    # 3. a background compaction, batches on the old snapshot meanwhile
    during, epochs, merged = [], [], []
    compact = cat.compact
    cat.compact = lambda: merged.append(compact()) or merged[-1]
    with kernel_threads() as calls:
        import threading
        main_thread = threading.get_ident()
        epoch0 = cat.epoch
        t0 = time.perf_counter()
        th = live.compact(background=True)
        while th.is_alive():
            epochs.append(cat.epoch)
            during.append(live.query_batch(reqs))
            time.sleep(LIVE_COMPACT_PACE_S)
        th.join(timeout=600)
        compact_wall_s = time.perf_counter() - t0
    if th.is_alive():
        raise AssertionError("the compaction did not finish")
    if {t for _, t in calls} - {main_thread}:
        raise AssertionError("the merge thread launched a kernel")
    if not epochs or epochs[0] != epoch0:
        raise AssertionError("no batch ran on the old snapshot")
    for outs in during:
        same_ranked(outs, outs_d, "a batch during the compaction")
    # hints observed under generation 0 after the swap's prune come from
    # a batch bound to the old snapshot that ended after it; the table
    # keeps them until the next prune, as the reference's does
    late = {key for key in live._cap_hints if key[0] != 1}
    mirror_s, q_s, _ = first_query(live, reqs)
    after_compact = {"first_query_mirrors_s": mirror_s,
                     "first_query_batch_s": q_s}
    hints = set(live._cap_hints)
    if {key[0] for key in late} - {0} or not hints - late or \
            any(key[0] != 1 for key in hints - late):
        raise AssertionError(f"compaction: hint generations "
                             f"{sorted({k[0] for k in hints})}, late "
                             f"{sorted(late)}")
    outs_c, _, peak_c = timed_batch(live, reqs)
    walls_c = paired_walls(live, eng, reqs)
    same_ranked(outs_c, outs_d, "live after the compaction")
    st = live.index_stats()
    if st["n_segments"] != 1 or st["geom"] != 1:
        raise AssertionError(f"compaction: {st['n_segments']} segments, "
                             f"generation {st['geom']}")
    emit({"phase": "live", "rows": n, "dims": d, "base_rows": base,
          "virtual_zones": nz, "batch": len(reqs),
          "appends": appends,
          "wall_by": f"median of {LIVE_WALL_ROUNDS} warm batches, live "
                     f"and static in turns",
          "after_appends": {
              **walls_a,
              "max_memory_allocated": peak_a,
              "static_max_memory_allocated": peak_s,
              "device_bytes": bytes_appended,
              "n_host_syncs": outs_a[0].stats["batch_n_host_syncs"],
              "host_syncs_by_site": syncs_live,
              "static_host_syncs_by_site": syncs_static,
              "launches": launches, "profile": prof,
              "bitwise_equal_static": True},
          "deletes": {"rows": n_dead, "delete_s": delete_s,
                      **after_delete, **walls_d,
                      "max_memory_allocated": peak_d,
                      "survivor_engine_build_s": mono_build_s,
                      "bitwise_equal_static_over_survivors": True,
                      "scan_knn": scan_knn, "scan_knn_launches":
                          scan_launches,
                      "use_fused_false": {
                          "per_query_wall_s": oracle_s / len(reqs),
                          "launches": oracle_launches,
                          "ids_equal_fused": True}},
          "compaction": {"wall_s": compact_wall_s,
                         "compact_s": merged[0]["compact_s"],
                         "batches_during": len(during),
                         "on_old_snapshot": sum(e == epoch0
                                                for e in epochs),
                         "kernel_calls_during": len(calls),
                         "late_generation_0_hints": len(late),
                         "merge_thread_kernel_calls": 0,
                         **after_compact, **walls_c,
                         "max_memory_allocated": peak_c,
                         "device_bytes": st["device_bytes"],
                         "bitwise_equal_before": True},
          "seconds": time.perf_counter() - t_phase})
    return ({**launches, "box_scan": scan_launches["box_scan"],
             "l2dist": scan_launches["l2dist"],
             "zone_prune": oracle_launches["zone_prune"],
             "box_scan_oracle": oracle_launches["box_scan"]}, probe,
            {"appends": appends[1:], "outs_after": outs_after})


# the durable live catalog: its data_dir under build/ (listed in
# .gitignore); the wal_commit crash fires at the second record, so pass
# 2's record lands and its snapshot swap does not
DURABLE_DIR = ROOT / "build" / "durable_catalog"
DURABLE_SYNC = "batch"
DURABLE_CRASH_CALL = 2
# the SIGKILL child: MID_N rows (base and rounds as live_split's), each
# round appends DURABLE_ROUND_ROWS rows, deletes one and queries; killed
# once DURABLE_CHILD_ROUNDS rounds have printed, after DURABLE_GRACE_S
DURABLE_ROUND_ROWS = 512
DURABLE_CHILD_ROUNDS = 4
DURABLE_GRACE_S = 0.05
DURABLE_CHILD_TIMEOUT_S = 300
# the sync modes at MID_N rows: live_split's tail in this many appends,
# each mode (and the memory-only catalog, first and last) timed in turn
SYNC_APPENDS = 4               # 8 before the 1,000 s cut
SYNC_MODES = ("none", "batch", "always")


def dir_bytes(path) -> int:
    """Bytes of every file under ``path`` (a file removed while it is
    walked counts 0)."""
    total = 0
    for p in Path(path).rglob("*"):
        try:
            if p.is_file():
                total += p.stat().st_size
        except OSError:
            pass
    return total


@contextlib.contextmanager
def recorded_checkpoints():
    """Record every SegmentedCatalog.checkpoint() made inside: its result
    (``checkpoint_s`` among it) and its thread."""
    import threading
    from repro_torch.core.segments import SegmentedCatalog
    calls = []
    orig = SegmentedCatalog.checkpoint

    def rec(self):
        out = orig(self)
        calls.append({**out, "thread": threading.get_ident()})
        return out
    SegmentedCatalog.checkpoint = rec
    try:
        yield calls
    finally:
        SegmentedCatalog.checkpoint = orig


@contextlib.contextmanager
def replay_timer():
    """Time every SegmentedCatalog.append / delete made inside (the WAL
    tail's replay during a recovery): yields [seconds]."""
    from repro_torch.core.segments import SegmentedCatalog
    walls, saved = [], {}
    for name in ("append", "delete"):
        orig = saved[name] = getattr(SegmentedCatalog, name)

        def timed(self, arg, _orig=orig):
            t = time.perf_counter()
            try:
                return _orig(self, arg)
            finally:
                walls.append(time.perf_counter() - t)
        setattr(SegmentedCatalog, name, timed)
    try:
        yield walls
    finally:
        for name, orig in saved.items():
            setattr(SegmentedCatalog, name, orig)


def memory_appends(device, x, reqs_base) -> dict:
    """The memory-only live engine's appends of live_split's passes (what
    phase_live reports), for ``--only durable``: each pass's record and
    the first batch after it."""
    from repro_torch.core import SearchEngine
    base, passes = live_split(len(x))
    live = SearchEngine(x[:base], device=device, live=True)
    first_query(live, reqs_base)
    appends, outs_after = [], []
    for i, (r0, r1) in enumerate(passes, 1):
        rec, outs = append_pass(live, x[r0:r1], reqs_base)
        appends.append({"pass": i, **rec})
        outs_after.append(outs)
    return {"appends": appends, "outs_after": outs_after}


def small_catalog():
    """The SIGKILL child's and the sync modes' catalog: MID_N x FULL_D
    clustered rows (seed 5) and a batch of 8 over the base's rows."""
    x, assign = clustered(MID_N, FULL_D, seed=5)
    base, _ = live_split(MID_N)
    return x, base_requests(make_requests(assign, 8, 100, seed=6), base)


def child_round(x, base: int, i: int):
    """Round i of the SIGKILL child: DURABLE_ROUND_ROWS new rows (base
    rows drawn with replacement plus the clusters' noise) and one base id
    to delete, from seed 100 + i."""
    rng = np.random.default_rng(100 + i)
    rows = x[rng.integers(0, base, DURABLE_ROUND_ROWS)] + rng.standard_normal(
        (DURABLE_ROUND_ROWS, x.shape[1]), dtype=np.float32) * np.float32(0.3)
    return rows.astype(np.float32), [int(rng.integers(0, base))]


def durable_child(data_dir: str, device: str) -> None:
    """The SIGKILL target, run in a child process: a durable engine on
    ``device`` (the card) over the small catalog's base, then rounds of
    (append, delete, query batch) until killed. Prints READY, then ROUND
    i."""
    from repro_torch.core import SearchEngine
    x, reqs = small_catalog()
    base, _ = live_split(MID_N)
    eng = SearchEngine(x[:base], device=device, live=True,
                       data_dir=data_dir, wal_sync=DURABLE_SYNC)
    print("READY", flush=True)
    i = 0
    while True:
        rows, dead = child_round(x, base, i)
        eng.append(rows)
        eng.delete(dead)
        for o in eng.query_batch(reqs):
            if isinstance(o, Exception):
                raise o
        i += 1
        print("ROUND", i, flush=True)


def sigkill_recovery(device) -> dict:
    """A child process ingests into a durable engine on the card and is
    SIGKILLed mid-loop; the card recovers a consistent prefix (clean, or
    typed-torn with salvage), whose batch is bitwise (ids, scores, integer
    stats, cold against cold) a CPU engine rebuilt from that prefix."""
    import shutil
    import signal
    import threading
    from repro_torch.core import SearchEngine
    d = DURABLE_DIR.parent / "durable_sigkill"
    shutil.rmtree(d, ignore_errors=True)
    err_path = DURABLE_DIR.parent / "durable_child.err"
    code = ("import sys; sys.path.insert(0, sys.argv[3]); import chip_smoke; "
            "chip_smoke.durable_child(sys.argv[1], sys.argv[2])")
    t0 = time.perf_counter()
    with open(err_path, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, str(d), str(device), str(ROOT)],
            stdout=subprocess.PIPE, stderr=err, cwd=ROOT)
    watchdog = threading.Timer(DURABLE_CHILD_TIMEOUT_S, proc.kill)
    watchdog.start()
    rounds_seen = 0
    try:
        while rounds_seen < DURABLE_CHILD_ROUNDS:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError("the durable child died: " + err_path
                                     .read_text(errors="replace")[-2000:])
            if line.startswith(b"ROUND"):
                rounds_seen = int(line.split()[1])
        time.sleep(DURABLE_GRACE_S)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
        watchdog.cancel()
        proc.stdout.close()
    child_s = time.perf_counter() - t0
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"the child exited {proc.returncode}, not by "
                             f"SIGKILL")
    t0 = time.perf_counter()
    rec = SearchEngine(None, live=True, data_dir=d, device=device)
    open_s = time.perf_counter() - t0
    rep = rec.recovery
    if not (rep.clean or (rep.torn_tail and rep.quarantined)):
        raise AssertionError(f"SIGKILL recovery: {rep.errors}")
    x, reqs = small_catalog()
    base, _ = live_split(MID_N)
    k, rem = divmod(rec.n - base, DURABLE_ROUND_ROWS)
    if rem or k < 0 or rep.replayed_appends != k or \
            rep.replayed_deletes > k or \
            rep.last_lsn != k + rep.replayed_deletes:
        raise AssertionError(f"SIGKILL recovery is not a prefix: {rec.n} "
                             f"rows, {rep}")
    # the same prefix rebuilt on the CPU: the script's rounds up to the
    # recovered LSN (a delete of a dead row takes none)
    cpu = SearchEngine(x[:base], device="cpu", live=True)
    target, i = rec._catalog._lsn, 0
    while cpu._catalog._lsn < target:
        rows, dead = child_round(x, base, i)
        cpu.append(rows)
        if cpu._catalog._lsn < target:
            cpu.delete(dead)
        i += 1
    sg, sc = rec._catalog.snapshot(), cpu._catalog.snapshot()
    if not (sg.n == sc.n and sg.live_rows == sc.live_rows
            and np.array_equal(sg.valid_host, sc.valid_host)
            and np.array_equal(sg.x, sc.x)):
        raise AssertionError("SIGKILL recovery != the rebuilt prefix")
    t0 = time.perf_counter()
    same_results(rec.query_batch(reqs), cpu.query_batch(reqs))
    batch_s = time.perf_counter() - t0
    rec.close()
    err_path.unlink(missing_ok=True)
    out = {"rows": MID_N, "base_rows": base, "child_rounds_seen": rounds_seen,
           "rounds_recovered": k, "recovered_rows": int(rec.n),
           "clean": rep.clean, "torn_tail": rep.torn_tail,
           "quarantined": rep.quarantined,
           "replayed_appends": rep.replayed_appends,
           "replayed_deletes": rep.replayed_deletes,
           "last_lsn": rep.last_lsn, "child_s": child_s,
           "open_s": open_s, "gpu_and_cpu_batch_s": batch_s,
           "bitwise_equal_cpu_rebuild": True}
    shutil.rmtree(d, ignore_errors=True)
    return out


def sync_modes(device) -> dict:
    """The three WAL sync modes at MID_N rows: the genesis checkpoint,
    SYNC_APPENDS appends of live_split's tail, a delete, a checkpoint and
    close, each mode beside the memory-only catalog (timed first and last)
    in one process; each mode's median append over the mean of the two
    memory-only medians (the reference's benchmarks/recovery_time.py
    prices the median append)."""
    import shutil
    import torch
    from repro_torch.core import SearchEngine
    x, _ = clustered(MID_N, FULL_D, seed=5)
    base, _ = live_split(MID_N)
    chunks = np.array_split(np.arange(base, MID_N), SYNC_APPENDS)
    runs = []
    for mode in (None,) + SYNC_MODES + (None,):
        d = DURABLE_DIR.parent / f"durable_sync_{mode}"
        shutil.rmtree(d, ignore_errors=True)
        kw = {} if mode is None else {"data_dir": d, "wal_sync": mode}
        with recorded_checkpoints() as ckpts:
            t0 = time.perf_counter()
            e = SearchEngine(x[:base], device=device, live=True, **kw)
            build_s = time.perf_counter() - t0
        walls = []
        for c in chunks:
            t0 = time.perf_counter()
            e.append(x[c])
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        e.delete(np.arange(0, base, 97))
        delete_s = time.perf_counter() - t0
        run = {"mode": mode or "memory", "build_s": build_s,
               "append_s": walls, "append_s_median": float(np.median(walls)),
               "delete_s": delete_s}
        if mode is not None:
            run["genesis_checkpoint_s"] = ckpts[0]["checkpoint_s"]
            run["checkpoint_s"] = e.checkpoint()["checkpoint_s"]
            t0 = time.perf_counter()
            e.close()
            run["close_s"] = time.perf_counter() - t0
            run["durable"] = e.index_stats()["durable"]
            shutil.rmtree(d, ignore_errors=True)
        runs.append(run)
        del e
        torch.cuda.synchronize()
    mem = (runs[0]["append_s_median"] + runs[-1]["append_s_median"]) / 2
    return {"rows": MID_N, "base_rows": base, "appends": SYNC_APPENDS,
            "append_rows": int(len(chunks[0])), "runs": runs,
            "append_ratio_to_memory": {r["mode"]: r["append_s_median"] / mem
                                       for r in runs[1:-1]}}


def phase_durable(device, eng, reqs, memory, k: int = 100) -> dict:
    """The durable live catalog at full width: full_size's rows, the
    first 75 % as the base of a ``live=True, data_dir=...`` engine on the
    card (``wal_sync="batch"``, the genesis checkpoint timed) with a
    wal_commit crash armed; pass 1 appended, pass 2 crashing between its
    durable WAL record and the snapshot swap. Recovery replays both
    appends, bitwise (ids, scores) the memory-only live engine after two
    appends (``memory``, from phase_live or memory_appends). Then pass 3,
    bitwise the static engine ``eng``; a checkpoint(); a background
    compaction with batches served meanwhile (its checkpoint written on
    the merge thread); the live phase's deletes; close(). Recovery again
    (the deletes replay from the WAL): its open() wall beside the static
    build, the first batch's mirrors and wall, the zone_candidates /
    box_scan_seg counters moving during it, then a warm batch bitwise
    (ids, scores, integer stats) the engine's before close(), and dtree /
    rforest / knn bitwise. Then the SIGKILL child and the sync modes at
    MID_N rows. Returns the recovered batch's launch counts."""
    import shutil
    import threading
    import torch
    from repro_torch.core import SearchEngine
    from repro_torch.core.errors import InjectedCrash
    from repro_torch.kernels import box_scan, zone_prune
    from repro_torch.serve import FaultInjector, FaultSpec
    t_phase = time.perf_counter()
    x = eng.x
    n, d = x.shape
    base, passes = live_split(n)
    reqs_base = base_requests(reqs, base)
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    DURABLE_DIR.mkdir(parents=True)
    emit({"phase": "durable_disk", "dir": str(DURABLE_DIR.relative_to(ROOT)),
          "free_bytes": shutil.disk_usage(DURABLE_DIR).free})
    disk = {}
    # 1. genesis, with the crash armed
    inj = FaultInjector(specs=[FaultSpec("wal_commit", "crash",
                                         at_calls=(DURABLE_CRASH_CALL,))])
    with recorded_checkpoints() as ckpts:
        t0 = time.perf_counter()
        dur = SearchEngine(x[:base], device=device, live=True,
                           data_dir=DURABLE_DIR, wal_sync=DURABLE_SYNC,
                           faults=inj)
        build_s = time.perf_counter() - t0
    genesis_s = ckpts[0]["checkpoint_s"]
    disk["genesis"] = dir_bytes(DURABLE_DIR)
    first_query(dur, reqs_base)
    # 2. pass 1; pass 2 crashes after its record is durable
    rec1, _ = append_pass(dur, x[slice(*passes[0])], reqs_base)
    t0 = time.perf_counter()
    try:
        dur.append(x[slice(*passes[1])])
    except InjectedCrash:
        crash_s = time.perf_counter() - t0
    else:
        raise AssertionError("the wal_commit crash did not fire")
    if dur._catalog.snapshot().n != passes[0][1]:
        raise AssertionError("the crashed append swapped its snapshot in")
    disk["after_crash"] = dir_bytes(DURABLE_DIR)
    del dur
    # 3. recovery: the WAL tail replays both appends
    with replay_timer() as replay1:
        t0 = time.perf_counter()
        live = SearchEngine(None, live=True, data_dir=DURABLE_DIR,
                            device=device, wal_sync=DURABLE_SYNC)
        open1_s = time.perf_counter() - t0
    rep1 = live.recovery
    if not rep1.clean or rep1.replayed_appends != 2 or \
            live.n != passes[1][1]:
        raise AssertionError(f"crash recovery: {live.n} rows, {rep1}")
    mirror1_s, q1_s, outs = first_query(live, reqs_base)
    same_ranked(outs, memory["outs_after"][1],
                "recovered after the crash != the live engine after two "
                "appends")
    # 4. pass 3 on the recovered engine; bitwise the static engine
    rec3, _ = append_pass(live, x[slice(*passes[2])], reqs_base)
    outs_a, _, _ = timed_batch(live, reqs)
    same_ranked(outs_a, eng.query_batch(reqs),
                "recovered + pass 3 != static")
    disk["after_appends"] = dir_bytes(DURABLE_DIR)
    # 5. a checkpoint of the four segments
    ck = live.checkpoint()
    disk["checkpoint"] = dir_bytes(DURABLE_DIR)
    # 6. a background compaction, batches served meanwhile; its checkpoint
    # is written on the merge thread (file I/O only)
    cat = live._catalog
    during, peak_disk = [], disk["checkpoint"]
    with recorded_checkpoints() as ckpts, kernel_threads() as calls:
        main_thread = threading.get_ident()
        epoch0 = cat.epoch
        t0 = time.perf_counter()
        th = live.compact(background=True)
        while th.is_alive():
            epoch = cat.epoch
            torch.cuda.synchronize()
            tb = time.perf_counter()
            o = live.query_batch(reqs)
            torch.cuda.synchronize()
            during.append((epoch, time.perf_counter() - tb, o))
            peak_disk = max(peak_disk, dir_bytes(DURABLE_DIR))
            time.sleep(LIVE_COMPACT_PACE_S)
        th.join(timeout=600)
        compact_wall_s = time.perf_counter() - t0
    if th.is_alive():
        raise AssertionError("the compaction did not finish")
    if {t for _, t in calls} - {main_thread}:
        raise AssertionError("the merge thread launched a kernel")
    if len(ckpts) != 1 or ckpts[0]["thread"] == main_thread:
        raise AssertionError("the compaction's checkpoint was not written "
                             "once on the merge thread")
    for _, _, o in during:
        same_ranked(o, outs_a, "a batch during the durable compaction")
    disk["compaction"] = dir_bytes(DURABLE_DIR)
    # 7. the live phase's deletes, into the WAL only
    dead = live_deletes(n, reqs, outs_a)
    t0 = time.perf_counter()
    n_dead = live.delete(dead)
    delete_s = time.perf_counter() - t0
    # 8. the engine before close(): a warm batch, the scan / knn models
    live.query_batch(reqs)
    before = live.query_batch(reqs)
    pos, neg = reqs[0]["pos_ids"], reqs[0]["neg_ids"]
    kw = dict(max_results=k, n_models=25, k_neighbors=1000)
    models_before = [live.query(pos, neg, model=m, **kw)
                     for m in ("dtree", "rforest", "knn")]
    ledger = cat.durability_snapshot()
    t0 = time.perf_counter()
    live.close()
    close_s = time.perf_counter() - t0
    disk["closed"] = dir_bytes(DURABLE_DIR)
    del live, cat
    # 9. recovery onto the card, the deletes replayed from the WAL
    torch.cuda.synchronize()
    with replay_timer() as replay:
        t0 = time.perf_counter()
        rec = SearchEngine(None, live=True, data_dir=DURABLE_DIR,
                           device=device)
        open_s = time.perf_counter() - t0
    rep = rec.recovery
    if not rep.clean or rep.replayed_deletes != 1 or rep.replayed_appends:
        raise AssertionError(f"recovery after close(): {rep}")
    if rec.index_stats()["device_bytes"]["total"]:
        raise AssertionError("recovery uploaded mirrors before a query")
    torch.cuda.synchronize()
    zone_prune.launches = zone_prune.candidates_launches = 0
    box_scan.seg_launches = 0
    mirror_s, q_s, first = first_query(rec, reqs)
    torch.cuda.synchronize()
    launches = {"zone_candidates": zone_prune.candidates_launches,
                "box_scan_seg": box_scan.seg_launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the recovered batch launched {launches}")
    same_ranked(first, before, "recovered cold batch != before close()")
    warm, _, peak = timed_batch(rec, reqs)
    same_results(warm, before)
    walls = paired_walls(rec, eng, reqs)
    same_all([rec.query(pos, neg, model=m, **kw)
              for m in ("dtree", "rforest", "knn")], models_before)
    for o in warm:
        if np.isin(o.ids, dead).any():
            raise AssertionError("a tombstoned id came back")
    rec.close()
    del rec
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    mem = {r["pass"]: r for r in memory["appends"]}
    append_rows = [
        {"pass": 1, "durable": rec1, "memory": mem[1],
         "ratio": rec1["append_s"] / mem[1]["append_s"]},
        {"pass": 2, "durable": {"crashed_s": crash_s,
                                "replayed_by_recovery": True},
         "memory": mem[2]},
        {"pass": 3, "durable": rec3, "memory": mem[3],
         "ratio": rec3["append_s"] / mem[3]["append_s"]}]
    out = {"phase": "durable", "rows": n, "dims": d, "base_rows": base,
           "sync": DURABLE_SYNC, "build_s": build_s,
           "genesis_checkpoint_s": genesis_s,
           "static_build_s": eng.build_time_s, "appends": append_rows,
           "crash": {"site": "wal_commit", "call": DURABLE_CRASH_CALL,
                     "open_s": open1_s, "report": _report_json(rep1),
                     "replay_s": sum(replay1),
                     "replay_rows_per_s": rep1.replayed_rows
                     / max(sum(replay1), 1e-9),
                     "first_query_mirrors_s": mirror1_s,
                     "first_query_batch_s": q1_s,
                     "bitwise_equal_live_after_2_appends": True},
           "checkpoint": ck,
           "compaction": {
               "wall_s": compact_wall_s, "batches_during": len(during),
               "on_old_snapshot": sum(e == epoch0 for e, _, _ in during),
               "batch_walls_before_swap_s": [w for e, w, _ in during
                                             if e == epoch0],
               "batch_walls_after_swap_s": [w for e, w, _ in during
                                            if e != epoch0],
               "checkpoint_s": ckpts[0]["checkpoint_s"],
               "checkpoint_on_merge_thread": True,
               "merge_thread_kernel_calls": 0,
               "bitwise_equal_before": True},
           "deletes": {"rows": n_dead, "delete_s": delete_s},
           "ledger_before_close": ledger, "close_s": close_s,
           "disk_bytes": disk, "disk_bytes_peak_sampled": peak_disk,
           "recovery": {"open_s": open_s, "report": _report_json(rep),
                        "replay_s": sum(replay),
                        "replay_deleted_rows_per_s":
                            n_dead / max(sum(replay), 1e-9),
                        "open_over_static_build": open_s / eng.build_time_s,
                        "first_query_mirrors_s": mirror_s,
                        "first_query_batch_s": q_s,
                        "warm_per_query_wall_s":
                            walls["live_per_query_wall_s"],
                        "static_per_query_wall_s":
                            walls["static_per_query_wall_s"],
                        "wall_by": f"median of {LIVE_WALL_ROUNDS} warm "
                                   f"batches, recovered and static in "
                                   f"turns",
                        "max_memory_allocated": peak,
                        "launches": launches,
                        "bitwise_equal_before_close": True,
                        "models_bitwise": ["dtree", "rforest", "knn"]}}
    out["sigkill"] = sigkill_recovery(device)
    out["sync_modes"] = sync_modes(device)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return launches


def _report_json(rep) -> dict:
    """A RecoveryReport as plain JSON."""
    import dataclasses
    return dataclasses.asdict(rep)


def phase_durable_only(device) -> None:
    """``--only durable``: full_size's static engine (one warm batch), the
    memory-only live engine's appends (what phase_live reports), then the
    durable phase."""
    eng, reqs, _, _ = full_engine(device, FULL_N, FULL_D, 100)
    eng.query_batch(reqs)
    base, _ = live_split(FULL_N)
    memory = memory_appends(device, eng.x, base_requests(reqs, base))
    launches = phase_durable(device, eng, reqs, memory)
    emit({"phase": "durable_kernels", "launches": launches})


MAIN_WALL_BATCHES = 21


def phase_main_wall(device) -> None:
    """``--only main_wall``: full_size's static engine and batch of 8,
    three warm-up batches, then the per-query wall of MAIN_WALL_BATCHES
    warm batches one after another (median, quartiles, all) and the sync
    warnings of one more by call site. It uses only the engine's static
    query API, so an older tree runs it too: run parent, change, change,
    parent in one call to compare the main path's wall."""
    import torch
    eng, reqs, _, build_s = full_engine(device, FULL_N, FULL_D, 100)
    for _ in range(3):
        eng.query_batch(reqs)
    walls = []
    for _ in range(MAIN_WALL_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.query_batch(reqs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / len(reqs))
    for o in outs:
        if isinstance(o, Exception):
            raise o
    # a site may warn more than once here (an older tree's pageable
    # uploads)
    _, syncs = sync_warnings(lambda: eng.query_batch(reqs))
    q1, med, q3 = np.percentile(walls, [25, 50, 75])
    emit({"phase": "main_wall", "tree": str(ROOT), "build_s": build_s,
          "batches": len(walls), "per_query_wall_s_median": float(med),
          "per_query_wall_s_q1": float(q1), "per_query_wall_s_q3": float(q3),
          "per_query_wall_s": walls, "sync_warnings_by_site": syncs,
          "ids_digest": int(sum(int(o.ids[:10].sum()) for o in outs))})


def phase_live_only(device) -> None:
    """``--only live``: full_size's static engine (one warm batch), the
    live phase against it, and the live GPU-vs-CPU schedule."""
    eng, reqs, _, _ = full_engine(device, FULL_N, FULL_D, 100)
    eng.query_batch(reqs)
    launches, probe, _ = phase_live(device, eng, reqs)
    emit({"phase": "live_kernels", "launches": launches, "probe": probe})
    emit({"phase": "gpu_vs_cpu_live", **live_gpu_vs_cpu(device)})


def phase_fit(device, eng=None, reqs=None, main_fit=None) -> None:
    """The batched device fit at full size (``--only fit``): full_size's
    batch of 8 (4 dbranch over 32 subsets, 4 dbens of 25 models x 5
    candidates) through ``_fit_boxes_batched`` on the card and on a CPU
    engine over the same state (from_arrays): lo_c, hi_c and the [2, G]
    meta bitwise, and each request's winners bitwise the numpy trainers'
    (the same subsets, the same boxes as a set); then timed warm
    (fit_measure; ``main_fit`` is full_size's, taken on the same engine).
    The same for deep_requests' batch, whose lanes outlive round 1, so the
    survivor round runs on the card."""
    import torch
    from repro_torch.core import SearchEngine
    if eng is None:
        eng, reqs, _, _ = full_engine(device, FULL_N, FULL_D, 100)
    cpu = SearchEngine.from_arrays(
        eng.x, eng.subsets,
        [{f: getattr(ix, f) for f in INDEX_FIELDS} for ix in eng.indexes],
        eng.frange, device="cpu")
    res = {"phase": "fit", "rows": eng.n, "dims": eng.d,
           "subsets": int(eng.subsets.shape[0]), "requests": len(reqs)}
    for name, rq in (("batch", reqs), ("deep", deep_requests(reqs))):
        with fit_recorder() as fg:
            batched_fit(eng, rq)
        t0 = time.perf_counter()
        with fit_recorder() as fc:
            batched_fit(cpu, rq)
        cpu_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        for what, a, b in zip(("lo_c", "hi_c", "meta"), fg[0]["out"],
                              fc[0]["out"]):
            if not (a.dtype == b.dtype and torch.equal(a.cpu(), b)):
                raise AssertionError(f"fit {name}: {what} on the card != "
                                     f"on the CPU")
        winners, numpy_s = same_fit_as_numpy(eng, rq)
        meas = (main_fit if name == "batch" and main_fit is not None
                else fit_measure(eng, rq))
        if name == "deep" and meas["round2_bucket"] == 0:
            raise AssertionError("the deep batch never reached round 2")
        res[name] = {**meas, "gpu_equals_cpu": True, "cpu_fit_s": cpu_s,
                     "winners_equal_numpy": winners,
                     "numpy_trainers_s": numpy_s,
                     "meta_groups": int(fg[0]["out"][2].shape[1])}
    emit(res)


def rforest_boxes(x, pos, neg):
    """The boxes of the rforest query's forest (25 trees, depth 12) over
    the catalog ``x``."""
    from repro_torch.core.trees import fit_random_forest
    forest = fit_random_forest(
        np.concatenate([x[pos], x[neg]]),
        np.concatenate([np.ones(len(pos)), np.zeros(len(neg))]),
        n_trees=25, max_depth=12, seed=0)
    return forest.boxes()


def phase_box_scan(device) -> None:
    """Rows 2-3 of the kernel table alone, at full size: the main path's
    engine after one batch, the fused batch's largest probe (box_scan_seg
    and zone_prune, warm and cold), rforest's boxes over the 1,048,576 x
    384 features and the use_fused=False batch's largest query_index
    call (box_scan), and the synthetic 1,048,576 x 384 x 64 and
    1,048,576 x 6 x 64 scans. For comparing two trees' kernels on one
    card."""
    import torch
    eng, reqs, _, build_s = full_engine(device, FULL_N, FULL_D, 100)
    eng.query_batch(reqs)         # the capacity hints phase_full's probe has
    probe = largest_probe(probe_inputs(eng, reqs))
    pos, neg = reqs[0]["pos_ids"], reqs[0]["neg_ids"]
    scan_in = (eng._device_features(), *(torch.from_numpy(a).to(eng.device)
                                         for a in rforest_boxes(eng.x, pos,
                                                                neg)))
    qi_in, mask_in = largest_query_index(eng, reqs)
    res = measure_kernels(*probe, mask_in=mask_in)
    res["box_scan"] = measure_scan(*scan_in)
    res["box_scan"]["query_index"] = measure_scan(*qi_in)
    res["box_scan"]["synthetic_64"] = measure_scan(
        *synthetic_scan(FULL_N, FULL_D, 64, 4, device), plain_device=False)
    # the narrow route (d <= 8, box_scan_pruned's one-block case) at d' = 6
    res["box_scan"]["synthetic_64_d6"] = measure_scan(
        *synthetic_scan(FULL_N, 6, 64, 4, device), plain_device=False)
    emit({"phase": "box_scan_only", "build_s": build_s, "runs": [res]})


# (NZ, B) of the [NZ, B] mask's rows: the main path's 1,024 zones of
# d' = 6 at the use_fused=False batch's largest call (2 boxes: its
# request's boxes on one subset, measured in the whole script's
# kernels_main_path) and at more boxes, then the paper's 131,072 zones
MASK_SHAPES = ((1024, 1), (1024, 2), (1024, 16), (1024, 64), (131072, 2),
               (131072, 16))


def mask_rows(device) -> list:
    """zone_prune's mask entry on zone maps made directly at MASK_SHAPES
    (measure_mask; device times by CUDA graphs)."""
    return [measure_mask(*synthetic_zones(nz, nb, 30 + i, device),
                         profile=False)
            for i, (nz, nb) in enumerate(MASK_SHAPES)]


def phase_zone_prune(device) -> None:
    """zone_prune.cu's entries alone: zone_candidates at the main path's
    shapes (1,024 zones of d' = 6, 16 boxes, capacity 1,024;
    synthetic_zones) beside the earlier launch chain and an empty launch,
    zone_rows (the most one CTA takes +- 1, 8,192 and 131,072 zones), and
    the [NZ, B] mask at MASK_SHAPES. It uses only the kernels' wrappers,
    so an older tree runs it too: parent and change in turns on one card
    compare the two."""
    zlo, zhi, lo, hi = synthetic_zones(1024, 16, 3, device)
    emit({"phase": "zone_prune_only", "tree": str(ROOT),
          "probe": measure_candidates(zlo, zhi, lo, hi, 1024),
          "empty_launch": empty_launch_ms(),
          "zones": zone_rows(device), "mask": mask_rows(device)})


def knn_inputs(device):
    """l2dist's inputs on the knn path without building the engine:
    subset 0's rows of the main path's catalog in its index's Morton
    order, and the first request's 15 positives on the subset's dims (what
    SearchEngine(x).query(..., model="knn") hands knn_subset)."""
    import torch
    from repro_torch.core.index import build_index
    from repro_torch.core.subsets import make_subsets
    x, assign = clustered(FULL_N, FULL_D, seed=0)
    reqs = make_requests(assign, 8, 100, seed=1)
    dims = make_subsets(FULL_D, 32, 6, seed=0)[0]
    ix = build_index(x, dims, block=1024, subset_id=0, device=device)
    rows3, _, _ = ix.device_arrays()
    q = torch.from_numpy(np.ascontiguousarray(
        x[reqs[0]["pos_ids"]][:, dims])).to(device)
    return rows3.reshape(-1, rows3.shape[-1])[:ix.n_rows], q


def clocks() -> str:
    """The card's SM and memory clocks, the SM clock's maximum and the
    active clock-event reasons, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,clocks.max.sm,"
         "clocks_event_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return (out.stdout or out.stderr).strip()


def l2dist_times(x, q) -> dict:
    """l2dist on (x, q), bitwise against l2dist_ref on the card (the
    data holds no NaN), timed every way the script times a kernel: CUDA
    events around a call, torch.profiler's device time, a CUDA graph of
    30 calls, and with the L2 flushed before each launch by the profiler
    and by the difference of two graphs."""
    import torch
    from repro_torch.kernels import l2dist, ref
    kern = lambda: l2dist.l2dist(x, q)
    if not torch.equal(kern(), ref.l2dist_ref(x, q)):
        raise AssertionError("l2dist != l2dist_ref")
    n, d = x.shape
    res = {"shape": {"n": n, "d": d, "queries": q.shape[0]},
           "clocks_before": clocks(), "ms": time_ms(kern),
           "device_ms_graph": graph_ms(kern)}
    res["device_ms"], res["device_ms_by"] = device_ms(kern)
    res["device_ms_cold"], res["device_ms_cold_by"] = cold_device_ms(
        kern, "l2dist")
    res["device_ms_cold_graph"] = cold_device_ms(kern, "l2dist",
                                                 use_profiler=False)[0]
    res["clocks_after"] = clocks()
    res["bound_ms"], res["bound_by"] = l2dist_bound(n, d, q.shape[0])
    return res


def phase_l2dist(device) -> None:
    """l2dist alone, at the knn path's inputs (knn_inputs) and the
    synthetic 1,048,576 x 6 x 15, 65,536 x 384 x 8 and 1,048,576 x 6 x 16
    shapes, timed every way (l2dist_times). For comparing two trees' kernels on one card."""
    import torch
    runs = [l2dist_times(*knn_inputs(device))]
    for n, d, nq, seed in ((FULL_N, 6, 15, 6), (MID_N, FULL_D, 8, 7),
                           (FULL_N, 6, 16, 8)):
        g = torch.Generator(device=device).manual_seed(seed)
        runs.append(l2dist_times(
            torch.randn(n, d, device=device, generator=g),
            torch.randn(nq, d, device=device, generator=g)))
    emit({"phase": "l2dist_only", "runs": runs})


def flash_counter() -> dict:
    """profile_batch's counters of the flash kernels' launches: the
    forward's main kernel, and the backward's dq and dk / dv kernels (one
    each a call, of either dtype; the forward's f32 pre-pass and splits'
    combine, and the backward's partials' sum, are not counted)."""
    from repro_torch.kernels import flash_attention as fa
    return {"flash_attention_kernel": lambda: fa.launches,
            "flash_bwd_dq_": lambda: fa.backward_launches,
            "flash_bwd_dkdv_": lambda: fa.backward_launches}


def phase_extraction(device):
    """The extraction path at full width: the paper-config ViT-T (seeded
    port init) over EXTRACT_N synthetic 64x64 patches by extract_catalog
    on the card; the first CPU_CHECK_N re-extracted on the CPU with the
    same weights. Returns the features, the labels, the flash launches of
    the timed catalog pass, the first batch's layer-0 attention inputs in
    the kernel layout and the images."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.rapidearth_vit import (FEATURE_DIM, IMAGE_SIZE,
                                                    PATCH_SIZE)
    from repro_torch.data.synthetic import (PatchDatasetConfig,
                                            generate_patches)
    from repro_torch.features.extract import (extract_catalog,
                                              extraction_throughput,
                                              vit_feature_fn)
    from repro_torch.features.vit import init_vit
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    precision = torch.get_float32_matmul_precision()
    if precision != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"f32 matmuls must be full f32 (TF32 misses "
                             f"the feature tolerance): {precision}")
    cfg = get_config("rapidearth-vit-t")
    t0 = time.perf_counter()
    data = generate_patches(PatchDatasetConfig(
        n_patches=EXTRACT_N, patch_size=IMAGE_SIZE, seed=0))
    gen_s = time.perf_counter() - t0
    imgs = data["images"]
    model = init_vit(cfg, image_size=IMAGE_SIZE, patch_size=PATCH_SIZE,
                     generator=torch.Generator().manual_seed(0),
                     device=device)
    fn = vit_feature_fn(model)
    extract_catalog(imgs[:2 * EXTRACT_BATCH], fn, batch=EXTRACT_BATCH,
                    device=device)                 # warm: cuBLAS, kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()     # earlier phases' state
    fa.launches = 0
    t0 = time.perf_counter()
    feats = extract_catalog(imgs, fn, batch=EXTRACT_BATCH, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    n_batches = -(-EXTRACT_N // EXTRACT_BATCH)
    if launches != n_batches * cfg.num_layers:
        raise AssertionError(f"flash_attention launched {launches} times "
                             f"for {n_batches} batches of "
                             f"{cfg.num_layers} layers")
    if feats.shape != (EXTRACT_N, FEATURE_DIM) \
            or not np.isfinite(feats).all():
        raise AssertionError(f"features {feats.shape}: not "
                             f"[{EXTRACT_N}, {FEATURE_DIM}] finite values")
    cpu_model = init_vit(cfg, image_size=IMAGE_SIZE, patch_size=PATCH_SIZE,
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    t0 = time.perf_counter()
    want = extract_catalog(imgs[:CPU_CHECK_N], vit_feature_fn(cpu_model),
                           batch=EXTRACT_BATCH, device="cpu")
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(feats[:CPU_CHECK_N] - want).max())
    if not np.allclose(feats[:CPU_CHECK_N], want, rtol=FEATURE_TOL,
                       atol=FEATURE_TOL):
        raise AssertionError(f"GPU features != CPU features (max abs err "
                             f"{err})")
    throughput = [extraction_throughput(fn, imgs, batch=b, iters=10,
                                        device=device)
                  for b in (EXTRACT_BATCH, 1024)]
    batch = torch.from_numpy(imgs[:EXTRACT_BATCH]).to(device)
    prof = profile_batch(lambda: fn(batch), flash_counter(),
                         graph_fallback=True)
    emit({"phase": "extraction", "model": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "head_dim": cfg.resolved_head_dim,
          "d_ff": cfg.d_ff, "image_size": IMAGE_SIZE,
          "patch_size": PATCH_SIZE, "patches": EXTRACT_N,
          "batch": EXTRACT_BATCH, "data_gen_s": gen_s,
          "image_bytes": int(imgs.nbytes),
          "extract_catalog_s": wall,
          "extract_catalog_patches_per_s": EXTRACT_N / wall,
          "throughput": throughput,
          "profile_one_batch": prof,
          "flash_launches": launches,
          "flash_launches_per_batch": launches / n_batches,
          "max_memory_allocated": peak,
          "peak_above_resident": peak - resident,
          "float32_matmul_precision": precision,
          "cpu_check_patches": CPU_CHECK_N, "cpu_extract_s": cpu_s,
          "gpu_vs_cpu_max_abs_err": err, "tol": FEATURE_TOL,
          "feature_abs_max": float(np.abs(feats).max())})
    with torch.inference_mode():
        x0 = model.embed(imgs[:EXTRACT_BATCH])
        flash_in = ops.kernel_layout(*model.layers[0].qkv(x0))
    return feats, data["labels"], launches, flash_in, imgs


def phase_extraction_400(device) -> dict:
    """The extractor at the paper's own patch size: the paper-config
    ViT-T at 400x400, /16 (626 tokens), seeded port init, over
    EXTRACT400_N synthetic patches by extract_catalog at batch 128, one
    resident batch by extraction_throughput, the first CPU_CHECK400_N
    re-extracted on the CPU with the same weights within FEATURE_TOL, and
    one batch under torch.profiler (flash attention against cuBLAS
    against the rest)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.rapidearth_vit import FEATURE_DIM, PATCH_SIZE
    from repro_torch.data.synthetic import (PatchDatasetConfig,
                                            generate_patches)
    from repro_torch.features.extract import (extract_catalog,
                                              extraction_throughput,
                                              vit_feature_fn)
    from repro_torch.features.vit import init_vit
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config("rapidearth-vit-t")
    size, n, b = EXTRACT400_SIZE, EXTRACT400_N, EXTRACT_BATCH
    t0 = time.perf_counter()
    imgs = generate_patches(PatchDatasetConfig(
        n_patches=n, patch_size=size, seed=0))["images"]
    gen_s = time.perf_counter() - t0
    model = init_vit(cfg, image_size=size, patch_size=PATCH_SIZE,
                     generator=torch.Generator().manual_seed(0),
                     device=device)
    fn = vit_feature_fn(model)
    extract_catalog(imgs[:b], fn, batch=b, device=device)     # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fa.launches = 0
    t0 = time.perf_counter()
    feats = extract_catalog(imgs, fn, batch=b, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    n_batches = -(-n // b)
    if launches != n_batches * cfg.num_layers:
        raise AssertionError(f"flash_attention launched {launches} times "
                             f"for {n_batches} batches of "
                             f"{cfg.num_layers} layers")
    if feats.shape != (n, FEATURE_DIM) or not np.isfinite(feats).all():
        raise AssertionError(f"features {feats.shape}: not [{n}, "
                             f"{FEATURE_DIM}] finite values")
    cpu_model = init_vit(cfg, image_size=size, patch_size=PATCH_SIZE,
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    t0 = time.perf_counter()
    want = extract_catalog(imgs[:CPU_CHECK400_N], vit_feature_fn(cpu_model),
                           batch=CPU_CHECK400_N, device="cpu")
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(feats[:CPU_CHECK400_N] - want).max())
    if not np.allclose(feats[:CPU_CHECK400_N], want, rtol=FEATURE_TOL,
                       atol=FEATURE_TOL):
        raise AssertionError(f"GPU features != CPU features at {size}x"
                             f"{size} (max abs err {err})")
    throughput = extraction_throughput(fn, imgs, batch=b, iters=10,
                                       device=device)
    batch = torch.from_numpy(imgs[:b]).to(device)
    prof = profile_batch(lambda: fn(batch), flash_counter(),
                         graph_fallback=True)
    seq = model.pos.shape[-2]
    res = {"phase": "extraction_400", "model": cfg.name,
           "image_size": size, "patch_size": PATCH_SIZE, "tokens": seq,
           "patches": n, "batch": b, "data_gen_s": gen_s,
           "image_bytes": int(imgs.nbytes), "extract_catalog_s": wall,
           "extract_catalog_patches_per_s": n / wall,
           "throughput": throughput,
           "resident_patches_per_s": throughput["patches_per_s"],
           "profile_one_batch": prof, "flash_launches": launches,
           "flash_launches_per_batch": launches / n_batches,
           "max_memory_allocated": peak,
           "peak_above_resident": peak - resident,
           "cpu_check_patches": CPU_CHECK400_N, "cpu_extract_s": cpu_s,
           "gpu_vs_cpu_max_abs_err": err, "tol": FEATURE_TOL}
    emit(res)
    return res


def phase_search_vit(device, feats, labels, k: int = 100,
                     phase: str = "search_on_vit_features") -> None:
    """The ViT features, normalised as examples/train_extractor.py does,
    into a SearchEngine on the card and one on the CPU; a query batch of
    8 (dbranch/dbens, 15 positives of one class, 80 negatives) on both,
    ids, scores and stats bitwise equal; the results' class share is
    printed beside the base rate, with no limit."""
    import torch
    from repro_torch.core import SearchEngine
    from repro_torch.data.synthetic import CLASSES
    x = ((feats - feats.mean(0)) / (feats.std(0) + 1e-6)).astype(np.float32)
    reqs = make_requests(labels, 8, k, seed=2, groups=VIT_QUERY_CLASSES)
    t0 = time.perf_counter()
    eg = SearchEngine(x, device=device)
    ec = SearchEngine(x, device="cpu")
    build_s = time.perf_counter() - t0
    # cold, then warm: the first batch teaches each engine's capacity
    # hints, so the two are compared run for run
    same_results(eg.query_batch(reqs), ec.query_batch(reqs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eg.query_batch(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same_results(outs, ec.query_batch(reqs))
    if any(o.n_found == 0 for o in outs):
        raise AssertionError("a query over the ViT features found nothing")
    groups = [VIT_QUERY_CLASSES[i % len(VIT_QUERY_CLASSES)]
              for i in range(len(reqs))]
    emit({"phase": phase, "rows": int(x.shape[0]),
          "dims": int(x.shape[1]), "batch": len(reqs),
          "classes": [CLASSES[c] for c in groups],
          "build_s_gpu_and_cpu": build_s, "query_batch_wall_s": wall,
          "per_query_wall_s": wall / len(reqs),
          "n_found": [o.n_found for o in outs],
          "class_share_of_results": [
              float((labels[o.ids] == c).mean()) for o, c in zip(outs,
                                                                 groups)],
          "class_base_rate": [float((labels == c).mean()) for c in groups],
          "gpu_equals_cpu": True})


# DINO training of the extractor (ROADMAP A12's remainder): the paper
# ViT-T at the config's 64x64 /16 with examples/train_extractor.py's
# batch of 64, and at the paper's 400x400 /16 (626 tokens): one step held
# against the CPU at batch 2, timed at batch 16
DINO_BATCH = 64
DINO_STEPS = 10                # timed steps (20 before the 1,000 s cut)
DINO400_CHECK_BATCH = 2
DINO400_BATCH = 16
DINO400_STEPS = 5
DINO_LR = 1e-3                # make_dino_step's default, as the reference's
# card against CPU after one step from one seed on the same views: the
# loss relative; each gradient against its tensor's largest |entry|; the
# moments likewise (v = (1 - b2) g^2: twice the gradient's); the
# parameters within 2 lr (Adam's first step moves each by at most lr, so
# a near-zero gradient whose sign differs can move them 2 lr apart), the
# teacher within (1 - ema) of that; the centre within FEATURE_TOL
DINO_LOSS_RTOL = 1e-4
DINO_GRAD_TOL = 1e-3
DINO_EMA = 0.996
@contextlib.contextmanager
def plain_attention_watch():
    """While open, counts the calls of kernels/ref.flash_attention_ref and
    flash_attention_bwd_ref (the plain versions: a path on the card makes
    none) and keeps the inputs of the first backward kernel call
    (kernels/flash_attention.flash_attention_bwd); restores the three
    functions on leaving."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    fwd, bwd = ref.flash_attention_ref, ref.flash_attention_bwd_ref
    kern = fa.flash_attention_bwd
    seen = {"plain_forward": 0, "plain_backward": 0, "bwd_inputs": None}

    def counted_fwd(*args, **kwargs):
        seen["plain_forward"] += 1
        return fwd(*args, **kwargs)

    def counted_bwd(*args, **kwargs):
        seen["plain_backward"] += 1
        return bwd(*args, **kwargs)

    def kept_kernel(*args, **kwargs):
        if seen["bwd_inputs"] is None:
            # detached: the saved tensors would keep the step's autograd
            # graph alive, whose AccumulateGrad nodes then tie the next
            # step to their stream (no CUDA graph can capture it)
            seen["bwd_inputs"] = (tuple(a.detach() for a in args), kwargs)
        return kern(*args, **kwargs)
    ref.flash_attention_ref, ref.flash_attention_bwd_ref = (counted_fwd,
                                                            counted_bwd)
    fa.flash_attention_bwd = kept_kernel
    try:
        yield seen
    finally:
        ref.flash_attention_ref, ref.flash_attention_bwd_ref = fwd, bwd
        fa.flash_attention_bwd = kern


def attention_counts(seen) -> dict:
    """The flash kernel's launches, the backward calls, the backward
    kernel's launches, and the plain forwards and backwards since
    zero_counts."""
    from repro_torch.kernels import flash_attention as fa
    return {"flash_attention": fa.launches, "backward_calls":
            fa.backward_calls, "backward_launches": fa.backward_launches,
            "plain_forward": seen["plain_forward"],
            "plain_backward": seen["plain_backward"]}


def needs_dino_launches(counts: dict, layers: int, what: str) -> None:
    """A step launches the kernel once a layer, view and network (teacher
    and student) and runs the backward once a layer and view, each on the
    backward kernel; no forward or backward takes the plain version."""
    want = {"flash_attention": 4 * layers, "backward_calls": 2 * layers,
            "backward_launches": 2 * layers, "plain_forward": 0,
            "plain_backward": 0}
    if counts != want:
        raise AssertionError(f"{what}: {counts}, expected {want}")


def _rel_max(a, b) -> float:
    """max |a - b| over max |b| (b on the CPU)."""
    return float((a.detach().cpu() - b.detach()).abs().max()
                 / b.detach().abs().max().clamp_min(1e-30))


def _abs_max(a, b) -> float:
    return float((a.detach().cpu() - b.detach()).abs().max())


def dino_gpu_vs_cpu(device, cfg, x, size: int) -> dict:
    """One DINO step from one seed (init_dino, generator seed 0) on the
    card and on the CPU, on the same two views of ``x`` (drawn and made on
    the CPU, then uploaded): loss, every gradient and the state after the
    step against the CPU's, to the DINO_* tolerances; the card's step
    launches the kernel 4 x layers times and the backward 2 x layers."""
    import torch
    from repro_torch.configs.rapidearth_vit import PATCH_SIZE
    from repro_torch.features.dino import augment, init_dino, make_dino_step
    step = make_dino_step(cfg, image_size=size, patch_size=PATCH_SIZE,
                          lr=DINO_LR, ema=DINO_EMA)
    gen = torch.Generator().manual_seed(1)
    xc = torch.from_numpy(np.ascontiguousarray(x))
    v1, v2 = augment(xc, gen), augment(xc, gen)
    sg, sc = (init_dino(cfg, image_size=size, patch_size=PATCH_SIZE,
                        generator=torch.Generator().manual_seed(0),
                        device=dev) for dev in (device, "cpu"))
    with plain_attention_watch() as seen:
        zero_counts()
        lg, cg, gg = step.loss_and_grads(sg, v1.to(device), v2.to(device))
        torch.cuda.synchronize()
        counts = attention_counts(seen)
    needs_dino_launches(counts, cfg.num_layers, f"dino step {size}x{size}")
    t0 = time.perf_counter()
    lc, cc, gc = step.loss_and_grads(sc, v1, v2)
    cpu_s = time.perf_counter() - t0
    loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
    grad_err = {n: _rel_max(gg[n], g) for n, g in gc.items()}
    worst = max(grad_err, key=grad_err.get)
    if not np.isfinite(float(lg)) or loss_err > DINO_LOSS_RTOL:
        raise AssertionError(f"dino {size}x{size}: GPU loss {float(lg)} != "
                             f"CPU loss {float(lc)} (rel {loss_err})")
    if grad_err[worst] > DINO_GRAD_TOL:
        raise AssertionError(f"dino {size}x{size}: gradient {worst} off by "
                             f"{grad_err[worst]} of its max")
    step.update(sg, gg, cg)
    step.update(sc, gc, cc)
    torch.cuda.synchronize()
    lr = DINO_LR
    st = dict(sc.trainables())
    moved = {n: (p.detach().cpu() - st[n].detach()).abs()
             for n, p in sg.trainables().items()}
    param_err = max(float(d.max()) for d in moved.values()) / lr
    n_el = sum(d.numel() for d in moved.values())
    far = sum(int((d > 0.01 * lr).sum()) for d in moved.values())
    teacher_err = max(
        [_abs_max(p, q) for p, q in zip(sg.teacher.parameters(),
                                        sc.teacher.parameters())]
        + [_abs_max(sg.head_t[w], sc.head_t[w]) for w in ("w1", "w2")])
    m_err = max(_rel_max(sg.opt_m[n], m) for n, m in sc.opt_m.items())
    v_err = max(_rel_max(sg.opt_v[n], v) for n, v in sc.opt_v.items())
    center_err = _abs_max(sg.center, sc.center)
    res = {"image_size": size, "batch": int(x.shape[0]),
           "tokens": int(sg.student.pos.shape[-2]),
           "loss_gpu": float(lg), "loss_cpu": float(lc),
           "loss_rel_err": loss_err, "loss_rtol": DINO_LOSS_RTOL,
           "grad_max_rel_err": grad_err[worst], "grad_worst": worst,
           "grad_tol": DINO_GRAD_TOL, "grads": len(grad_err),
           "param_max_err_lr": param_err,
           "param_share_over_0.01lr": far / n_el,
           "teacher_max_err": teacher_err, "moment_m_rel_err": m_err,
           "moment_v_rel_err": v_err, "center_max_err": center_err,
           "launches": counts, "cpu_step_grads_s": cpu_s}
    if param_err > 2.0 + 1e-3 or teacher_err > 2 * (1 - DINO_EMA) * lr \
            + 1e-6 or m_err > DINO_GRAD_TOL or v_err > 2 * DINO_GRAD_TOL \
            or center_err > FEATURE_TOL:
        raise AssertionError(f"dino {size}x{size}: the state after a step "
                             f"is off the CPU's: {res}")
    return res


def dino_train(device, cfg, imgs, size: int, batch: int, steps: int):
    """DINO training on the card through the user's entry point,
    ``make_dino_step(...)(state, images, generator)`` with host batches
    cycling through ``imgs`` as examples/train_extractor.py takes them:
    one warm step, one counted step (the kernel 4 x layers times, the
    backward 2 x layers, no plain forward), then ``steps`` timed steps
    (host clock ending in a synchronise), peak memory above what was
    resident, every loss finite, the teacher moved. Returns the state, the
    step and the record."""
    import torch
    from repro_torch.configs.rapidearth_vit import PATCH_SIZE
    from repro_torch.features.dino import init_dino, make_dino_step
    state = init_dino(cfg, image_size=size, patch_size=PATCH_SIZE,
                      generator=torch.Generator().manual_seed(0),
                      device=device)
    step = make_dino_step(cfg, image_size=size, patch_size=PATCH_SIZE,
                          lr=DINO_LR, ema=DINO_EMA)
    gen = torch.Generator().manual_seed(2)
    n = imgs.shape[0] - imgs.shape[0] % batch
    batches = [imgs[i:i + batch] for i in range(0, n, batch)]
    teacher0 = state.teacher.layers[0].wq.detach().clone()
    state, _ = step(state, batches[0], gen)                  # warm
    with plain_attention_watch() as seen:
        zero_counts()
        state, _ = step(state, batches[1 % len(batches)], gen)
        torch.cuda.synchronize()
        counts = attention_counts(seen)
    needs_dino_launches(counts, cfg.num_layers,
                        f"dino_step {size}x{size} batch {batch}")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = step(state, batches[(i + 2) % len(batches)], gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().numpy()
    moved = float((state.teacher.layers[0].wq - teacher0).abs().max())
    if not np.isfinite(losses).all() or moved == 0:
        raise AssertionError(f"dino {size}x{size}: losses {losses}, teacher "
                             f"moved {moved}")
    return state, step, {
        "image_size": size, "batch": batch, "steps": steps,
        "s_per_step": wall / steps, "images_per_s": batch * steps / wall,
        "max_memory_allocated": peak, "peak_above_resident": peak - resident,
        "losses": losses.tolist(), "teacher_max_move": moved,
        "state_steps": state.step, "launches_per_step": counts}


def dino_profile(device, state, step, x):
    """One step on two uploaded views of ``x`` under torch.profiler
    (profile_batch; the backward kernels are their own class), and a CUDA
    graph of 3 such steps (device time with no host gaps). Run after
    the state is no longer needed: the graph's replays take steps with a
    stale Adam scale. Returns the record and the profiled step's first
    attention backward's inputs."""
    import torch
    from repro_torch.features.dino import augment
    gen = torch.Generator().manual_seed(3)
    xc = torch.from_numpy(np.ascontiguousarray(x))
    v1, v2 = (augment(xc, gen).to(device) for _ in range(2))
    fn = lambda: step.on_views(state, v1, v2)
    with plain_attention_watch() as seen:
        prof = profile_batch(fn, flash_counter(), graph_fallback=True)
        prof["graph_step_ms"] = graph_ms(fn, iters=3)
    return prof, seen["bwd_inputs"]


def attention_bwd_bound(bh: int, s: int, g: int, d: int, causal: bool,
                        dtype: str):
    """The attention backward: q, k, v, dout and lse (f32) read, out too
    where bf16 (delta = sum_d dout out; the f32 route reads no out), and
    dq, dk, dv written once, against its five products of 2 BH G S^2 D
    FLOPs each (the scores again, dv, dp, dq, dk), halved when causal (a
    kernel skips the masked tiles), on the tensor cores by flash_bound's
    convention: bf16 inputs at the bf16 peak, f32 as 3xTF32."""
    bf16 = dtype == "bfloat16"
    item = 2 if bf16 else 4
    byts = ((3 + bf16) * bh * s * g * d + 4 * bh * s * d) * item \
        + 4 * bh * s * g
    flops = 10 * bh * g * s * s * d / (2 if causal else 1)
    tb = byts / HBM_BYTES_PER_S
    to = (flops / BF16_FLOPS_PER_S if dtype == "bfloat16"
          else 3 * flops / TF32_FLOPS_PER_S)
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def seeded_like(t, seed: int):
    """N(0, 1) in t's shape, dtype and device, from a seeded generator."""
    import torch
    gen = torch.Generator(device=t.device).manual_seed(seed)
    return torch.randn(t.shape, device=t.device, generator=gen).to(t.dtype)


@contextlib.contextmanager
def uncounted():
    """The flash counters as they were before: launches made to hold a
    kernel to its plain version or to time it are no path's."""
    from repro_torch.kernels import flash_attention as fa
    names = ("launches", "backward_launches", "backward_calls")
    before = {n: getattr(fa, n) for n in names}
    try:
        yield
    finally:
        for n, v in before.items():
            setattr(fa, n, v)


def fwd_residuals(q, k, v, causal: bool):
    """(out, lse) of the forward kernel on kernel-layout inputs, as the
    autograd Function saves them for the backward; not a path's launch."""
    from repro_torch.kernels import flash_attention as fa
    with uncounted():
        return fa.flash_attention(q, k, v, causal=causal, return_lse=True)


def check_flash_bwd(q, k, v, out, lse, dout, causal: bool) -> dict:
    """flash_attention_bwd against flash_attention_bwd_ref on the same
    kernel-layout inputs (the forward's out and lse among them): dq, dk
    and dv each within FLASH_TOL of its dtype (torch.allclose, rtol = atol
    = tol); raises beyond it. Both read the forward kernel's residuals
    (bf16: p from lse, delta from dout out; f32 reads neither), so a
    fault in them would pass here: measure_flash holds the forward's out
    and lse to the plain forward's (LSE_TOL), and the paths' gradient
    checks hold the whole step to the CPU's."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dt = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    tol = FLASH_TOL[dt]
    with uncounted():
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal)
    torch.cuda.synchronize()
    errs = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a.float(), w.float()
        errs[name] = float((a - w).abs().max())
        if a.dtype != w.dtype or not torch.allclose(a, w, rtol=tol,
                                                    atol=tol):
            raise AssertionError(
                f"flash_attention_bwd {tuple(q.shape)} {dt} causal="
                f"{causal}: {name} != the plain version's (max abs err "
                f"{errs[name]}, tol {tol})")
    bh, s, g, d = q.shape
    return {"shape": {"bh": bh, "s": s, "g": g, "d": d}, "dtype": dt,
            "causal": causal, "max_abs_err": max(errs.values()),
            "max_abs_err_by_output": errs, "tol": tol}


def sdpa_backward(q, k, v, dout, causal: bool) -> dict:
    """The library yardstick, never on the path: SDPA on the same q, k, v
    (its [B, H, S, D] layout, the G query heads of a kv head as H), its
    backward alone (torch.autograd.grad of one forward's output, the
    graph kept) by CUDA events and by a CUDA graph of 10 calls, and its
    forward alone and forward + backward by events. The forward runs on
    the stream the graph captures on, so that the backward's kernels run
    there too."""
    import torch
    import torch.nn.functional as F
    g = q.shape[2]
    ql = q.detach().permute(0, 2, 1, 3).contiguous().requires_grad_(True)
    kl = k.detach()[:, None].contiguous().requires_grad_(True)
    vl = v.detach()[:, None].contiguous().requires_grad_(True)
    dl = dout.permute(0, 2, 1, 3).contiguous()
    leaves = (ql, kl, vl)
    sdpa = lambda: F.scaled_dot_product_attention(ql, kl, vl,
                                                  is_causal=causal,
                                                  enable_gqa=g > 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o = sdpa()
    torch.cuda.current_stream().wait_stream(side)
    bwd = lambda: torch.autograd.grad(o, leaves, dl, retain_graph=True)
    res = {"library_bwd_ms": time_ms(bwd, iters=10, warmup=2),
           "library_bwd_device_ms": graph_ms(bwd, iters=10, stream=side),
           "library_bwd_device_ms_by": "graph",
           "library_fwd_ms": time_ms(sdpa, iters=10, warmup=2),
           "library_fwd_bwd_ms": time_ms(
               lambda: torch.autograd.grad(sdpa(), leaves, dl), iters=10,
               warmup=2)}
    got = bwd()
    res["library_grads"] = (got[0].permute(0, 2, 1, 3), got[1][:, 0],
                            got[2][:, 0])
    return res


def measure_flash_bwd(q, k, v, dout, causal: bool) -> dict:
    """check_flash_bwd from the forward kernel's out and lse, then the
    kernel's event (median of 30 calls) and device time (a CUDA graph of
    10), the plain version's event time (median of 5), SDPA's backward
    alone (sdpa_backward) and the bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    out, lse = fwd_residuals(q, k, v, causal)
    res = check_flash_bwd(q, k, v, out, lse, dout, causal)
    kern = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                          causal=causal)
    with uncounted():
        res["ms"] = time_ms(kern)
        res["device_ms"] = graph_ms(kern, iters=10)
        res["device_ms_by"] = "graph"
    res["plain_ms"] = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, dout, causal=causal), iters=5, warmup=1)
    lib = sdpa_backward(q, k, v, dout, causal)
    del lib["library_grads"]
    res.update(lib)
    sh = res["shape"]
    res["bound_ms"], res["bound_by"] = attention_bwd_bound(
        sh["bh"], sh["s"], sh["g"], sh["d"], causal, res["dtype"])
    return res


def flash_bwd_rows(device) -> list:
    """flash_attention_bwd at every FLASH_CASES shape, causal and not, and
    at the mesh MoE's (BH 1, G 16, D 128, f32, causal), each with a
    seeded dout (measure_flash_bwd)."""
    cases = [(*c[:5], causal, c[6]) for c in FLASH_CASES
             for causal in (c[5], not c[5])]
    cases.append((1, MESH_TRAIN_SEQ, 16, 1, 128, True, "float32"))
    rows = []
    for i, case in enumerate(cases):
        q, k, v = flash_case(*case, seed=40 + i, device=device)
        rows.append(measure_flash_bwd(q, k, v, seeded_like(q, 80 + i),
                                      case[5]))
        del q, k, v
    return rows


# one backward call may allocate at most this much above its inputs and
# outputs: the kernel's lse and delta rows are [BH, S G] f32 (1 MB at
# lm_train's shape), the plain version's p and dp [BH, G, S, S] f32 each
BWD_SCRATCH_LIMIT = 150 << 20


def attention_backward_memory(args, kwargs) -> dict:
    """At one backward's own inputs: the kernel twice, bitwise equal; the
    peak allocation of one kernel call and of one plain call above their
    inputs and outputs (raises if the kernel's reaches
    BWD_SCRATCH_LIMIT)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, out, lse, dout = args
    causal = kwargs["causal"]

    def above(fn):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        outs = sum(t.numel() * t.element_size() for t in out)
        return peak - base - outs, out
    with uncounted():
        kern_bytes, a = above(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, dout, causal=causal))
        b = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(x, y) for x, y in zip(a, b))
    del a, b
    plain_bytes, grads = above(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, dout, causal=causal))
    del grads
    free_cuda()
    res = {"bitwise_equal_twice": bitwise,
           "kernel_peak_above_io_bytes": kern_bytes,
           "plain_peak_above_io_bytes": plain_bytes,
           "kernel_limit_bytes": BWD_SCRATCH_LIMIT}
    if not bitwise or kern_bytes >= BWD_SCRATCH_LIMIT:
        raise AssertionError(f"flash_attention_bwd at {tuple(q.shape)}: "
                             f"{res}")
    return res


def attention_backward_times(args, kwargs) -> dict:
    """At one backward's own inputs (q, k, v, out, lse, dout in the kernel
    layout, as a step gave them to the backward kernel): the kernel held
    to the plain version (check_flash_bwd); the kernel's and the plain
    backward's times by CUDA events and by a CUDA graph (device ms); the
    kernel forward and backward through ops' autograd Function (events);
    SDPA's backward alone, forward and forward + backward on the same q,
    k, v and dout (sdpa_backward), the library yardstick, never on the
    path; the backward's bound. None of these calls counts as a path's."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import _FlashAttention
    q, k, v, out, lse, dout = args
    causal = kwargs["causal"]
    bh, s, g, d = q.shape
    kern = lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                          causal=causal)
    plain = lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                causal=causal)
    # the autograd Function in the kernel layout (ops applies it there)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def port_fb():
        o = _FlashAttention.apply(*leaves, causal)
        return torch.autograd.grad(o, leaves, dout)
    res = check_flash_bwd(q, k, v, out, lse, dout, causal)
    # the backward against SDPA's, on the same inputs (a yardstick)
    lib = sdpa_backward(q, k, v, dout, causal)
    got = plain()
    res["library_max_abs_diff"] = max(
        float((a.float() - b.float().reshape(a.shape)).abs().max())
        for a, b in zip(got, lib.pop("library_grads")))
    del got
    res.update(lib)
    with uncounted():
        res.update({
            "kernel_bwd_ms": time_ms(kern, iters=30, warmup=3),
            "kernel_bwd_device_ms": graph_ms(kern, iters=10),
            "kernel_bwd_device_ms_by": "graph",
            "plain_bwd_ms": time_ms(plain, iters=10, warmup=2),
            "plain_bwd_device_ms": graph_ms(plain, iters=10),
            "plain_bwd_device_ms_by": "graph",
            "kernel_fwd_bwd_ms": time_ms(port_fb, iters=10, warmup=2)})
    res["bound_ms"], res["bound_by"] = attention_bwd_bound(
        bh, s, g, d, causal,
        "bfloat16" if q.dtype == torch.bfloat16 else "float32")
    return res


def phase_dino(device, imgs=None, labels=None) -> dict:
    """DINO training of the paper-config ViT-T on the card (ROADMAP A12's
    remainder, examples/train_extractor.py's flow): at 64x64 /16 one step
    held against the CPU at batch DINO_BATCH, the counted step, DINO_STEPS
    timed steps and a profiled one; the trained student embeds the
    extraction phase's patches (``imgs``, ``labels``; made here when not
    given) for one dbranch/dbens batch (phase_search_vit); at 400x400 one
    step against the CPU at batch DINO400_CHECK_BATCH and DINO400_STEPS
    timed at DINO400_BATCH; the attention backward kernel held to its
    plain version and timed at each step's own inputs beside the plain
    version and SDPA's (attention_backward_times). Returns the record."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.rapidearth_vit import IMAGE_SIZE
    from repro_torch.data.synthetic import (PatchDatasetConfig,
                                            generate_patches)
    from repro_torch.features.extract import extract_catalog, vit_feature_fn
    from repro_torch.kernels import flash_attention as fa
    precision = torch.get_float32_matmul_precision()
    if precision != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"f32 matmuls must be full f32: {precision}")
    cfg = get_config("rapidearth-vit-t")
    if imgs is None:
        data = generate_patches(PatchDatasetConfig(
            n_patches=EXTRACT_N, patch_size=IMAGE_SIZE, seed=0))
        imgs, labels = data["images"], data["labels"]
    t_phase = time.perf_counter()
    check = dino_gpu_vs_cpu(device, cfg, imgs[:DINO_BATCH], IMAGE_SIZE)
    n_train = DINO_BATCH * (DINO_STEPS + 2)
    state, step, train = dino_train(device, cfg, imgs[:n_train], IMAGE_SIZE,
                                    DINO_BATCH, DINO_STEPS)
    zero_counts()
    t0 = time.perf_counter()
    feats = extract_catalog(imgs, vit_feature_fn(state.student),
                            batch=EXTRACT_BATCH, device=device)
    embed_s = time.perf_counter() - t0
    embed_launches = fa.launches
    if embed_launches != -(-len(imgs) // EXTRACT_BATCH) * cfg.num_layers \
            or not np.isfinite(feats).all():
        raise AssertionError(f"dino embedding: {embed_launches} launches, "
                             f"finite {np.isfinite(feats).all()}")
    phase_search_vit(device, feats, labels, phase="search_on_dino_features")
    prof, bwd_in = dino_profile(device, state, step, imgs[:DINO_BATCH])
    bwd = attention_backward_times(*bwd_in)
    del state, step, feats
    imgs400 = generate_patches(PatchDatasetConfig(
        n_patches=2 * DINO400_BATCH, patch_size=EXTRACT400_SIZE,
        seed=0))["images"]
    check400 = dino_gpu_vs_cpu(device, cfg, imgs400[:DINO400_CHECK_BATCH],
                               EXTRACT400_SIZE)
    state, step, train400 = dino_train(device, cfg, imgs400,
                                       EXTRACT400_SIZE, DINO400_BATCH,
                                       DINO400_STEPS)
    prof400, bwd_in = dino_profile(device, state, step,
                                   imgs400[:DINO400_BATCH])
    bwd400 = attention_backward_times(*bwd_in)
    del state, step
    res = {"phase": "dino", "model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "head_dim": cfg.resolved_head_dim, "proj_dim": 256,
           "float32_matmul_precision": precision,
           "gpu_vs_cpu": check, "train": train, "profile_one_step": prof,
           "embed_s": embed_s, "embed_patches": int(len(imgs)),
           "embed_flash_launches": embed_launches,
           "attention_backward": bwd,
           "gpu_vs_cpu_400": check400, "train_400": train400,
           "profile_one_step_400": prof400,
           "attention_backward_400": bwd400,
           "phase_s": time.perf_counter() - t_phase}
    emit(res)
    return res


# the LM backbones' serving path (ROADMAP A13a): llama3-8b whole at full
# width (32 layers, d 4096, 32/8 heads of 128, bf16) from a seeded CUDA
# generator; a 4,096-token prefill is the smallest that launches the flash
# kernel (S > FLASH_THRESHOLD and a multiple of the reference's 2048-token
# q chunk), then 32 greedy decode steps and lm_feature_fn on 4 x 4,096
LM_ARCH = "llama3-8b"
LM_SEQ = 4096
LM_DECODE = 32
LM_FEATURE_BATCH = 4
LM_SEED = 0
# card against CPU: the model's first layer, the same weights; the
# final hidden state within FLASH_TOL["bfloat16"] of its max |value|
LM_CHECK_LAYERS = 1          # 2 before the 1,000 s cut
LM_HIDDEN_TOL = 2e-2
# every other architecture at full width, cut to one repeat of its scan
# pattern (True) or whole (False): prefill(S) + LM_CONSIST_STEPS decode
# steps against prefill(S + LM_CONSIST_STEPS) at the last position
# (tests/test_arch_smoke.py's check), dropless MoE at capacity factor 64
# as that test sets it. bf16 compute through 1-48 layers, each path
# rounding its own way (the flash kernel beside f32 plain attention, one
# token's products beside 4,104 rows'): the logits within 5e-2 of their
# max |value|
LM_OTHERS = (("qwen3-moe-235b-a22b", True),
             ("llama4-maverick-400b-a17b", True), ("granite-20b", True),
             ("nemotron-4-15b", True), ("llava-next-mistral-7b", True),
             ("internlm2-1.8b", False), ("mamba2-1.3b", False),
             ("musicgen-medium", False), ("recurrentgemma-2b", True))
LM_CONSIST_STEPS = 4           # 8 before the 1,000 s cut
LM_CONSIST_TOL = 5e-2
LM_MOE_CAPACITY = 64.0


def lm_config(arch: str, cut: bool):
    """The arch's full-width config; ``cut``: one repeat of its scan
    pattern. MoE at LM_MOE_CAPACITY."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    over = {"moe_capacity_factor": LM_MOE_CAPACITY} if cfg.num_experts \
        else {}
    if cut:
        over["num_layers"] = len(cfg.scan_pattern()[0])
    return dataclasses.replace(cfg, **over)


def flash_layers(cfg, s: int) -> int:
    """The flash kernel's launches of one prefill (or lm_feature_fn call)
    of S tokens: one a global-attention layer where the LM takes its flash
    branch (S > FLASH_THRESHOLD) and flash_attention does not route to
    full_attention (S a multiple of min(2048, S) and of min(1024, S))."""
    from repro_torch.models import lm
    if s <= lm.FLASH_THRESHOLD or s % min(2048, s) or s % min(1024, s):
        return 0
    return sum(kind in ("AD", "AM") for kind in cfg.layer_kinds())


def lm_inputs(cfg, b: int, s: int, seed: int):
    """Seeded token ids [b, s] int32, or for embedding inputs (llava)
    N(0, 1) float32 embeddings [b, s, d]."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@contextlib.contextmanager
def first_flash_inputs(store: list):
    """Records (clones of) the kernel-layout q, k, v of the first flash
    kernel call made inside; the call itself goes through unchanged."""
    from repro_torch.kernels import flash_attention as fa
    raw = fa.flash_attention

    def capture(q, k, v, *, causal=True, **kwargs):
        if not store:
            store.append((q.clone(), k.clone(), v.clone(), causal))
        return raw(q, k, v, causal=causal, **kwargs)
    fa.flash_attention = capture
    try:
        yield store
    finally:
        fa.flash_attention = raw


def flash_at(store: list) -> dict:
    """The flash kernel against flash_attention_ref at the recorded
    inputs, within FLASH_TOL of the dtype (raises beyond it)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v, causal = store[0]
    got = fa.flash_attention(q, k, v, causal=causal).float()
    want = ref.flash_attention_ref(q, k, v, causal=causal).float()
    torch.cuda.synchronize()
    dt = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    err = float((got - want).abs().max())
    if not err <= FLASH_TOL[dt]:
        raise AssertionError(f"flash_attention at the LM's inputs "
                             f"{tuple(q.shape)}: max abs err {err} > "
                             f"{FLASH_TOL[dt]}")
    return {"shape": list(q.shape), "dtype": dt, "max_abs_err": err,
            "tol": FLASH_TOL[dt]}


def synced(fn):
    """(fn(), host seconds) with the card synchronised on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for c in caches
               for t in (c.values() if isinstance(c, dict) else c))


def free_cuda() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def lm_serve(device, cfg, model) -> tuple:
    """llama3-8b's prefill of LM_SEQ tokens (the flash kernel's launches
    counted: one a layer), pad_caches and LM_DECODE greedy decode steps
    (none), lm_feature_fn on LM_FEATURE_BATCH x LM_SEQ (one a layer a
    call); the first layer's kernel inputs captured in a warm prefill.
    Returns (record, captured inputs)."""
    import torch
    from repro_torch.configs.base import ServeConfig
    from repro_torch.features.extract import lm_feature_fn
    from repro_torch.models import lm
    sv = ServeConfig()
    tokens = lm_inputs(cfg, 1, LM_SEQ, LM_SEED)
    store = []
    with first_flash_inputs(store):
        (_, caches), warm_s = synced(lambda: lm.prefill(model, tokens, sv))
    del caches
    ((logits, caches), prefill_s), counts = counted(
        lambda: synced(lambda: lm.prefill(model, tokens, sv)))
    want = flash_layers(cfg, LM_SEQ)
    if counts["flash_attention"] != want or want != cfg.num_layers:
        raise AssertionError(f"lm prefill: {counts['flash_attention']} "
                             f"flash launches, expected {want}")
    if tuple(logits.shape) != (1, 1, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("lm prefill: logits of the wrong shape or "
                             "not finite")
    prefill_counts = counts
    caches = lm.pad_caches(caches, cfg, LM_SEQ + LM_DECODE)
    kv = cache_bytes(caches)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    steps, out = [], []

    def decode():
        nonlocal logits, caches, tok
        for i in range(LM_DECODE):
            t0 = time.perf_counter()
            logits, caches = lm.decode_step(model, caches, tok, LM_SEQ + i,
                                            sv)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            out.append(tok)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
    (_, decode_s), counts = counted(lambda: synced(decode))
    if counts["flash_attention"] != 0:
        raise AssertionError(f"lm decode: {counts['flash_attention']} "
                             f"flash launches, expected 0")
    gen_tokens = torch.cat(out, 1)[0].tolist()
    if not all(0 <= t < cfg.padded_vocab for t in gen_tokens) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("lm decode: a token out of range or logits "
                             "not finite")
    prof = lm_profile(model, torch.from_numpy(tokens).to(device), caches,
                      tok, LM_SEQ + LM_DECODE - 1, sv)
    del caches, logits
    feat_tokens = torch.from_numpy(
        lm_inputs(cfg, LM_FEATURE_BATCH, LM_SEQ, LM_SEED + 1)).to(device)
    fn = lm_feature_fn(model)
    fn(feat_tokens)
    (feats, feat_s), fcounts = counted(lambda: synced(
        lambda: fn(feat_tokens)))
    if fcounts["flash_attention"] != cfg.num_layers \
            or tuple(feats.shape) != (LM_FEATURE_BATCH, cfg.d_model) \
            or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"lm_feature_fn: {fcounts['flash_attention']} "
                             f"launches, shape {tuple(feats.shape)}")
    rec = {"prefill_tokens": LM_SEQ, "prefill_s": prefill_s,
           "prefill_warm_s": warm_s,
           "prefill_tokens_per_s": LM_SEQ / prefill_s,
           "prefill_launches": prefill_counts,
           "kv_cache_bytes": kv, "decode_steps": LM_DECODE,
           "decode_s": decode_s,
           "decode_s_per_token": decode_s / LM_DECODE,
           "decode_s_per_token_median": float(np.median(steps)),
           "decode_tokens_per_s": LM_DECODE / decode_s,
           "decode_launches": counts, "greedy_tokens": gen_tokens,
           "feature_batch": [LM_FEATURE_BATCH, LM_SEQ],
           "feature_s": feat_s, "feature_launches": fcounts,
           "feature_shape": list(feats.shape), "profile": prof}
    return rec, store


def lm_profile(model, tokens, caches, tok, pos: int, sv) -> dict:
    """Where a prefill's and a decode step's time goes: one warm prefill
    of ``tokens`` (on the card) and one decode step at ``pos`` (it
    rewrites that slot of the padded caches) under torch.profiler
    (profile_batch: device busy by class, launches, the idle share), and
    the decode step as a CUDA graph of 3 steps (its device time with no
    host gaps)."""
    from repro_torch.models import lm
    prefill = lambda: lm.prefill(model, tokens, sv)
    step = lambda: lm.decode_step(model, caches, tok, pos, sv)
    return {"prefill": profile_batch(prefill, flash_counter()),
            "decode_step": {**profile_batch(step, flash_counter(),
                                            graph_fallback=True),
                            "graph_step_ms": graph_ms(step, iters=3)}}


def lm_gpu_vs_cpu(device, cfg, model) -> dict:
    """The model's first LM_CHECK_LAYERS layers, on the same weights, on
    the card and on the CPU (its plain versions): one LM_SEQ-token prefill
    at batch 1 (the flash branch on both sides), the final hidden state
    within LM_HIDDEN_TOL of its max |value|, the last logits' argmax
    equal."""
    import dataclasses
    import torch
    from repro_torch.models import lm
    small = dataclasses.replace(cfg, num_layers=LM_CHECK_LAYERS)
    full = dict(model.named_parameters())
    out = {}
    tokens = torch.from_numpy(lm_inputs(cfg, 1, LM_SEQ, LM_SEED + 2))
    for where in ("gpu", "cpu"):
        dev = device if where == "gpu" else torch.device("cpu")
        part = lm.LM(small, device=dev)
        with torch.no_grad():
            for name, p in part.named_parameters():
                p.copy_(full[name])
        x = tokens.to(dev)

        def run():
            with torch.no_grad():
                pos = torch.arange(LM_SEQ, device=dev)
                h, _, _ = lm._stack_forward(
                    part, lm.embed_inputs(part, x, pos), mode="prefill",
                    positions=pos)
                return h, lm.unembed(part, h[:, -1:])
        t0 = time.perf_counter()
        if where == "gpu":
            (h, logits), counts = counted(lambda: synced(run)[0])
        else:
            h, logits = run()
            counts = None
        out[where] = (h.float().cpu(), logits.float().cpu(),
                      time.perf_counter() - t0, counts)
        del part, h, logits
    hg, lg, gpu_s, counts = out["gpu"]
    hc, lc, cpu_s, _ = out["cpu"]
    if counts["flash_attention"] != LM_CHECK_LAYERS:
        raise AssertionError(f"lm gpu_vs_cpu: {counts['flash_attention']} "
                             f"flash launches")
    scale = float(hc.abs().max())
    err = float((hg - hc).abs().max())
    same_argmax = int(lg[0, -1].argmax()) == int(lc[0, -1].argmax())
    if not err <= LM_HIDDEN_TOL * scale or not same_argmax:
        raise AssertionError(f"lm gpu_vs_cpu: hidden err {err} (max "
                             f"{scale}), argmax equal {same_argmax}")
    return {"layers": LM_CHECK_LAYERS, "tokens": LM_SEQ,
            "hidden_max_abs_err": err, "hidden_max_abs": scale,
            "hidden_rel_err": err / scale, "tol": LM_HIDDEN_TOL,
            "logits_max_abs_err": float((lg - lc).abs().max()),
            "argmax": int(lc[0, -1].argmax()), "same_argmax": same_argmax,
            "gpu_s": gpu_s, "cpu_s": cpu_s}


def lm_consistency(device, arch: str, cut: bool) -> dict:
    """One architecture at full width on the card (seeded CUDA init):
    prefill(S) + LM_CONSIST_STEPS teacher-forced decode steps against
    prefill(S + steps) at the last position, flash launches by routing
    (flash_layers), the kernel held to its plain version at the first
    flash call's inputs."""
    import torch
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models import lm
    cfg = lm_config(arch, cut)
    sv = ServeConfig()
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (model, init_s) = synced(lambda: lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(LM_SEED),
        device=device))
    n_params = sum(p.numel() for p in model.parameters())
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    s, steps = LM_SEQ, LM_CONSIST_STEPS
    x = lm_inputs(cfg, 1, s + steps, LM_SEED + 3)
    store = []
    with first_flash_inputs(store):
        ((logits, caches), prefill_s), pc = counted(
            lambda: synced(lambda: lm.prefill(model, x[:, :s], sv)))
    if pc["flash_attention"] != flash_layers(cfg, s):
        raise AssertionError(f"{arch} prefill: {pc['flash_attention']} "
                             f"flash launches, expected "
                             f"{flash_layers(cfg, s)}")
    kernel = flash_at(store) if store else None
    store.clear()
    caches = lm.pad_caches(caches, cfg, s + steps)
    xt = torch.from_numpy(x).to(device)

    def decode():
        nonlocal logits, caches
        for t in range(s, s + steps):
            logits, caches = lm.decode_step(model, caches,
                                            xt[:, t:t + 1], t, sv)
    (_, decode_s), dc = counted(lambda: synced(decode))
    del caches
    (want, _), wc = counted(lambda: lm.prefill(model, xt, sv))
    if dc["flash_attention"] != 0 \
            or wc["flash_attention"] != flash_layers(cfg, s + steps):
        raise AssertionError(f"{arch}: decode {dc['flash_attention']}, "
                             f"prefill(S + {steps}) "
                             f"{wc['flash_attention']} flash launches")
    got, want = logits.float(), want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    peak = torch.cuda.max_memory_allocated() - base
    del model, logits, got, want, xt
    free_cuda()
    if not finite or not err <= LM_CONSIST_TOL * scale:
        raise AssertionError(f"{arch}: prefill + decode against prefill(S + "
                             f"{steps}): max |d| {err}, logits' max "
                             f"{scale}, finite {finite}")
    return {"arch": arch, "layers": cfg.num_layers,
            "full_layers": lm_config(arch, False).num_layers,
            "cut": ("one repeat of the scan pattern "
                    f"{list(cfg.scan_pattern()[0])}") if cut else None,
            "params": n_params, "weight_bytes": wbytes,
            "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype,
            "moe_capacity_factor": cfg.moe_capacity_factor
            if cfg.num_experts else None,
            "init_s": init_s, "prefill_s": prefill_s,
            "decode_s_per_token": decode_s / steps,
            "flash_launches": {"prefill": pc["flash_attention"],
                               "decode": dc["flash_attention"],
                               "prefill_s_plus": wc["flash_attention"]},
            "kernel_at_inputs": kernel, "max_abs_delta": err,
            "logits_max_abs": scale, "rel_delta": err / scale,
            "tol": LM_CONSIST_TOL, "peak_bytes": peak}


def phase_lm(device) -> dict:
    """The LM backbones' serving path on the card (ROADMAP A13a): llama3-8b
    whole at full width (lm_serve; the flash kernel held to its plain
    version at layer 0's own inputs and timed there, measure_flash), its
    first layer against the CPU (lm_gpu_vs_cpu), then every other
    assigned architecture at full width (lm_consistency), each freed
    before the next. Returns the record."""
    import torch
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    cfg = lm_config(LM_ARCH, False)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    model, init_s = synced(lambda: lm.init_params(cfg, generator=gen,
                                                  device=device))
    n_params = sum(p.numel() for p in model.parameters())
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    serve, store = lm_serve(device, cfg, model)
    peak = torch.cuda.max_memory_allocated() - base
    kernel = measure_flash(*store[0][:3], causal=store[0][3])
    store.clear()
    check = lm_gpu_vs_cpu(device, cfg, model)
    del model
    free_cuda()
    others = [lm_consistency(device, arch, cut) for arch, cut in LM_OTHERS]
    res = {"phase": "lm", "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                             cfg.num_kv_heads],
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "param_dtype": cfg.param_dtype,
           "params": n_params, "weight_bytes": wbytes, "init_s": init_s,
           "peak_bytes_above_start": peak, **serve,
           "kernel_at_layer0": kernel, "gpu_vs_cpu": check,
           "others": others, "phase_s": time.perf_counter() - t_phase}
    emit(res)
    return res


# LM training (ROADMAP A13b): internlm2-1.8b whole at full width and depth
# (24 AD layers, d 2048, 16 / 8 heads of 128, d_ff 8192, vocab 92,544;
# float32 parameters, bf16 compute; 1.89 B parameters, ~30 GB with
# gradients and AdamW's moments) drawn on the card from seed 0 and trained
# by Trainer.run: TrainConfig's defaults (remat "full", z-loss 1e-4,
# AdamW) with 1,024-token loss chunks, DataConfig(seq_len=4096,
# global_batch=2) from TokenSource (4,096: the shortest sequence that
# takes the flash branch)
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_SEQ = 4096
TRAIN_BATCH = 2
TRAIN_LOSS_CHUNK = 1024
TRAIN_WARM_STEPS = 2
TRAIN_STEPS = 5
# the one step with remat "none" (to show one launch a layer) takes the
# batch's first row: every activation is kept for the backward, ~1 GB a
# layer a row beside the 30 GB state
TRAIN_NONE_ROWS = 1
# the profiled step lists this many kernels of most device time in each
# class (flash, its backward, cuBLAS, the rest) and in each range
TRAIN_TOP_KERNELS = 12
# torch.profiler range around the step's clip and AdamW update
TRAIN_OPT_RANGE = "clip_and_update"
# card against CPU: the model's first layer (with the embedding, the
# final norm and the unembedding) on the same weights, batch 1 x 4,096,
# both sides in bf16 summing in other orders: the loss within 5e-3
# relative, grad_norm within 2e-2 relative, each parameter's gradient
# within 5e-2 of its max |value|
TRAIN_CHECK_LAYERS = 1       # 2 before the 1,000 s cut
TRAIN_LOSS_RTOL = 5e-3
TRAIN_GNORM_RTOL = 2e-2
TRAIN_GRAD_TOL = 5e-2
# the checkpoint round trip, at the reduced internlm2 config: 3 steps and
# a save, a new Trainer restores and takes step 4
TRAIN_CKPT_DIR = ROOT / "build" / "lm_train_checkpoint"
TRAIN_CKPT_STEPS = 3
TRAIN_CKPT_DATA = dict(seq_len=256, global_batch=4)


def lm_train_config():
    """(model config, TrainConfig, DataConfig) of the timed run."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig
    cfg = get_config(TRAIN_ARCH)
    return (cfg, TrainConfig(loss_chunk=TRAIN_LOSS_CHUNK),
            DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                       vocab_size=cfg.vocab_size, seed=LM_SEED))


def needs_train_counts(counts: dict, cfg, steps: int, remat: str,
                       what: str) -> None:
    """A step launches the kernel once a flash layer at TRAIN_SEQ, twice
    under a recomputing remat (the forward, then the backward's
    recompute), and the backward kernel once a layer; no forward or
    backward takes the plain version."""
    n = flash_layers(cfg, TRAIN_SEQ) * steps
    want = {"flash_attention": n * (1 if remat == "none" else 2),
            "backward_calls": n, "backward_launches": n,
            "plain_forward": 0, "plain_backward": 0}
    if counts != want:
        raise AssertionError(f"{what}: {counts}, expected {want}")


def lm_train_gpu_vs_cpu(device, cfg, tc, model) -> dict:
    """``model``'s first TRAIN_CHECK_LAYERS layers (its embedding, final
    norm and unembedding with them), on the same weights, on the card and
    on the CPU (the plain versions): forward_train and
    torch.autograd.grad on one TRAIN_SEQ-token batch of 1 (the flash
    branch on both sides; tc's remat, loss chunks and z-loss), the loss,
    the gradients' global norm and every gradient to the TRAIN_*
    tolerances."""
    import dataclasses
    import torch
    from repro_torch.models import lm
    from repro_torch.train.optimizer import global_norm
    small = dataclasses.replace(cfg, num_layers=TRAIN_CHECK_LAYERS)
    full = dict(model.named_parameters())
    tokens = lm_inputs(cfg, 1, TRAIN_SEQ + 1, LM_SEED + 4)
    x, y = (torch.from_numpy(np.ascontiguousarray(a))
            for a in (tokens[:, :-1], tokens[:, 1:]))
    out = {}
    for where in ("gpu", "cpu"):
        dev = device if where == "gpu" else torch.device("cpu")
        part = lm.LM(small, device=dev)
        with torch.no_grad():
            for name, p in part.named_parameters():
                p.copy_(full[name])
        part.requires_grad_(True)
        params = dict(part.named_parameters())

        def run():
            loss, _ = lm.forward_train(
                part, x.to(dev), y.to(dev), remat=tc.remat,
                loss_chunk=tc.loss_chunk, z_loss=tc.z_loss)
            grads = torch.autograd.grad(loss, list(params.values()))
            return loss.detach(), dict(zip(params, grads))
        with plain_attention_watch() as seen:
            zero_counts()
            t0 = time.perf_counter()
            loss, grads = run()
            gnorm = global_norm(grads)
            if where == "gpu":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = attention_counts(seen)
        out[where] = (float(loss), float(gnorm),
                      {k: g.float().cpu() for k, g in grads.items()},
                      secs, counts)
        del part, params, grads
    lg, ng, gg, gpu_s, counts = out["gpu"]
    lc, nc, gc, cpu_s, _ = out["cpu"]
    needs_train_counts(counts, small, 1, tc.remat, "lm_train gpu_vs_cpu")
    grad_err = {k: float((gg[k] - g).abs().max())
                / max(float(g.abs().max()), 1e-30) for k, g in gc.items()}
    worst = max(grad_err, key=grad_err.get)
    res = {"layers": TRAIN_CHECK_LAYERS, "tokens": TRAIN_SEQ,
           "loss": {"gpu": lg, "cpu": lc, "rel_err": abs(lg / lc - 1),
                    "tol": TRAIN_LOSS_RTOL},
           "grad_norm": {"gpu": ng, "cpu": nc, "rel_err": abs(ng / nc - 1),
                         "tol": TRAIN_GNORM_RTOL},
           "grad_max_err_of_max": grad_err[worst], "worst_grad": worst,
           "grad_tol": TRAIN_GRAD_TOL, "gpu_launches": counts,
           "gpu_s": gpu_s, "cpu_s": cpu_s}
    if not (res["loss"]["rel_err"] <= TRAIN_LOSS_RTOL
            and res["grad_norm"]["rel_err"] <= TRAIN_GNORM_RTOL
            and grad_err[worst] <= TRAIN_GRAD_TOL):
        raise AssertionError(f"lm_train gpu_vs_cpu: {res}")
    return res


def lm_train_resume(device) -> dict:
    """The checkpoint round trip on the card at the reduced config:
    Trainer A takes TRAIN_CKPT_STEPS steps and saves; Trainer B restores
    from the directory (``resumed_from``) and takes one step; Trainer C
    runs TRAIN_CKPT_STEPS + 1 steps uninterrupted. B's loss must equal C's
    last bitwise, and A's losses C's first."""
    import shutil
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer
    cfg = get_reduced_config(TRAIN_ARCH)
    tc = TrainConfig(loss_chunk=64)
    dc = DataConfig(vocab_size=cfg.vocab_size, seed=LM_SEED,
                    **TRAIN_CKPT_DATA)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    try:
        a = Trainer(cfg, tc, dc, device=device, checkpoint_dir=TRAIN_CKPT_DIR,
                    checkpoint_every=0)
        state, rep_a = a.run(TRAIN_CKPT_STEPS, log_every=0)
        a.ckpt.save(int(state.step), state)
        files = sorted(p.name for p in (
            TRAIN_CKPT_DIR / f"step_{TRAIN_CKPT_STEPS:08d}").iterdir())
        b = Trainer(cfg, tc, dc, device=device, checkpoint_dir=TRAIN_CKPT_DIR)
        _, rep_b = b.run(1, log_every=0)
        c = Trainer(cfg, tc, dc, device=device)
        _, rep_c = c.run(TRAIN_CKPT_STEPS + 1, log_every=0)
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    res = {"config": cfg.name, "steps_saved": TRAIN_CKPT_STEPS,
           "leaf_files": len(files) - 1,
           "resumed_from": rep_b.resumed_from,
           "resumed_loss": rep_b.losses[0],
           "uninterrupted_losses": rep_c.losses, "first_losses": rep_a.losses,
           "bitwise": rep_b.losses[0] == rep_c.losses[-1]
           and rep_a.losses == rep_c.losses[:TRAIN_CKPT_STEPS]}
    if rep_b.resumed_from != TRAIN_CKPT_STEPS or not res["bitwise"]:
        raise AssertionError(f"lm_train resume: {res}")
    return res


@contextlib.contextmanager
def optimizer_range():
    """While open, the train step's clip_by_global_norm and AdamW.update
    run inside the torch.profiler range TRAIN_OPT_RANGE; restores both on
    leaving."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.train.optimizer import AdamW
    clip, update = steps.clip_by_global_norm, AdamW.update

    def ranged(fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(TRAIN_OPT_RANGE):
                return fn(*args, **kwargs)
        return call
    steps.clip_by_global_norm, AdamW.update = ranged(clip), ranged(update)
    try:
        yield
    finally:
        steps.clip_by_global_norm, AdamW.update = clip, update


def phase_lm_train(device) -> dict:
    """LM training on the card (ROADMAP A13b): internlm2-1.8b whole at full
    width and depth trained by Trainer.run (TRAIN_WARM_STEPS warm-up
    steps, TRAIN_STEPS timed), the flash kernel launched twice a layer a
    step (the forward and the remat recompute) and the backward kernel
    once, no plain forward or backward; finite losses and every
    parameter changed; one step under torch.profiler; one step with
    remat "none" on TRAIN_NONE_ROWS rows (once a layer); two layers
    against the CPU (lm_train_gpu_vs_cpu, on the initial weights); the
    kernel held to its plain version and timed at the training step's
    attention inputs (measure_flash), the backward kernel at its own
    (attention_backward_times: held to the plain version, both timed by
    events and CUDA graphs, SDPA's forward + backward, the bound; and
    attention_backward_memory: two calls bitwise equal, each version's
    peak above its inputs and outputs); the checkpoint round trip
    (lm_train_resume). Returns the record."""
    import dataclasses
    import torch
    from repro_torch.device import to_device_async
    from repro_torch.launch.steps import derive_generator, make_train_step
    from repro_torch.train.trainer import Trainer
    t_phase = time.perf_counter()
    cfg, tc, dc = lm_train_config()
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = Trainer(cfg, tc, dc, device=device, step_deadline_s=600)
    state, init_s = synced(lambda: tr.init_or_restore(tc.seed))
    params = dict(state.model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    state_bytes = sum(t.numel() * t.element_size() for t in (
        *params.values(), *state.opt.m.values(), *state.opt.v.values()))
    check = lm_train_gpu_vs_cpu(device, cfg, tc, state.model)
    free_cuda()
    before = {k: p.detach().to("cpu", copy=True)
              for k, p in params.items()}
    state, warm = tr.run(TRAIN_WARM_STEPS, state=state, log_every=0)
    torch.cuda.reset_peak_memory_stats()
    store = []
    with first_flash_inputs(store), plain_attention_watch() as seen:
        zero_counts()
        state, rep = tr.run(TRAIN_STEPS, state=state, log_every=0)
        counts = attention_counts(seen)
        bwd_in = seen["bwd_inputs"]
    peak = torch.cuda.max_memory_allocated()
    needs_train_counts(counts, cfg, TRAIN_STEPS, tc.remat, "lm_train")
    losses = warm.losses + rep.losses
    unchanged = [k for k, p in params.items()
                 if torch.equal(p.detach().to("cpu"), before[k])]
    del before
    if not np.isfinite(losses).all() or unchanged:
        raise AssertionError(f"lm_train: losses {losses}, parameters "
                             f"unchanged {unchanged}")
    # one more step under the profiler, then one with remat "none"
    step = int(state.step)
    batch = {k: to_device_async(v, device)
             for k, v in tr.source.batch(step).items()}
    gen = derive_generator(tc.seed ^ 0x5EED, step)
    fn = lambda: tr.step_fn(state, batch, gen)
    with optimizer_range():
        prof = profile_batch(fn, flash_counter(),
                             ranges=(TRAIN_OPT_RANGE,),
                             top_by_class=TRAIN_TOP_KERNELS)
    none_step = make_train_step(cfg, dataclasses.replace(tc, remat="none"))
    rows = {k: v[:TRAIN_NONE_ROWS] for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    with plain_attention_watch() as seen_none:
        zero_counts()
        (_, m_none), none_s = synced(lambda: none_step(state, rows, gen))
        counts_none = attention_counts(seen_none)
    needs_train_counts(counts_none, cfg, 1, "none", "lm_train remat none")
    none_peak = torch.cuda.max_memory_allocated()
    del state, params, tr, fn, none_step, batch
    free_cuda()
    kernel = measure_flash(*store[0][:3], causal=store[0][3])
    store.clear()
    bwd = attention_backward_times(*bwd_in)
    bwd_mem = attention_backward_memory(*bwd_in)
    del bwd_in
    free_cuda()
    resume = lm_train_resume(device)
    step_s = TRAIN_STEPS * dc.global_batch * dc.seq_len \
        / rep.tokens_per_s / TRAIN_STEPS
    res = {"phase": "lm_train", "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                             cfg.num_kv_heads],
           "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "params": n_params,
           "state_bytes": state_bytes, "init_s": init_s,
           "train_config": dataclasses.asdict(tc),
           "batch": [dc.global_batch, dc.seq_len],
           "warm_steps": TRAIN_WARM_STEPS, "timed_steps": TRAIN_STEPS,
           "losses": losses, "s_per_step": step_s,
           "tokens_per_s": rep.tokens_per_s,
           "straggler_events": rep.straggler_events,
           "peak_bytes": peak, "peak_bytes_above_start": peak - base,
           "launches": counts,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in counts.items()},
           "remat_none_step": {"rows": TRAIN_NONE_ROWS,
                               "launches": counts_none, "s": none_s,
                               "loss": float(m_none["loss"]),
                               "peak_bytes": none_peak},
           "profile_one_step": prof, "gpu_vs_cpu": check,
           "kernel_at_train_inputs": kernel, "attention_backward": bwd,
           "attention_backward_memory": bwd_mem, "resume": resume,
           "phase_s": time.perf_counter() - t_phase}
    emit(res)
    return res


# the LM on a mesh, serving (ROADMAP A13c-1): internlm2-1.8b whole at
# full width and depth (24 AD layers, d 2048, 16 / 8 heads of 128, d_ff
# 8192, vocab 92,544), bf16 weights from seed 0 drawn alike by the
# single-rank run and every rank (init_params(..., mesh=) draws each
# module whole and keeps its shard), served through make_prefill_step /
# make_decode_step / lm_feature_fn on four meshes of one world of 4 ranks
# on the one card: a 1 x 4,096-token prefill (the flash branch), 2
# teacher-forced decode steps over the sequence-sharded cache and
# lm_feature_fn on 2 x 4,096 (the data x model mesh: batch 2 throughout)
MESH_ARCH = "internlm2-1.8b"
MESH_SEQ = 4096
MESH_DECODE = 2                # 8 before the 1,000 s cut
MESH_FEATURE_BATCH = 2
MESH_WARM_SEQ = 64             # a short prefill first: cuBLAS, gloo pairs
MESH_WORLD = 4
# (name, mesh shape over world ranks 0.., seq_parallel, batch): head on
# (1, 4) (16 heads, 4 a rank: the flash kernel on each rank's heads); qseq
# on a world of 3 at (1, 3) (16 % 3 != 0); ctxpar (seq_parallel); data x
# model with batch 2
MESH_MODES = (("head", (1, 4), False, 1), ("qseq", (1, 3), False, 1),
              ("ctxpar", (1, 4), True, 1), ("data_model", (2, 2), False, 2))
MESH_BACKEND = "gloo"
MESH_BACKEND_WHY = ("every rank is a process on the one card: NCCL refuses "
                    "two ranks on one device; gloo takes CUDA tensors "
                    "(staged through host memory)")
# limits set before the first run, against the single-rank run on the
# card: the hidden state after the first two layers within 2e-2 of its
# max |value| (the lm phase's), last-position and every decode step's
# logits and the pooled features within 5e-2 of their max; MoE dispatch
# counts bitwise
MESH_CHECK_LAYERS = 2
MESH_HIDDEN_TOL = 2e-2
MESH_LOGITS_TOL = 5e-2
# qwen3-moe-235b-a22b at full width, cut to 2 of its 94 layers (its bf16
# weights, 470 GB whole, are what needs a mesh), its 128 experts split 32
# a rank on (1, 4); the config's own capacity factor 1.25. Its compute in
# float32: the dispatch counts are held bitwise, and in bf16 the row-
# parallel all-reduce rounds the router's input other than one product
# does (a last-bit difference moves a token's 8th expert now and then)
MESH_MOE_ARCH = "qwen3-moe-235b-a22b"
MESH_MOE_LAYERS = 2
MESH_MOE_MESH = (1, 4)
MESH_MOE_COMPUTE = "float32"
MESH_JOIN_S = 900
# the collectives the port's mesh calls (models/common.py's all_reduce,
# sum over bf16 and f32 activations and the f32 flash-decoding partials,
# max over the f32 running maxima; all_gather and DTensor's redistribute,
# an all-gather into one tensor of bf16 and f32): a rank fails unless
# gloo does each on the card's tensors; gloo_check's others are recorded
MESH_COLLECTIVES = ("all_reduce_sum_f32", "all_reduce_sum_bf16",
                    "all_reduce_max_f32", "all_gather_single",
                    "all_gather_single_bf16")


def mesh_config(arch: str, layers=None, compute: str = "bfloat16"):
    """The arch's full-width config with bf16 weights, ``compute``
    activations, cut to ``layers`` where given."""
    import dataclasses
    from repro_torch.configs import get_config
    over = {"param_dtype": "bfloat16", "compute_dtype": compute}
    if layers:
        over["num_layers"] = layers
    return dataclasses.replace(get_config(arch), **over)


@contextlib.contextmanager
def layer_output(store: list, index: int):
    """Records (whole, float32, numpy) the residual after layer
    ``index`` of the first prefill made inside; on a mesh it is gathered
    over the batch and sequence axes by a context of its own, so the
    step's collective counts do not see it."""
    import dataclasses
    from repro_torch.models import lm
    from repro_torch.models.common import CommStats, all_gather
    raw = lm._apply_layer
    seen = [0]

    def hook(layer, x, cfg, **kw):
        out = raw(layer, x, cfg, **kw)
        if kw["mode"] == "prefill":
            if seen[0] == index and not store:
                h, ctx, lay = out[0], kw.get("ctx"), kw.get("lay")
                if ctx is not None and ctx.mesh is not None:
                    own = dataclasses.replace(ctx, comm=CommStats())
                    h = all_gather(all_gather(h, own, lay.seq_axis, 1,
                                              lay.s), own, lay.bax, 0)
                store.append(h.float().cpu().numpy())
            seen[0] += 1
        return out
    lm._apply_layer = hook
    try:
        yield store
    finally:
        lm._apply_layer = raw


@contextlib.contextmanager
def dispatch_counts(store: list):
    """Records each MoE dispatch's top-k experts made inside (a copy on
    the device, no sync) with the expert count; ``dispatch_lists`` turns
    them into tokens per expert after the timed window."""
    from repro_torch.models import moe
    raw = moe._dispatch_group

    def rec(p, xt, **kw):
        d = raw(p, xt, **kw)
        store.append((d.expert_idx.reshape(-1).clone(), p.router.shape[1]))
        return d
    moe._dispatch_group = rec
    try:
        yield store
    finally:
        moe._dispatch_group = raw


def dispatch_lists(store: list) -> list:
    """dispatch_counts' records as tokens per expert (bincount lists)."""
    import torch
    return [torch.bincount(i, minlength=e).tolist() for i, e in store]


def kernel_inputs_np(store: list):
    """first_flash_inputs' record as numpy for a queue (bf16 as its int16
    bits), None where no flash call was made."""
    import torch
    if not store:
        return None
    q, k, v, causal = store[0]
    bits = lambda t: (t.view(torch.int16) if t.dtype == torch.bfloat16
                      else t).cpu().numpy()
    return {"qkv": [bits(t) for t in (q, k, v)], "causal": causal,
            "dtype": str(q.dtype).replace("torch.", "")}


def kernel_inputs_of(rec: dict, device):
    """kernel_inputs_np's record back as (q, k, v, causal) on ``device``."""
    import torch
    dt = getattr(torch, rec["dtype"])
    q, k, v = (torch.from_numpy(a).to(device).view(dt) for a in rec["qkv"])
    return q, k, v, rec["causal"]


def mesh_serve(device, cfg, mesh, seq_parallel: bool, batch: int,
               features: bool = True) -> dict:
    """cfg served through the step factories on ``mesh`` (None: the one
    rank): the model drawn from seed LM_SEED, a short warm prefill, an
    untimed MESH_SEQ-token prefill for the checks (the residual after
    layer MESH_CHECK_LAYERS gathered whole, the MoE dispatch counts, the
    first flash call's inputs), then the timed MESH_SEQ-token prefill
    with nothing of the checks inside (the whole last-position logits,
    flash launches, collective bytes), pad_caches, MESH_DECODE teacher-
    forced decode steps (each step's whole logits, copied out after its
    timed window; the dispatch counts after the last) and, with
    ``features``,
    lm_feature_fn on MESH_FEATURE_BATCH x MESH_SEQ. Peak
    memory is this process's, and above what it held at the start (the
    single-rank run's process holds earlier phases' tensors)."""
    import torch
    from repro_torch.configs.base import ServeConfig
    from repro_torch.features.extract import lm_feature_fn
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.models.common import gather_placed as whole
    sv = ServeConfig(seq_parallel=seq_parallel)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    model, init_s = synced(lambda: lm.init_params(
        cfg, generator=gen, device=device, mesh=mesh))
    local_bytes = sum(p.to_local().numel() * p.element_size()
                      if mesh is not None else p.numel() * p.element_size()
                      for p in model.parameters())
    prefill = steps.make_prefill_step(cfg, sv, mesh)
    decode = steps.make_decode_step(cfg, sv, mesh)
    x = torch.from_numpy(lm_inputs(cfg, batch, MESH_SEQ + MESH_DECODE,
                                   LM_SEED + 4)).to(device)
    synced(lambda: prefill(model, x[:, :MESH_WARM_SEQ]))
    hidden, disp, flash_in = [], [], []
    with layer_output(hidden, MESH_CHECK_LAYERS - 1), \
            dispatch_counts(disp), first_flash_inputs(flash_in):
        synced(lambda: prefill(model, x[:, :MESH_SEQ]))
    out = {"hidden": hidden[0], "decode_logits": [],
           "prefill_dispatch": dispatch_lists(disp),
           "flash_inputs": kernel_inputs_np(flash_in) if mesh is not None
           else None}
    del disp, flash_in
    prefill.ctx.comm.reset()
    ((logits, caches), prefill_s), pc = counted(
        lambda: synced(lambda: prefill(model, x[:, :MESH_SEQ])))
    prefill_comm = prefill.ctx.comm.snapshot()
    out["logits"] = whole(logits).float().cpu().numpy()
    del logits
    caches = lm.pad_caches(caches, cfg, MESH_SEQ + MESH_DECODE, prefill.ctx)
    step_s, disp = [], []
    zero_counts()
    with dispatch_counts(disp):
        for t in range(MESH_SEQ, MESH_SEQ + MESH_DECODE):
            (lg, caches), s = synced(lambda: decode(model, caches,
                                                    x[:, t:t + 1], t))
            step_s.append(s)
            out["decode_logits"].append(whole(lg).float().cpu().numpy())
    dc = read_counts()
    out["decode_dispatch"] = dispatch_lists(disp)
    del caches
    rec = {"batch": batch, "init_s": init_s,
           "param_bytes_local": local_bytes, "prefill_tokens":
           batch * MESH_SEQ, "prefill_s": prefill_s,
           "prefill_tokens_per_s": batch * MESH_SEQ / prefill_s,
           "prefill_flash_launches": pc["flash_attention"],
           "prefill_comm": prefill_comm, "decode_steps": MESH_DECODE,
           "decode_s_per_token": float(np.median(step_s)),
           "decode_s_first": step_s[0],
           "decode_flash_launches": dc["flash_attention"],
           "decode_comm": decode.ctx.comm.snapshot()}
    if features:
        fx = torch.from_numpy(lm_inputs(cfg, MESH_FEATURE_BATCH, MESH_SEQ,
                                        LM_SEED + 5)).to(device)
        fn = lm_feature_fn(model, prefill.ctx)
        prefill.ctx.comm.reset()
        (feats, feat_s), fc = counted(lambda: synced(lambda: fn(fx)))
        out["features"] = feats.float().cpu().numpy()
        rec.update({"feature_batch": [MESH_FEATURE_BATCH, MESH_SEQ],
                    "feature_s": feat_s,
                    "feature_flash_launches": fc["flash_attention"],
                    "feature_comm": prefill.ctx.comm.snapshot()})
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["peak_bytes_above_start"] = rec["peak_bytes"] - base
    rec["mode"] = lm.attn_parallel_mode(cfg, prefill.ctx)
    del model
    free_cuda()
    return {"record": rec, "out": out}


def gloo_check(world: int, dev) -> dict:
    """Which collectives gloo takes on ``dev``'s tensors here (every rank
    calls each; a value check beside): "ok", "wrong" or the error."""
    import torch
    import torch.distributed as dist
    from repro_torch.compat import all_gather_single
    one = lambda n=4, dt=torch.float32: torch.ones(n, dtype=dt, device=dev)

    def gather_into(dt=torch.float32):
        out = torch.empty(4 * world, dtype=dt, device=dev)
        all_gather_single(out, one(4, dt), None)
        return bool((out == 1).all())

    def reduce_scatter():
        out = torch.empty(4, device=dev)
        rs = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        rs(out, one(4 * world))
        return bool((out == world).all())

    def all_to_all():
        out = torch.empty(4 * world, device=dev)
        dist.all_to_all_single(out, one(4 * world))
        return bool((out == 1).all())

    def reduce(op, dt):
        t = one(4, dt)
        dist.all_reduce(t, op=op)
        return bool((t == (world if op == dist.ReduceOp.SUM else 1)).all())

    def gather_list():
        outs = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(outs, one())
        return all(bool((o == 1).all()) for o in outs)

    def broadcast():
        t = one()
        dist.broadcast(t, src=0)
        return bool((t == 1).all())
    checks = {"all_reduce_sum_f32": lambda: reduce(dist.ReduceOp.SUM,
                                                   torch.float32),
              "all_reduce_sum_bf16": lambda: reduce(dist.ReduceOp.SUM,
                                                    torch.bfloat16),
              "all_reduce_max_f32": lambda: reduce(dist.ReduceOp.MAX,
                                                   torch.float32),
              "all_gather": gather_list,
              "all_gather_single": gather_into,
              "all_gather_single_bf16": lambda: gather_into(torch.bfloat16),
              "reduce_scatter_tensor": reduce_scatter,
              "all_to_all_single": all_to_all, "broadcast": broadcast}
    out = {}
    for name, fn in checks.items():
        try:
            out[name] = "ok" if fn() else "wrong"
        except Exception as e:    # a collective gloo lacks: its message
            out[name] = f"{type(e).__name__}: {str(e)[:120]}"
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return out


def mesh_rank(rank: int, world: int, store_path: str, device_type: str,
              q) -> None:
    """One rank of the lm_mesh world with gloo, on cuda:0 (the one card)
    for ``device_type`` "cuda": the collective check, then every
    MESH_MODES mesh it belongs to, then the MoE mesh; puts (rank, record)
    or (rank, traceback) on ``q``. A crash of the process writes its
    Python stack to mesh_fault_path(rank)."""
    import faulthandler
    import traceback
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    fault = open(mesh_fault_path(rank), "w")
    faulthandler.enable(fault)
    dev = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device(device_type)
    try:
        tmesh.init_process_group(MESH_BACKEND, rank=rank, world_size=world,
                                 init_method=f"file://{store_path}",
                                 device=dev)
        res = {"collectives": gloo_check(world, dev)}
        bad = {k: v for k, v in res["collectives"].items() if v != "ok"}
        if bad.keys() & set(MESH_COLLECTIVES):
            raise RuntimeError(f"gloo lacks a collective the mesh uses on "
                               f"{dev.type} tensors: {bad}")
        cfg = mesh_config(MESH_ARCH)
        for name, shape, seqp, batch in MESH_MODES:
            mesh = tmesh.mesh_of(shape, ("data", "model"), device_type)
            if mesh.get_coordinate() is not None:
                res[name] = mesh_serve(dev, cfg, mesh, seqp, batch)
        mesh = tmesh.mesh_of(MESH_MOE_MESH, ("data", "model"), device_type)
        res["moe"] = mesh_serve(dev, mesh_config(
            MESH_MOE_ARCH, MESH_MOE_LAYERS, MESH_MOE_COMPUTE), mesh, False, 1,
            features=False)
        # numpy only through the queue (a tensor would travel as a file
        # descriptor of a rank that may have exited); rank 0 sends the
        # whole outputs
        if rank != 0:
            for v in res.values():
                if isinstance(v, dict):
                    v.pop("out", None)
        q.put((rank, res))
    except Exception:
        q.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def mesh_fault_path(rank: int) -> Path:
    """Where lm_mesh's rank ``rank`` writes its stack if it crashes."""
    return ROOT / "build" / f"lm_mesh_rank{rank}.fault"


def run_world(target, args: tuple, join_s: float, what: str) -> dict:
    """Spawn MESH_WORLD ranks (``spawn``) on ``target(rank, world, store,
    *args, q)``; {rank: record}. Every rank is joined under ``join_s`` and
    killed past it; a rank that dies without answering ends the wait at
    once; a failed rank raises, with the stacks of any that crashed."""
    import multiprocessing as mp
    import queue as queue_mod
    store = ROOT / "build" / f"lm_mesh_store_{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, MESH_WORLD, str(store),
                                              *args, q))
             for r in range(MESH_WORLD)]
    for p in procs:
        p.start()
    results, t0 = {}, time.perf_counter()
    try:
        while len(results) < MESH_WORLD \
                and time.perf_counter() - t0 < join_s:
            try:
                rank, res = q.get(timeout=5)
                results[rank] = res
            except queue_mod.Empty:
                if any(p.exitcode for p in procs):
                    break
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        store.unlink(missing_ok=True)
    bad = {r: v for r, v in results.items() if isinstance(v, str)}
    if bad:
        raise AssertionError(f"{what} ranks failed:\n" + "\n".join(
            f"rank {r}:\n{v}" for r, v in sorted(bad.items())))
    codes = [p.exitcode for p in procs]
    if len(results) < MESH_WORLD or any(codes):
        stacks = "".join(
            f"\nrank {r}:\n{mesh_fault_path(r).read_text()[-3000:]}"
            for r in range(MESH_WORLD) if mesh_fault_path(r).exists()
            and mesh_fault_path(r).stat().st_size)
        raise AssertionError(f"{what}: ranks answered {sorted(results)}, "
                             f"exit codes {codes}{stacks}")
    return results


def run_mesh_world(device_type: str) -> dict:
    """The lm_mesh world: mesh_rank on every rank (run_world)."""
    return run_world(mesh_rank, (device_type,), MESH_JOIN_S, "lm_mesh")


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (numpy arrays)."""
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def mesh_compare(single: dict, mesh: dict, what: str) -> dict:
    """One mesh run's whole outputs against the single-rank run's, within
    the limits; raises beyond them."""
    s, m = single["out"], mesh["out"]
    err = {"hidden": _rel_err(m["hidden"], s["hidden"]),
           "prefill_logits": _rel_err(m["logits"], s["logits"]),
           "decode_logits": [_rel_err(a, b) for a, b in
                             zip(m["decode_logits"], s["decode_logits"])]}
    if "features" in s:
        err["features"] = _rel_err(m["features"], s["features"])
    ok = (err["hidden"] <= MESH_HIDDEN_TOL
          and err["prefill_logits"] <= MESH_LOGITS_TOL
          and len(err["decode_logits"]) == MESH_DECODE
          and max(err["decode_logits"]) <= MESH_LOGITS_TOL
          and err.get("features", 0.0) <= MESH_LOGITS_TOL)
    err["dispatch_equal"] = (m["prefill_dispatch"] == s["prefill_dispatch"]
                             and m["decode_dispatch"]
                             == s["decode_dispatch"])
    if not ok or not err["dispatch_equal"]:
        raise AssertionError(f"lm_mesh {what}: {err}")
    return err


def phase_lm_mesh(device) -> dict:
    """The LM on a mesh (ROADMAP A13c-1): the single-rank runs on the card
    (internlm2-1.8b at batch 1 and 2, qwen3-moe cut to 2 layers), then
    one world of MESH_WORLD gloo ranks on the card runs each MESH_MODES
    mesh and the MoE mesh; every mode within the limits against the
    single-rank run, the flash kernel once a layer a prefill on each rank
    in head mode, and held to its plain version (measure_flash, which
    raises beyond FLASH_TOL) at rank 0's layer-0 inputs in head, data x
    model and the MoE's float32 run. Returns the record."""
    import torch
    t_phase = time.perf_counter()
    cfg = mesh_config(MESH_ARCH)
    moe_cfg = mesh_config(MESH_MOE_ARCH, MESH_MOE_LAYERS, MESH_MOE_COMPUTE)
    single = {b: mesh_serve(device, cfg, None, False, b)
              for b in sorted({m[3] for m in MESH_MODES})}
    single_moe = mesh_serve(device, moe_cfg, None, False, 1,
                            features=False)
    free_cuda()
    world = run_mesh_world(device.type)
    modes = {}
    for name, shape, seqp, batch in MESH_MODES:
        ranks = [r for r in sorted(world) if name in world[r]]
        recs = [world[r][name]["record"] for r in ranks]
        err = mesh_compare(single[batch], world[0][name], name)
        want = cfg.num_layers if name in ("head", "data_model") else 0
        launches = [r["prefill_flash_launches"] for r in recs]
        flaunches = [r["feature_flash_launches"] for r in recs]
        if launches != [want] * len(ranks) \
                or flaunches != [want] * len(ranks) \
                or any(r["decode_flash_launches"] for r in recs):
            raise AssertionError(f"lm_mesh {name}: flash launches prefill "
                                 f"{launches}, features {flaunches}, want "
                                 f"{want} a rank")
        modes[name] = {"mesh": list(shape), "seq_parallel": seqp,
                       "batch": batch, "ranks": ranks,
                       "attn_mode": recs[0]["mode"], "vs_single": err,
                       "per_rank": recs}
    # the kernel at the local heads the mesh gives it, after the world
    # has exited (the card to this process alone)
    kernel_at = {}
    for name in ("head", "data_model", "moe"):
        kin = world[0][name]["out"]["flash_inputs"]
        if kin is None:
            raise AssertionError(f"lm_mesh {name}: rank 0 made no flash "
                                 f"call to check")
        q, k, v, causal = kernel_inputs_of(kin, device)
        kernel_at[name] = measure_flash(q, k, v, causal)
        del q, k, v
        free_cuda()
    recs = [world[r]["moe"]["record"] for r in sorted(world)]
    moe = {"arch": moe_cfg.name, "layers": moe_cfg.num_layers,
           "full_layers": mesh_config(MESH_MOE_ARCH).num_layers,
           "cut": f"depth {MESH_MOE_LAYERS} of "
                  f"{mesh_config(MESH_MOE_ARCH).num_layers} layers",
           "mesh": list(MESH_MOE_MESH), "experts": moe_cfg.num_experts,
           "capacity_factor": moe_cfg.moe_capacity_factor,
           "compute_dtype": moe_cfg.compute_dtype,
           "vs_single": mesh_compare(single_moe, world[0]["moe"], "moe"),
           "dispatch_counts_prefill": world[0]["moe"]["out"][
               "prefill_dispatch"],
           "per_rank": recs, "single": single_moe["record"]}
    res = {"phase": "lm_mesh", "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": [cfg.num_heads,
                                             cfg.num_kv_heads],
           "param_dtype": cfg.param_dtype, "backend": MESH_BACKEND,
           "backend_why": MESH_BACKEND_WHY, "world": MESH_WORLD,
           "device": torch.cuda.get_device_name(0),
           "collectives": {device.type: world[0]["collectives"]},
           "tolerances": {"hidden": MESH_HIDDEN_TOL,
                          "logits": MESH_LOGITS_TOL},
           "single": {b: v["record"] for b, v in single.items()},
           "modes": modes, "moe": moe,
           "kernel_at_mesh_inputs": kernel_at,
           "phase_s": time.perf_counter() - t_phase}
    emit(res)
    return res


# the LM trained on a mesh (ROADMAP A13c-2): one world of 4 gloo ranks on
# the one card trains through Trainer(mesh=...) / make_train_step(cfg, tc,
# mesh), each run from seed LM_SEED drawn alike by the single-rank oracle
# and every rank: internlm2-1.8b (f32 parameters, bf16 compute) at full
# width in its own default_train_config (zero3, remat "full", loss chunks
# of 512) on (2, 2) with a global batch of 4 x 4,096 (one row a rank),
# the same in fsdp_tp on (2, 2), data x model (head mode: 8 heads a rank)
# with 2 x 4,096, and qwen3-moe at the lm_mesh serving cut (2 of 94
# layers, bf16 weights, f32 compute, 32 experts a rank on (1, 4)) with
# 1 x 4,096 (its default_train_config with 1 microbatch: its default
# splits train_4k's 256 rows into 16). Depth: MESH_TRAIN_LAYERS of
# internlm2's 24, so the leg's gloo traffic (~0.5-0.7 GB/s a rank, PR 25)
# keeps the whole script inside its limit
MESH_TRAIN_ARCH = "internlm2-1.8b"
MESH_TRAIN_LAYERS = 2
MESH_TRAIN_SEQ = 4096
MESH_TRAIN_STEPS = 1           # timed steps (2 before the 1,000 s cut)
# (name, arch, mesh shape, sharding mode, global batch of the timed run)
MESH_TRAIN_RUNS = (("zero3", MESH_TRAIN_ARCH, (2, 2), "zero3", 4),
                   ("fsdp_tp", MESH_TRAIN_ARCH, (2, 2), "fsdp_tp", 2),
                   ("moe", MESH_MOE_ARCH, MESH_MOE_MESH, "fsdp_tp", 1))
# the check: one step's loss_and_grads from the initial state on the
# single rank (the oracle, before the world starts) and on the mesh, at
# the check batch (internlm2: 4 x 4,096 for both of its runs; the MoE:
# its own batch); limits set before the first run (PR 24's card limits):
# loss and grad norm within 5e-3 relative, every gradient within 5e-2 of
# its max |value| (each rank's shard against the oracle's slice of it:
# the gathered gradient's error), the MoE dispatch counts bitwise
MESH_TRAIN_CHECK_ROWS = {MESH_TRAIN_ARCH: 4, MESH_MOE_ARCH: 1}
MESH_TRAIN_RTOL = 5e-3
MESH_TRAIN_GRAD_TOL = 5e-2
MESH_TRAIN_ORACLE = ROOT / "build" / "lm_mesh_train_oracle"
MESH_TRAIN_JOIN_S = 900
# the collectives the training world calls: the serving world's, and the
# reduce-scatter of every all-gather's backward
MESH_TRAIN_COLLECTIVES = MESH_COLLECTIVES + ("reduce_scatter_tensor",)


def mesh_train_config(arch: str, mode: str, batch: int):
    """(cfg, tc, dc) of a training run on the mesh: the arch's
    default_train_config in ``mode`` with one microbatch; internlm2 at
    full width cut to MESH_TRAIN_LAYERS, qwen3-moe as the lm_mesh serving
    cut (mesh_config)."""
    import dataclasses
    from repro_torch.configs import default_train_config, get_config
    from repro_torch.data.pipeline import DataConfig
    if arch == MESH_MOE_ARCH:
        cfg = mesh_config(arch, MESH_MOE_LAYERS, MESH_MOE_COMPUTE)
    else:
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=MESH_TRAIN_LAYERS)
    tc = dataclasses.replace(default_train_config(arch), sharding_mode=mode,
                             microbatches=1)
    dc = DataConfig(seq_len=MESH_TRAIN_SEQ, global_batch=batch,
                    vocab_size=cfg.vocab_size, seed=LM_SEED)
    return cfg, tc, dc


def mesh_train_check_batch(cfg, arch: str, device) -> dict:
    """The check's batch: MESH_TRAIN_CHECK_ROWS[arch] rows of MESH_TRAIN_SEQ
    seeded tokens, targets shifted by one."""
    import torch
    t = lm_inputs(cfg, MESH_TRAIN_CHECK_ROWS[arch], MESH_TRAIN_SEQ + 1,
                  LM_SEED + 6)
    return {"inputs": torch.from_numpy(np.ascontiguousarray(
                t[:, :-1])).to(device),
            "targets": torch.from_numpy(np.ascontiguousarray(
                t[:, 1:])).to(device)}


def grad_numpy(g):
    """A gradient as numpy for the oracle's files (bf16 as its int16
    bits)."""
    import torch
    g = g.detach()
    return (g.view(torch.int16) if g.dtype == torch.bfloat16
            else g).cpu().numpy()


def mesh_train_oracle(device, arch: str) -> dict:
    """The single rank's check step of ``arch`` (loss_and_grads from the
    initial state at the check batch), its gradients written one file a
    parameter under MESH_TRAIN_ORACLE/<arch>: the loss, the grad norm,
    each gradient's max |value|, the dispatch counts."""
    import shutil
    import torch
    from repro_torch.launch.steps import (TrainState, derive_generator,
                                          make_train_step, trainable_)
    from repro_torch.models import lm
    from repro_torch.train.optimizer import global_norm
    cfg, tc, _ = mesh_train_config(arch, "fsdp_tp", 1)
    out_dir = MESH_TRAIN_ORACLE / arch
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    free_cuda()
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    model = trainable_(lm.init_params(cfg, generator=gen, device=device))
    step = make_train_step(cfg, tc)
    data = mesh_train_check_batch(cfg, arch, device)
    disp = []
    with dispatch_counts(disp), plain_attention_watch() as seen:
        zero_counts()
        (metrics, grads), secs = synced(lambda: step.loss_and_grads(
            TrainState(model, None, 0), data,
            derive_generator(tc.seed ^ 0x5EED, 0)))
        counts = attention_counts(seen)
    peak = torch.cuda.max_memory_allocated()
    rec = {"loss": float(metrics["ce_loss"]),
           "grad_norm": float(global_norm(grads)), "s": secs,
           "launches": counts, "peak_bytes": peak,
           "dispatch": dispatch_lists(disp), "dir": str(out_dir),
           "max": {}, "dtype": {}}
    for k, g in grads.items():
        rec["max"][k] = float(g.float().abs().max())
        rec["dtype"][k] = str(g.dtype).replace("torch.", "")
        np.save(out_dir / f"{k}.npy", grad_numpy(g))
    del model, grads, step, data
    free_cuda()
    return rec


def oracle_errors(grads: dict, params: dict, oracle: dict) -> dict:
    """{parameter: max |this rank's gradient shard - the oracle's slice of
    the whole gradient|}, the oracle read memory-mapped."""
    import torch
    from repro_torch.compat import DTensor
    from repro_torch.launch.sharding import placed_slices
    out = {}
    for k, g in grads.items():
        a = np.load(Path(oracle["dir"]) / f"{k}.npy", mmap_mode="r")
        if isinstance(params[k], DTensor):
            a = a[placed_slices(params[k])]
        t = torch.from_numpy(np.array(a)).to(g.device)
        if oracle["dtype"][k] == "bfloat16":
            t = t.view(torch.bfloat16)
        out[k] = float((g.float() - t.float()).abs().max())
    return out


def mesh_train_run(dev, mesh, name: str, arch: str, mode: str, batch: int,
                   oracle: dict, rank: int) -> dict:
    """One run on ``mesh``: a Trainer's state from LM_SEED, the check step
    (loss_and_grads on the check batch against the oracle: loss, grad
    norm, each shard's error, the dispatch counts, the first flash call's
    inputs, the step's collectives forward and backward), then
    MESH_TRAIN_STEPS steps of Trainer.run timed (s/step, tokens/s over
    the global batch, peak memory, collectives, flash launches and plain
    backward calls)."""
    import torch
    from repro_torch.launch.steps import derive_generator
    from repro_torch.models import lm
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.trainer import Trainer
    cfg, tc, dc = mesh_train_config(arch, mode, batch)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = Trainer(cfg, tc, dc, mesh=mesh, device=dev, step_deadline_s=900)
    state, init_s = synced(lambda: tr.init_or_restore(LM_SEED))
    params = dict(state.model.named_parameters())
    local_bytes = sum(t.to_local().numel() * t.element_size() for t in (
        *params.values(), *state.opt.m.values(), *state.opt.v.values()))
    data = mesh_train_check_batch(cfg, arch, dev)
    comm = tr.step_fn.ctx.comm
    disp, flash_in = [], []
    comm.reset()
    with dispatch_counts(disp), first_flash_inputs(flash_in), \
            plain_attention_watch() as seen:
        zero_counts()
        (metrics, grads), check_s = synced(lambda: tr.step_fn.loss_and_grads(
            state, data, derive_generator(tc.seed ^ 0x5EED, 0)))
        check_counts = attention_counts(seen)
    check_comm = comm.snapshot()
    check_peak = torch.cuda.max_memory_allocated()
    gnorm = float(global_norm(grads, params))
    errs = oracle_errors(grads, params, oracle)
    del grads, data
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    comm.reset()
    with plain_attention_watch() as seen:
        zero_counts()
        state, rep = tr.run(MESH_TRAIN_STEPS, state=state, log_every=0)
        counts = attention_counts(seen)
    peak = torch.cuda.max_memory_allocated()
    steps_comm = comm.snapshot()
    tokens = dc.global_batch * dc.seq_len
    rec = {"run": name, "arch": cfg.name, "layers": cfg.num_layers,
           "mesh": list(mesh.shape), "sharding_mode": tc.sharding_mode,
           "attn_mode": lm.attn_parallel_mode(cfg, tr.step_fn.ctx),
           "init_s": init_s, "state_bytes_local": local_bytes,
           "check": {"loss": float(metrics["ce_loss"]), "grad_norm": gnorm,
                     "grad_abs_err": errs, "s": check_s,
                     "peak_bytes": check_peak,
                     "launches": check_counts, "comm": check_comm},
           "batch": [dc.global_batch, dc.seq_len], "steps": MESH_TRAIN_STEPS,
           "losses": rep.losses, "tokens_per_s": rep.tokens_per_s,
           "s_per_step": tokens / rep.tokens_per_s,
           "peak_bytes": peak, "peak_bytes_above_start": peak - base,
           "launches": counts,
           "launches_per_step": {k: v / MESH_TRAIN_STEPS
                                 for k, v in counts.items()},
           "comm_steps": steps_comm}
    out = {"record": rec, "dispatch": dispatch_lists(disp),
           "flash_inputs": kernel_inputs_np(flash_in) if rank == 0
           else None}
    del state, tr, params
    free_cuda()
    return out


def mesh_train_rank(rank: int, world: int, store_path: str,
                    device_type: str, oracles: dict, q) -> None:
    """One rank of the training world (gloo, on cuda:0 for "cuda"): the
    collective check, then every MESH_TRAIN_RUNS run; puts (rank, record)
    or (rank, traceback) on ``q``; a crash writes its stack to
    mesh_fault_path(rank). The rank's allocator grows its segments in
    place (expandable_segments): four ranks' training peaks share the
    card."""
    import faulthandler
    import traceback
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    fault = open(mesh_fault_path(rank), "w")
    faulthandler.enable(fault)
    dev = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device(device_type)
    try:
        tmesh.init_process_group(MESH_BACKEND, rank=rank, world_size=world,
                                 init_method=f"file://{store_path}",
                                 device=dev)
        res = {"collectives": gloo_check(world, dev),
               "free_bytes_at_start": torch.cuda.mem_get_info(dev)[0]}
        bad = {k: v for k, v in res["collectives"].items() if v != "ok"}
        if bad.keys() & set(MESH_TRAIN_COLLECTIVES):
            raise RuntimeError(f"gloo lacks a collective the training mesh "
                               f"uses on {dev.type} tensors: {bad}")
        for name, arch, shape, mode, batch in MESH_TRAIN_RUNS:
            mesh = tmesh.mesh_of(shape, ("data", "model"), device_type)
            res[name] = mesh_train_run(dev, mesh, name, arch, mode, batch,
                                       oracles[arch], rank)
        q.put((rank, res))
    except Exception:
        mem = ""
        if dev.type == "cuda":
            mem = (f"\nallocated {torch.cuda.memory_allocated()}, peak "
                   f"{torch.cuda.max_memory_allocated()}, reserved "
                   f"{torch.cuda.memory_reserved()}, free on the card "
                   f"{torch.cuda.mem_get_info(dev)[0]}")
        q.put((rank, traceback.format_exc() + mem))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def mesh_train_compare(oracle: dict, recs: list, what: str) -> dict:
    """Every rank's check against the oracle within the limits: the loss
    and the grad norm, each gradient's worst shard error over the
    gradient's max |value|; raises beyond them."""
    loss = [abs(r["check"]["loss"] / oracle["loss"] - 1) for r in recs]
    gnorm = [abs(r["check"]["grad_norm"] / oracle["grad_norm"] - 1)
             for r in recs]
    grad = {k: max(r["check"]["grad_abs_err"][k] for r in recs)
            / max(m, 1e-30) for k, m in oracle["max"].items()}
    worst = max(grad, key=grad.get)
    err = {"loss_rel": max(loss), "grad_norm_rel": max(gnorm),
           "grad_max_err_of_max": grad[worst], "worst_grad": worst,
           "tol": {"loss_and_grad_norm": MESH_TRAIN_RTOL,
                   "grad": MESH_TRAIN_GRAD_TOL}}
    if not (err["loss_rel"] <= MESH_TRAIN_RTOL
            and err["grad_norm_rel"] <= MESH_TRAIN_RTOL
            and grad[worst] <= MESH_TRAIN_GRAD_TOL):
        raise AssertionError(f"lm_mesh_train {what}: {err}")
    return err


def needs_mesh_train_counts(counts: dict, cfg, steps: int,
                            what: str) -> None:
    """Each rank launches the kernel twice a flash layer a step (the
    forward and remat's recompute, on its heads) and the backward kernel
    once; no forward or backward takes the plain version."""
    n = flash_layers(cfg, MESH_TRAIN_SEQ) * steps
    want = {"flash_attention": 2 * n, "backward_calls": n,
            "backward_launches": n, "plain_forward": 0,
            "plain_backward": 0}
    if n == 0 or counts != want:
        raise AssertionError(f"{what}: {counts}, expected {want}")


def phase_lm_mesh_train(device) -> dict:
    """LM training on a mesh (ROADMAP A13c-2): the single-rank oracle of
    each arch's check step on the card (before the world starts, its
    gradients to files), then one world of MESH_WORLD gloo ranks on the
    card runs each MESH_TRAIN_RUNS run (the check against the oracle
    within the limits, the MoE's dispatch counts bitwise, then
    MESH_TRAIN_STEPS timed Trainer steps); the flash kernel launched on
    every rank twice a layer a step and the backward kernel once, both
    held to their plain versions (measure_flash, measure_flash_bwd with
    a seeded dout) at rank 0's layer-0 training inputs of each run once
    the world has exited. The oracle's files are removed at the end.
    Returns the record."""
    import shutil
    import torch
    t_phase = time.perf_counter()
    oracles = {}
    for arch in dict.fromkeys(r[1] for r in MESH_TRAIN_RUNS):
        oracles[arch] = mesh_train_oracle(device, arch)
    free_cuda()
    held = {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "free_on_card": torch.cuda.mem_get_info(device)[0]}
    try:
        world = run_world(mesh_train_rank, (device.type, oracles),
                          MESH_TRAIN_JOIN_S, "lm_mesh_train")
    finally:
        shutil.rmtree(MESH_TRAIN_ORACLE, ignore_errors=True)
    runs, kernel_at, kernel_bwd_at = {}, {}, {}
    for name, arch, shape, mode, batch in MESH_TRAIN_RUNS:
        cfg = mesh_train_config(arch, mode, batch)[0]
        recs = [world[r][name]["record"] for r in sorted(world)]
        err = mesh_train_compare(oracles[arch], recs, name)
        if cfg.num_experts:
            err["dispatch_equal"] = all(
                world[r][name]["dispatch"] == oracles[arch]["dispatch"]
                for r in world)
            if not err["dispatch_equal"]:
                raise AssertionError(f"lm_mesh_train {name}: dispatch "
                                     f"counts differ from the single rank")
        for r, rec in zip(sorted(world), recs):
            needs_mesh_train_counts(rec["check"]["launches"], cfg, 1,
                                    f"lm_mesh_train {name} check rank {r}")
            needs_mesh_train_counts(rec["launches"], cfg, MESH_TRAIN_STEPS,
                                    f"lm_mesh_train {name} rank {r}")
            if not np.isfinite(rec["losses"]).all():
                raise AssertionError(f"lm_mesh_train {name} rank {r}: "
                                     f"losses {rec['losses']}")
        runs[name] = {"vs_single": err, "per_rank": recs,
                      "losses_equal_on_ranks": all(
                          r["losses"] == recs[0]["losses"] for r in recs)}
    for name, *_ in MESH_TRAIN_RUNS:
        kin = world[0][name]["flash_inputs"]
        if kin is None:
            raise AssertionError(f"lm_mesh_train {name}: rank 0 made no "
                                 f"flash call to check")
        q, k, v, causal = kernel_inputs_of(kin, device)
        kernel_at[name] = measure_flash(q, k, v, causal)
        kernel_bwd_at[name] = measure_flash_bwd(q, k, v,
                                                seeded_like(q, 90), causal)
        del q, k, v
        free_cuda()
    res = {"phase": "lm_mesh_train", "backend": MESH_BACKEND,
           "backend_why": MESH_BACKEND_WHY, "world": MESH_WORLD,
           "device": torch.cuda.get_device_name(0),
           "collectives": {device.type: world[0]["collectives"]},
           "parent_bytes_during_world": held,
           "free_bytes_at_rank_start": [world[r]["free_bytes_at_start"]
                                        for r in sorted(world)],
           "cuts": {"internlm2_layers": f"{MESH_TRAIN_LAYERS} of 24",
                    "moe_layers": f"{MESH_MOE_LAYERS} of 94",
                    "moe_microbatches": "1 (default: 16 of train_4k's 256 "
                                        "rows)",
                    "batch": "4 / 2 / 1 x 4,096 (train_4k: 256 x 4,096)"},
           "oracle": {a: {k: v for k, v in o.items()
                          if k not in ("max", "dtype", "dir")}
                      for a, o in oracles.items()},
           "runs": runs, "kernel_at_train_inputs": kernel_at,
           "kernel_bwd_at_train_inputs": kernel_bwd_at,
           "phase_s": time.perf_counter() - t_phase}
    emit(res)
    return res


SERVE_N = 64                 # requests of the bitwise HTTP check
SERVE_CLIENTS = 8
SERVE_REPEATS = 16           # of them re-sent: cache hits
SERVE_LOAD = ((1, 32), (8, 16), (32, 8))   # (clients, requests a client)
SERVE_OPEN_FRACS = (0.5, 1.0, 1.5)          # of the closed-loop peak
SERVE_OPEN_S = 1.0           # each open loop (2.0 before the 1,000 s cut)
SERVE_QUEUE_DEPTH = 64
SERVE_DEADLINE_S = 1.0
SERVE_OBS_REPS = 2
SERVE_WINDOW_SWEEP = (0.005, 0.010)
SERVE_OBS_OPEN_S = 2.0       # 4.0 before the 1,000 s cut
SERVE_DIR = ROOT / "build" / "serve_durable"
# wire keys that carry wall times or minted trace ids
WIRE_VOLATILE = ("e2e_ms", "latency_ms", "train_time_s", "query_time_s",
                 "trace_id")
METRIC_FAMILIES = ("server_latency_seconds_bucket", "span_seconds_sum",
                   "request_seconds_count", "cache_hits_total",
                   "server_served", "profile_seconds_count")


def wire_body(r, k=100) -> dict:
    """A make_requests request as the JSON body of POST /query."""
    return {"pos_ids": [int(i) for i in r["pos_ids"]],
            "neg_ids": [int(i) for i in r["neg_ids"]],
            "model": r.get("model", "dbranch"),
            "max_results": r.get("max_results", k)}


def http(base: str, path: str, body=None, timeout: float = 300.0):
    """(status, payload) of one request: POST with a JSON body, else GET;
    a JSON payload is parsed, /metrics' text is returned as it is."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        base + path, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw, ctype = r.status, r.read(), r.headers.get(
                "Content-Type", "")
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), "application/json"
    return status, (json.loads(raw) if ctype.startswith("application/json")
                    else raw.decode())


@contextlib.contextmanager
def serving(eng, **kw):
    """A started QueryServer over ``eng`` behind an HttpFrontEnd on
    127.0.0.1 (an ephemeral port): yields (server, base URL); both are
    closed on the way out."""
    from repro_torch.serve import HttpFrontEnd, QueryServer
    srv = QueryServer(eng, **kw)
    srv.start()
    fe = HttpFrontEnd(srv, host="127.0.0.1", port=0)
    try:
        host, port = fe.start()
        yield srv, f"http://{host}:{port}"
    finally:
        fe.close()
        srv.close(drain=False)


def closed_loop(base: str, bodies, clients: int) -> dict:
    """``clients`` threads each POST the next body as soon as their last
    answer came back, until none is left: throughput and latency
    percentiles of the answers, and every (index, status, body)."""
    import threading
    nxt, lock, done = [0], threading.Lock(), []

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(bodies):
                return
            t0 = time.perf_counter()
            st, payload = http(base, "/query", bodies[i])
            with lock:
                done.append((i, st, payload, time.perf_counter() - t0))

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lat = [d[3] for d in done if d[1] == 200]
    return {"clients": clients, "requests": len(bodies), "wall_s": wall,
            "qps": len(lat) / wall,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "non_200": sum(1 for d in done if d[1] != 200),
            "answers": sorted(done, key=lambda d: d[0])}


def open_loop(base: str, bodies, qps: float) -> dict:
    """Open loop as benchmarks/serve_load.py drives it over the wire:
    body i is POSTed at t0 + i / qps from its own thread whatever the
    server's progress; rejection rate and the served answers' latency."""
    import threading
    lock, done, threads = threading.Lock(), [], []

    def fire(body, t_submit):
        st, payload = http(base, "/query", body)
        with lock:
            done.append((st, payload.get("error_type", ""),
                         time.perf_counter() - t_submit))

    t0 = time.perf_counter()
    for i, body in enumerate(bodies):
        delay = t0 + i / qps - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=fire, args=(body, time.perf_counter()))
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    lat = [d[2] for d in done if d[0] == 200]
    tags = {}
    for d in done:
        if d[0] != 200:
            tags[d[1]] = tags.get(d[1], 0) + 1
    return {"offered_qps": qps, "requests": len(bodies),
            "served": len(lat), "rejection_rate": 1 - len(lat) / len(done),
            "rejected_by_type": tags,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3 if lat else None,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3 if lat else None}


def wire(payload: dict) -> dict:
    return {k: v for k, v in payload.items() if k not in WIRE_VOLATILE}


def same_wire(body: dict, res, what: str) -> None:
    """A /query answer's ids and scores bitwise a QueryResult's."""
    if body.get("ok") is not True:
        raise AssertionError(f"{what}: {body}")
    if not (np.array_equal(np.asarray(body["ids"], np.int64),
                           np.asarray(res.ids, np.int64))
            and np.array_equal(np.asarray(body["scores"], np.float64),
                               np.asarray(res.scores, np.float64))):
        raise AssertionError(f"{what}: ids/scores over HTTP != the "
                             f"engine's direct query_batch")


def device_kernel_events(fn) -> int:
    """Device events (kernels, copies, sets) torch.profiler records while
    ``fn`` runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def site_counts(reg) -> dict:
    from repro_torch.obs.profile import PROFILE_SITES
    return {s: int(reg.value("profile_seconds_count", site=s))
            for s in PROFILE_SITES}


def traced_request(srv, base, body) -> dict:
    """One request alone: its trace's span seconds by name, coverage of
    its wall, device rounds, and the profile sites it counted."""
    before = site_counts(srv.obs.registry)
    st, payload = http(base, "/query", body)
    if st != 200:
        raise AssertionError(f"traced request: {st} {payload}")
    after = site_counts(srv.obs.registry)
    tr = srv.obs.traces.get(payload["trace_id"])
    by_name = {}
    for sp in tr["spans"]:
        by_name[sp["name"]] = by_name.get(sp["name"], 0.0) + sp["dur_s"]
    rounds = sum(1 for sp in tr["spans"] if sp["name"] == "device_round")
    return {"wall_s": tr["wall_s"], "span_s": by_name,
            "coverage": sum(by_name.values()) / tr["wall_s"],
            "device_rounds": rounds,
            "span_names": [sp["name"] for sp in tr["spans"]],
            "profile_counts": {s: after[s] - before[s] for s in after},
            "cache": payload["cache"]}


def serve_full(eng, assign, k: int = 100) -> dict:
    """full_size's engine behind QueryServer + HttpFrontEnd: 64 requests
    from 8 clients bitwise the engine's direct query_batch, on the
    serving thread alone; 16 of them again as cache hits with no device
    work; a warm traced request; /metrics and /stats."""
    from repro_torch.kernels import box_scan, zone_prune
    from repro_torch.serve import ResultCache
    reqs = make_requests(assign, SERVE_N, k, seed=21)
    direct = []
    for i in range(0, SERVE_N, 8):             # warms these shapes too
        direct += eng.query_batch(reqs[i:i + 8])
    for o in direct:
        if isinstance(o, Exception):
            raise o
    bodies = [wire_body(r, k) for r in reqs]
    warm = [wire_body(r, k) for r in make_requests(assign, 16, k, seed=22)]
    out = {}
    with serving(eng, max_batch=8, batch_window_s=0.002, max_results=k,
                 cache=ResultCache()) as (srv, base):
        closed_loop(base, warm, SERVE_CLIENTS)
        b0 = srv.stats["batches"]
        zone_prune.launches = zone_prune.candidates_launches = 0
        box_scan.seg_launches = 0
        with kernel_threads() as calls:
            run = closed_loop(base, bodies, SERVE_CLIENTS)
        launches = {"zone_candidates": zone_prune.candidates_launches,
                    "box_scan_seg": box_scan.seg_launches}
        windows = srv.stats["batches"] - b0
        first = {}
        for i, st, payload, _ in run["answers"]:
            if st != 200 or payload["cache"] != "miss":
                raise AssertionError(f"request {i}: {st} {wire(payload)}")
            same_wire(payload, direct[i], f"request {i}")
            first[i] = payload
        threads = {t for _, t in calls}
        if not calls or threads != {srv._thread.ident}:
            raise AssertionError(f"kernel calls from threads {threads}, "
                                 f"not the serving thread alone")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a path kernel never launched: "
                                 f"{launches}")
        # the first SERVE_REPEATS again, three times: every one a hit,
        # bitwise; no device work while the first pass is served under
        # torch.profiler, the others timed without it (8 clients, 1)
        c1 = (zone_prune.candidates_launches, box_scan.seg_launches)
        hits = {}
        events = device_kernel_events(lambda: hits.update(
            {"profiled": closed_loop(base, bodies[:SERVE_REPEATS],
                                     SERVE_CLIENTS)}))
        hits["run"] = closed_loop(base, bodies[:SERVE_REPEATS],
                                  SERVE_CLIENTS)
        hits["one"] = closed_loop(base, bodies[:SERVE_REPEATS], 1)
        for i, st, payload, _ in (hits["profiled"]["answers"]
                                  + hits["run"]["answers"]
                                  + hits["one"]["answers"]):
            if payload.get("cache") != "hit" \
                    or wire(payload) != {**wire(first[i]), "cache": "hit",
                                         "request_id":
                                             payload["request_id"]}:
                raise AssertionError(f"repeat {i}: not a bitwise hit")
        if events or c1 != (zone_prune.candidates_launches,
                            box_scan.seg_launches):
            raise AssertionError(f"cache hits ran device work: {events} "
                                 f"device events")
        trace = traced_request(srv, base, wire_body(make_requests(
            assign, 1, k, seed=24)[0], k))
        if trace["coverage"] < 0.9:
            raise AssertionError(f"a warm trace covers "
                                 f"{trace['coverage']:.1%} of its wall")
        pc = trace["profile_counts"]
        if not (pc["jit_dispatch"] == pc["device_sync"]
                == trace["device_rounds"] > 0):
            raise AssertionError(f"profile sites {pc} for "
                                 f"{trace['device_rounds']} rounds")
        st, text = http(base, "/metrics")
        missing = [f for f in METRIC_FAMILIES if f not in text]
        if st != 200 or missing:
            raise AssertionError(f"/metrics {st}: missing {missing}")
        st, stats = http(base, "/stats")
        leaked = [v for v in json_leaves(stats)
                  if isinstance(v, str) and "tensor(" in v]
        if st != 200 or leaked:
            raise AssertionError(f"/stats {st}: tensors on the wire "
                                 f"{leaked[:3]}")
        out = {"requests": SERVE_N, "clients": SERVE_CLIENTS,
               "qps": run["qps"], "p50_ms": run["p50_ms"],
               "p99_ms": run["p99_ms"], "windows": windows,
               "launches": launches,
               "launches_per_window": {n: v / max(windows, 1)
                                       for n, v in launches.items()},
               "bitwise_equal_direct_query_batch": True,
               "kernel_calls_on_serving_thread_only": len(calls),
               "cache_hits": {"requests": SERVE_REPEATS,
                              "p50_ms": hits["run"]["p50_ms"],
                              "p99_ms": hits["run"]["p99_ms"],
                              "profiled_p50_ms":
                                  hits["profiled"]["p50_ms"],
                              "one_client_p50_ms": hits["one"]["p50_ms"],
                              "one_client_p99_ms": hits["one"]["p99_ms"],
                              "device_events": events,
                              "bitwise_equal_miss": True},
               "warm_trace": trace,
               "metrics_families": list(METRIC_FAMILIES),
               "stats_served": stats["served"],
               "stats_cache": stats["cache"]}
    return out


def json_leaves(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from json_leaves(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from json_leaves(v)
    else:
        yield obj


def serve_load(eng, assign, k: int = 100) -> dict:
    """The uncached engine path under load: closed loop at 1, 8 and 32
    clients (distinct requests, no cache); an open loop at 50 / 100 /
    150 % of the closed loop's peak with queue_depth=64 and a default
    deadline; 8 clients with longer batching windows; the obs overhead
    (the 8-client closed loop and an open loop at half the peak, with
    metrics and tracing off against on, best p99 of SERVE_OBS_REPS
    each)."""
    from repro_torch.obs import Observability
    from repro_torch.obs import profile as obs_profile
    pool = [wire_body(r, k) for r in make_requests(assign, 512, k, seed=25)]
    kw = dict(max_batch=8, batch_window_s=0.002, max_results=k)
    def closed_run(bodies, clients, **over):
        with serving(eng, **{**kw, **over}) as (srv, base):
            r = closed_loop(base, bodies, clients)
            r["windows"] = srv.stats["batches"]
        r.pop("answers")
        r["mean_window"] = r["requests"] / max(r["windows"], 1)
        if r["non_200"]:
            raise AssertionError(f"closed loop at {clients}: {r}")
        return r

    closed, at = [], 0
    for clients, per in SERVE_LOAD:
        closed.append(closed_run(pool[at:at + clients * per], clients))
        at += clients * per
    peak = max(r["qps"] for r in closed)
    # 8 clients, longer batching windows: how full a window gets
    sweep = [{"batch_window_s": w, **closed_run(pool[:128], 8,
                                                batch_window_s=w)}
             for w in SERVE_WINDOW_SWEEP]
    opened = []
    for frac in SERVE_OPEN_FRACS:
        qps = peak * frac
        n = max(int(qps * SERVE_OPEN_S), 8)
        bodies = [pool[i % len(pool)] for i in range(n)]
        with serving(eng, queue_depth=SERVE_QUEUE_DEPTH,
                     default_deadline_s=SERVE_DEADLINE_S, **kw) as (srv,
                                                                     base):
            r = open_loop(base, bodies, qps)
            r["queue_depth_peak"] = srv.summary()["queue_depth_peak"]
        r["fraction_of_peak"] = frac
        opened.append(r)
    # the obs layer's price: the 8-client closed loop, and an open loop
    # at half the peak (the reference's idle regime), with metrics and
    # tracing off against on, in turns
    n = 8 * 16
    slow = [pool[i % len(pool)]
            for i in range(max(int(peak * 0.5 * SERVE_OBS_OPEN_S), 8))]
    arms = {(load, tag): [] for load in ("closed", "open")
            for tag in ("on", "off")}
    try:
        for _ in range(SERVE_OBS_REPS):
            for load in ("closed", "open"):
                for tag in ("on", "off"):
                    obs = Observability(metrics_enabled=tag == "on",
                                        tracing_enabled=tag == "on")
                    if tag == "off":
                        obs_profile.set_enabled(False)
                    with serving(eng, obs=obs, **kw) as (srv, base):
                        if load == "closed":
                            r = closed_loop(base, pool[:n], 8)
                            r.pop("answers")
                        else:
                            r = open_loop(base, slow, peak * 0.5)
                        r["windows"] = srv.stats["batches"]
                    arms[(load, tag)].append(r)
    finally:
        obs_profile.set_enabled(True)
    overhead = {}
    for load in ("closed", "open"):
        on, off = arms[(load, "on")], arms[(load, "off")]
        p99 = {t: min(r["p99_ms"] for r in v)
               for t, v in (("on", on), ("off", off))}
        overhead[load] = {
            "p99_ms": p99, "p99_ratio": p99["on"] / p99["off"],
            "runs": {t: [{k: r.get(k) for k in ("qps", "p50_ms", "p99_ms",
                                                "windows", "rejection_rate")}
                         for r in v] for t, v in (("on", on),
                                                  ("off", off))}}
    return {"closed_loop": closed, "peak_qps": peak,
            "window_sweep": sweep, "open_loop": opened,
            "queue_depth": SERVE_QUEUE_DEPTH,
            "default_deadline_s": SERVE_DEADLINE_S,
            "obs_overhead": {**overhead, "reference_limit": 1.1}}


def serve_gpu_vs_cpu(device, n: int = MID_N, d: int = FULL_D,
                     k: int = 100) -> dict:
    """The same requests over HTTP to a GPU server and a CPU server, one
    at a time: bodies equal but for wall times and trace ids (dbranch /
    dbens, a full-result request, dtree, rforest and knn, and two cache
    hits). The GPU server's first request is its engine's first: its
    trace says where a cold request's time goes."""
    from repro_torch.core import SearchEngine
    from repro_torch.serve import ResultCache
    x, assign = clustered(n, d, seed=7)
    reqs = make_requests(assign, 9, k, seed=8)
    first = wire_body(reqs.pop(), k)    # each engine's first request
    bodies = [wire_body(r, k) for r in reqs]
    bodies += [{**bodies[0], "max_results": None},
               {**bodies[1], "model": "dtree"},
               {**bodies[2], "model": "rforest", "n_models": 5},
               {**bodies[3], "model": "knn"}, bodies[0], bodies[1]]
    answers, cold = {}, None
    for dev in (device, "cpu"):
        eng = SearchEngine(x, device=dev)
        with serving(eng, max_batch=8, batch_window_s=0.002, max_results=k,
                     cache=ResultCache()) as (srv, base):
            trace = traced_request(srv, base, first)
            if dev != "cpu":
                cold = trace
            got = []
            for b in bodies:
                st, payload = http(base, "/query", b)
                if st != 200:
                    raise AssertionError(f"{dev}: {st} {payload}")
                got.append(wire(payload))
        answers[str(dev)] = got
    g, c = answers[str(device)], answers["cpu"]
    for i, (a, b) in enumerate(zip(g, c)):
        if a != b:
            raise AssertionError(f"body {i}: GPU server != CPU server")
    return {"rows": n, "dims": d, "bodies": len(bodies),
            "models": sorted({b.get("model") for b in bodies}),
            "cache_hits": sum(1 for a in g if a["cache"] == "hit"),
            "bitwise_equal": True, "cold_first_request": cold}


def serve_durable(device, n: int = MID_N, d: int = FULL_D,
                  k: int = 100) -> dict:
    """A live, durable engine (build/serve_durable) behind the server:
    append, delete and checkpoint over /ingest; the query after the
    append misses the cache and finds the new rows, after the delete it
    no longer does, each bitwise the engine's direct answer; the WAL's
    fsync is counted as profile_seconds{site="wal_fsync"}."""
    import shutil
    from repro_torch.core import SearchEngine
    from repro_torch.serve import ResultCache
    x, assign = clustered(n, d, seed=9)
    # every hit, not the top k: the new rows tie with old ones and lose
    # the tie by id
    r = {**make_requests(assign, 1, k, seed=10)[0], "max_results": None}
    body = wire_body(r, k)
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    eng = SearchEngine(x, live=True, data_dir=str(SERVE_DIR), device=device)
    res = {}
    try:
        with serving(eng, max_batch=8, batch_window_s=0.002, max_results=k,
                     cache=ResultCache()) as (srv, base):
            seq = [http(base, "/query", body)[1] for _ in range(2)]
            if [s["cache"] for s in seq] != ["miss", "hit"]:
                raise AssertionError(f"repeat: {[wire(s) for s in seq]}")
            rows = x[r["pos_ids"]]            # look-alikes of the positives
            st, app = http(base, "/ingest", {"op": "append",
                                             "features": rows.tolist()})
            new = app["info"]["ids"]
            if st != 200 or new != list(range(n, n + len(rows))):
                raise AssertionError(f"append: {st} {app}")
            st, after = http(base, "/query", body)
            seen = sorted(set(new) & set(after["ids"]))
            if after["cache"] != "miss" or not seen:
                raise AssertionError(f"after the append: cache "
                                     f"{after['cache']}, new rows {seen}")
            st, dele = http(base, "/ingest", {"op": "delete", "ids": seen})
            st2, gone = http(base, "/query", body)
            if st != 200 or set(seen) & set(gone["ids"]) \
                    or gone["cache"] != "miss":
                raise AssertionError(f"delete: {st} {dele}")
            st, ck = http(base, "/ingest", {"op": "checkpoint"})
            if st != 200:
                raise AssertionError(f"checkpoint: {st} {ck}")
            st, text = http(base, "/metrics")
            fsyncs = site_counts(srv.obs.registry)["wal_fsync"]
            if 'profile_seconds_count{site="wal_fsync"}' not in text \
                    or fsyncs <= 0:
                raise AssertionError("wal_fsync not counted")
            summ = srv.summary()
        # the engine's own answer now, bitwise the last one over HTTP
        same_wire(gone, eng.query_batch([r])[0], "after the delete")
        res = {"rows": n, "dims": d, "appended": len(new),
               "new_rows_ranked": len(seen), "deleted": dele["info"]["rows"],
               "checkpoint": {kk: v for kk, v in ck["info"].items()
                              if isinstance(v, (int, float, str))},
               "wal_fsync_count": fsyncs,
               "durable": summ.get("durable"),
               "ingest_ms": {"append": app["latency_ms"],
                             "delete": dele["latency_ms"],
                             "checkpoint": ck["latency_ms"]},
               "bitwise_equal_direct": True}
    finally:
        eng.close()
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    return res


def phase_serve(device, eng, k: int = 100) -> dict:
    """The serving layer on the card (QueryServer, HttpFrontEnd,
    ResultCache, the obs layer): serve_full and serve_load on full_size's
    engine, serve_gpu_vs_cpu and serve_durable at 65,536 rows. Runs after
    the timed phases: its Observability turns profiling on, and it is
    switched off again at the end."""
    from repro_torch.obs import profile as obs_profile
    t0 = time.perf_counter()
    assign = cluster_assign(eng.n, eng.d, seed=0)
    try:
        full = serve_full(eng, assign, k)
        load = serve_load(eng, assign, k)
        gvc = serve_gpu_vs_cpu(device)
        durable = serve_durable(device)
    finally:
        obs_profile.set_enabled(False)
    res = {"phase": "serve", "card": card_line(), "rows": eng.n,
           "dims": eng.d, "full": full, "load": load, "gpu_vs_cpu": gvc,
           "durable": durable, "seconds": time.perf_counter() - t0}
    emit(res)
    return res


def phase_serve_only(device) -> None:
    """``--only serve``: full_size's static engine (one warm batch), then
    the serve phase."""
    eng, reqs, _, _ = full_engine(device, FULL_N, FULL_D, 100)
    eng.query_batch(reqs)
    phase_serve(device, eng)


# ----------------------------------------------------------------------
# the quantized mirror (A10) and the sharded catalogs (A11)
# ----------------------------------------------------------------------

# the quantized batch's host stages: the whole scoring, the probes, the
# compactions, the candidate syncs (Tensor.cpu), the host-row staging
# (inv_perm, np.full), the pinned uploads, the re-checks; beside the fit
# and the ranking
QUANT_STAGES = ("_device_scores_quantized", "quantized_probe",
                "quantized_compact", "<method 'cpu' of 'torch._C.TensorBase' "
                "objects>", "inv_perm", "full", "to_device_async",
                "quantized_recheck", "_fit_boxes_batched", "_rank_device")
SHARD_COUNTS = (1, 2, 4, 8)    # benchmarks/query_time.py run_sharded's
GPU_VS_CPU_SHARDS = 4
LIVE_SHARDS = 2
MESH_SHARDS = 4                # a device list naming the one card 4 times


def zero_counts() -> None:
    """Every kernel wrapper's launch counter to 0 (the attention
    backward's too), and the attention backward's call counter."""
    from repro_torch.kernels import box_scan, flash_attention, l2dist
    from repro_torch.kernels import zone_prune
    zone_prune.launches = zone_prune.candidates_launches = 0
    box_scan.scan_launches = box_scan.seg_launches = 0
    box_scan.pruned_launches = 0
    l2dist.launches = flash_attention.launches = 0
    flash_attention.backward_calls = flash_attention.backward_launches = 0


def read_counts() -> dict:
    """Each kernel's launches since zero_counts (zone_prune: its [NZ, B]
    and hit-vector entries)."""
    from repro_torch.kernels import box_scan, flash_attention, l2dist
    from repro_torch.kernels import zone_prune
    return {"zone_candidates": zone_prune.candidates_launches,
            "zone_prune": zone_prune.launches
            - zone_prune.candidates_launches,
            "box_scan_seg": box_scan.seg_launches,
            "box_scan": box_scan.scan_launches,
            "box_scan_pruned": box_scan.pruned_launches,
            "l2dist": l2dist.launches,
            "flash_attention": flash_attention.launches}


def counted(fn):
    """(fn's result, the kernel launches it made): the counters are set
    to 0 just before and read just after."""
    zero_counts()
    out = fn()
    return out, read_counts()


def needs_launches(counts: dict, names, what: str) -> None:
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched ({counts})")


def quantized_gpu_vs_cpu(device, x, reqs) -> dict:
    """mirror="quantized" on the card against the port's CPU engine:
    batches with and without max_results and single queries, ids, scores
    and integer stats bitwise, at two capacity fractions (1/64 forces
    overflow retries); resident bytes by kind equal, no f32 mirror."""
    from repro_torch.core import SearchEngine
    t0 = time.perf_counter()
    for cf in (0.25, 1 / 64):
        eg = SearchEngine(x, device=device, mirror="quantized",
                          capacity_frac=cf)
        ec = SearchEngine(x, device="cpu", mirror="quantized",
                          capacity_frac=cf)
        for mr in (100, None):
            rq = [{**r, "max_results": mr} for r in reqs]
            same_results(eg.query_batch(rq), ec.query_batch(rq))
        for r in reqs[:2]:
            kw = dict(model=r["model"], max_results=100)
            same_results([eg.query(r["pos_ids"], r["neg_ids"], **kw)],
                         [ec.query(r["pos_ids"], r["neg_ids"], **kw)],
                         batched=False)
    bg, bc = (e.index_stats()["device_bytes"] for e in (eg, ec))
    if bg != bc or bg["rows"] or bg["zones"] or not bg["quantized"]:
        raise AssertionError(f"quantized device bytes {bg} (CPU {bc})")
    return {"capacity_fracs": [0.25, 1 / 64], "device_bytes": bg,
            "bitwise_equal": True, "seconds": time.perf_counter() - t0}


def sharded_gpu_vs_cpu(device, x, reqs, eg1) -> dict:
    """n_shards=GPU_VS_CPU_SHARDS on the card (flat) against the port's CPU
    engine: the default, numpy-fit and dense modes, use_fused=False and
    the dtree / rforest / knn queries, bitwise (stats included); an
    engine on a device list naming the card MESH_SHARDS times, ids and
    scores bitwise the flat one's; and on such a list distributed_query
    and its pruned form over the unsharded card engine ``eg1``'s largest
    probe, bitwise query_index and the same calls over a CPU list."""
    from repro_torch.core import SearchEngine
    t0 = time.perf_counter()
    s = GPU_VS_CPU_SHARDS
    eg = SearchEngine(x, device=device, n_shards=s)
    ec = SearchEngine(x, device="cpu", n_shards=s)
    if eg.shard_mesh is not None:
        raise AssertionError("one card, and the engine built a mesh")
    for mode in ENGINE_MODES:
        set_mode((eg, ec), mode)
        for mr in (100, None):
            rq = [{**r, "max_results": mr} for r in reqs]
            same_results(eg.query_batch(rq), ec.query_batch(rq))
    set_mode((eg, ec), "default")
    for e in (eg, ec):
        e.use_fused = False
    try:
        rq = [{**r, "max_results": None} for r in reqs]
        same_all(eg.query_batch(rq), ec.query_batch(rq))
    finally:
        for e in (eg, ec):
            e.use_fused = True
    for model in ("dtree", "rforest", "knn"):
        for r in reqs[:2]:
            kw = dict(model=model, max_results=100, k_neighbors=1000)
            same_all([eg.query(r["pos_ids"], r["neg_ids"], **kw)],
                     [ec.query(r["pos_ids"], r["neg_ids"], **kw)])
    em = SearchEngine(x, device=device, n_shards=MESH_SHARDS,
                      shard_mesh=[str(device)] * MESH_SHARDS)
    for mr in (100, None):
        rq = [{**r, "max_results": mr} for r in reqs]
        same_ranked(em.query_batch(rq), ec.query_batch(rq),
                    "device-list mesh != flat (CPU)")
    dist = distributed_check(eg1, reqs, [str(device)] * MESH_SHARDS,
                             cpu_mesh=["cpu"] * MESH_SHARDS)
    return {"n_shards": s, "engine_modes": list(ENGINE_MODES),
            "use_fused_false": True,
            "models": ["dbranch", "dbens", "dtree", "rforest", "knn"],
            "mesh": [str(d) for d in em.shard_mesh],
            "distributed_query": dist,
            "bitwise_equal": True, "seconds": time.perf_counter() - t0}


def held_seg(x, lo, hi, onehot, what: str):
    """box_scan_seg's kernel on (x, lo, hi, onehot) held bitwise to its
    plain version, which runs over row chunks (rows are independent, so
    the chunks' concatenation is the whole); returns the plain counts."""
    import torch
    from repro_torch.kernels import ops, ref
    got = ops.box_scan_seg(x, lo, hi, onehot)
    step = max(1, ref._SCAN_CHUNK_ELEMS // max(lo.shape[0] * x.shape[1], 1))
    want = torch.cat([ref.box_scan_seg_ref(x[i:i + step], lo, hi, onehot)
                      for i in range(0, x.shape[0], step)])
    if not torch.equal(got, want):
        raise AssertionError(f"box_scan_seg, {what} {tuple(x.shape)} x "
                             f"{lo.shape[0]} boxes: kernel != plain")
    return want


def quantized_recount(eq, reqs) -> dict:
    """The quantized scoring at full size, its launches held to the plain
    versions and its integer stats recounted with them. The jobs are the
    batch's (query_batch's device fit, _make_jobs_flat); for each subset
    at the capacity the warm hints give: zone_candidates on the widened
    f16 zones and box_scan_seg on the code-space inputs (codes widened to
    f32 over [C·block, d'], thresholds that are ±inf on pad boxes, an
    all-ones [B, 1] one-hot) bitwise their plain versions, the candidate
    mask, count and compacted list bitwise quantized_probe's and
    quantized_compact's; then box_scan_seg on the re-check's staged
    [rcap, d'] rows and the request one-hot. An overflow retries as the
    engine does. Host syncs, host bytes (stat vectors, candidate lists,
    staged rows), score rows and gathered blocks recounted from the plain
    candidate sets must equal what the engine's scoring reports for the
    same jobs."""
    import torch
    from repro_torch.core.capacity import pow2ceil
    from repro_torch.core.index import (code_thresholds, quantized_compact,
                                        quantized_probe)
    from repro_torch.kernels import ops, ref
    nq = len(reqs)
    lo_c, hi_c, entries = batched_fit(eq, reqs)
    jobs, _ = eq._make_jobs_flat(
        [(lo_c, hi_c, g, sid, cnt, q) for q, ent in enumerate(entries)
         for g, sid, cnt in ent], nq)
    count = {"n_host_syncs": 0, "host_bytes_transferred": 0,
             "score_rows": 0, "blocks_gathered": 0, "retried_subsets": 0}
    shapes = {"code_space_rows_max": 0, "boxes_max": 0,
              "recheck_rows_max": 0, "inf_thresholds": 0}
    rounds = 0
    for sid, merged, owner in jobs:
        ix = eq.indexes[sid]
        lo, hi, oh = eq._probe_inputs(merged, owner, nq)
        cap = eq._initial_capacity(ix, merged.n_boxes)
        qrows3, c0, scale, zlo16, zhi16 = ix.device_quantized()
        _, block, d = qrows3.shape
        attempts = 0
        while True:
            attempts += 1
            count["host_bytes_transferred"] += 8     # the [2] stat vector
            zl, zh = zlo16.float(), zhi16.float()
            cand, n_hit = ref.zone_candidates_ref(zl, zh, lo, hi, cap)
            kc, kn = ops.zone_candidates(zl, zh, lo, hi, cap)
            if not (torch.equal(kc, cand) and torch.equal(kn, n_hit)):
                raise AssertionError(f"subset {sid}: zone_candidates on "
                                     f"the f16 zones != plain")
            nh = int(n_hit)
            if nh <= cap:
                break
            count["blocks_gathered"] += cap
            cap = min(pow2ceil(nh), ix.n_blocks)
        rounds = max(rounds, attempts)
        count["retried_subsets"] += attempts - 1
        count["blocks_gathered"] += cap
        qf = (qrows3.index_select(0, cand.long()).float() + 127.0).reshape(
            cap * block, d)
        tlo, thi = code_thresholds(lo, hi, c0, scale)
        ones = torch.ones((lo.shape[0], 1), dtype=torch.float32,
                          device=lo.device)
        m = held_seg(qf, tlo, thi, ones, f"subset {sid} code space")
        gids = ix.device_gids().index_select(0, cand.long())
        valid = torch.arange(cap, device=lo.device) < n_hit
        want = (m.reshape(cap, block) > 0) & (gids >= 0) & valid[:, None]
        kg, kmask, kst = quantized_probe(ix, lo, hi, capacity=cap)
        nc = int(want.sum())
        if not (torch.equal(kmask, want) and torch.equal(kg, gids)
                and kst.tolist() == [nh, nc]):
            raise AssertionError(f"subset {sid}: quantized_probe != the "
                                 f"plain candidate set ({kst.tolist()} "
                                 f"against {[nh, nc]})")
        rcap = pow2ceil(max(nc, 1))
        live = torch.arange(rcap, device=lo.device) < nc
        cg = torch.where(live, gids.reshape(-1)[
            ref.compact_ref(want.reshape(-1), rcap).long()], -1)
        if not torch.equal(quantized_compact(kg, kmask,
                                             row_capacity=rcap)[0], cg):
            raise AssertionError(f"subset {sid}: quantized_compact != plain")
        cgh = cg.cpu().numpy()
        xsub = np.full((rcap, d), np.inf, np.float32)
        livem = cgh >= 0
        xsub[livem] = ix.rows[ix.inv_perm()[cgh[livem]]]
        held_seg(torch.from_numpy(xsub).to(lo.device), lo, hi, oh,
                 f"subset {sid} re-check")
        count["n_host_syncs"] += 1
        count["host_bytes_transferred"] += int(cgh.nbytes) + int(xsub.nbytes)
        count["score_rows"] += nc
        shapes["code_space_rows_max"] = max(shapes["code_space_rows_max"],
                                            int(qf.shape[0]))
        shapes["boxes_max"] = max(shapes["boxes_max"], int(lo.shape[0]))
        shapes["recheck_rows_max"] = max(shapes["recheck_rows_max"], rcap)
        shapes["inf_thresholds"] += int(torch.isinf(tlo).sum()
                                        + torch.isinf(thi).sum())
    count["n_host_syncs"] += rounds
    _, agg = eq._device_scores(jobs, nq, eq._view())
    got = {key: int(agg[key]) for key in count}
    if got != count:
        raise AssertionError(f"quantized scoring stats {got} != the plain "
                             f"recount {count}")
    return {"subsets": len(jobs), "rounds": rounds, "recount": count,
            "shapes": shapes, "box_scan_seg_exact": True,
            "zone_candidates_exact": True}


def distributed_check(eng, reqs, mesh, cpu_mesh=None) -> dict:
    """The mesh leg's distributed_query (zone_hits + box_scan a device)
    and distributed_query_pruned (zone_candidates + box_scan_pruned) over
    the device list ``mesh``, at the subset and boxes of the batch's
    largest probe: each bitwise query_index's counts, Morton order mapped
    back; with ``cpu_mesh`` also bitwise the same calls over that CPU
    list. Returns their launches."""
    import torch
    from repro_torch.core.boxes import BoxSet
    from repro_torch.core.index import (distributed_query,
                                        distributed_query_pruned,
                                        query_index)
    ix, lo, hi, _, _ = max(probe_inputs(eng, reqs),
                           key=lambda t: t[1].shape[0])
    rows3, zlo, zhi = ix.device_arrays()
    per_dev = ix.n_blocks // len(mesh)           # covers every survivor
    args = (rows3, zlo, zhi, lo, hi)
    got, l_full = counted(lambda: distributed_query(*args, mesh, ix.block))
    pruned, l_pruned = counted(lambda: distributed_query_pruned(
        *args, mesh, ix.block, per_dev))
    torch.cuda.synchronize()
    if not torch.equal(got, pruned):
        raise AssertionError("distributed_query_pruned != distributed_query")
    local, _ = query_index(ix, BoxSet(lo.cpu().numpy(), hi.cpu().numpy(),
                                      ix.dims, ix.subset_id))
    valid = ix.perm >= 0
    g = got.cpu().numpy()
    back = np.zeros(ix.n_rows, np.int32)
    back[ix.perm[valid]] = g[valid]
    if not np.array_equal(back, local):
        raise AssertionError("distributed_query != query_index")
    if cpu_mesh is not None:
        cargs = [a.cpu() for a in args]
        if not (np.array_equal(distributed_query(
                *cargs, cpu_mesh, ix.block).numpy(), g)
                and np.array_equal(distributed_query_pruned(
                    *cargs, cpu_mesh, ix.block, per_dev).numpy(), g)):
            raise AssertionError("distributed_query on the card != CPU")
    needs_launches(l_full, ("zone_prune", "box_scan"), "distributed_query")
    needs_launches(l_pruned, ("zone_candidates", "box_scan_pruned"),
                   "distributed_query_pruned")
    return {"mesh": [str(d) for d in mesh], "blocks": ix.n_blocks,
            "boxes": int(lo.shape[0]), "counted_rows": int((g > 0).sum()),
            "launches": {"distributed_query": l_full,
                         "distributed_query_pruned": l_pruned},
            "bitwise_query_index": True, "bitwise_cpu": cpu_mesh is not None}


def phase_quantized(device, eng, reqs, k: int = 100) -> dict:
    """mirror="quantized" at full width: full_size's catalog and batch of
    8 on a quantized engine beside full_size's f32 engine ``eng``: ids
    and scores bitwise (ranked and full lists), the cadence (one stat
    sync a round plus one candidate sync a subset), resident bytes by
    kind for both engines and their ratio, the warm per-query wall of
    both in turns, host bytes and launches a batch, device busy; and
    quantized_recount: every box_scan_seg and zone_candidates input of
    the batch's scoring held to the plain versions at full size, its
    syncs, host bytes, score rows and gathered blocks recounted from
    them. Returns the quantized batch's launches."""
    import torch
    from repro_torch.core import SearchEngine
    from repro_torch.kernels import box_scan, zone_prune
    t0 = time.perf_counter()
    eq = SearchEngine(eng.x, device=device, mirror="quantized")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eq.query_batch(reqs)                      # the mirrors, the hints
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    eq.query_batch(reqs)
    torch.cuda.synchronize()
    outs, launches = counted(lambda: eq.query_batch(reqs))
    needs_launches(launches, ("zone_candidates", "box_scan_seg"),
                   "the quantized batch")
    if launches["zone_prune"] or launches["box_scan"]:
        raise AssertionError(f"the quantized batch ran another path: "
                             f"{launches}")
    same_ranked(outs, eng.query_batch(reqs), "quantized != f32")
    rq = [{**r, "max_results": None} for r in reqs]
    same_ranked(eq.query_batch(rq), eng.query_batch(rq),
                "quantized != f32, max_results=None")
    st = outs[0].stats
    # per subset one probe (a zone_candidates, a code-space box_scan_seg)
    # and, once it did not overflow, one re-check box_scan_seg; one stat
    # sync a round and one candidate sync a subset
    subsets = launches["box_scan_seg"] - launches["zone_candidates"]
    if (st["batch_retried_subsets"] == 0
            and st["batch_n_host_syncs"] != 1 + subsets):
        raise AssertionError(f"{st['batch_n_host_syncs']} host syncs for "
                             f"{subsets} subsets in one round")
    # the batch's own stats are the recount's: the same jobs and hints
    recount = quantized_recount(eq, reqs)
    for key in ("n_host_syncs", "score_rows", "blocks_gathered",
                "retried_subsets"):
        if st[f"batch_{key}"] != recount["recount"][key]:
            raise AssertionError(f"quantized batch {key} "
                                 f"{st[f'batch_{key}']} != the plain "
                                 f"recount {recount['recount'][key]}")
    rank_bytes = (st["batch_host_bytes_transferred"]
                  - recount["recount"]["host_bytes_transferred"])
    # ... and the rest is the ranked lists' bytes, the f32 batch's past
    # its [2] stat vector a probe
    f32_outs, f32_launches = counted(lambda: eng.query_batch(reqs))
    f32_host = f32_outs[0].stats["batch_host_bytes_transferred"]
    if rank_bytes != f32_host - 8 * f32_launches["zone_candidates"]:
        raise AssertionError(f"quantized batch host bytes "
                             f"{st['batch_host_bytes_transferred']}: the "
                             f"scoring's recount {recount['recount']} and "
                             f"ranked lists not the f32 batch's ({f32_host},"
                             f" {f32_launches['zone_candidates']} probes)")
    bq = eq.index_stats()["device_bytes"]
    bf = eng.index_stats()["device_bytes"]
    if bq["rows"] or bq["zones"] or not bq["quantized"]:
        raise AssertionError(f"quantized engine's device bytes {bq}")
    _, wall_q, peak_q = timed_batch(eq, reqs)
    walls = turn_walls({"quantized": eq, "f32": eng}, reqs)
    counters = {
        "zone_candidates_kernel": lambda: zone_prune.candidates_launches,
        "box_scan_seg_kernel": lambda: box_scan.seg_launches}
    prof = profile_batch(lambda: eq.query_batch(reqs), counters)
    host_s = host_split(lambda: eq.query_batch(reqs), QUANT_STAGES)
    out = {"phase": "quantized", "rows": eng.n, "dims": eng.d,
           "batch": len(reqs), "build_s": build_s,
           "first_batch_s": first_s,
           "per_query_wall_s": walls["quantized"],
           "f32_per_query_wall_s": walls["f32"],
           "wall_ratio_quantized_over_f32": walls["quantized"] / walls["f32"],
           "timed_batch_wall_s": wall_q, "max_memory_allocated": peak_q,
           "device_bytes": {"quantized": bq, "f32": bf},
           "f32_rows_zones_over_quantized":
               (bf["rows"] + bf["zones"]) / bq["quantized"],
           "n_host_syncs": st["batch_n_host_syncs"],
           "subsets": subsets,
           "retried_subsets": st["batch_retried_subsets"],
           "host_bytes_transferred": st["batch_host_bytes_transferred"],
           "host_bytes_per_query":
               st["batch_host_bytes_transferred"] / len(reqs),
           "f32_host_bytes_transferred": f32_host,
           "blocks_gathered": st["batch_blocks_gathered"],
           "score_rows": st["batch_score_rows"],
           "plain_recount": recount, "rank_host_bytes": rank_bytes,
           "launches": launches, "profile": prof, "host_s": host_s,
           "bitwise_equal_f32": True}
    emit(out)
    return launches


def phase_sharded(device, eng, reqs, k: int = 100) -> dict:
    """n_shards in SHARD_COUNTS at full width, flat on the one card (as
    benchmarks/query_time.py run_sharded sweeps them): full_size's
    catalog and batch of 8; S = 1 is full_size's engine ``eng``. Each
    engine's ranked and full lists bitwise S = 1's; host bytes a query,
    syncs, launches and resident bytes; the warm per-query wall of all in
    turns. Beside them an engine on a device list naming the card
    MESH_SHARDS times (a code-path check of the mesh leg, not a multi-card
    figure), and at S = 4 the dense mode, the dtree / rforest / knn
    queries and use_fused=False, bitwise S = 1's. Returns the launches by
    path."""
    import torch
    from repro_torch.core import SearchEngine
    rq_full = [{**r, "max_results": None} for r in reqs]
    outs1 = eng.query_batch(reqs)
    full1 = eng.query_batch(rq_full)
    engines, build = {"S=1": eng}, {}
    for s in SHARD_COUNTS[1:]:
        t0 = time.perf_counter()
        engines[f"S={s}"] = SearchEngine(eng.x, device=device, n_shards=s)
        build[f"S={s}"] = time.perf_counter() - t0
        if engines[f"S={s}"].shard_mesh is not None:
            raise AssertionError("one card, and the engine built a mesh")
    mesh = f"mesh{MESH_SHARDS}"
    t0 = time.perf_counter()
    engines[mesh] = SearchEngine(eng.x, device=device, n_shards=MESH_SHARDS,
                                 shard_mesh=[str(device)] * MESH_SHARDS)
    build[mesh] = time.perf_counter() - t0
    per, launches = {}, {}
    for name, e in engines.items():
        t0 = time.perf_counter()
        e.query_batch(reqs)                   # the mirrors, the hints
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        e.query_batch(reqs)
        torch.cuda.synchronize()
        outs, launches[name] = counted(lambda: e.query_batch(reqs))
        needs_launches(launches[name], ("zone_candidates", "box_scan_seg"),
                       f"the {name} batch")
        same_ranked(outs, outs1, f"{name} != S=1")
        same_ranked(e.query_batch(rq_full), full1,
                    f"{name} != S=1, max_results=None")
        st = outs[0].stats
        per[name] = {
            "first_batch_s": first_s, "build_s": build.get(name),
            "n_host_syncs": st["batch_n_host_syncs"],
            "retried_subsets": st["batch_retried_subsets"],
            "host_bytes_per_query":
                st["batch_host_bytes_transferred"] / len(reqs),
            "blocks_gathered": st["batch_blocks_gathered"],
            "blocks_touched": st["batch_blocks_touched"],
            "score_rows": st["batch_score_rows"],
            "device_bytes": e.index_stats()["device_bytes"]["total"],
            "launches": launches[name]}
    # host bytes flat in S: a probe syncs a [5] int32 stat vector flat at
    # every S > 1, a [2] one at S = 1 (one zone_candidates a probe, retries
    # included); the rest (the ranked lists) is the same at every S
    rest = {name: per[name]["host_bytes_per_query"] * len(reqs)
            - (8 if name == "S=1" else 20)
            * launches[name]["zone_candidates"]
            for name in [f"S={s}" for s in SHARD_COUNTS]}
    if len(set(rest.values())) != 1:
        raise AssertionError(f"host bytes past the stat vectors differ "
                             f"with S: {rest} ({per})")
    walls = turn_walls(engines, reqs)
    # S = 4: the dense buffer, the scan and knn models, the host oracle
    e4, s4 = engines["S=4"], {}
    set_mode([e4], "dense")
    try:
        outs_d, wall_d, peak_d = timed_batch(e4, reqs)
        _, launches["S=4_dense"] = counted(lambda: e4.query_batch(reqs))
    finally:
        set_mode([e4], "default")
    same_ranked(outs_d, outs1, "S=4 dense != S=1")
    s4["dense"] = {"query_batch_wall_s": wall_d,
                   "per_query_wall_s": wall_d / len(reqs),
                   "max_memory_allocated": peak_d,
                   "score_buffer_bytes_peak":
                       outs_d[0].stats["batch_score_buffer_bytes_peak"]}
    pos, neg = reqs[0]["pos_ids"], reqs[0]["neg_ids"]
    kw = dict(max_results=k, max_depth=12, n_models=25, k_neighbors=1000)
    for m in ("dtree", "rforest", "knn"):
        e4.query(pos, neg, model=m, **kw)     # warm
        t0 = time.perf_counter()
        a, launches[f"S=4_{m}"] = counted(
            lambda: e4.query(pos, neg, model=m, **kw))
        torch.cuda.synchronize()
        s4[m] = {"query_wall_s": time.perf_counter() - t0}
        same_ranked([a], [eng.query(pos, neg, model=m, **kw)],
                    f"S=4 {m} != S=1")
    needs_launches(launches["S=4_knn"], ("l2dist",), "S=4 knn")
    if launches["S=4_knn"]["l2dist"] != 4:
        raise AssertionError("S=4 knn: not one l2dist a shard")
    needs_launches(launches["S=4_rforest"], ("box_scan",), "S=4 rforest")
    e4.use_fused = False
    try:
        e4.query_batch(rq_full)               # the shards' own mirrors
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs_u, launches["S=4_host_oracle"] = counted(
            lambda: e4.query_batch(rq_full))
        torch.cuda.synchronize()
        s4["host_oracle"] = {"per_query_wall_s":
                             (time.perf_counter() - t0) / len(reqs)}
    finally:
        e4.use_fused = True
    needs_launches(launches["S=4_host_oracle"], ("zone_prune", "box_scan"),
                   "S=4 use_fused=False")
    same_ranked(outs_u, full1, "S=4 use_fused=False != S=1")
    dist = distributed_check(eng, reqs, [str(device)] * MESH_SHARDS)
    for leg, n in dist["launches"].items():
        launches[f"{mesh}_{leg}"] = n
    emit({"phase": "sharded", "rows": eng.n, "dims": eng.d,
          "batch": len(reqs), "shard_counts": list(SHARD_COUNTS),
          "flat": True, "mesh": {"name": mesh,
                                 "devices": [str(d) for d in
                                             engines[mesh].shard_mesh],
                                 "note": "one card named "
                                         f"{MESH_SHARDS} times: a code-path "
                                         "check, not a multi-card figure"},
          "per_query_wall_s": walls, "per_engine": per,
          "host_bytes_flat_in_S": True, "host_bytes_past_stats": rest,
          "distributed_query": dist, "S=4": s4, "launches": launches,
          "bitwise_equal_S1": True})
    return launches


def phase_quantized_only(device) -> None:
    """``--only quantized``: full_size's static engine (one warm batch),
    then the quantized phase."""
    eng, reqs, _, _ = full_engine(device, FULL_N, FULL_D, 100)
    eng.query_batch(reqs)
    phase_quantized(device, eng, reqs)


def phase_sharded_only(device) -> None:
    """``--only sharded``: full_size's static engine (one warm batch),
    then the sharded phase."""
    eng, reqs, _, _ = full_engine(device, FULL_N, FULL_D, 100)
    eng.query_batch(reqs)
    phase_sharded(device, eng, reqs)


# ----------------------------------------------------------------------
# the dry-run tools (ROADMAP A13d)
# ----------------------------------------------------------------------

DRYRUN_DIR = ROOT / "build" / "dryrun_torch"
DRYRUN_CELL = ("internlm2-1.8b", "train_4k")     # one production cell
# the paper catalog's local search steps (paper §3: 90,429,772 rows in
# blocks of 1,024) over the main path's distribution (full_engine's
# clustered catalog, its 1,024 centres) and the boxes the engine's
# trainers fit for the main path's batch of 8 requests (search_fits):
# index_query on one card (the catalog whole, ordered and zone-mapped as
# build_index does it), full_scan on one card's shard of a 16-card world
# (the main path's rows tiled)
SEARCH_BLOCK = 1024
SEARCH_SELECTIVITY = 0.02
SCAN_SHARDS = 16
SEARCH_SEED = 17

def mesh_train_predictions() -> dict:
    """The dry run of each MESH_TRAIN_RUNS run's check step
    (``loss_and_grads`` at the check batch, the run's cuts) in a fake
    world of MESH_WORLD ranks, every rank: {run: [per rank: its
    collectives (ctx.comm), state bytes, predicted peak, FLOPs]}."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import dry_run
    out = {}
    for name, arch, shape, mode, batch in MESH_TRAIN_RUNS:
        cfg, tc, _ = mesh_train_config(arch, mode, batch)
        check = ShapeConfig("check", "train", MESH_TRAIN_SEQ,
                            MESH_TRAIN_CHECK_ROWS[arch])
        out[name] = []
        for rank in range(MESH_WORLD):
            d = dry_run(cfg, check, tc=tc, mesh_shape=shape, rank=rank,
                        what="loss_and_grads")
            out[name].append({"comm": d["comm"],
                              "state_bytes": d["state_bytes"],
                              "peak_bytes_est":
                                  d["memory"]["peak_bytes_est"],
                              "dot_flops": d["dot_flops_per_device"],
                              "collectives": d["collectives"]})
    return out


def mesh_train_against_measured(pred: dict, measured: dict) -> dict:
    """Each rank's predicted collectives (calls and bytes by kind,
    forward and backward) and state bytes against lm_mesh_train's
    measured ones; raises unless every one is equal. The predicted peaks
    beside the measured ones (the check step's and the timed steps')."""
    out = {}
    for name, ranks in pred.items():
        recs = measured["runs"][name]["per_rank"]
        for r, (p, m) in enumerate(zip(ranks, recs)):
            if p["comm"] != m["check"]["comm"]:
                raise AssertionError(
                    f"dryrun {name} rank {r}: predicted collectives "
                    f"{p['comm']}, measured {m['check']['comm']}")
            if p["state_bytes"] != m["state_bytes_local"]:
                raise AssertionError(
                    f"dryrun {name} rank {r}: predicted state "
                    f"{p['state_bytes']} B, measured "
                    f"{m['state_bytes_local']} B")
        out[name] = {
            "comm_equal": True, "state_equal": True,
            "state_bytes": [p["state_bytes"] for p in ranks],
            "predicted_peak_bytes": [p["peak_bytes_est"] for p in ranks],
            "measured_check_peak_bytes": [m["check"]["peak_bytes"]
                                          for m in recs],
            "measured_step_peak_bytes": [m["peak_bytes"] for m in recs]}
    return out


def model_flops(cfg, batch: int, seq: int) -> float:
    """A training step's model FLOPs as a model-FLOPs share counts them
    (PaLM, arXiv:2204.02311, appendix B): 6 a token for each parameter of
    a product (all but the input embedding, a gather; the norms' few
    count too), and the causal attention's two products, forward and
    backward (3 x 4 BH G D S(S+1)/2 a layer). No remat recompute, no
    masked half, no f32 work of a plain backward. For a dense decoder
    whose every layer is global attention, as internlm2-1.8b."""
    from repro_torch.kernels.meta import flash_flops
    if cfg.family != "dense" or cfg.local_window or cfg.num_experts:
        raise ValueError(f"model_flops: {cfg.name} is not a dense decoder "
                         f"of global attention")
    n = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
    attn = flash_flops((batch * cfg.num_heads, seq, 1,
                        cfg.resolved_head_dim), causal=True)
    return 6.0 * n * batch * seq + 3.0 * cfg.num_layers * attn


def lm_train_prediction(measured) -> dict:
    """The dry run of lm_train's step (internlm2-1.8b whole, 2 x 4,096,
    its TrainConfig) on one device: the products' FLOPs it dispatches
    (the flash forward and backward counted with the full S^2 as the
    reference counts its attention, and with the causal kernels' own
    half; remat's
    recompute and the loss checkpoint's second unembedding included),
    predicted peak and arguments, and model_flops beside them; with the
    measured run, their shares of the bf16 peak at its s/step: the
    hardware-FLOPs share (``hw_flops_share``, the dispatched products)
    and the model-FLOPs share (``model_flops_share``, model_flops)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import dry_run
    cfg, tc, dc = lm_train_config()
    d = dry_run(cfg, ShapeConfig("lm_train", "train", dc.seq_len,
                                 dc.global_batch), tc=tc)
    flash = sum(d["kernels"].get(n, {}).get("flops", 0.0)
                for n in ("flash_attention", "flash_attention_bwd"))
    causal = d["dot_flops_per_device"] - flash \
        + d["flash_causal_flops_per_device"]
    rec = {"dot_flops": d["dot_flops_per_device"],
           "dot_flops_causal_flash": causal,
           "dot_flops_backward": d["dot_flops_backward_per_device"],
           "model_flops": model_flops(cfg, dc.global_batch, dc.seq_len),
           "flash_calls": d["kernels"].get("flash_attention",
                                           {}).get("calls", 0),
           "predicted_peak_bytes": d["memory"]["peak_bytes_est"],
           "argument_bytes": d["memory"]["argument_bytes"],
           "seconds": d["lower_s"] + d["compile_s"]}
    if measured is not None:
        s = measured["s_per_step"]
        rec.update(measured_s_per_step=s,
                   measured_peak_bytes=measured["peak_bytes"],
                   hw_flops_share=rec["dot_flops"] / s / BF16_FLOPS_PER_S,
                   hw_flops_share_causal=causal / s / BF16_FLOPS_PER_S,
                   model_flops_share=rec["model_flops"] / s
                   / BF16_FLOPS_PER_S)
    return rec


def production_cell() -> dict:
    """DRYRUN_CELL on the 16 x 16 fake world (rank 0), its files under
    build/."""
    from repro_torch.launch.dryrun import run_cell
    r = run_cell(*DRYRUN_CELL, False, art_dir=DRYRUN_DIR)
    if not r["ok"]:
        raise AssertionError(f"dryrun {DRYRUN_CELL}: {r['error']}")
    keep = ("arch", "shape", "mesh", "devices", "rank", "memory",
            "state_bytes", "flops_per_device", "dot_flops_per_device",
            "flash_causal_flops_per_device", "hbm_bytes_per_device",
            "collective_bytes_per_device", "collectives", "lower_s",
            "compile_s", "seconds")
    return {k: r[k] for k in keep}


def search_fits(x, reqs) -> dict:
    """The main path's batch ``reqs`` fitted on ``x`` as the engine fits
    it with its numpy trainers (bitwise its device fit), at its defaults:
    32 subsets of 6 dims (seed 0), depth 12, 25 dbens models, seed 0, the
    catalog's feature range. index_query: the dbranch / dbens boxes on
    the subset the batch's fits use most (a probe's boxes, padded as
    pad_boxes pads them). full_scan: each request's rforest boxes (25
    trees of depth 12, as the scan path's rforest query fits them), the
    requests in turn, the first FULL_SCAN["n_boxes"]."""
    from repro_torch.core.dbranch import fit_dbens, fit_dbranch_best_subset
    from repro_torch.core.index import pad_boxes
    from repro_torch.core.subsets import make_subsets
    from repro_torch.launch.search_dryrun import FULL_SCAN
    subsets = make_subsets(x.shape[1], 32, 6, seed=0)
    frange = (x.min(0), x.max(0))
    by_subset, rf = {}, []
    for r in reqs:
        xp, xn = x[r["pos_ids"]], x[r["neg_ids"]]
        sets = ([fit_dbranch_best_subset(xp, xn, subsets, max_depth=12,
                                         feature_range=frange)]
                if r["model"] == "dbranch"
                else fit_dbens(xp, xn, subsets, n_models=25, max_depth=12,
                               seed=0, feature_range=frange))
        for b in sets:
            by_subset.setdefault(int(b.subset_id), []).append(b)
        rf.append(rforest_boxes(x, r["pos_ids"], r["neg_ids"]))
    sid = max(sorted(by_subset),
              key=lambda s: sum(b.n_boxes for b in by_subset[s]))
    lo = np.concatenate([b.lo for b in by_subset[sid]]).astype(np.float32)
    hi = np.concatenate([b.hi for b in by_subset[sid]]).astype(np.float32)
    n_fit = lo.shape[0]
    lo, hi, _ = pad_boxes(lo, hi, None)
    nbox = FULL_SCAN["n_boxes"]
    rf_lo = np.concatenate([b[0] for b in rf])[:nbox].astype(np.float32)
    rf_hi = np.concatenate([b[1] for b in rf])[:nbox].astype(np.float32)
    if rf_lo.shape[0] < nbox:
        raise AssertionError(f"search_fits: {rf_lo.shape[0]} rforest "
                             f"boxes, fewer than {nbox}")
    return {"subset": sid, "dims": subsets[sid], "lo": lo, "hi": hi,
            "fitted_boxes": n_fit,
            "boxes_by_subset": {s: sum(b.n_boxes for b in v)
                                for s, v in sorted(by_subset.items())},
            "rf_lo": rf_lo, "rf_hi": rf_hi}


def card_zone_index(sub, block: int):
    """``core.index.build_index``'s order and zone maps for ``sub`` [N, d']
    on its own device: quantile-rank Morton codes (8 bits a dim for d' =
    6), a stable sort, +inf rows padding the last block, zone maps over
    the real rows. Returns (rows [NB, block, d'], zlo, zhi)."""
    import torch
    n, d = sub.shape
    nbits = min(8, 64 // max(d, 1))
    dev = sub.device
    code = torch.zeros(n, dtype=torch.int64, device=dev)
    ranks = torch.empty(n, dtype=torch.int64, device=dev)
    for j in range(d):
        order = torch.sort(sub[:, j], stable=True).indices
        ranks[order] = torch.arange(n, device=dev)
        del order
        q = ranks * (1 << nbits) // n
        for b in range(nbits):
            code |= ((q >> b) & 1) << (b * d + j)
        del q
    del ranks
    perm = torch.sort(code, stable=True).indices
    del code
    nb = -(-n // block)
    rows = torch.full((nb * block, d), float("inf"), device=dev)
    rows[:n] = sub.index_select(0, perm)
    del perm
    rows = rows.reshape(nb, block, d)
    zlo, zhi = rows.amin(1), rows.amax(1)
    zhi[-1] = rows[-1, :n - (nb - 1) * block].amax(0)
    return rows, zlo, zhi


def check_zone_index(device, dims, centers) -> None:
    """card_zone_index against build_index on a sample of the search
    catalog's distribution (not a multiple of the block): rows and zone
    maps bitwise."""
    import torch
    from repro_torch.core.index import build_index
    rng = np.random.default_rng(SEARCH_SEED)
    n = 3 * SEARCH_BLOCK * 16 + 123
    sub = centers[rng.integers(0, len(centers), n)][:, dims]
    sub += rng.standard_normal(sub.shape, dtype=np.float32) * np.float32(0.3)
    want = build_index(sub, np.arange(sub.shape[1]), block=SEARCH_BLOCK,
                       device="cpu")
    rows, zlo, zhi = (t.cpu().numpy() for t in card_zone_index(
        torch.from_numpy(sub).to(device), SEARCH_BLOCK))
    if not (np.array_equal(rows.reshape(want.rows.shape), want.rows)
            and np.array_equal(zlo, want.zlo)
            and np.array_equal(zhi, want.zhi)):
        raise AssertionError("card_zone_index != build_index")


def plain_pruned(rows, zlo, zhi, lo, hi, capacity: int):
    """``core.index.pruned_local_step`` with the kernels' plain versions
    (kernels/ref.py) on the same device."""
    from repro_torch.kernels import ref as kref
    cand, n_hit = kref.zone_candidates_ref(zlo, zhi, lo, hi, capacity)
    return kref.box_scan_pruned_ref(rows, cand, n_hit, lo, hi)


def aten_ops(fn) -> list:
    """The names of the aten operators ``fn`` dispatches, in order (a
    kernel's ctypes launch is none of them)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            names.append(str(func))
            return func(*args, **(kwargs or {}))
    names = []
    with Record():
        fn()
    return names


def search_times(fn, bound: tuple, model_bytes: float,
                 model_ops: float) -> dict:
    """The step's event and device ms (a CUDA graph of TIME_ITERS calls)
    beside its ``bound`` (ms, by), from the bytes and compares this run's
    data needs, and, apart, the reference's kernel model (search_dryrun's
    kernel_model: its bytes at HBM_BYTES_PER_S, its compares at
    F32_LANE_OPS_PER_S), which counts neither what the data spares nor
    every byte the step writes, so is no bound."""
    return {"ms": time_ms(fn), "device_ms": graph_ms(fn),
            "bound_ms": bound[0], "bound_by": bound[1],
            "kernel_model_bytes": model_bytes,
            "kernel_model_compares": model_ops,
            "kernel_model_bytes_ms": 1e3 * model_bytes / HBM_BYTES_PER_S,
            "kernel_model_compares_ms": 1e3 * model_ops / F32_LANE_OPS_PER_S}


def search_index_query(device, fits: dict, centers) -> dict:
    """pruned_local_step on the card over the paper catalog whole: its
    rows drawn on the card from the main path's distribution in the
    dims of ``fits``' subset, ordered and zone-mapped as build_index
    does (card_zone_index, held to it first on a sample), probed with
    ``fits``' boxes at the capacity the engine gives a warm probe
    (pow2ceil of the surviving blocks, at most the blocks). Counted (one
    zone_candidates and one box_scan_pruned launch, and no gather, fill
    or scatter among its aten operators), held bitwise to its plain
    version and to the unpruned counts (zone_hits + box_scan over every
    row, distributed_query); timed warm and with the L2 flushed, beside
    its bound (the zone maps, boxes and surviving blocks read, every
    row's count written, the zone compares and the scan compares the
    surviving rows need) and its plain version; its peak above its
    inputs. ``kernel``: box_scan_pruned alone on the step's (cand,
    n_hit) against box_scan_pruned_ref, beside its own bound."""
    import torch
    from repro_torch.core.capacity import pow2ceil
    from repro_torch.core.index import distributed_query, pruned_local_step
    from repro_torch.kernels import box_scan, zone_prune
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.search_dryrun import (PAPER_ROWS, geometry,
                                                  kernel_model)
    dims = fits["dims"]
    check_zone_index(device, dims, centers)
    n, d = PAPER_ROWS, len(dims)
    nb, _, cap_ref = geometry(n, SEARCH_BLOCK, 1, SEARCH_SELECTIVITY)
    g = torch.Generator(device=device).manual_seed(SEARCH_SEED)
    sub = torch.from_numpy(np.ascontiguousarray(centers[:, dims])).to(
        device)[torch.randint(0, len(centers), (n,), generator=g,
                              device=device)]
    sub += torch.randn(sub.shape, generator=g, device=device) * 0.3
    rows, zlo, zhi = card_zone_index(sub, SEARCH_BLOCK)
    del sub
    free_cuda()
    lo, hi = (torch.from_numpy(a).to(device) for a in (fits["lo"],
                                                       fits["hi"]))
    args = (rows, zlo, zhi, lo, hi)
    hit = kref.zone_hits_ref(zlo, zhi, lo, hi)
    n_hit = int(hit.sum())
    cap = min(pow2ceil(n_hit), nb)
    if n_hit == 0:
        raise AssertionError("dryrun index_query: no block survives")
    step = pruned_local_step(SEARCH_BLOCK, cap)
    step(*args)                    # zone_candidates' scratch, at first use
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counts, launches = counted(lambda: step(*args))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    needs_launches(launches, ("zone_candidates", "box_scan_pruned"),
                   "dryrun index_query")
    ops = aten_ops(lambda: step(*args))
    if any(k in op for op in ops
           for k in ("index_select", "scatter", "zero", "fill")):
        raise AssertionError(f"dryrun index_query: the step gathers, fills "
                             f"or scatters: {ops}")
    plain_step = lambda: plain_pruned(*args, cap)
    plain = plain_step()
    unpruned = distributed_query(*args, [device], SEARCH_BLOCK)
    if not (torch.equal(counts, plain) and torch.equal(counts, unpruned)):
        raise AssertionError("dryrun index_query: the pruned counts differ "
                             "from the plain or the unpruned ones")
    del plain, unpruned
    nbox = lo.shape[0]
    scan_need, _ = scan_compares(rows[hit].reshape(-1, d), lo, hi)
    boxes_b = 2 * nbox * d * 4
    scan_b = (n_hit * SEARCH_BLOCK * d * 4 + nb * SEARCH_BLOCK * 4 + boxes_b
              + 4 * (cap + 1))
    byts = 2 * nb * d * 4 + boxes_b + scan_b
    compares = nb * nbox * d * 2 + scan_need
    model = kernel_model("index_query", nb_loc=nb, capacity=cap,
                         block=SEARCH_BLOCK, d_sub=d, n_boxes=nbox, bpe=4)
    timed = search_times(lambda: step(*args), _bound(byts, compares), *model)
    timed["device_ms_cold"], timed["device_ms_cold_by"] = cold_device_ms(
        lambda: step(*args), "box_scan_pruned", use_profiler=False)
    timed["plain_ms"] = time_ms(plain_step, iters=PLAIN_ITERS, warmup=1)
    timed["plain_device_ms"] = graph_ms(plain_step, iters=PLAIN_ITERS)
    # the kernel alone, on the step's candidates
    cand, nh = zone_prune.zone_candidates(zlo, zhi, lo, hi, cap)
    kern = measure_one(
        "box_scan_pruned",
        lambda: box_scan.box_scan_pruned(rows, cand, nh, lo, hi),
        lambda: kref.box_scan_pruned_ref(rows, cand, nh, lo, hi),
        _bound(scan_b, scan_need), plain_iters=PLAIN_ITERS, profile=False)
    kern["device_ms_cold"], kern["device_ms_cold_by"] = cold_device_ms(
        lambda: box_scan.box_scan_pruned(rows, cand, nh, lo, hi),
        "box_scan_pruned", use_profiler=False)
    kern["bound_bytes"], kern["bound_compares"] = scan_b, scan_need
    kern["shape"] = {"blocks": nb, "block": SEARCH_BLOCK, "d": d,
                     "capacity": cap, "n_hit": n_hit, "boxes": nbox}
    rec = {"rows": n, "blocks": nb, "capacity": cap,
           "capacity_reference": cap_ref, "n_hit": n_hit,
           "subset": fits["subset"], "dims": [int(v) for v in dims],
           "boxes": nbox, "fitted_boxes": fits["fitted_boxes"],
           "boxes_by_subset": fits["boxes_by_subset"], "d": d,
           "rows_bytes": rows.numel() * 4,
           "hits": int((counts > 0).sum()), "launches": launches,
           "aten_ops": sorted(set(ops)),
           "bitwise_plain_and_unpruned": True,
           "peak_bytes_above_inputs": peak, "bound_bytes": byts,
           "bound_compares": compares, **timed, "kernel": kern}
    del args, rows, counts, hit, cand, nh
    free_cuda()
    return rec


def search_full_scan(device, x, fits: dict) -> dict:
    """The full-scan step (box_scan over the flattened shard) on one
    card's shard of a SCAN_SHARDS-card world: the main path's rows ``x``
    tiled to the shard's rows, ``fits``' rforest boxes. Counted, held
    bitwise to box_scan_ref, timed beside its bound (scan_bound with the
    compares this run's data needs, counted on ``x`` once)."""
    import torch
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.search_dryrun import (FULL_SCAN, PAPER_ROWS,
                                                  geometry, kernel_model,
                                                  make_full_scan_step)
    d, nbox = FULL_SCAN["d_sub"], FULL_SCAN["n_boxes"]
    _, nb_loc, cap = geometry(PAPER_ROWS, SEARCH_BLOCK, SCAN_SHARDS,
                              SEARCH_SELECTIVITY)
    n, nx = nb_loc * SEARCH_BLOCK, x.shape[0]
    base = torch.from_numpy(x).to(device)
    rows = torch.empty((n, d), device=device)
    for r0 in range(0, n, nx):
        rows[r0:r0 + nx] = base[:n - r0]
    lo, hi = (torch.from_numpy(a).to(device) for a in (fits["rf_lo"],
                                                       fits["rf_hi"]))
    # the tiled rows repeat x: rows [0, rem) of x come reps + 1 times
    reps, rem = divmod(n, nx)
    head, tail = (scan_compares(part, lo, hi)
                  for part in (base[:rem], base[rem:]))
    need = (reps + 1) * head[0] + reps * tail[0]
    upper = (reps + 1) * head[1] + reps * tail[1]
    del base
    rows = rows.reshape(nb_loc, SEARCH_BLOCK, d)
    step = make_full_scan_step()
    counts, launches = counted(lambda: step(rows, lo, hi))
    needs_launches(launches, ("box_scan",), "dryrun full_scan")
    if not torch.equal(counts, kref.box_scan_ref(rows.reshape(-1, d), lo,
                                                 hi)):
        raise AssertionError("dryrun full_scan: counts differ from "
                             "box_scan_ref")
    cons = ~((lo == -float("inf")) & (hi == float("inf")))
    model = kernel_model("full_scan", nb_loc=nb_loc, capacity=cap,
                         block=SEARCH_BLOCK, d_sub=d, n_boxes=nbox, bpe=4)
    rec = {"rows": n, "d": d, "boxes": nbox,
           "constrained_dims_a_box": sorted({int(v) for v in
                                             cons.sum(1).tolist()}),
           "rows_bytes": rows.numel() * 4, "hits": int((counts > 0).sum()),
           "compares_needed": need, "compares_upper": upper,
           "launches": launches, "bitwise_plain": True,
           **search_times(lambda: step(rows, lo, hi),
                          scan_bound(n, d, nbox, need), *model)}
    del rows, counts
    free_cuda()
    return rec


def phase_dryrun(device, mesh_train_rec=None, train_rec=None,
                 x=None) -> dict:
    """The dry-run tools (ROADMAP A13d): predicts lm_mesh_train's three
    check steps in a fake world of MESH_WORLD ranks, every rank (where
    ``mesh_train_rec`` is given, the phase fails unless each rank's
    collective calls and bytes by kind and its state bytes equal the
    measured ones); lm_train's step FLOPs, with ``train_rec`` its
    hardware- and model-FLOPs shares and the predicted peak beside the
    measured one; one production cell (DRYRUN_CELL on the 16 x 16 fake
    world); then the paper catalog's local search steps for real on the
    card, with the boxes the engine fits for the main path's batch over
    its catalog ``x`` (made anew where not given): index_query (held
    bitwise to its plain version and to the unpruned counts) and
    full_scan (bitwise box_scan_ref), each timed beside its bound and
    the reference's kernel model. Returns the record, whose
    ``launches`` the kernels line reads."""
    t0 = time.perf_counter()
    pred = mesh_train_predictions()
    mesh = ({name: {"predicted_peak_bytes": [p["peak_bytes_est"]
                                             for p in ranks],
                    "state_bytes": [p["state_bytes"] for p in ranks],
                    "collectives_rank0": ranks[0]["collectives"]}
             for name, ranks in pred.items()}
            if mesh_train_rec is None
            else mesh_train_against_measured(pred, mesh_train_rec))
    for name, ranks in pred.items():
        mesh[name]["comm_rank0"] = ranks[0]["comm"]
        mesh[name]["dot_flops_rank0"] = ranks[0]["dot_flops"]
    t_mesh = time.perf_counter() - t0
    train = lm_train_prediction(train_rec)
    cell = production_cell()
    t_meta = time.perf_counter() - t0
    if x is None:
        x = clustered(FULL_N, FULL_D, seed=0)[0]
    reqs = make_requests(cluster_assign(len(x), x.shape[1], 0), 8, 100,
                         seed=1)
    fits = search_fits(x, reqs)
    centers = _cluster_draws(0, x.shape[1], 0)[1]
    iq = search_index_query(device, fits, centers)
    fs = search_full_scan(device, x, fits)
    res = {"phase": "dryrun", "card": card_line(),
           "lm_mesh_train": mesh, "compared_with_measured":
               mesh_train_rec is not None,
           "lm_train": train, "production_cell": cell,
           "search": {"index_query": iq, "full_scan": fs},
           "seconds": {"mesh_predictions": t_mesh, "meta_total": t_meta,
                       "phase": time.perf_counter() - t0}}
    emit(res)
    return res


KERNELS = {
    "zone_candidates": ("src/repro_torch/kernels/csrc/zone_prune.cu",
                        "src/repro/kernels/zone_prune.py:33"),
    "zone_prune": ("src/repro_torch/kernels/csrc/zone_prune.cu",
                   "src/repro/kernels/zone_prune.py:33"),
    "box_scan_seg": ("src/repro_torch/kernels/csrc/box_scan_seg.cu",
                     "src/repro/kernels/box_scan.py:74"),
    "box_scan": ("src/repro_torch/kernels/csrc/box_scan.cu",
                 "src/repro/kernels/box_scan.py:35"),
    # the same Pallas kernel as the pruned step uses it: the gather, the
    # scan and the scatter-max of pruned_local_step in one kernel
    "box_scan_pruned": ("src/repro_torch/kernels/csrc/box_scan.cu",
                        "src/repro/kernels/box_scan.py:35"),
    "l2dist": ("src/repro_torch/kernels/csrc/l2dist.cu",
               "src/repro/kernels/l2dist.py:30"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
}


ONLY = {"flash": lambda dev: emit({"phase": "flash_cases",
                                   "flash_attention": flash_rows(dev),
                                   "flash_attention_bwd":
                                       flash_bwd_rows(dev)}),
        "extraction_400": phase_extraction_400,
        "box_scan": phase_box_scan,
        "zone_prune": phase_zone_prune,
        "l2dist": phase_l2dist,
        "fit": phase_fit,
        "live": phase_live_only,
        "durable": phase_durable_only,
        "main_wall": phase_main_wall,
        "quantized": phase_quantized_only,
        "sharded": phase_sharded_only,
        "serve": phase_serve_only,
        "dino": phase_dino,
        "lm": phase_lm,
        "lm_train": phase_lm_train,
        "lm_mesh": phase_lm_mesh,
        "lm_mesh_train": phase_lm_mesh_train,
        "fused_oracle": phase_fused_oracle_only}


def walled(walls: dict, name: str, fn, *args):
    """fn(*args), its wall seconds kept in ``walls`` under ``name`` and
    printed on a line of their own."""
    t0 = time.perf_counter()
    out = fn(*args)
    walls[name] = time.perf_counter() - t0
    emit({"phase_wall_s": name, "seconds": walls[name]})
    return out


def main(argv) -> int:
    """With no arguments, every phase and the closing records. With
    ``--only`` and a comma-separated subset of flash, extraction_400,
    box_scan, zone_prune, l2dist, fit, live, durable, main_wall,
    quantized, sharded, serve, dino, lm, lm_train, lm_mesh,
    lm_mesh_train, fused_oracle and dryrun, the kernels are built and only
    those phases run: the FLASH_CASES rows, the 400x400 extraction, the
    box scans at the main path's inputs, zone_candidates and the [NZ, B]
    mask on synthetic zone maps, l2dist at the knn path's inputs, the
    per-index fused query on full_size's engine, the batched device fit at full
    size, the live catalog at full size (and its GPU-vs-CPU schedule), the
    durable live catalog at full size (about 3.5 GB on disk under build/
    at its peak), the main path's warm wall, the quantized mirror and the
    sharded catalogs at full size, the serving layer over full_size's
    engine, DINO training of the ViT-T at 64x64 and 400x400 (with its own
    16,384 synthetic patches to embed), the LM backbones' serving path
    (llama3-8b at full width and depth, every other architecture at full
    width), LM training (internlm2-1.8b at full width and depth), the LM
    on a mesh of 4 gloo ranks on the card (internlm2-1.8b and qwen3-moe
    cut to 2 layers), LM training on that mesh (internlm2-1.8b in zero3
    and fsdp_tp, qwen3-moe; each cut to 2 layers), the dry-run tools (the
    mesh training's and lm_train's predictions, held to their measured
    records where those phases ran before it in the same --only, one
    production cell, the paper catalog's search steps on the card); for
    comparing two trees on one card."""
    import torch
    only = argv[argv.index("--only") + 1].split(",") if "--only" in argv \
        else None
    if only is not None and not set(only) <= {*ONLY, "dryrun"}:
        print(f"chip_smoke: --only takes {sorted({*ONLY, 'dryrun'})}",
              file=sys.stderr)
        return 2
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
    fwd_sass = flash_fwd_sass(libs)
    emit(fwd_sass)
    bwd_sass = flash_bwd_sass(libs)
    emit(bwd_sass)
    box_sass = bulk_sass(libs)
    emit(box_sass)
    if only is not None:
        recs, walls = {}, {}
        for name in only:
            dev = torch.device("cuda", 0)
            # with lm_mesh_train / lm_train before it in the same --only,
            # the dry run's predictions are held to their measured records
            recs[name] = (walled(walls, name, phase_dryrun, dev,
                                 recs.get("lm_mesh_train"),
                                 recs.get("lm_train"))
                          if name == "dryrun"
                          else walled(walls, name, ONLY[name], dev))
        print(card, flush=True)
        return 0
    if fwd_sass["no_wgmma"] or fwd_sass["no_setmaxnreg"] \
            or fwd_sass["spills"]:
        raise AssertionError(f"flash_attention: no wgmma or TMA load in "
                             f"{fwd_sass['no_wgmma']}, no setmaxnreg in "
                             f"{fwd_sass['no_setmaxnreg']}, spills (or no "
                             f"ptxas record) in {fwd_sass['spills']}")
    if box_sass["missing"]:
        raise AssertionError(f"box scans: no cp.async.bulk in "
                             f"{box_sass['missing']}")
    if bwd_sass["no_mma"] or bwd_sass["no_wgmma"] or bwd_sass["spills"]:
        raise AssertionError(f"flash_attention_bwd: no mma.sync (HMMA) in "
                             f"{bwd_sass['no_mma']}, no wgmma or TMA in "
                             f"{bwd_sass['no_wgmma']}, spills (or no "
                             f"ptxas record) in {bwd_sass['spills']}")
    dev = torch.device("cuda", 0)
    walls = {}
    run = lambda name, fn, *args: walled(walls, name, fn, *args)
    run("kernels", phase_kernels, dev)
    run("gpu_vs_cpu", phase_gpu_vs_cpu, dev)
    launches, probe, ctx, main_fit = run("full_size", phase_full, dev)
    run("fit", phase_fit, dev, ctx[0], ctx[1], main_fit)
    scan_launches, scan_in, knn_in, (qi_in, mask_in) = run(
        "full_size_scan_knn", phase_full_scan_knn, *ctx)
    run("fused_oracle", phase_fused_oracle, ctx[0], ctx[1])
    live_launches, live_probe, memory = run("live", phase_live, dev, ctx[0],
                                            ctx[1])
    durable_launches = run("durable", phase_durable, dev, ctx[0], ctx[1],
                           memory)
    feats, labels, flash_launches, flash_in, imgs = run(
        "extraction", phase_extraction, dev)
    run("search_vit", phase_search_vit, dev, feats, labels)
    dino = run("dino", phase_dino, dev, imgs, labels)
    del imgs
    ext400 = run("extraction_400", phase_extraction_400, dev)
    lm_rec = run("lm", phase_lm, dev)
    train_rec = run("lm_train", phase_lm_train, dev)
    mesh_rec = run("lm_mesh", phase_lm_mesh, dev)
    mesh_train_rec = run("lm_mesh_train", phase_lm_mesh_train, dev)
    dry = run("dryrun", phase_dryrun, dev, mesh_train_rec, train_rec,
              ctx[0].x)["search"]
    t0 = time.perf_counter()
    res = measure_kernels(*probe, mask_in=mask_in)
    res["box_scan"] = measure_scan(*scan_in)
    # the narrow route, at the use_fused=False batch's largest call
    res["box_scan"]["query_index"] = {
        **measure_scan(*qi_in, plain_device=False),
        "launches": scan_launches["host_oracle"]["box_scan"]}
    res["l2dist"] = measure_l2dist(*knn_in)
    # box_scan_pruned at the dryrun phase's index_query step
    res["box_scan_pruned"] = dry["index_query"]["kernel"]
    res["flash_attention"] = measure_flash(*flash_in, causal=False,
                                           profile=True)
    emit({"phase": "kernels_main_path", "card": card, "runs": [res]})
    walls["kernels_main_path"] = time.perf_counter() - t0
    quant_launches = run("quantized", phase_quantized, dev, ctx[0], ctx[1])
    shard_launches = run("sharded", phase_sharded, dev, ctx[0], ctx[1])
    # last: the serving layer's Observability turns profiling on
    serve = run("serve", phase_serve, dev,
                ctx[0])["full"]["launches_per_window"]
    # each kernel's launches on its own path: the fused batch of 8 for
    # zone_candidates / box_scan_seg, the use_fused=False batch of 8 for
    # zone_prune's mask, the dtree + rforest + knn query set for box_scan /
    # l2dist (and the use_fused=False batch beside them), the extraction
    # of the catalog for flash_attention
    launches = {**launches,
                "zone_prune": scan_launches["host_oracle"]["zone_prune"],
                "box_scan": scan_launches["box_scan"],
                "box_scan_pruned":
                    dry["index_query"]["launches"]["box_scan_pruned"],
                "l2dist": scan_launches["l2dist"],
                "flash_attention": flash_launches}
    by_path = {"zone_candidates": {"fused_batch":
                                       launches["zone_candidates"],
                                   "live_batch":
                                       live_launches["zone_candidates"],
                                   "durable_recovered_batch":
                                       durable_launches["zone_candidates"],
                                   "serve_per_window":
                                       serve["zone_candidates"]},
               "box_scan_seg": {"fused_batch": launches["box_scan_seg"],
                                "live_batch": live_launches["box_scan_seg"],
                                "durable_recovered_batch":
                                    durable_launches["box_scan_seg"],
                                "serve_per_window": serve["box_scan_seg"]},
               "zone_prune": {"host_oracle_batch": launches["zone_prune"],
                              "live_host_oracle_batch":
                                  live_launches["zone_prune"]},
               "box_scan": {"scan_knn_set": scan_launches["box_scan"],
                            "host_oracle_batch":
                                scan_launches["host_oracle"]["box_scan"],
                            "live_scan_knn_set": live_launches["box_scan"],
                            "live_host_oracle_batch":
                                live_launches["box_scan_oracle"]},
               "box_scan_pruned": {},
               "l2dist": {"knn_query": scan_launches["l2dist"],
                          "live_knn_query": live_launches["l2dist"]},
               "flash_attention": {
                   "extract_catalog": flash_launches,
                   "per_batch": flash_launches
                   / -(-EXTRACT_N // EXTRACT_BATCH),
                   "dino_step": dino["train"]["launches_per_step"][
                       "flash_attention"],
                   "dino_step_400": dino["train_400"]["launches_per_step"][
                       "flash_attention"],
                   "dino_embed_catalog": dino["embed_flash_launches"],
                   "lm_prefill_4096": lm_rec["prefill_launches"][
                       "flash_attention"],
                   "lm_decode_32_steps": lm_rec["decode_launches"][
                       "flash_attention"],
                   "lm_feature_fn_4x4096": lm_rec["feature_launches"][
                       "flash_attention"],
                   "lm_others_prefill_4096": {
                       o["arch"]: o["flash_launches"]["prefill"]
                       for o in lm_rec["others"]},
                   "lm_train_step": train_rec["launches_per_step"][
                       "flash_attention"],
                   "lm_train_step_remat_none": train_rec[
                       "remat_none_step"]["launches"]["flash_attention"],
                   # each rank's launches of one 4,096-token prefill and
                   # one lm_feature_fn call on the lm_mesh meshes (head
                   # mode: its own heads; qseq / ctxpar: kvscan, none)
                   "lm_mesh_prefill_per_rank": {
                       name: [r["prefill_flash_launches"]
                              for r in m["per_rank"]]
                       for name, m in mesh_rec["modes"].items()},
                   "lm_mesh_feature_fn_per_rank": {
                       name: [r["feature_flash_launches"]
                              for r in m["per_rank"]]
                       for name, m in mesh_rec["modes"].items()},
                   "lm_mesh_moe_prefill_per_rank": [
                       r["prefill_flash_launches"]
                       for r in mesh_rec["moe"]["per_rank"]],
                   # each rank's launches a training step on the
                   # lm_mesh_train meshes (the forward and remat's
                   # recompute, on its heads)
                   "lm_mesh_train_step_per_rank": {
                       name: [r["launches_per_step"]["flash_attention"]
                              for r in m["per_rank"]]
                       for name, m in mesh_train_rec["runs"].items()}}}
    # the paper catalog's local search steps of the dryrun phase (A13d):
    # pruned_local_step on one card, the full scan of a 16-card shard
    for name in ("zone_candidates", "box_scan_pruned"):
        by_path[name]["dryrun_index_query"] = \
            dry["index_query"]["launches"][name]
    by_path["box_scan"]["dryrun_full_scan"] = \
        dry["full_scan"]["launches"]["box_scan"]
    # the quantized batch (A10) and the sharded paths (A11): S = 4's fused
    # batch, its dense batch, knn, dtree + rforest and use_fused=False
    for name in KERNELS:
        by_path[name]["quantized_batch"] = quant_launches[name]
        by_path[name]["sharded"] = {
            path: c[name] for path, c in shard_launches.items()}
    rows = []
    for name, (src, replaces) in KERNELS.items():
        r = res[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "launches_by_path": by_path.get(name),
                     "max_abs_err": r["max_abs_err"],
                     "exact": r.get("exact", False), "tol": r.get("tol"),
                     "ms": r["ms"], "kernel_ms": r["ms"],
                     "plain_ms": r["plain_ms"], "device_ms": r["device_ms"],
                     "device_ms_by": r["device_ms_by"],
                     "device_ms_cold": r.get("device_ms_cold"),
                     "device_ms_cold_by": r.get("device_ms_cold_by"),
                     "plain_device_ms": r["plain_device_ms"],
                     "plain_device_ms_by": r["plain_device_ms_by"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r.get("library_ms"),
                     "library_device_ms": r.get("library_device_ms"),
                     "library_device_ms_by": r.get("library_device_ms_by"),
                     "shape": r["shape"]})
    by_name = {r["name"]: r for r in rows}
    cands = res["zone_candidates"]
    by_name["zone_candidates"].update(
        {k: cands[k] for k in ("cand_exact", "n_hit_exact", "ms_cold",
                               "device_ms_graph", "device_ms_cold_graph",
                               "earlier", "device_work", "ctas")})
    by_name["zone_candidates"]["floor"] = empty_launch_ms()
    # the mask at the use_fused=False batch's largest call, beside the
    # floor of one launch and the fused probe's zone_candidates
    mask = res["zone_prune"]
    by_name["zone_prune"].update(
        {k: mask[k] for k in ("twice_equal", "hits_exact", "host_us",
                              "device_ms_graph", "floor")})
    by_name["zone_prune"]["zone_candidates_device_ms"] = cands["device_ms"]
    # the live batch's largest probe: NZ = the virtual block count
    for name in ("zone_candidates", "box_scan_seg"):
        by_name[name]["live"] = {**live_probe[name],
                                 "launches": live_launches[name]}
    by_name["l2dist"].update({k: res["l2dist"][k] for k in (
        "device_ms_graph",)})
    # the live knn's per-segment calls: its largest segment and last delta
    by_name["l2dist"]["live"] = {**live_probe["l2dist"],
                                 "launches": live_launches["l2dist"]}
    scan = res["box_scan"]
    by_name["box_scan"].update(
        {k: scan[k] for k in ("compares_needed", "compares_upper",
                              "bound_ms_upper", "query_index")})
    for name in ("box_scan", "box_scan_pruned", "box_scan_seg"):
        by_name[name]["sass"] = {f: c for f, c in box_sass["functions"].items()
                                 if f"{name}_kernel" in f}
    rows[-1]["sass"] = fwd_sass["functions"]
    rows[-1]["extraction_400_flash_launches"] = ext400["flash_launches"]
    # the LM's flash branch at llama3-8b's layer-0 inputs of a 4,096-token
    # prefill (BH 8, S 4096, G 4, D 128, causal, bf16)
    rows[-1]["lm"] = lm_rec["kernel_at_layer0"]
    # and at internlm2-1.8b's training step's (BH 16, S 4096, G 2, D 128,
    # causal, bf16)
    rows[-1]["lm_train"] = train_rec["kernel_at_train_inputs"]
    # and at rank 0's layer-0 inputs on the lm_mesh meshes: internlm2's
    # local heads in head (1, 4) and data x model (2, 2), bf16, and
    # qwen3-moe's in float32 (G 16, D 128)
    rows[-1]["lm_mesh"] = mesh_rec["kernel_at_mesh_inputs"]
    # and at rank 0's layer-0 inputs of the lm_mesh_train runs' check
    # step: zero3 (one row, 8 kv heads: BH 8, G 2), fsdp_tp head mode (two
    # rows, 4 kv heads: BH 8, G 2), bf16; the MoE's float32 (BH 1, G 16)
    rows[-1]["lm_mesh_train"] = mesh_train_rec["kernel_at_train_inputs"]
    # the attention backward kernel (B5b), held and timed at lm_train's
    # step's inputs (BH 16, S 4096, G 2, D 128, causal, bf16); beside it
    # each DINO step's and each lm_mesh_train run's (rank 0's inputs, a
    # seeded dout); launches: lm_train's timed steps
    bw = train_rec["attention_backward"]
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:143",
        "launches": train_rec["launches"]["backward_launches"],
        "launches_by_path": {
            "dino_step": dino["train"]["launches_per_step"][
                "backward_launches"],
            "dino_step_400": dino["train_400"]["launches_per_step"][
                "backward_launches"],
            "lm_train_step": train_rec["launches_per_step"][
                "backward_launches"],
            "lm_train_step_remat_none": train_rec["remat_none_step"][
                "launches"]["backward_launches"],
            "lm_mesh_train_step_per_rank": {
                name: [r["launches_per_step"]["backward_launches"]
                       for r in m["per_rank"]]
                for name, m in mesh_train_rec["runs"].items()}},
        "max_abs_err": bw["max_abs_err"], "exact": False, "tol": bw["tol"],
        "ms": bw["kernel_bwd_ms"], "kernel_ms": bw["kernel_bwd_ms"],
        "plain_ms": bw["plain_bwd_ms"],
        "device_ms": bw["kernel_bwd_device_ms"],
        "device_ms_by": bw["kernel_bwd_device_ms_by"],
        "plain_device_ms": bw["plain_bwd_device_ms"],
        "plain_device_ms_by": bw["plain_bwd_device_ms_by"],
        "bound_ms": bw["bound_ms"], "bound_by": bw["bound_by"],
        # SDPA's backward alone (one torch.autograd.grad of its output);
        # its forward + backward beside the port's kernel forward +
        # backward
        "library_ms": bw["library_bwd_ms"],
        "library_device_ms": bw["library_bwd_device_ms"],
        "library_fwd_bwd_ms": bw["library_fwd_bwd_ms"],
        "library_fwd_ms": bw["library_fwd_ms"],
        "kernel_fwd_bwd_ms": bw["kernel_fwd_bwd_ms"],
        "shape": bw["shape"], "sass": bwd_sass["functions"],
        "memory": train_rec["attention_backward_memory"],
        "dino_step": dino["attention_backward"],
        "dino_step_400": dino["attention_backward_400"],
        "lm_mesh_train": mesh_train_rec["kernel_bwd_at_train_inputs"]})
    emit({"phase_walls_s": walls, "phases_s": sum(walls.values()),
          "since_start_s": time.perf_counter() - START})
    emit({"kernels": rows, "library_note": LIBRARY_NOTE})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
