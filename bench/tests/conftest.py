"""Puts the repository root and ``src`` on the path, and gives the tests
a tiny context for a cell: its configuration and traffic with small
sizes, on the CPU, where the port runs its plain versions."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# small sizes a CPU test holds; the widths and depths of the cells stay in
# their configuration files
TINY_VIT = dict(num_layers=2, d_model=64, num_heads=1, num_kv_heads=1,
                head_dim=64, d_ff=128, image_size=32)
# every patch of the tiny window is compared, so a fault in one is seen
TINY_VIT_TRAFFIC = dict(pool=8, batch=4, sample=8, trace_units=1)
# float32 compute on the CPU: the tiny run's own rounding then sits far
# below every limit, so a fault's reading is the fault's alone
TINY_LM = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
               head_dim=16, d_ff=128, vocab_size=300,
               compute_dtype="float32")
TINY_LM_TRAFFIC = dict(batch=4, seq_len=32, trace_units=1)
TINY = {"vit_t.embed_400": (TINY_VIT, TINY_VIT_TRAFFIC),
        "internlm2.train_4k": (TINY_LM, TINY_LM_TRAFFIC),
        "internlm2.train_32k": (TINY_LM, dict(TINY_LM_TRAFFIC, batch=1))}


def tiny_parts(cell: str):
    from bench import registry
    bm = registry.load_benchmark()
    parts = registry.cell_parts(bm, cell)
    cfg_over, tr_over = TINY[cell]
    parts = dict(parts, config=dict(parts["config"], **cfg_over),
                 traffic=dict(parts["traffic"], **tr_over))
    return bm, parts


def tiny_ctx(cell: str, seed: int = 2_200_000_017, seconds: float = 0.0,
             trace: bool = False, hooks=None):
    from bench.harness import Context
    bm, parts = tiny_parts(cell)
    return bm, parts, Context(
        cell=parts["cell"], config=parts["config"], traffic=parts["traffic"],
        reference=parts["reference"], seed=seed, seconds=seconds,
        trace=trace, device="cpu", t0=time.perf_counter(),
        hooks=dict(hooks or {}))
