"""Run one cell of ``BENCHMARK.json`` once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m bench.run ...``), from the root of a checkout. The last
line of standard output is the result as one JSON object; the numbers
compared for ``correct`` end standard error, each beside its limit.
Exit codes: 0 a result printed (correct or not); 2 no card, or fewer
cards than the cell asks for; 3 JAX or the JAX package loaded in this
process; 4 a cell, configuration, mix or metric that the files do not
give.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# JAX, its libraries and the JAX package: none may be loaded (whole
# top-level names: the port's package is not the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# No cache directory is set: the port builds its kernels with nvcc into
# the checkout's build/kernels/ (kernels/build.BUILD_DIR, a path fixed in
# its code) as SASS for sm_90a, so no PTX is compiled at load, and it
# uses no Triton, torch.compile or torch.utils.cpp_extension.


def _paths() -> None:
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit by nvidia-smi, or None where it cannot be
    read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(bm, parts, res, ctx, kind: str, chips: int) -> dict:
    """The result object (``checks`` last)."""
    from bench import registry
    from bench.harness import correct
    cell_name = parts["cell"]["name"]
    metrics = {}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(res.memory_peak_bytes),
              "power_limit_w": power_limit_w()}
    out = {"correct": correct(res.checks, res.failed),
           "attempted": int(res.attempted), "failed": int(res.failed)}
    if ctx.trace:
        run = {"trace": res.trace, "work": res.work,
               "config": parts["config"], "traffic": parts["traffic"],
               "kind": kind}
        for m in registry.per_layer(bm, cell_name):
            v = registry.metric_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = res.trace["busy_s"]
        device["window_s"] = res.trace["window_s"]
    else:
        for m in registry.end_to_end(bm, cell_name):
            metrics[m["name"]] = {"value": res.metrics[m["name"]],
                                  "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = device
    if ctx.trace:
        out["breakdown"] = res.trace["breakdown"]
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in res.checks}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    _paths()
    from bench import registry
    from bench.harness import Context
    bm = registry.load_benchmark()
    try:
        parts = registry.cell_parts(bm, args.workload)
    except (KeyError, FileNotFoundError, ModuleNotFoundError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 4
    chips = int(parts["cell"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell {args.workload} needs {chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = Context(cell=parts["cell"], config=parts["config"],
                  traffic=parts["traffic"], reference=parts["reference"],
                  seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device="cuda", t0=T0)
    code, out = run_cell(bm, parts, ctx, torch.cuda.get_device_name(0),
                         chips)
    if code == 0:
        print(json.dumps(out))
        sys.stdout.flush()
    return code


def run_cell(bm, parts, ctx, kind: str, chips: int):
    """Everything after the look for the card: the job, the look for JAX
    once its window has closed, and the result (exit code, result
    object; the compared numbers printed to standard error)."""
    res = parts["job"].run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"bench: this process loaded {bad}: the benchmark runs "
              f"the PyTorch port alone", file=sys.stderr)
        return 3, None
    out = result_line(bm, parts, res, ctx, kind, chips)
    for c in res.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.passed else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    return 0, out


if __name__ == "__main__":
    sys.exit(main())
