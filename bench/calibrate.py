"""The readings a cell's limits are set from, in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 0] [--out FILE]

For each of ``--seeds``: one run of the cell as ``bench/run.py`` makes it
(set-up, a window of ``--seconds``, at least one unit, and the check),
with its compared numbers: the lower readings. For each of
``--control-seeds``: the job's ``controls`` (the reference in the
program's place in the precision below the configuration's, and the
planted faults the job reads): the upper readings. It prints one JSON
object a run, with the verdict that the cell's limits give it (``correct``
by the same ``harness.checks`` and ``harness.correct`` that decide a
benchmark run's result: a control has to read false), then the largest
program reading and the smallest control reading of each number. It
needs the card as ``bench/run.py`` does.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:] = [p for p in sys.path
               if p != str(Path(__file__).resolve().parent)]
sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from bench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    bench_run._paths()
    import torch
    from bench import registry
    from bench.harness import Context, checks, correct
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bm = registry.load_benchmark()
    parts = registry.cell_parts(bm, args.workload)
    records = []

    def ctx_for(seed: int) -> Context:
        return Context(cell=parts["cell"], config=parts["config"],
                       traffic=parts["traffic"],
                       reference=parts["reference"], seed=seed,
                       seconds=args.seconds, trace=False, device="cuda",
                       t0=time.perf_counter())
    for s in [int(x) for x in args.seeds.split(",") if x]:
        t = time.perf_counter()
        res = parts["job"].run(ctx_for(s))
        rec = {"kind": "program", "seed": s,
               "checks": dict(res.readings.get("gaps", {}),
                              **{c.name: c.value for c in res.checks}),
               "correct": correct(res.checks, res.failed),
               "metrics": res.metrics, "readings": res.readings,
               "memory_peak_bytes": res.memory_peak_bytes,
               "failed": res.failed, "s": time.perf_counter() - t}
        records.append(rec)
        print(json.dumps(rec), flush=True)
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        t = time.perf_counter()
        for name, g in parts["job"].controls(ctx_for(s)).items():
            found = checks(parts["traffic"], g)
            rec = {"kind": name, "seed": s, "checks": g,
                   "correct": correct(found, 0),
                   "failing": [c.name for c in found if not c.passed],
                   "s": time.perf_counter() - t}
            records.append(rec)
            print(json.dumps(rec), flush=True)
    summary = {}
    for r in records:
        for k, v in r["checks"].items():
            e = summary.setdefault(r["kind"], {}).setdefault(k, v)
            summary[r["kind"]][k] = max(e, v) if r["kind"] == "program" \
                else min(e, v)
    print(json.dumps({"summary": summary,
                      "kind": torch.cuda.get_device_name(0)}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"records": records,
                                              "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
