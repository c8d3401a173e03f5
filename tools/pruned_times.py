"""Time the paper catalog's index_query step (``core/index.
pruned_local_step``) and box_scan's narrow route (d <= 8), so that two
versions of the port can be set side by side on one card.

    python3 tools/pruned_times.py [--src DIR] [--iters N]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's): another commit, unpacked with ``git archive``
into a directory that .gitignore lists, is timed by the same script in
the same call. The inputs are chip_smoke.py's (this checkout's), made
anew from its seeds: the dryrun phase's index_query step (90,429,772
rows of the main path's distribution in the dims of the batch's most
used subset, ordered and zone-mapped as build_index does, the batch's
fitted boxes there, capacity pow2ceil of the surviving blocks), and
``synthetic_scan`` at 1,048,576 rows of d' = 6 with 16 and 64 boxes (the
last 4 impossible padding).
Prints the card's name and power limit, then one JSON line a case: the
event ms (the median of CUDA events around each call), the device ms
(CUDA events around one replay of a CUDA graph of the calls), for the
step also its peak above its inputs and whether its counts equal the
plain unpruned ones bitwise (box_scan_ref over every row, kept where its
block survives the prune: no survivor is dropped at this capacity), and
the kernel launches of one call. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("pruned_times: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    # after chip_smoke, which puts this checkout's src first
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core.capacity import pow2ceil
    from repro_torch.core.index import pruned_local_step
    from repro_torch.kernels import box_scan
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.search_dryrun import PAPER_ROWS
    dev = torch.device("cuda", 0)
    src = str(Path(args.src).resolve())
    x = cs.clustered(cs.FULL_N, cs.FULL_D, seed=0)[0]
    reqs = cs.make_requests(cs.cluster_assign(len(x), x.shape[1], 0), 8,
                            100, seed=1)
    fits = cs.search_fits(x, reqs)
    centers = cs._cluster_draws(0, x.shape[1], 0)[1]
    del x
    dims = fits["dims"]
    g = torch.Generator(device=dev).manual_seed(cs.SEARCH_SEED)
    sub = torch.from_numpy(centers[:, dims].copy()).to(dev)[torch.randint(
        0, len(centers), (PAPER_ROWS,), generator=g, device=dev)]
    sub += torch.randn(sub.shape, generator=g, device=dev) * 0.3
    rows, zlo, zhi = cs.card_zone_index(sub, cs.SEARCH_BLOCK)
    del sub
    lo, hi = (torch.from_numpy(a).to(dev) for a in (fits["lo"],
                                                    fits["hi"]))
    step_args = (rows, zlo, zhi, lo, hi)
    n_hit = int(kref.zone_hits_ref(zlo, zhi, lo, hi).sum())
    cap = min(pow2ceil(n_hit), rows.shape[0])
    step = pruned_local_step(cs.SEARCH_BLOCK, cap)
    call = lambda: step(*step_args)
    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, launches = cs.counted(call)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    # no survivor is dropped at this capacity: the plain unpruned counts
    hit = kref.zone_hits_ref(zlo, zhi, lo, hi).repeat_interleave(
        cs.SEARCH_BLOCK)
    want = kref.box_scan_ref(rows.reshape(-1, rows.shape[-1]), lo, hi)
    same = bool(torch.equal(got, torch.where(hit, want, 0)))
    del got, hit, want
    print(json.dumps({"case": "index_query_step", "src": src,
                      "blocks": rows.shape[0], "n_hit": n_hit,
                      "capacity": cap, "boxes": lo.shape[0],
                      "ms": cs.time_ms(call, iters=args.iters),
                      "device_ms": cs.graph_ms(call, iters=args.iters),
                      "peak_bytes_above_inputs": peak,
                      "bitwise_plain": same, "launches": launches}),
          flush=True)
    del step_args, rows, zlo, zhi
    cs.free_cuda()
    for nbox in (16, 64):
        x6, blo, bhi = cs.synthetic_scan(cs.FULL_N, 6, nbox, 4, dev)
        scan = lambda: box_scan.box_scan(x6, blo, bhi)
        same = bool(torch.equal(scan(), kref.box_scan_ref(x6, blo, bhi)))
        print(json.dumps({"case": f"narrow_d6_{nbox}_boxes", "src": src,
                          "rows": x6.shape[0], "boxes": nbox,
                          "ms": cs.time_ms(scan, iters=args.iters),
                          "device_ms": cs.graph_ms(scan, iters=args.iters),
                          "bitwise_plain": same,
                          "launches": cs.counted(scan)[1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
