"""Dry run of the paper's own technique at production scale — counterpart
of ``repro.launch.search_dryrun``.

One shard's range-query step against the paper's catalog geometry:
90,429,772 rows x d' subset dims in blocks of 1,024, the blocks split
evenly over the 16 x 16 pod (256 ranks) or 2 x 16 x 16 (512), traced on
the ``meta`` device in a fake world of that size (``dryrun.fake_world``),
allocating nothing. Each rank of the port is one process running its own
shard's step, so the step traced is that local program, the one the
reference ``shard_map``s:

  index_query   ``core/index.pruned_local_step``: zone-prune the shard's
                zones and compact the survivors (``zone_candidates``),
                scan at most ``capacity`` surviving blocks where they lie
                and write every block's counts (``box_scan_pruned``)
  full_scan     ``box_scan`` over the whole flattened shard (the DT / RF
                inference), at d' = 384 with 128 full-width boxes

It writes the same files as ``dryrun.py`` (``search-<variant><tag>_<mesh>
.json`` and its ``.trace.json.gz``), under the same directory. Beside
the trace's figures it reports the reference's analytic kernel model
(``kernel_model``: the zone maps, the gathered rows and their counts,
each read or written once; three compares a (row, box, dim)). It is no
bound: it counts every dim of every box, where the scan skips the
unconstrained ones, and leaves out the step's [nb_loc * block] counts
output. The step has no collective: each shard's counts stay on it.

Usage:
  python -m repro_torch.launch.search_dryrun --variant index_query
  python -m repro_torch.launch.search_dryrun --all
"""
from __future__ import annotations

import argparse
import gzip
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.index import pruned_local_step
from repro_torch.kernels import ops as kops
from repro_torch.launch.dryrun import ART_DIR, TRACE_SUFFIX, fake_world
from repro_torch.launch.hlo_analysis import OpTrace, analyze
from repro_torch.launch.mesh import make_production_mesh

# the paper's catalog (§3): 90,429,772 patches
PAPER_ROWS = 90_429_772
# the scan models' constraint (paper §4.1): the full 384-d feature matrix
# against full-width boxes
FULL_SCAN = {"d_sub": 384, "n_boxes": 128}


def geometry(n_rows: int, block: int, n_shards: int,
             selectivity: float) -> tuple:
    """(blocks, blocks a shard, surviving-block capacity a shard): the
    block count rounded up to a multiple of the shards, and the
    reference's capacity (2 % of a shard's blocks by default, at least
    8; the prune fractions measured on the synthetic catalog are
    85-99 %)."""
    nb = -(-n_rows // block)
    nb = -(-nb // n_shards) * n_shards
    nb_loc = nb // n_shards
    return nb, nb_loc, max(8, int(nb_loc * selectivity))


def kernel_model(variant: str, *, nb_loc: int, capacity: int, block: int,
                 d_sub: int, n_boxes: int, bpe: int) -> tuple:
    """(bytes, compares) of one shard's step by the kernels' own traffic
    (the reference's formulas): index_query reads both zone maps, the
    gathered blocks, and writes their counts; full_scan reads the shard
    and writes its counts."""
    if variant == "index_query":
        byts = (2 * nb_loc * d_sub * bpe
                + capacity * block * d_sub * bpe
                + capacity * block * 4)
        ops = (3.0 * nb_loc * n_boxes * d_sub
               + 3.0 * capacity * block * n_boxes * d_sub)
    else:
        byts = nb_loc * block * d_sub * bpe + nb_loc * block * 4
        ops = 3.0 * nb_loc * block * n_boxes * d_sub
    return float(byts), float(ops)


def make_full_scan_step():
    """The full-scan step for one shard: ``box_scan`` over its rows."""
    def local(rows, blo, bhi):
        return kops.box_scan(rows.reshape(-1, rows.shape[-1]), blo, bhi)
    return local


def local_specs(nb_loc: int, *, d_sub: int, block: int, n_boxes: int,
                dtype=torch.float32) -> tuple:
    """One shard's inputs as meta tensors: rows [nb_loc, block, d'] and
    zone maps [nb_loc, d'] in ``dtype``, boxes [n_boxes, d'] float32."""
    meta = torch.device("meta")
    rows = torch.empty((nb_loc, block, d_sub), dtype=dtype, device=meta)
    zlo, zhi = (torch.empty((nb_loc, d_sub), dtype=dtype, device=meta)
                for _ in range(2))
    blo, bhi = (torch.empty((n_boxes, d_sub), dtype=torch.float32,
                            device=meta) for _ in range(2))
    return rows, zlo, zhi, blo, bhi


def run_variant(variant: str, *, n_rows: int = PAPER_ROWS, d_sub: int = 6,
                block: int = 1024, n_boxes: int = 32,
                multi_pod: bool = False, selectivity: float = 0.02,
                save: bool = True, dtype=torch.float32, tag: str = "",
                art_dir: Optional[Path] = None) -> dict:
    """One variant on one rank of the production mesh; the reference's
    result dict (``ok`` False and the error where it fails)."""
    art_dir = Path(art_dir or ART_DIR)
    mesh_name = "pod2_2x16x16" if multi_pod else "pod1_16x16"
    world = 512 if multi_pod else 256
    name = f"search-{variant}{tag}_{mesh_name}"
    result = {"arch": f"search-{variant}{tag}",
              "shape": f"rows{n_rows}_d{d_sub}_b{block}_q{n_boxes}",
              "mesh": mesh_name, "ok": False, "devices": world}
    t0 = time.perf_counter()
    try:
        with fake_world(world):
            n_shards = make_production_mesh(multi_pod=multi_pod,
                                            device_type="cpu").size()
            _, nb_loc, capacity = geometry(n_rows, block, n_shards,
                                           selectivity)
            result["capacity_blocks"] = capacity
            rows, zlo, zhi, blo, bhi = local_specs(
                nb_loc, d_sub=d_sub, block=block, n_boxes=n_boxes,
                dtype=dtype)
            if variant == "index_query":
                fn = pruned_local_step(block, capacity)
                args = (rows, zlo, zhi, blo, bhi)
            else:
                fn = make_full_scan_step()
                args = (rows, blo, bhi)
            with OpTrace(args) as tr:
                out = fn(*args)
            memory = tr.finish(out)
        trace = tr.trace()
        deep = analyze(trace)
        bpe = dtype.itemsize
        model_bytes, model_flops = kernel_model(
            variant, nb_loc=nb_loc, capacity=capacity, block=block,
            d_sub=d_sub, n_boxes=n_boxes, bpe=bpe)
        result.update(
            ok=True,
            compile_s=round(time.perf_counter() - t0, 1),
            memory=memory,
            xla_flops_per_device=deep["dot_flops"],
            flops_per_device=deep["total_flops"],
            dot_flops_per_device=deep["dot_flops"],
            hbm_bytes_per_device=deep["hbm_bytes"],
            hbm_bytes_upper_per_device=deep["hbm_bytes_upper"],
            collective_bytes_per_device=deep["collective_bytes"],
            collectives=deep["collectives"],
            kernels=deep["kernels"],
            rows_per_device=n_rows / n_shards,
            shard_bytes=nb_loc * block * d_sub * bpe,
            kernel_model_bytes_per_device=model_bytes,
            kernel_model_flops_per_device=model_flops,
        )
        art_dir.mkdir(parents=True, exist_ok=True)
        with gzip.open(art_dir / (name + TRACE_SUFFIX), "wt") as f:
            json.dump(trace, f, separators=(",", ":"))
    except Exception as e:  # noqa: BLE001 — a failing variant is a report
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
    if save:
        art_dir.mkdir(parents=True, exist_ok=True)
        (art_dir / f"{name}.json").write_text(json.dumps(result, indent=1))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default=None,
                    choices=["index_query", "full_scan"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--boxes", type=int, default=32)
    ap.add_argument("--d-sub", type=int, default=6)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--selectivity", type=float, default=0.02)
    ap.add_argument("--tag", default="")
    ap.add_argument("--art-dir", default=None,
                    help=f"where the files go (default {ART_DIR})")
    args = ap.parse_args(argv)
    variants = (["index_query", "full_scan"] if args.all
                else [args.variant or "index_query"])
    rc = 0
    for v in variants:
        kw = (dict(FULL_SCAN) if v == "full_scan"
              else dict(d_sub=args.d_sub, n_boxes=args.boxes))
        r = run_variant(v, multi_pod=args.multi_pod, block=args.block,
                        dtype=getattr(torch, args.dtype),
                        selectivity=args.selectivity, tag=args.tag,
                        art_dir=args.art_dir, **kw)
        if r["ok"]:
            print(f"[ok] search/{v} {r['mesh']} "
                  f"hbm/dev={r['hbm_bytes_per_device'] / 2**30:.3f} GiB "
                  f"model/dev={r['kernel_model_bytes_per_device'] / 2**30:.3f}"
                  f" GiB flops/dev={r['flops_per_device']:.3e} "
                  f"coll/dev={r['collective_bytes_per_device'] / 2**20:.1f}"
                  f" MiB")
        else:
            rc = 1
            print(f"[FAIL] search/{v}: {r['error']}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
