"""Serving launcher: ``python -m repro_torch.launch.serve [...]``.

Builds a synthetic catalog (features via the handcrafted extractor),
constructs the SearchEngine + QueryServer, and runs a batched query
workload — the offline stand-in for the FastAPI deployment. The engine
runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.engine import MODELS, SearchEngine
from repro_torch.data.synthetic import (CLASS_IDS, PatchDatasetConfig,
                                        generate_patches,
                                        handcrafted_features)
from repro_torch.serve.engine import QueryRequest, QueryServer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--model", default="dbranch", choices=MODELS)
    ap.add_argument("--positive-class", default="solar_panel")
    ap.add_argument("--labels", type=int, default=12,
                    help="labelled positives/negatives per query")
    ap.add_argument("--subsets", type=int, default=24)
    ap.add_argument("--subset-dim", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    print(f"[serve] generating {args.rows} synthetic patches ...")
    data = generate_patches(PatchDatasetConfig(
        n_patches=args.rows, seed=args.seed,
        positive_class=args.positive_class))
    feats = handcrafted_features(data["images"])
    labels = data["labels"]
    pos_cls = CLASS_IDS[args.positive_class]

    print("[serve] building indexes ...")
    engine = SearchEngine(feats, n_subsets=args.subsets,
                          subset_dim=args.subset_dim, seed=args.seed,
                          device=args.device)
    print(f"[serve] {engine.index_stats()}")

    server = QueryServer(engine)
    server.start()
    rng = np.random.default_rng(args.seed)
    pos_pool = np.nonzero(labels == pos_cls)[0]
    neg_pool = np.nonzero(labels != pos_cls)[0]

    pending = []
    t0 = time.perf_counter()
    for q in range(args.queries):
        pos = rng.choice(pos_pool, args.labels, replace=False)
        neg = rng.choice(neg_pool, args.labels, replace=False)
        pending.append(server.submit(QueryRequest(q, pos, neg, args.model)))
    for q, p in enumerate(pending):
        resp = p.get(timeout=600)
        r = resp.result
        if resp.ok:
            hit = (labels[r.ids] == pos_cls).mean() if r.n_found else 0.0
            print(f"  q{q}: {r.summary()}  precision={hit:.2f}")
        else:
            print(f"  q{q}: ERROR {resp.error}")
    dt = time.perf_counter() - t0
    server.close()
    s = server.summary()
    print(f"[serve] {s['served']} queries in {dt:.2f}s "
          f"(mean latency {1e3 * s['mean_latency_s']:.1f} ms, "
          f"errors {s['errors']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
