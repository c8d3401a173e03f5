"""The RapidEarth search engine on PyTorch — the static single-device
paths of ``repro.core.engine`` for all five models.

  offline:  features [N, D]  ->  K feature subsets  ->  K zone-map indexes
  online :  (pos ids, neg ids, model)  ->  fit classifier (numpy)  ->
            boxes  ->  one fused probe per subset on the device  ->
            survivor tiles  ->  ranked object ids + query statistics

The dtree/rforest models scan the whole feature matrix with their
full-width boxes (box_scan), the knn model ranks the rows of subset 0
(l2dist + top-k), and ``use_fused=False`` answers dbranch/dbens through
the host ``query_index`` oracle; all three rank on the host.

Per round every pending subset's probe (zone prune -> bounded block
gather -> segmented box scan -> tile labelling) is queued on the device,
then ONE batched stat sync reads every subset's survivor counts; subsets
that overflowed their capacity are re-queued, the rest compact their
surviving rows into exactly-sized tiles keyed by global row id. With
``max_results`` set the ranking runs on the device too (``sparse_topk``)
and only [Q, k] ids and scores cross to the host.

Ids, scores and the integer stats are bitwise those of the reference
engine in the same configuration. What this port does not implement yet
raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import knn as knn_mod
from repro_torch.core.boxes import BoxSet, concat_box_arrays
from repro_torch.core.capacity import HintTable
from repro_torch.core.capacity import hybrid_bucket as _cap_hybrid
from repro_torch.core.capacity import pow2ceil as _cap_pow2ceil
from repro_torch.core.dbranch import fit_dbens, fit_dbranch_best_subset
from repro_torch.core.errors import check_deadline
from repro_torch.core.index import (ZoneMapIndex, build_index, full_scan,
                                    fused_stats, pad_boxes, query_index,
                                    sparse_probe, to_device_f32)
from repro_torch.core.subsets import make_subsets
from repro_torch.core.trees import fit_decision_tree, fit_random_forest
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

MODELS = ("dbranch", "dbens", "dtree", "rforest", "knn")

# sentinel: "no per-call override — use the engine default"
_UNSET = object()


@dataclass
class QueryResult:
    """What the web application receives back (paper §4, step 4)."""

    model: str
    ids: np.ndarray               # result row ids, ranked by confidence
    scores: np.ndarray            # per-id confidence (box-membership votes)
    train_time_s: float
    query_time_s: float
    stats: Dict = field(default_factory=dict)

    @property
    def n_found(self) -> int:
        return int(len(self.ids))

    def summary(self) -> str:
        return (f"{self.model}: {self.n_found} objects in "
                f"{1e3 * (self.train_time_s + self.query_time_s):.1f} ms "
                f"(fit {1e3 * self.train_time_s:.1f} + "
                f"query {1e3 * self.query_time_s:.1f})")


@dataclass
class _EngineView:
    """The catalog state one query (or batch window) runs against. A
    static engine hands out a trivial view over its own fields."""
    indexes: Sequence
    n: int
    x: np.ndarray
    frange: Tuple[np.ndarray, np.ndarray]


@dataclass
class SparseScores:
    """Survivor-sparse device score form: ``keys`` [R] int32 global ids
    (TILE_INVALID padding), ``vals`` [R, Q] int16/int32 per-query vote
    counts (zero padding). A global id may appear in several tiles; the
    consumers sum duplicates in int32, so any merge order is exact."""
    keys: torch.Tensor
    vals: torch.Tensor
    n: int                        # catalog rows (dense-equivalent height)

    @property
    def nbytes(self) -> int:
        return int(self.keys.nbytes) + int(self.vals.nbytes)


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


class SearchEngine:
    """End-to-end engine over an in-memory feature matrix, on one device.

    ``device=None`` means CUDA and raises when CUDA is absent; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    ``max_results`` (constructor default, overridable per query) caps how
    many ranked ids a query returns AND switches ranking to the device;
    with ``max_results=None`` the full ranked list comes from the host
    ranking oracle. The trainer is the numpy one (``use_jax_fit=False``
    in the reference); the batched device fit is ROADMAP A5.

    Options (``_configure``): ``device``, ``capacity_frac`` (cold-start
    gather capacity as a fraction of the blocks), ``max_results``,
    ``use_fused`` (False: the host ``query_index`` oracle for
    dbranch/dbens), and the reference's ``use_jax_fit``, ``score_mode``,
    ``mirror``, ``n_shards``, ``live``, ``data_dir`` and ``faults``, which
    take only the values of the static sparse path.

    The scan models read the whole [N, D] feature matrix. The reference
    uploads it on every scan; this engine keeps one device copy,
    uploaded at the first scan query (``feature_mirror_bytes``).
    """

    def __init__(self, features: np.ndarray, *, n_subsets: int = 32,
                 subset_dim: int = 6, block: int = 1024, seed: int = 0,
                 **options):
        self._configure(features, **options)
        t0 = time.perf_counter()
        self.subsets = make_subsets(self.d, n_subsets, subset_dim, seed=seed)
        self.indexes = [
            build_index(self.x, dims, block=block, subset_id=k,
                        device=self.device)
            for k, dims in enumerate(self.subsets)
        ]
        self.build_time_s = time.perf_counter() - t0
        self.frange = (self.x.min(0), self.x.max(0))

    def _configure(self, features, *, device=None,
                   capacity_frac: float = 0.25,
                   max_results: Optional[int] = None,
                   use_jax_fit: bool = False, use_fused: bool = True,
                   score_mode: str = "sparse", mirror: str = "f32",
                   n_shards: int = 1, live: bool = False, data_dir=None,
                   faults=None) -> None:
        """The options every constructor takes; each one the port does not
        implement yet raises NotImplementedError naming its ROADMAP item."""
        self.device = resolve_device(device)
        if use_jax_fit:
            raise _unported("use_jax_fit=True (the batched device fit)",
                            "A5")
        if score_mode == "dense":
            raise _unported("score_mode='dense' (the dense oracle)",
                            "A3/A4")
        if score_mode != "sparse":
            raise ValueError(f"score_mode must be 'sparse' or 'dense', "
                             f"got {score_mode!r}")
        if mirror == "quantized":
            raise _unported("mirror='quantized'", "A10")
        if mirror != "f32":
            raise ValueError(f"mirror must be 'f32' or 'quantized', "
                             f"got {mirror!r}")
        if int(n_shards) > 1:
            raise _unported("n_shards > 1", "A11")
        if live or data_dir is not None:
            raise _unported("live=True / data_dir (live, durable catalogs)",
                            "A7/A8")
        if faults is not None:
            raise _unported("faults (fault-injection seams)", "A9")
        self.x = np.ascontiguousarray(np.asarray(features, np.float32))
        self.n, self.d = self.x.shape
        self.capacity_frac = capacity_frac
        self.max_results = max_results
        self.use_fused = bool(use_fused)
        # the scan models' device copy of x, uploaded at first use
        self._x_dev: Optional[torch.Tensor] = None
        # survivor counts observed by the probes, keyed by (generation,
        # subset, box-count bucket); sizes the next like-shaped gather
        self._cap_hints = HintTable()
        # high-water mark of device score-buffer bytes across queries
        self._score_bytes_peak = 0

    @classmethod
    def from_arrays(cls, x: np.ndarray, subsets: np.ndarray,
                    indexes: Sequence[Dict], frange,
                    **options) -> "SearchEngine":
        """An engine over state built elsewhere, as numpy arrays: the
        feature matrix, the [K, d'] subsets, one dict of ZoneMapIndex
        fields per subset (dims, perm, rows, zlo, zhi, block, n_rows,
        subset_id) and the (lo [D], hi [D]) feature range. It answers
        exactly as an engine that built the same state itself."""
        from repro_torch.core.convert import index_from_arrays
        eng = cls.__new__(cls)
        eng._configure(x, **options)
        eng.subsets = np.asarray(subsets, np.int32)
        eng.indexes = [index_from_arrays(**ix, device=eng.device)
                       for ix in indexes]
        eng.build_time_s = 0.0
        eng.frange = (np.asarray(frange[0], np.float32),
                      np.asarray(frange[1], np.float32))
        return eng

    # ------------------------------------------------------------------
    def _view(self) -> _EngineView:
        return _EngineView(self.indexes, self.n, self.x, self.frange)

    def _round_checkpoint(self, deadline_s) -> None:
        """Once per device launch round: the between-rounds deadline
        check — a request whose budget is gone stops HERE instead of
        burning another round of device time."""
        check_deadline(deadline_s, "device query round")

    @staticmethod
    def _index_nbytes(ix) -> int:
        return int(ix.rows.nbytes)

    def _device_features(self) -> torch.Tensor:
        """The [N, D] features on the engine's device, uploaded ONCE (a
        view of the host array on the CPU)."""
        if self._x_dev is None:
            self._x_dev = torch.from_numpy(self.x).to(self.device)
        return self._x_dev

    def feature_mirror_bytes(self) -> int:
        """Bytes of the scan models' device feature copy (0 until the
        first scan query uploads it)."""
        return 0 if self._x_dev is None else int(self._x_dev.nbytes)

    def index_stats(self) -> Dict:
        st = {
            "rows": self.n,
            "dims": self.d,
            "n_subsets": len(self.indexes),
            "subset_dim": int(self.subsets.shape[1]),
            "build_time_s": self.build_time_s,
            "index_bytes": int(sum(ix.rows.nbytes for ix in self.indexes)),
            "feature_bytes": int(self.x.nbytes),
            "device": str(self.device),
        }
        dev: Dict[str, int] = {}
        for ix in self.indexes:
            for k, v in ix.device_bytes().items():
                dev[k] = dev.get(k, 0) + int(v)
        st["device_bytes"] = {**dev, "total": int(sum(dev.values()))}
        st["score_buffer_bytes_peak"] = int(self._score_bytes_peak)
        return st

    # ------------------------------------------------------------------
    def query(
        self,
        pos_ids: Sequence[int],
        neg_ids: Sequence[int],
        model: str = "dbranch",
        *,
        k_neighbors: int = 1000,
        max_depth: int = 12,
        n_models: int = 25,
        seed: int = 0,
        include_training: bool = False,
        max_results=_UNSET,
        deadline_s: Optional[float] = None,
    ) -> QueryResult:
        """One user query: label sets in, ranked ids out.

        ``max_results=k`` truncates the ranked list to its top k entries
        and runs the ranking on the device, so the host receives O(k)
        bytes. ``deadline_s`` is an absolute ``time.monotonic()``
        deadline, checked before the fit and between device rounds."""
        if model not in MODELS:
            raise ValueError(f"unknown model {model!r}; choose from {MODELS}")
        check_deadline(deadline_s, "fit")
        mr = self.max_results if max_results is _UNSET else max_results
        view = self._view()
        pos_ids = np.asarray(list(pos_ids), np.int64)
        neg_ids = np.asarray(list(neg_ids), np.int64)
        xp, xn = view.x[pos_ids], view.x[neg_ids]

        t0 = time.perf_counter()
        if model in ("dbranch", "dbens"):
            boxes = self._fit_boxes(model, xp, xn, max_depth=max_depth,
                                    n_models=n_models, seed=seed,
                                    frange=view.frange)
        elif model in ("dtree", "rforest"):
            xtr = np.concatenate([xp, xn])
            ytr = np.concatenate([np.ones(len(xp)), np.zeros(len(xn))])
            if model == "dtree":
                tree = fit_decision_tree(xtr, ytr, max_depth=max_depth)
                lo, hi = tree.lo, tree.hi
            else:
                lo, hi = fit_random_forest(xtr, ytr, n_trees=n_models,
                                           max_depth=max_depth,
                                           seed=seed).boxes()
        t_fit = time.perf_counter() - t0

        t0 = time.perf_counter()
        check_deadline(deadline_s, "inference")
        if model in ("dbranch", "dbens"):
            ids, scores, stats = self._run_index_path(
                boxes, pos_ids, neg_ids, include_training, mr, view,
                deadline_s=deadline_s)
            stats["path"] = "index"
            stats["fit_path"] = "numpy"
        elif model == "knn":
            k = min(k_neighbors, view.n)
            ids_k, _ = knn_mod.knn_subset(view.indexes[0], xp, k=k)
            counts = knn_mod.knn_vote(ids_k, view.n)
            stats = {"path": "index",
                     "bytes_touched": self._index_nbytes(view.indexes[0])}
            t_fit = 0.0
            ids, scores = self._rank(counts, pos_ids, neg_ids,
                                     include_training)
        else:
            if len(lo) == 0:
                counts = np.zeros(view.n, np.int32)
            else:
                counts = full_scan(self._device_features(), lo, hi)
            stats = {"path": "scan", "bytes_touched": int(view.x.nbytes),
                     "n_boxes": int(len(lo))}
            ids, scores = self._rank(counts, pos_ids, neg_ids,
                                     include_training)
        if mr is not None:      # device-ranked results are already <= mr
            ids, scores = ids[:mr], scores[:mr]
        t_query = time.perf_counter() - t0
        return QueryResult(model, ids, scores, t_fit, t_query, stats)

    # ------------------------------------------------------------------
    def _fit_boxes(self, model: str, xp: np.ndarray, xn: np.ndarray, *,
                   max_depth: int, n_models: int, seed: int,
                   frange=None) -> List[BoxSet]:
        """Fit an index-path model with the numpy trainers; query() and
        query_batch() both come here, so batched and sequential answers
        train identically. The engine's feature range is plumbed into the
        trainers so box expansion sees the catalog's spread."""
        frange = self.frange if frange is None else frange
        if model == "dbranch":
            return [fit_dbranch_best_subset(xp, xn, self.subsets,
                                            max_depth=max_depth,
                                            feature_range=frange)]
        return fit_dbens(xp, xn, self.subsets, n_models=n_models,
                         max_depth=max_depth, seed=seed,
                         feature_range=frange)

    # capacity bucketing is shared policy (core/capacity.py)
    @staticmethod
    def _pow2ceil(v: int) -> int:
        return _cap_pow2ceil(v)

    def _cap_key(self, sid: int, n_boxes: int, geom: int = 0):
        """Hints are keyed by (geometry generation, subset, pow2-bucketed
        box count), so a single query (few boxes) and a batch window's
        union (many boxes) do not poison each other's sizing."""
        return (int(geom), sid, self._pow2ceil(max(int(n_boxes), 1)))

    def _cap_bucket(self, v: int, n_blocks: int) -> int:
        """Capacity bucket: pow2-rounded, capped at the block count."""
        return min(_cap_pow2ceil(max(int(v), 1)), n_blocks)

    def _initial_capacity(self, index: ZoneMapIndex,
                          n_boxes: Optional[int] = None,
                          geom: int = 0) -> int:
        """Gather capacity for a subset's probe: the last observed
        survivor count for a like-sized boxset when one is known,
        otherwise the capacity_frac cold-start policy. Results stay exact
        either way: an under-sized guess is caught by the batched
        overflow check and retried."""
        nbk = index.n_blocks
        if n_boxes is not None:
            hint = self._cap_hints.get(self._cap_key(index.subset_id,
                                                     n_boxes, geom))
            if hint is not None:
                return self._cap_bucket(hint, nbk)
        cap = max(1, int(nbk * self.capacity_frac))
        return self._cap_bucket(cap, nbk)

    @staticmethod
    def _new_agg() -> Dict:
        return {"blocks_touched": 0, "blocks_gathered": 0, "blocks_total": 0,
                "bytes_touched": 0, "n_boxes": 0, "n_range_queries": 0,
                "host_bytes_transferred": 0, "n_host_syncs": 0,
                "retried_subsets": 0}

    @staticmethod
    def _accumulate_agg(agg: Dict, st: Dict, n_boxes: int) -> None:
        agg["blocks_touched"] += st["blocks_touched"]
        # host path has no bounded gather: it reads exactly the survivors
        agg["blocks_gathered"] += st.get("blocks_gathered",
                                         st["blocks_touched"])
        agg["blocks_total"] += st["blocks_total"]
        agg["bytes_touched"] += st["bytes_touched"]
        agg["n_boxes"] += n_boxes
        agg["n_range_queries"] += n_boxes

    @staticmethod
    def _finalize_agg(agg: Dict, view: _EngineView) -> Dict:
        agg["scan_bytes_equiv"] = int(view.x.nbytes)
        agg["bytes_saved_frac"] = 1.0 - agg["bytes_touched"] / max(
            view.x.nbytes, 1)
        return agg

    # ------------------------------------------------------------------
    # device-resident scoring (the online hot path, DESIGN.md §9, §13)
    # ------------------------------------------------------------------
    def _make_jobs(self, pairs: Sequence[Tuple[BoxSet, int]], nq: int):
        """Group (BoxSet, owner-query) pairs per subset.

        Returns ([(sid, merged BoxSet, owner [B] int32)] — one fused
        probe each — and the max per-query total box count)."""
        by_subset: Dict[int, List[Tuple[BoxSet, int]]] = {}
        for bs, q in pairs:
            by_subset.setdefault(bs.subset_id, []).append((bs, q))
        jobs = []
        totals = np.zeros(nq, np.int64)
        for sid, group in by_subset.items():
            lo = concat_box_arrays([bs.lo for bs, _ in group])
            hi = concat_box_arrays([bs.hi for bs, _ in group])
            owner = np.concatenate([np.full(bs.n_boxes, q, np.int32)
                                    for bs, q in group])
            jobs.append((sid, BoxSet(lo, hi, group[0][0].dims, sid), owner))
            totals += np.bincount(owner, minlength=nq)
        return jobs, (int(totals.max()) if jobs else 0)

    def _upload(self, a) -> torch.Tensor:
        return to_device_f32(a, self.device)

    def _probe_inputs(self, merged: BoxSet, owner: np.ndarray, nq: int):
        """Padded boxes and the [B, Q] f32 ownership one-hot, on the
        engine's device."""
        lo, hi, owner_p = pad_boxes(merged.lo, merged.hi, owner)
        onehot = (owner_p[:, None] == np.arange(nq)[None]).astype(np.float32)
        return self._upload(lo), self._upload(hi), self._upload(onehot)

    def _device_scores(self, jobs, nq: int, view: _EngineView,
                       deadline_s=None):
        """The survivor-sparse accumulation (DESIGN.md §13).

        Per round: queue every pending subset's probe, then ONE batched
        device->host sync of the stacked [2] stat vectors (n_hit,
        n_match). Overflowed subsets (n_hit > capacity) are re-queued at
        min(pow2ceil(n_hit), n_blocks); the others compact their surviving
        rows into one packed, exactly-sized tile per round. The zone prune
        is conservative and int32 vote addition is associative, so the
        tiles are bitwise the dense accumulation."""
        agg = self._new_agg()
        tile_parts, tile_bytes, score_rows = [], 0, 0
        # every per-row, per-query count is bounded by its round's merged
        # box count, so below 2**15 boxes the tile values fit int16
        val_dt = (torch.int16
                  if max(m.n_boxes for _, m, _ in jobs) < 2 ** 15
                  else torch.int32)
        val_sz = 2 if val_dt == torch.int16 else 4
        transient = 0
        pending = [(sid, merged, owner,
                    self._initial_capacity(view.indexes[sid],
                                           merged.n_boxes))
                   for sid, merged, owner in jobs]
        while pending:
            self._round_checkpoint(deadline_s)
            launched, round_parts, round_rcaps = [], [], []
            for sid, merged, owner, cap in pending:
                lo_d, hi_d, onehot = self._probe_inputs(merged, owner, nq)
                probe = sparse_probe(view.indexes[sid], lo_d, hi_d, onehot,
                                     capacity=cap)
                launched.append((sid, merged, owner, cap) + probe)
            # ONE batched sync: a fixed-width int vector per subset
            stvecs = torch.stack([l[7] for l in launched]).cpu().numpy()
            agg["n_host_syncs"] += 1
            agg["host_bytes_transferred"] += int(stvecs.nbytes)
            pending = []
            for (sid, merged, owner, cap, counts, gids, ok, _), st in zip(
                    launched, stvecs):
                index = view.indexes[sid]
                nh = int(st[0])
                self._cap_hints.observe(self._cap_key(sid, merged.n_boxes),
                                        nh)
                if nh > cap:
                    # the failed attempt still gathered (and priced) cap
                    # blocks of device traffic
                    agg["blocks_gathered"] += cap
                    agg["bytes_touched"] += int(
                        cap * index.block * len(index.dims) * 4)
                    pending.append((sid, merged, owner,
                                    min(self._pow2ceil(nh), index.n_blocks)))
                    continue
                nm = int(st[1])
                score_rows += nm
                self._accumulate_agg(
                    agg, fused_stats(index, nh, cap, merged.n_boxes),
                    merged.n_boxes)
                round_parts.append((counts, gids, ok))
                round_rcaps.append(_cap_hybrid(max(nm, 1), quantum=512))
            if len(round_parts) == 1:
                keys, vals, _ = kops.survivor_tiles(
                    *round_parts[0], row_capacity=round_rcaps[0],
                    val_dtype=val_dt)
                tile_parts.append((keys, vals))
                tile_bytes += int(keys.nbytes) + int(vals.nbytes)
            elif round_parts:
                keys, vals = kops.packed_survivor_tiles(
                    tuple(round_parts), row_capacities=tuple(round_rcaps),
                    val_dtype=val_dt)
                tile_parts.append((keys, vals))
                tile_bytes += int(keys.nbytes) + int(vals.nbytes)
                transient = max(transient,
                                max(rc * (4 + nq * val_sz)
                                    for rc in round_rcaps))
            agg["retried_subsets"] += len(pending)
        return self._finish_sparse(tile_parts, tile_bytes, score_rows,
                                   agg, nq, view, transient_bytes=transient)

    def _finish_sparse(self, tile_parts, tile_bytes: int, score_rows: int,
                       agg: Dict, nq: int, view: _EngineView, *,
                       transient_bytes: int = 0):
        """Merge the round tiles into ONE SparseScores and close out the
        memory accounting: the tiles plus the packing scratch, or plus
        the concatenated copy that retry rounds pay."""
        copied = 0
        if tile_parts:
            if len(tile_parts) == 1:
                keys, vals = tile_parts[0]
            else:
                keys = torch.cat([t[0] for t in tile_parts])
                vals = torch.cat([t[1] for t in tile_parts])
                copied = int(keys.nbytes) + int(vals.nbytes)
        else:
            keys = torch.full((1,), int(kops.TILE_INVALID),
                              dtype=torch.int32, device=self.device)
            vals = torch.zeros((1, nq), dtype=torch.int32,
                               device=self.device)
        sp = SparseScores(keys, vals, int(view.n))
        peak = int(tile_bytes) + max(copied, int(transient_bytes))
        agg["score_buffer_bytes_peak"] = peak
        agg["score_rows"] = int(score_rows)
        agg["dense_score_bytes_equiv"] = int(view.n) * nq * 4
        self._score_bytes_peak = max(self._score_bytes_peak, peak)
        return sp, self._finalize_agg(agg, view)

    def _scores_to_host(self, scores_dev: SparseScores,
                        view: _EngineView) -> np.ndarray:
        """[N, Q] int32 host counts in GLOBAL row order: only the survivor
        tiles cross, de-duplicated by scatter-add on the host."""
        keys = scores_dev.keys.cpu().numpy()
        vals = scores_dev.vals.cpu().numpy()
        out = np.zeros((scores_dev.n, vals.shape[1]), np.int32)
        m = keys != int(kops.TILE_INVALID)
        np.add.at(out, keys[m], vals[m])
        return out

    def _index_inference(self, boxsets: List[BoxSet], view: _EngineView):
        """Host/oracle range-query path (use_fused=False): per-subset
        query_index, the boxes of one subset merged into one call. Kept
        as the correctness oracle for the device-resident path."""
        counts = np.zeros(view.n, np.int64)
        agg = self._new_agg()
        by_subset: Dict[int, List[BoxSet]] = {}
        for bs in boxsets:
            by_subset.setdefault(bs.subset_id, []).append(bs)
        for sid, group in by_subset.items():
            merged = group[0]
            for g in group[1:]:
                merged = merged.concatenate(g)
            c, st = query_index(view.indexes[sid], merged)
            counts += c
            self._accumulate_agg(agg, st, merged.n_boxes)
        return counts, self._finalize_agg(agg, view)

    def _run_index_path(self, boxsets, pos_ids, neg_ids,
                        include_training: bool, mr: Optional[int],
                        view: _EngineView, deadline_s=None):
        """Single-query index inference + ranking: the fused engine scores
        on the device and, with ``mr`` set, ranks there too; the
        use_fused=False engine runs the host oracle."""
        if not self.use_fused:
            counts, stats = self._index_inference(boxsets, view)
            ids, scores = self._rank(counts, pos_ids, neg_ids,
                                     include_training)
            return ids, scores, stats    # query() applies the mr cut
        jobs, bound = self._make_jobs([(bs, 0) for bs in boxsets], 1)
        scores_dev, stats = self._device_scores(jobs, 1, view,
                                                deadline_s=deadline_s)
        if mr is None:
            counts = self._scores_to_host(scores_dev, view)[:, 0]
            # sparse buffers cross as tiles: price what actually moved
            stats["host_bytes_transferred"] += scores_dev.nbytes
            ids, scores = self._rank(counts, pos_ids, neg_ids,
                                     include_training)
        else:
            ranked, hb = self._rank_device(
                scores_dev, [(pos_ids, neg_ids, include_training)], mr,
                view)
            stats["host_bytes_transferred"] += hb
            ids, scores = ranked[0]
        return ids, scores, stats

    # ------------------------------------------------------------------
    def _rank(self, counts: np.ndarray, pos_ids: np.ndarray,
              neg_ids: np.ndarray, include_training: bool):
        """counts -> (ids ranked by confidence, scores) on the HOST — the
        ranking oracle the device stage must reproduce exactly: stable
        argsort of -counts == descending score, ascending id on ties."""
        found = np.nonzero(counts > 0)[0]
        if not include_training:
            found = found[~np.isin(found,
                                   np.concatenate([pos_ids, neg_ids]))]
        order = np.argsort(-counts[found], kind="stable")
        ids = found[order]
        return ids, counts[ids].astype(np.float64)

    def _rank_device(self, scores_dev: SparseScores, masks, k: int,
                     view: _EngineView):
        """Device ranking (kops.sparse_topk) of the survivor tiles; only
        [Q, k] ids/scores plus [Q] valid counts cross to the host.
        masks: per-query (pos, neg, include_training). Returns
        ([(ids, scores)] aligned with masks, host bytes transferred)."""
        n, nq = view.n, len(masks)
        # k pow2-bucketed, as in the reference (a static jit arg there):
        # the [Q, k] transfer, and so host bytes, stay equal
        kk = min(self._pow2ceil(max(int(k), 1)), n)
        tmax = max([1] + [len(p) + len(ng) for p, ng, inc in masks
                          if not inc])
        tmax = -(-tmax // 16) * 16
        tids = np.full((nq, tmax), n, np.int32)   # N pads are never keys
        for q, (pos, neg, inc) in enumerate(masks):
            if not inc:
                tr = np.concatenate([pos, neg])
                tids[q, :len(tr)] = tr
        ids_k, scores_k, n_valid = kops.sparse_topk(
            scores_dev.keys, scores_dev.vals,
            torch.from_numpy(tids).to(self.device), k=kk)
        ids_k = ids_k.cpu().numpy()
        scores_k = scores_k.cpu().numpy()
        n_valid = n_valid.cpu().numpy()
        hb = int(ids_k.nbytes + scores_k.nbytes + n_valid.nbytes)
        out = []
        for q in range(nq):
            nv = int(n_valid[q])
            out.append((ids_k[q, :nv].astype(np.int64),
                        scores_k[q, :nv].astype(np.float64)))
        return out, hb

    def query_batch(self, requests: Sequence[Dict],
                    deadline_s: Optional[float] = None) -> List:
        """Answer MANY concurrent queries with ONE fused device probe per
        feature subset and one survivor tile set for the whole batch.

        Each request is a dict with ``pos_ids``/``neg_ids`` plus the same
        optional keys query() accepts. dbranch/dbens requests are fitted
        one by one (numpy), their boxes flattened with a per-box owner id
        and grouped per subset; the ownership one-hot de-muxes counts per
        query on the device. When every request sets ``max_results`` the
        ranking runs on the device too. Other models, and every request
        of a use_fused=False engine, go through query() one by one.

        Returns a list aligned with ``requests``: QueryResult on success,
        the raised Exception on per-request failure. Batch-wide stats are
        namespaced ``batch_*``; ``n_boxes`` is the request's own."""
        results: List = [None] * len(requests)
        view = self._view()
        to_fit = []   # (slot, model, pos, neg, incl, mr, depth, n_models, seed)
        for i, req in enumerate(requests):
            try:
                model = req.get("model", "dbranch")
                if model not in MODELS:
                    raise ValueError(
                        f"unknown model {model!r}; choose from {MODELS}")
                if model not in ("dbranch", "dbens") or not self.use_fused:
                    kw = {k: v for k, v in req.items()
                          if k not in ("pos_ids", "neg_ids", "model")}
                    results[i] = self.query(req["pos_ids"], req["neg_ids"],
                                            model=model, **kw)
                    continue
                pos = np.asarray(list(req["pos_ids"]), np.int64)
                neg = np.asarray(list(req["neg_ids"]), np.int64)
                mr = (req["max_results"] if "max_results" in req
                      else self.max_results)
                to_fit.append((i, model, pos, neg,
                               req.get("include_training", False), mr,
                               req.get("max_depth", 12),
                               req.get("n_models", 25), req.get("seed", 0)))
            except Exception as e:  # noqa: BLE001 — per-request isolation
                results[i] = e
        if not to_fit:
            return results
        check_deadline(deadline_s, "batch fit")

        # ---- fit phase: per-request numpy trainers --------------------
        t0 = time.perf_counter()
        fitted = []   # (slot, model, boxsets, pos, neg, incl, mr, t_fit)
        for it in to_fit:
            t1 = time.perf_counter()
            try:
                boxsets = self._fit_boxes(
                    it[1], view.x[it[2]], view.x[it[3]],
                    max_depth=it[6], n_models=it[7], seed=it[8],
                    frange=view.frange)
            except Exception as e:  # noqa: BLE001
                results[it[0]] = e
                continue
            fitted.append((it[0], it[1], boxsets, it[2], it[3], it[4],
                           it[5], time.perf_counter() - t1))
        fit_wall = time.perf_counter() - t0
        if not fitted:
            return results

        # ---- ONE fused device probe per subset, ONE sync per round -----
        t0 = time.perf_counter()
        nq = len(fitted)
        jobs, _ = self._make_jobs(
            [(bs, q) for q, f in enumerate(fitted) for bs in f[2]], nq)
        scores_dev, agg = self._device_scores(jobs, nq, view,
                                              deadline_s=deadline_s)

        # ---- ranking ---------------------------------------------------
        mrs = [f[6] for f in fitted]
        if all(m is not None for m in mrs):
            masks = [(pos, neg, incl)
                     for (_, _, _, pos, neg, incl, _, _) in fitted]
            ranked, hb = self._rank_device(scores_dev, masks, max(mrs), view)
            agg["host_bytes_transferred"] += hb
            ranked = [(ids[:m], sc[:m]) for (ids, sc), m in zip(ranked, mrs)]
        else:
            # any full-result request forces the tiles to the host ONCE;
            # truncated requests still see the device-ranking prefix
            counts = np.ascontiguousarray(
                self._scores_to_host(scores_dev, view).T)
            agg["host_bytes_transferred"] += scores_dev.nbytes
            ranked = []
            for q, (_, _, _, pos, neg, incl, m, _) in enumerate(fitted):
                ids, sc = self._rank(counts[q], pos, neg, incl)
                if m is not None:
                    ids, sc = ids[:m], sc[:m]
                ranked.append((ids, sc))
        t_query = time.perf_counter() - t0

        # ---- de-mux to per-request results -----------------------------
        base = {f"batch_{k}": v for k, v in agg.items()}
        base["path"] = "index"
        base["batch_size"] = nq
        base["batch_fit_s"] = fit_wall
        base["fit_path"] = "numpy"
        for q, (slot, model, boxes, pos, neg, incl, m, t_fit) in enumerate(
                fitted):
            ids, sc = ranked[q]
            stats = {**base, "n_boxes": int(sum(bs.n_boxes for bs in boxes))}
            results[slot] = QueryResult(model, ids, sc, t_fit, t_query,
                                        stats)
        return results

    # ------------------------------------------------------------------
    def refine(self, result: QueryResult, extra_pos: Sequence[int],
               extra_neg: Sequence[int], prev_pos: Sequence[int],
               prev_neg: Sequence[int], **kw) -> QueryResult:
        """Paper §5: iterative refinement — add labels, re-query. No index
        rebuild: only the model fit and the range queries rerun."""
        pos = list(prev_pos) + list(extra_pos)
        neg = list(prev_neg) + list(extra_neg)
        return self.query(pos, neg, model=result.model, **kw)
