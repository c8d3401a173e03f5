"""The RapidEarth search engine on PyTorch — the single-device paths of
``repro.core.engine`` for all five models, over a static catalog or a
live one (``live=True``: append / delete / compact, core/segments.py).

  offline:  features [N, D]  ->  K feature subsets  ->  K zone-map indexes
  online :  (pos ids, neg ids, model)  ->  batched device fit  ->
            winning boxes on the device  ->  one fused probe per subset
            ->  survivor tiles  ->  ranked object ids + query statistics

The dbranch/dbens fit of a whole batch window is one batched device
program (core/dbranch.fit_select) with two host syncs; the winning boxes
stay on the device. ``use_jax_fit=False`` selects the numpy trainers
(the oracle), and ``score_mode="dense"`` the dense [N, Q] score buffer
(the oracle of the survivor tiles), ranked by ``rank_topk``.

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

A live engine runs the same stages over the segmented catalog's virtual
block space (every segment's blocks concatenated), with tombstoned rows
masked at tile labelling (or accumulation, dense); each query or batch
window binds one catalog snapshot and keeps it. With ``data_dir`` the
live catalog is durable (core/persist.py): a directory that holds one is
recovered — disk wins over the constructor's features and geometry — and
served through the same probe.

Ids, scores and the integer stats are bitwise those of the reference
engine in the same configuration. What this port does not implement yet
raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import knn as knn_mod
from repro_torch.core import persist as persistmod
from repro_torch.core.boxes import BoxSet, concat_box_arrays
from repro_torch.core.capacity import HintTable
from repro_torch.core.capacity import hybrid_bucket as _cap_hybrid
from repro_torch.core.capacity import pow2ceil as _cap_pow2ceil
from repro_torch.core.capacity import quantum_bucket as _cap_quantum
from repro_torch.core.dbranch import (DBENS_SUBSET_CANDIDATES, dbens_draws,
                                      fit_dbens, fit_dbranch_best_subset,
                                      fit_select, split_tables)
from repro_torch.core.errors import RecoveryError, check_deadline, unported
from repro_torch.core.index import (build_indexes, full_scan, fused_stats,
                                    pad_boxes, query_index, sparse_probe,
                                    to_device_f32)
from repro_torch.core.segments import (SegmentedCatalog,
                                       SegmentedZoneMapIndex,
                                       segmented_fused_stats,
                                       segmented_query_accumulate,
                                       segmented_sparse_probe)
from repro_torch.core.subsets import make_subsets
from repro_torch.core.trees import fit_decision_tree, fit_random_forest
from repro_torch.device import resolve_device, to_device_async
from repro_torch.kernels import ops as kops
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as obs_trace

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
    """The catalog state one query (or batch window) runs against: the
    index set, features, feature range and validity mask of ONE catalog
    state. A static engine hands out a trivial view over its own fields,
    a live one the catalog snapshot of the moment."""
    indexes: Sequence
    n: int
    x: np.ndarray
    frange: Tuple[np.ndarray, np.ndarray]
    epoch: int = 0
    geom: int = 0        # compaction generation — capacity-hint key tag
    live: bool = False
    valid: Optional[torch.Tensor] = None       # [n] int32 device mask
    valid_host: Optional[np.ndarray] = None    # [n] bool host mirror
    live_rows: int = -1                        # -1 -> all n rows live


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


class SearchEngine:
    """End-to-end engine over an in-memory feature matrix, on one device.

    ``device=None`` means CUDA and raises when CUDA is absent; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    ``max_results`` (constructor default, overridable per query) caps how
    many ranked ids a query returns AND switches ranking to the device;
    with ``max_results=None`` the full ranked list comes from the host
    ranking oracle.

    Options (``_configure``): ``device``, ``capacity_frac`` (cold-start
    gather capacity as a fraction of the blocks), ``max_results``,
    ``use_fused`` (False: the host ``query_index`` oracle and the numpy
    trainers for dbranch/dbens), ``use_jax_fit`` (the reference's name,
    so one set of keyword arguments builds both engines: True, the
    default, trains on the engine's device; False, the numpy trainers),
    ``fit_max_nodes`` (the device fit's worklist floor), ``score_mode``
    ("sparse" survivor tiles or the "dense" oracle), ``live`` (a mutable
    catalog: ``append``, ``delete``, ``compact``), ``data_dir`` (a
    durable live catalog: ``checkpoint``, ``close``; a directory that
    already holds one is recovered, and ``features`` may then be None),
    ``wal_sync`` ("always", "batch" or "none"), ``faults`` (a fault
    injector, serve/faults.py, whose seams the engine and the catalog
    fire), and the reference's ``mirror`` and ``n_shards``, which take
    only the values of the single-device path. ``recovery`` holds the
    report of a recovery (None otherwise); a damaged directory serves
    its salvaged catalog.

    The scan models read the whole [N, D] feature matrix. The reference
    uploads it on every scan; this engine keeps one device copy, uploaded
    at the first scan query and extended by appended rows only
    (``feature_mirror_bytes``).
    """

    def __init__(self, features: Optional[np.ndarray] = None, *,
                 n_subsets: int = 32, subset_dim: int = 6, block: int = 1024,
                 seed: int = 0, data_dir=None, wal_sync: str = "batch",
                 **options):
        recovered = self._configure(features, data_dir=data_dir,
                                    wal_sync=wal_sync, **options)
        t0 = time.perf_counter()
        if recovered is not None:
            # disk wins: subsets and geometry come from the manifest, not
            # the constructor's arguments
            self.subsets = np.asarray(recovered.subsets)
            self._catalog = recovered
            self.indexes = list(recovered.snapshot().indexes)
        else:
            self.subsets = make_subsets(self.d, n_subsets, subset_dim,
                                        seed=seed)
            if self.live:
                self._catalog = SegmentedCatalog(
                    self.x, self.subsets, block=block, faults=self.faults,
                    persist_dir=data_dir, sync=wal_sync, device=self.device)
                self.indexes = list(self._catalog.snapshot().indexes)
            else:
                self.indexes = build_indexes(self.x, self.subsets,
                                             block=block, device=self.device)
        self.build_time_s = time.perf_counter() - t0
        # a recovered catalog's physical rows include tombstones: its live
        # range comes from the snapshot, never a rescan
        self.frange = (recovered.snapshot().frange if recovered is not None
                       else (self.x.min(0), self.x.max(0)))

    def _configure(self, features, *, device=None,
                   capacity_frac: float = 0.25,
                   max_results: Optional[int] = None,
                   use_jax_fit: bool = True, fit_max_nodes: int = 64,
                   use_fused: bool = True, score_mode: str = "sparse",
                   mirror: str = "f32", n_shards: int = 1,
                   live: bool = False, data_dir=None,
                   wal_sync: str = "batch",
                   faults=None) -> Optional[SegmentedCatalog]:
        """The options every constructor takes; each one the port does not
        implement yet raises NotImplementedError naming its ROADMAP item.
        Returns the catalog recovered from ``data_dir``, or None."""
        self.device = resolve_device(device)
        if score_mode not in ("sparse", "dense"):
            raise ValueError(f"score_mode must be 'sparse' or 'dense', "
                             f"got {score_mode!r}")
        if mirror == "quantized":
            raise unported("mirror='quantized'", "A10")
        if mirror != "f32":
            raise ValueError(f"mirror must be 'f32' or 'quantized', "
                             f"got {mirror!r}")
        if int(n_shards) > 1:
            raise unported("n_shards > 1 (sharded, and live sharded, "
                            "catalogs)", "A11")
        # fault-injection seams: an object with a check(site) method, or
        # None; the engine never imports the injector
        self.faults = faults
        self.recovery = None
        recovered = None
        if data_dir is not None:
            if not live:
                raise ValueError("data_dir requires live=True")
            # one writing process a directory: open() and the genesis
            # Persistence both take its lock
            if persistmod.has_state(data_dir):
                try:
                    recovered = SegmentedCatalog.open(
                        data_dir, faults=faults, sync=wal_sync,
                        device=self.device)
                except RecoveryError as e:
                    if e.catalog is None:
                        raise
                    recovered = e.catalog
                self.recovery = recovered.recovery
                if recovered.n_shards > 1:
                    recovered.close()
                    raise unported("n_shards > 1 (a recovered sharded "
                                   "live catalog)", "A11")
        self.n_shards = 1
        self.mirror = mirror
        self.live = bool(live)
        self._catalog: Optional[SegmentedCatalog] = None
        self._sync_lock = threading.Lock()
        if recovered is not None:
            self.x = np.asarray(recovered.snapshot().x)
        elif features is None:
            raise ValueError(
                "features is required unless data_dir holds a "
                "recoverable durable catalog")
        else:
            self.x = np.ascontiguousarray(np.asarray(features, np.float32))
        self.n, self.d = self.x.shape
        self.capacity_frac = capacity_frac
        self.max_results = max_results
        self.use_fused = bool(use_fused)
        # the batched device trainer (DESIGN.md §10): every dbranch/dbens
        # fit of a batch window in one program, winning boxes kept on the
        # device; the numpy trainers stay the oracle (use_jax_fit=False)
        self.use_jax_fit = bool(use_jax_fit)
        # worklist FLOOR per trained model (batched fits scale it to 2x
        # the padded positive count so realistic trees never hit it)
        self.fit_max_nodes = int(fit_max_nodes)
        self.score_mode = score_mode
        # the scan models' device copy of x, uploaded at first use
        self._x_dev: Optional[torch.Tensor] = None
        # survivor counts observed by the probes, keyed by (generation,
        # subset, box-count bucket); sizes the next like-shaped gather
        self._cap_hints = HintTable()
        # high-water mark of device score-buffer bytes across queries
        self._score_bytes_peak = 0
        return recovered

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

    @classmethod
    def from_catalog(cls, catalog: SegmentedCatalog,
                     **options) -> "SearchEngine":
        """A live engine over an existing catalog (for instance one that
        core/convert.catalog_from_arrays carried over), on the catalog's
        device; it adopts the catalog's subsets and geometry, as the
        reference's engine adopts a recovered one. A durable catalog
        (``SegmentedCatalog(persist_dir=...)`` or ``SegmentedCatalog.open``)
        keeps its own persistence, so ``data_dir`` is refused here."""
        if options.get("data_dir") is not None:
            raise ValueError("from_catalog serves the catalog it is given; "
                             "its persistence is the catalog's own")
        dev = options.pop("device", catalog.device)
        if resolve_device(dev) != catalog.device:
            raise ValueError(f"the catalog's mirrors live on "
                             f"{catalog.device}, not {dev}")
        eng = cls.__new__(cls)
        eng._configure(catalog.snapshot().x, device=catalog.device,
                       live=True, **options)
        eng.subsets = np.asarray(catalog.subsets)
        eng._catalog = catalog
        eng.build_time_s = 0.0
        eng._sync_live()
        return eng

    # ------------------------------------------------------------------
    def _view(self) -> _EngineView:
        """Bind the catalog state one query (or batch window) runs
        against: a live engine reads its catalog's snapshot ONCE here, and
        every later stage takes the view."""
        if self._catalog is None:
            return _EngineView(self.indexes, self.n, self.x, self.frange)
        s = self._catalog.snapshot()
        return _EngineView(s.indexes, s.n, s.x, s.frange, epoch=s.epoch,
                           geom=s.geom, live=True, valid=s.valid_device(),
                           valid_host=s.valid_host, live_rows=s.live_rows)

    def _fault(self, site: str) -> None:
        """Fault-injection checkpoint: a no-op unless an injector was
        given at construction."""
        if self.faults is not None:
            self.faults.check(site)

    def _round_checkpoint(self, deadline_s) -> None:
        """Once per device launch round: the fused-query fault seam, then
        the between-rounds deadline check — a request whose budget is
        gone stops HERE instead of burning another round of device
        time."""
        # trace seam too: closes the previous device_round span and
        # opens the next on every ambient trace (no-op untraced)
        obs_trace.round_mark()
        self._fault("fused_query")
        check_deadline(deadline_s, "device query round")

    def invalidate_capacity_hints(self) -> int:
        """Drop every capacity hint (cold-start sizing resumes); returns
        the number of entries dropped."""
        return self._cap_hints.invalidate()

    @staticmethod
    def _index_nbytes(ix) -> int:
        return (ix.rows_nbytes if isinstance(ix, SegmentedZoneMapIndex)
                else int(ix.rows.nbytes))

    def _device_features(self, view: Optional[_EngineView] = None
                         ) -> torch.Tensor:
        """The view's [n, D] features on the engine's device (a view of
        the host array on the CPU). Uploaded once, then extended by the
        appended rows only: a catalog's rows never change, and every
        snapshot's features are a prefix of the newest."""
        x = self.x if view is None else view.x
        n = x.shape[0]
        have = 0 if self._x_dev is None else int(self._x_dev.shape[0])
        if have < n:
            delta = torch.from_numpy(x[have:n]).to(self.device)
            self._x_dev = delta if have == 0 else torch.cat([self._x_dev,
                                                             delta])
        return self._x_dev[:n]

    def feature_mirror_bytes(self) -> int:
        """Bytes of the scan models' device feature copy (0 until the
        first scan query uploads it)."""
        return 0 if self._x_dev is None else int(self._x_dev.nbytes)

    # ------------------------------------------------------------------
    # live-catalog lifecycle
    # ------------------------------------------------------------------
    def _require_live(self) -> SegmentedCatalog:
        if self._catalog is None:
            raise RuntimeError(
                "this engine is static — construct SearchEngine(..., "
                "live=True) to append/delete/compact")
        return self._catalog

    def _sync_live(self) -> None:
        """Refresh the engine-level mirrors of the catalog head (what
        index_stats and callers read; queries bind a snapshot instead) and
        drop the capacity hints of dead geometry generations. Serialised:
        a background compaction finishes on its own thread."""
        with self._sync_lock:
            s = self._catalog.snapshot()
            self.indexes = list(s.indexes)
            self.x = s.x
            self.n = s.n
            self.frange = s.frange
            self._cap_hints.prune_generation(s.geom)

    def append(self, features: np.ndarray) -> np.ndarray:
        """Seal new rows into a delta segment; returns their global ids
        (append-ordered, stable forever). O(new rows): no rebuild, and
        no existing segment's mirrors are uploaded again."""
        ids = self._require_live().append(features)
        self._sync_live()
        return ids

    def delete(self, ids) -> int:
        """Tombstone global ids; returns how many rows went live -> dead.
        Ranked queries never surface tombstoned rows again."""
        nd = self._require_live().delete(ids)
        self._sync_live()
        return nd

    def compact(self, background: bool = False):
        """Merge all sealed segments into one re-sorted segment and swap
        it in under a new epoch. ``background=True`` runs the merge (host
        work only: the new mirrors are built by the next query) off the
        calling thread and returns the started Thread; queries go on over
        the old snapshot until the swap. Otherwise returns the compaction
        stats."""
        self._require_live()
        if background:
            t = threading.Thread(target=self._compact_now, daemon=True)
            t.start()
            return t
        return self._compact_now()

    def _compact_now(self) -> Dict:
        with obs_profile.profile("compact"):
            st = self._catalog.compact()
        self._sync_live()
        return st

    def checkpoint(self) -> Dict:
        """Durably checkpoint the live catalog (segment column files +
        manifest); requires ``data_dir``. Shortens the WAL replay of a
        later recovery."""
        return self._require_live().checkpoint()

    def close(self) -> None:
        """Flush and fsync the durable catalog's WAL and release its
        directory; a no-op for static or non-durable engines."""
        if self._catalog is not None:
            self._catalog.close()

    def index_stats(self) -> Dict:
        st = {
            "rows": self.n,
            "dims": self.d,
            "n_subsets": len(self.indexes),
            "subset_dim": int(self.subsets.shape[1]),
            "n_shards": self.n_shards,
            "build_time_s": self.build_time_s,
            "index_bytes": int(sum(self._index_nbytes(ix)
                                   for ix in self.indexes)),
            "feature_bytes": int(self.x.nbytes),
            "score_mode": self.score_mode,
            "mirror": self.mirror,
            "device": str(self.device),
        }
        # resident device-mirror bytes, by kind and per index (lazy
        # mirrors count 0 until their first use)
        dev: Dict[str, int] = {}
        per_index = []
        for ix in self.indexes:
            db = ix.device_bytes()
            per_index.append({"subset_id": int(ix.subset_id),
                              **{k: int(v) for k, v in db.items()},
                              "total": int(sum(db.values()))})
            for k, v in db.items():
                dev[k] = dev.get(k, 0) + int(v)
        st["device_bytes"] = {**dev, "total": int(sum(dev.values()))}
        st["device_bytes_per_index"] = per_index
        st["score_buffer_bytes_peak"] = int(self._score_bytes_peak)
        if self._catalog is not None:
            st["live"] = True
            st.update(self._catalog.stats())
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
        _t_prep = time.perf_counter()
        if model not in MODELS:
            raise ValueError(f"unknown model {model!r}; choose from {MODELS}")
        check_deadline(deadline_s, "fit")
        mr = self.max_results if max_results is _UNSET else max_results
        view = self._view()
        pos_ids = np.asarray(list(pos_ids), np.int64)
        neg_ids = np.asarray(list(neg_ids), np.int64)
        xp, xn = view.x[pos_ids], view.x[neg_ids]
        # snapshot + label-row gather is real pre-fit wall: billed as its
        # own span so traces account for >=90% of the request
        obs_trace.add_span_active("prepare", _t_prep,
                                  time.perf_counter() - _t_prep)

        t0 = time.perf_counter()
        if model in ("dbranch", "dbens"):
            if self.use_jax_fit and self.use_fused:
                # device fit, device boxes: only the [2, G] winner meta
                # crosses to the host
                lo_c, hi_c, entries = self._fit_boxes_batched(
                    [(model, xp, xn, n_models, seed)], max_depth=max_depth,
                    return_device=True, frange=view.frange)
                if isinstance(entries[0], Exception):
                    raise entries[0]
                boxes = ("device", lo_c, hi_c, entries[0])
            else:
                # the non-fused engine is the all-oracle configuration:
                # host inference AND the numpy trainer
                boxes = self._fit_boxes(model, xp, xn, max_depth=max_depth,
                                        n_models=n_models, seed=seed,
                                        use_jax=False, frange=view.frange)
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
        obs_trace.add_span_active("fit", t0, t_fit)

        t0 = time.perf_counter()
        check_deadline(deadline_s, "inference")
        if model in ("dbranch", "dbens"):
            ids, scores, stats = self._run_index_path(
                boxes, pos_ids, neg_ids, include_training, mr, view,
                deadline_s=deadline_s)
            stats["path"] = "index"
            # named after the reference's option, not the library: "jax"
            # is the batched device fit
            stats["fit_path"] = ("jax" if self.use_jax_fit and self.use_fused
                                 else "numpy")
        elif model == "knn":
            n_live = view.live_rows if view.live else view.n
            k = min(k_neighbors, n_live)
            ids_k, _ = knn_mod.knn_subset(view.indexes[0], xp, k=k,
                                          live=view.valid_host)
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
                counts = full_scan(self._device_features(view), lo, hi)
            if view.valid_host is not None:
                # the scan sees every physical row: tombstoned rows must
                # not surface from this path either
                counts = np.where(view.valid_host, counts, 0)
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
                   use_jax: Optional[bool] = None,
                   frange=None) -> List[BoxSet]:
        """Fit an index-path model; query() and query_batch() both come
        here (or to _fit_boxes_batched), so batched and sequential answers
        train identically. The engine's feature range is plumbed into both
        trainers so box expansion sees the catalog's spread. ``use_jax``
        overrides the engine default; the device fit's BoxSets hold
        tensors on the engine's device."""
        use_jax = self.use_jax_fit if use_jax is None else use_jax
        frange = self.frange if frange is None else frange
        if use_jax:
            return self._fit_boxes_batched(
                [(model, xp, xn, n_models, seed)], max_depth=max_depth,
                frange=frange)[0]
        if model == "dbranch":
            return [fit_dbranch_best_subset(xp, xn, self.subsets,
                                            max_depth=max_depth,
                                            feature_range=frange)]
        return fit_dbens(xp, xn, self.subsets, n_models=n_models,
                         max_depth=max_depth, seed=seed,
                         feature_range=frange)

    def _fit_boxes_batched(self, specs: Sequence[Tuple], *,
                           max_depth: int, return_device: bool = False,
                           frange=None):
        """Device-resident batched fit (DESIGN.md §10): train EVERY model
        of a batch window — (candidate subsets x ensemble members x
        requests) lanes — on the device (core/dbranch.fit_select: one
        capped round over all lanes, one survivor round for deep trees),
        select each model's winning subset there, and keep the winning
        boxes there.

        specs: [(model, xp, xn, n_models, seed)] with xp/xn the raw
        full-width label features. With ``return_device`` the compacted
        winner arrays come back — (lo [G, S, d'], hi, entries per spec of
        (winner row, subset id, box count)) — and flow into
        _make_jobs_flat with no host round trip; otherwise box-set lists
        aligned with specs. Shapes are bucketed (P, Ng, lanes, groups) as
        in the reference. The inputs go up without a host sync; the only
        syncs are the round-1 survivor flags and the [2, G] meta."""
        frange = self.frange if frange is None else frange
        n_sub = len(self.subsets)
        dsub = int(self.subsets.shape[1])
        groups = []     # (spec_idx, cand ids, lane start, boot pos, boot neg)
        lane0 = p_max = n_max = 0
        for si, (model, xp, xn, n_models, seed) in enumerate(specs):
            xp = np.asarray(xp, np.float32)
            xn = np.asarray(xn, np.float32)
            p_max, n_max = max(p_max, len(xp)), max(n_max, len(xn))
            if model == "dbranch":
                draws = [(None, None, np.arange(n_sub))]
            else:       # dbens: same bootstrap draws as the numpy trainer
                draws = dbens_draws(len(xp), len(xn), n_sub, n_models,
                                    DBENS_SUBSET_CANDIDATES, seed)
            for ip, ineg, cand in draws:
                bp = xp if ip is None else xp[ip]
                bn = xn if ineg is None else (xn[ineg] if len(xn) else xn)
                groups.append((si, np.asarray(cand), lane0, bp, bn))
                lane0 += len(cand)
        t = lane0
        g_real = len(groups)
        # bucketing: pow2 for small values, then coarse linear quanta
        p_pad = self._fit_bucket(p_max, 32)
        n_pad = self._fit_bucket(n_max, 32)
        t_pad = self._fit_bucket(t, 128)
        # dummy lanes park in an extra dummy group so real winners are
        # never contested by padding
        g_pad = self._pow2ceil(g_real + (1 if t_pad > t else 0))
        x_b = np.zeros((t_pad, p_pad + n_pad, dsub), np.float32)
        m_b = np.zeros((t_pad, p_pad + n_pad), bool)
        fr_b = np.zeros((t_pad, 2, dsub), np.float32)
        gid_b = np.full(t_pad, g_real, np.int32)
        for g, (si, cand, l0, bp, bn) in enumerate(groups):
            c = len(cand)
            dims = self.subsets[cand]                          # [C, d']
            x_b[l0:l0 + c, :len(bp)] = bp[:, dims].transpose(1, 0, 2)
            m_b[l0:l0 + c, :len(bp)] = True
            if len(bn):
                x_b[l0:l0 + c, p_pad:p_pad + len(bn)] = \
                    bn[:, dims].transpose(1, 0, 2)
                m_b[l0:l0 + c, p_pad:p_pad + len(bn)] = True
            fr_b[l0:l0 + c, 0] = frange[0][dims]
            fr_b[l0:l0 + c, 1] = frange[1][dims]
            gid_b[l0:l0 + c] = g
        # split-search tables on the host: numpy sorts the whole lane
        # stack in one shot, the device program never sorts
        si_b, re_b = split_tables(x_b)
        # the worklist cap: trees that outgrow it emit early, diverging
        # from the (uncapped) numpy oracle — scale headroom with the
        # label-set size (a tree has at most one leaf per positive)
        max_nodes = max(self.fit_max_nodes, 2 * p_pad)
        dev = self.device
        lo_c, hi_c, meta_dev = fit_select(
            to_device_async(x_b, dev), to_device_async(m_b, dev),
            to_device_async(fr_b, dev), to_device_async(gid_b, dev),
            to_device_async(np.concatenate([si_b, re_b], axis=2), dev),
            p_cnt=p_pad, n_groups=g_pad, max_nodes=max_nodes,
            max_depth=max_depth)
        meta = meta_dev.cpu().numpy()                  # the ONE result sync
        # decode winners PER SPEC: a request whose label set produced no
        # boxes fails alone — its exception rides in its slot and the
        # rest of the window keeps its finished device fit
        entries: List = [[] for _ in specs]
        for g, (si, cand, start, _, _) in enumerate(groups):
            if isinstance(entries[si], Exception):
                continue
            wl, nb = int(meta[0, g]), int(meta[1, g])
            if wl >= t or nb <= 0:
                entries[si] = RuntimeError("no subset produced boxes")
                continue
            sid = int(cand[wl - start])
            entries[si].append((g, sid, nb))
        if return_device:
            return lo_c, hi_c, entries
        out = []
        for ent in entries:
            if isinstance(ent, Exception):
                raise ent
            out.append([BoxSet(lo_c[g, :nb], hi_c[g, :nb],
                               self.subsets[sid], sid)
                        for g, sid, nb in ent])
        return out

    def _make_jobs_flat(self, parts, nq: int):
        """The _make_jobs counterpart for device-resident fit output.

        parts: [(lo_c, hi_c, g, sid, cnt, q)] — the [G, S, d'] compacted
        winner arrays from _fit_boxes_batched(return_device=True), a
        winner row g, its subset, real box count, and owning query.
        Builds the same jobs with ONE device gather per (subset, fit
        array) instead of per-model slices."""
        by_subset: Dict[int, List] = {}
        for part in parts:
            by_subset.setdefault(part[3], []).append(part)
        jobs = []
        totals = np.zeros(nq, np.int64)
        for sid, group in by_subset.items():
            by_arr: Dict[int, Tuple] = {}
            for lo_c, hi_c, g, _, cnt, q in group:
                by_arr.setdefault(id(lo_c), (lo_c, hi_c, []))[2].append(
                    (g, cnt, q))
            los, his, owners = [], [], []
            for lo_c, hi_c, ents in by_arr.values():
                s, d = lo_c.shape[1], lo_c.shape[2]
                idx = to_device_async(np.concatenate(
                    [np.arange(cnt, dtype=np.int64) + g * s
                     for g, cnt, _ in ents]), lo_c.device)
                los.append(lo_c.reshape(-1, d).index_select(0, idx))
                his.append(hi_c.reshape(-1, d).index_select(0, idx))
                owners += [np.full(cnt, q, np.int32) for _, cnt, q in ents]
            lo = los[0] if len(los) == 1 else torch.cat(los)
            hi = his[0] if len(his) == 1 else torch.cat(his)
            owner = np.concatenate(owners)
            jobs.append((sid, BoxSet(lo, hi, self.subsets[sid], sid),
                         owner))
            totals += np.bincount(owner, minlength=nq)
        return jobs, (int(totals.max()) if jobs else 0)

    # capacity/shape bucketing is shared policy (core/capacity.py)
    @staticmethod
    def _pow2ceil(v: int) -> int:
        return _cap_pow2ceil(v)

    @staticmethod
    def _fit_bucket(v: int, quantum: int) -> int:
        """Shape bucket for the batched trainer: pow2 below ``quantum``,
        then quantum multiples (a 128-lane dbens window pads to 640 lanes,
        not 1024)."""
        v = max(int(v), 1)
        if v <= quantum:
            return _cap_pow2ceil(v)
        return _cap_quantum(v, quantum)

    def _cap_key(self, sid: int, n_boxes: int, geom: int = 0):
        """Hints are keyed by (geometry generation, subset, pow2-bucketed
        box count), so a single query (few boxes) and a batch window's
        union (many boxes) do not poison each other's sizing."""
        return (int(geom), sid, self._pow2ceil(max(int(n_boxes), 1)))

    def _cap_bucket(self, v: int, n_blocks: int) -> int:
        """Capacity bucket: pow2-rounded, capped at the block count."""
        return min(_cap_pow2ceil(max(int(v), 1)), n_blocks)

    def _initial_capacity(self, index, n_boxes: Optional[int] = None,
                          geom: int = 0) -> int:
        """Gather capacity for a subset's probe: the last observed
        survivor count for a like-sized boxset of the same geometry
        generation when one is known, otherwise the capacity_frac
        cold-start policy (over a segmented index's whole virtual block
        space). Results stay exact either way: an under-sized guess is
        caught by the batched overflow check and retried."""
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
        """A probe input as f32 on the engine's device: host arrays go up
        pinned and non-blocking (a pageable copy is a host sync)."""
        if isinstance(a, torch.Tensor):
            return to_device_f32(a, self.device)
        return to_device_async(np.asarray(a, np.float32), self.device)

    def _probe_inputs(self, merged: BoxSet, owner: np.ndarray, nq: int):
        """Padded boxes and the [B, Q] f32 ownership one-hot, on the
        engine's device."""
        lo, hi, owner_p = pad_boxes(merged.lo, merged.hi, owner)
        onehot = (owner_p[:, None] == np.arange(nq)[None]).astype(np.float32)
        return self._upload(lo), self._upload(hi), self._upload(onehot)

    def _device_scores(self, jobs, nq: int, view: _EngineView,
                       deadline_s=None):
        """Mode dispatch for the score accumulation: the survivor tiles
        (score_mode="sparse") or the dense [N, Q] buffer ("dense"). Same
        probes, capacities, sync cadence and retries; int32 vote addition
        is exactly associative, so both are bitwise-identical end to
        end. Runs under a trace round scope: each ``_round_checkpoint``
        inside becomes one ``device_round`` span on every ambient trace
        (overflow-retry rounds included); a shared no-op when nothing is
        attached."""
        with obs_trace.round_scope():
            if self.score_mode == "dense":
                return self._device_scores_dense(jobs, nq, view,
                                                 deadline_s=deadline_s)
            return self._device_scores_sparse(jobs, nq, view,
                                              deadline_s=deadline_s)

    @staticmethod
    def _live_agg(agg: Dict, view: _EngineView) -> np.ndarray:
        """A live view's catalog stats in ``agg``; returns the zeroed
        per-segment refined-block counter."""
        n_segs = view.indexes[0].n_segments
        agg["n_segments"] = n_segs
        agg["rows_live"] = view.live_rows
        agg["rows_tombstoned"] = view.n - view.live_rows
        return np.zeros(n_segs, np.int64)

    def _device_scores_dense(self, jobs, nq: int, view: _EngineView,
                             deadline_s=None):
        """Answer every subset's boxes and accumulate all counts into ONE
        [n, nq] int32 device score buffer in ORIGINAL row order (the
        reference's dense ``_device_scores_impl``).

        Per round: queue every pending subset's fused query, then ONE
        batched device->host sync of the stacked stat vectors. Subsets
        whose survivors exceeded capacity are re-queued with capacity >=
        the observed count; the others gather their counts into the
        buffer on the device (kops.accumulate_scores). A live view probes
        the virtual block space of base + every delta in one call a
        subset (segmented_query_accumulate): the buffer's row index is the
        global id, tombstoned rows are masked to 0 inside the
        accumulation, and the stat vector carries the refined blocks per
        segment after the survivor total."""
        scores = torch.zeros((view.n, nq), dtype=torch.int32,
                             device=self.device)
        agg = self._new_agg()
        live = view.live
        per_seg_agg = self._live_agg(agg, view) if live else None
        pending = [(sid, merged, owner,
                    self._initial_capacity(view.indexes[sid],
                                           merged.n_boxes, geom=view.geom))
                   for sid, merged, owner in jobs]
        while pending:
            self._round_checkpoint(deadline_s)
            launched = []
            _t_disp = time.perf_counter()
            for sid, merged, owner, cap in pending:
                index = view.indexes[sid]
                lo_d, hi_d, onehot = self._probe_inputs(merged, owner, nq)
                if live:
                    # accumulated already: an overflowed attempt leaves
                    # the buffer as it was
                    scores, stvec = segmented_query_accumulate(
                        index, scores, lo_d, hi_d, onehot, view.valid,
                        capacity=cap)
                    launched.append((sid, merged, owner, cap, None, None,
                                     stvec))
                    continue
                rows3, zlo, zhi = index.device_arrays()
                counts, cand, n_hit = kops.fused_query(
                    rows3, zlo, zhi, lo_d, hi_d, onehot, capacity=cap)
                launched.append((sid, merged, owner, cap, counts, cand,
                                 n_hit.reshape(1)))
            # ONE batched sync covers the whole round's overflow checks
            obs_profile.record("jit_dispatch",
                               time.perf_counter() - _t_disp)
            self._fault("device_sync")
            with obs_profile.profile("device_sync"):
                stvecs = torch.stack([l[6] for l in launched]).cpu().numpy()
            agg["n_host_syncs"] += 1
            agg["host_bytes_transferred"] += int(stvecs.nbytes)
            pending = []
            for (sid, merged, owner, cap, counts, cand, _), st in zip(
                    launched, stvecs):
                index = view.indexes[sid]
                nh = int(st[0])
                self._cap_hints.observe(
                    self._cap_key(sid, merged.n_boxes, view.geom), nh)
                if nh > cap:
                    # the failed attempt still gathered (and priced) cap
                    # blocks of device traffic
                    agg["blocks_gathered"] += cap
                    agg["bytes_touched"] += int(
                        cap * index.block * len(index.dims) * 4)
                    pending.append((sid, merged, owner,
                                    min(self._pow2ceil(nh), index.n_blocks)))
                    continue
                if live:
                    st_d = segmented_fused_stats(index, nh, st[1:], cap,
                                                 merged.n_boxes,
                                                 view.live_rows)
                    per_seg_agg += np.asarray(
                        st_d["per_segment_blocks_touched"], np.int64)
                else:
                    scores = kops.accumulate_scores(
                        scores, counts, cand, index.device_inv_perm(),
                        nb=index.n_blocks)
                    st_d = fused_stats(index, nh, cap, merged.n_boxes)
                self._accumulate_agg(agg, st_d, merged.n_boxes)
            agg["retried_subsets"] += len(pending)
        if live:
            agg["per_segment_blocks_touched"] = per_seg_agg.tolist()
        self._note_dense_buffer(agg, scores, nq, view)
        return scores, self._finalize_agg(agg, view)

    def _note_dense_buffer(self, agg: Dict, scores, nq: int,
                           view: _EngineView) -> None:
        """Dense-path memory accounting, symmetric with the sparse form:
        the peak device score footprint IS the full buffer."""
        agg["score_buffer_bytes_peak"] = int(scores.nbytes)
        agg["score_rows"] = int(scores.nbytes) // (4 * max(nq, 1))
        agg["dense_score_bytes_equiv"] = int(view.n) * nq * 4
        self._score_bytes_peak = max(self._score_bytes_peak,
                                     int(scores.nbytes))

    def _device_scores_sparse(self, jobs, nq: int, view: _EngineView,
                              deadline_s=None):
        """The survivor-sparse accumulation (DESIGN.md §13).

        Per round: queue every pending subset's probe, then ONE batched
        device->host sync of the stacked [2] stat vectors (n_hit,
        n_match). Overflowed subsets (n_hit > capacity) are re-queued at
        min(pow2ceil(n_hit), n_blocks); the others compact their surviving
        rows into one packed, exactly-sized tile per round. The zone prune
        is conservative and int32 vote addition is associative, so the
        tiles are bitwise the dense accumulation. A live view probes the
        virtual block space with its validity mask, and its stat vectors
        carry the refined blocks per segment as well."""
        agg = self._new_agg()
        live = view.live
        per_seg_agg = self._live_agg(agg, view) if live else None
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
                                           merged.n_boxes, geom=view.geom))
                   for sid, merged, owner in jobs]
        while pending:
            self._round_checkpoint(deadline_s)
            launched, round_parts, round_rcaps = [], [], []
            _t_disp = time.perf_counter()
            for sid, merged, owner, cap in pending:
                lo_d, hi_d, onehot = self._probe_inputs(merged, owner, nq)
                if live:
                    probe = segmented_sparse_probe(
                        view.indexes[sid], lo_d, hi_d, onehot, view.valid,
                        capacity=cap)
                else:
                    probe = sparse_probe(view.indexes[sid], lo_d, hi_d,
                                         onehot, capacity=cap)
                launched.append((sid, merged, owner, cap) + probe)
            # ONE batched sync: a fixed-width int vector per subset
            obs_profile.record("jit_dispatch",
                               time.perf_counter() - _t_disp)
            self._fault("device_sync")
            with obs_profile.profile("device_sync"):
                stvecs = torch.stack([l[7] for l in launched]).cpu().numpy()
            agg["n_host_syncs"] += 1
            agg["host_bytes_transferred"] += int(stvecs.nbytes)
            pending = []
            for (sid, merged, owner, cap, counts, gids, ok, _), st in zip(
                    launched, stvecs):
                index = view.indexes[sid]
                nh = int(st[0])
                self._cap_hints.observe(
                    self._cap_key(sid, merged.n_boxes, view.geom), nh)
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
                if live:
                    st_d = segmented_fused_stats(index, nh, st[2:], cap,
                                                 merged.n_boxes,
                                                 view.live_rows)
                    per_seg_agg += np.asarray(
                        st_d["per_segment_blocks_touched"], np.int64)
                else:
                    st_d = fused_stats(index, nh, cap, merged.n_boxes)
                self._accumulate_agg(agg, st_d, merged.n_boxes)
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
        if live:
            agg["per_segment_blocks_touched"] = per_seg_agg.tolist()
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

    def _scores_to_host(self, scores_dev, view: _EngineView) -> np.ndarray:
        """[N, Q] int32 host counts in GLOBAL row order: the dense buffer
        as it is, or only the survivor tiles, de-duplicated by scatter-add
        on the host (bitwise the dense transfer at O(survivors))."""
        if not isinstance(scores_dev, SparseScores):
            return scores_dev.cpu().numpy()
        keys = scores_dev.keys.cpu().numpy()
        vals = scores_dev.vals.cpu().numpy()
        out = np.zeros((scores_dev.n, vals.shape[1]), np.int32)
        m = keys != int(kops.TILE_INVALID)
        np.add.at(out, keys[m], vals[m])
        return out

    def _index_inference(self, boxsets: List[BoxSet], view: _EngineView):
        """Host/oracle range-query path (use_fused=False): per-subset
        query_index, the boxes of one subset merged into one call. Kept
        as the correctness oracle for the device-resident path. A live
        view runs it per segment (counts land at each segment's global
        offset), then zeroes the tombstoned rows."""
        counts = np.zeros(view.n, np.int64)
        agg = self._new_agg()
        qfn = self._query_segments if view.live else query_index
        by_subset: Dict[int, List[BoxSet]] = {}
        for bs in boxsets:
            by_subset.setdefault(bs.subset_id, []).append(bs)
        for sid, group in by_subset.items():
            merged = group[0]
            for g in group[1:]:
                merged = merged.concatenate(g)
            c, st = qfn(view.indexes[sid], merged)
            counts += c
            self._accumulate_agg(agg, st, merged.n_boxes)
        if view.valid_host is not None:
            counts = np.where(view.valid_host, counts, 0)
        return counts, self._finalize_agg(agg, view)

    @staticmethod
    def _query_segments(segx: SegmentedZoneMapIndex, merged: BoxSet):
        """query_index over each segment of a live subset view: [n] counts
        in global order and the segments' stats summed."""
        c = np.zeros(segx.n_rows, np.int64)
        st_sum: Dict = {}
        for seg, off in zip(segx.segs, segx.offsets[:-1]):
            cs, st = query_index(seg, merged)
            c[off:off + seg.n_rows] = cs
            for k, v in st.items():
                st_sum[k] = st_sum.get(k, 0) + v
        return c, st_sum

    def _run_index_path(self, boxsets, pos_ids, neg_ids,
                        include_training: bool, mr: Optional[int],
                        view: _EngineView, deadline_s=None):
        """Single-query index inference + ranking: the fused engine scores
        on the device and, with ``mr`` set, ranks there too; the
        use_fused=False engine runs the host oracle. ``boxsets`` is a
        List[BoxSet], or the ("device", lo, hi, entries) form handed out
        by the batched device fit — those boxes never touch the host."""
        if not self.use_fused:
            counts, stats = self._index_inference(boxsets, view)
            ids, scores = self._rank(counts, pos_ids, neg_ids,
                                     include_training)
            return ids, scores, stats    # query() applies the mr cut
        _t_prep = time.perf_counter()
        if isinstance(boxsets, tuple) and boxsets[0] == "device":
            _, lo_c, hi_c, ent = boxsets
            jobs, bound = self._make_jobs_flat(
                [(lo_c, hi_c, g, sid, cnt, 0) for g, sid, cnt in ent], 1)
        else:
            jobs, bound = self._make_jobs([(bs, 0) for bs in boxsets], 1)
        # job assembly (per-subset grouping, device slicing) sits between
        # fit and the first device round: billed so it never reads as an
        # unexplained gap in the trace
        obs_trace.add_span_active("prepare", _t_prep,
                                  time.perf_counter() - _t_prep,
                                  {"jobs": len(jobs)})
        scores_dev, stats = self._device_scores(jobs, 1, view,
                                                deadline_s=deadline_s)
        _t_rank = time.perf_counter()
        if mr is None:
            counts = self._scores_to_host(scores_dev, view)[:, 0]
            # sparse buffers cross as tiles: price what actually moved
            stats["host_bytes_transferred"] += (
                scores_dev.nbytes if isinstance(scores_dev, SparseScores)
                else int(counts.nbytes))
            ids, scores = self._rank(counts, pos_ids, neg_ids,
                                     include_training)
        else:
            ranked, hb = self._rank_device(
                scores_dev, [(pos_ids, neg_ids, include_training)], mr,
                bound, view)
            stats["host_bytes_transferred"] += hb
            ids, scores = ranked[0]
        obs_trace.add_span_active("rank", _t_rank,
                                  time.perf_counter() - _t_rank)
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

    def _rank_device(self, scores_dev, masks, k: int, score_bound: int,
                     view: _EngineView):
        """Device ranking: kops.sparse_topk of the survivor tiles, or
        kops.rank_topk of the dense [N, Q] buffer (``score_bound``, the
        largest per-query box count, bounds its scores); only [Q, k]
        ids/scores plus [Q] valid counts cross to the host. masks:
        per-query (pos, neg, include_training). Returns ([(ids, scores)]
        aligned with masks, host bytes transferred)."""
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
        tids_d = to_device_async(tids, self.device)
        if isinstance(scores_dev, SparseScores):
            ids_k, scores_k, n_valid = kops.sparse_topk(
                scores_dev.keys, scores_dev.vals, tids_d, k=kk)
        else:
            ids_k, scores_k, n_valid = kops.rank_topk(
                scores_dev, tids_d, k=kk, score_bound=score_bound,
                scores_transposed=True)
        # the three int32 results cross in ONE device->host copy
        m = ids_k.numel()
        host = torch.cat([ids_k.reshape(-1), scores_k.reshape(-1),
                          n_valid]).cpu().numpy()
        ids_k = host[:m].reshape(nq, -1)
        scores_k = host[m:2 * m].reshape(nq, -1)
        n_valid = host[2 * m:]
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
        together on the device (one batched fit per distinct max_depth;
        the numpy trainers one by one with use_jax_fit=False), their
        boxes flattened with a per-box owner id and grouped per subset;
        the ownership one-hot de-muxes counts per query on the device.
        When every request sets ``max_results`` the ranking runs on the
        device too. Other models, and every request of a use_fused=False
        engine, go through query() one by one.

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

        # ---- fit phase: the WHOLE window trains on the device together
        # (one batched fit per distinct max_depth); use_jax_fit=False
        # keeps the per-request numpy oracle
        t0 = time.perf_counter()
        fitted = []   # (slot, model, boxsets, pos, neg, incl, mr, t_fit)
        if self.use_jax_fit:
            # slot -> ("device", lo, hi, entries) or List[BoxSet] fallback
            boxsets_by_slot: Dict[int, object] = {}
            by_depth: Dict[int, List] = {}
            for it in to_fit:
                by_depth.setdefault(it[6], []).append(it)
            for depth, items in by_depth.items():
                try:
                    lo_c, hi_c, entries = self._fit_boxes_batched(
                        [(it[1], view.x[it[2]], view.x[it[3]], it[7], it[8])
                         for it in items], max_depth=depth,
                        return_device=True, frange=view.frange)
                except (torch.AcceleratorError, torch.OutOfMemoryError):
                    # a fault of the device itself: no per-request
                    # fallback may hide it
                    raise
                except Exception:  # noqa: BLE001 — degrade, don't die
                    entries = None  # batch-wide failure: per-request oracle
                for j, it in enumerate(items):
                    if entries is not None and not isinstance(
                            entries[j], Exception):
                        boxsets_by_slot[it[0]] = ("device", lo_c, hi_c,
                                                  entries[j])
                        continue
                    # this request failed the device fit (or the whole
                    # window did): retry it alone on the numpy oracle so
                    # one bad label set never drags the batch down
                    try:
                        boxsets_by_slot[it[0]] = self._fit_boxes(
                            it[1], view.x[it[2]], view.x[it[3]],
                            max_depth=it[6], n_models=it[7], seed=it[8],
                            use_jax=False, frange=view.frange)
                    except Exception as e:  # noqa: BLE001
                        results[it[0]] = e
            fit_wall = time.perf_counter() - t0
            # the fit is a shared device phase; bill it evenly
            share = fit_wall / max(len(boxsets_by_slot), 1)
            for it in to_fit:
                if it[0] in boxsets_by_slot:
                    fitted.append((it[0], it[1], boxsets_by_slot[it[0]],
                                   it[2], it[3], it[4], it[5], share))
        else:
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
        # the batched fit is one shared device phase: every trace in the
        # window carries the same fit span (shared-cost attribution)
        obs_trace.add_span_active("fit", t0, fit_wall,
                                  {"batch": len(to_fit)})
        if not fitted:
            return results

        # ---- ONE fused device probe per subset, ONE sync per round -----
        t0 = time.perf_counter()
        nq = len(fitted)
        # device-fit requests contribute (winner-array, row) parts and
        # never touch the host; oracle-fit (or fallback) requests
        # contribute classic BoxSets — both merge into the same jobs
        flat_parts, box_pairs = [], []
        for q, (_, _, boxes, *_r) in enumerate(fitted):
            if isinstance(boxes, tuple) and boxes[0] == "device":
                flat_parts += [(boxes[1], boxes[2], g, sid, cnt, q)
                               for g, sid, cnt in boxes[3]]
            else:
                box_pairs += [(bs, q) for bs in boxes]
        jobs, bound = [], 0
        if flat_parts:
            jobs, bound = self._make_jobs_flat(flat_parts, nq)
        if box_pairs:
            j2, b2 = self._make_jobs(box_pairs, nq)
            # a request's boxes live entirely in one form, so per-query
            # score bounds combine by max
            jobs, bound = jobs + j2, max(bound, b2)
        # shared assembly wall, same attribution rule as the fit span
        obs_trace.add_span_active("prepare", t0,
                                  time.perf_counter() - t0,
                                  {"jobs": len(jobs)})
        scores_dev, agg = self._device_scores(jobs, nq, view,
                                              deadline_s=deadline_s)

        # ---- ranking ---------------------------------------------------
        _t_rank = time.perf_counter()
        mrs = [f[6] for f in fitted]
        if all(m is not None for m in mrs):
            masks = [(pos, neg, incl)
                     for (_, _, _, pos, neg, incl, _, _) in fitted]
            ranked, hb = self._rank_device(scores_dev, masks, max(mrs),
                                           bound, view)
            agg["host_bytes_transferred"] += hb
            ranked = [(ids[:m], sc[:m]) for (ids, sc), m in zip(ranked, mrs)]
        else:
            # any full-result request forces the scores to the host ONCE;
            # truncated requests still see the device-ranking prefix
            counts = np.ascontiguousarray(
                self._scores_to_host(scores_dev, view).T)
            # sparse buffers cross as tiles: price what actually moved
            agg["host_bytes_transferred"] += (
                scores_dev.nbytes if isinstance(scores_dev, SparseScores)
                else int(counts.nbytes))
            ranked = []
            for q, (_, _, _, pos, neg, incl, m, _) in enumerate(fitted):
                ids, sc = self._rank(counts[q], pos, neg, incl)
                if m is not None:
                    ids, sc = ids[:m], sc[:m]
                ranked.append((ids, sc))
        obs_trace.add_span_active("rank", _t_rank,
                                  time.perf_counter() - _t_rank)
        t_query = time.perf_counter() - t0

        # ---- de-mux to per-request results -----------------------------
        base = {f"batch_{k}": v for k, v in agg.items()}
        base["path"] = "index"
        base["batch_size"] = nq
        base["batch_fit_s"] = fit_wall
        base["fit_path"] = "jax" if self.use_jax_fit else "numpy"
        for q, (slot, model, boxes, pos, neg, incl, m, t_fit) in enumerate(
                fitted):
            ids, sc = ranked[q]
            if isinstance(boxes, tuple) and boxes[0] == "device":
                nb = int(sum(cnt for _, _, cnt in boxes[3]))
            else:
                nb = int(sum(bs.n_boxes for bs in boxes))
            stats = {**base, "n_boxes": nb}
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
