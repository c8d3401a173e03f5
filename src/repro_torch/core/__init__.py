"""Core of the port: decision branches + index co-design and the search
engine around them. Exports the counterparts of ``repro.core``'s names;
its device trainers ``fit_dbranch_jax`` / ``fit_select_jax`` /
``predict_boxes_jax`` are ``fit_dbranch_dev`` / ``fit_select`` /
``predict_boxes`` here."""
from repro_torch.core.boxes import BoxSet, boxes_contain, merge_boxsets
from repro_torch.core.dbranch import (dbens_draws, fit_dbens, fit_dbranch,
                                      fit_dbranch_best_subset,
                                      fit_dbranch_dev, fit_select,
                                      predict_boxes)
from repro_torch.core.engine import MODELS, QueryResult, SearchEngine
from repro_torch.core.index import (ZoneMapIndex, build_index,
                                    distributed_query, full_scan,
                                    query_index)
from repro_torch.core.kdtree import KDTree, build_kdtree, range_query
from repro_torch.core.subsets import make_subsets
from repro_torch.core.trees import (DecisionTree, RandomForest,
                                    fit_decision_tree, fit_random_forest)

__all__ = [
    "BoxSet", "DecisionTree", "KDTree", "MODELS", "QueryResult",
    "RandomForest", "SearchEngine", "ZoneMapIndex", "boxes_contain",
    "build_index", "build_kdtree", "dbens_draws", "distributed_query",
    "fit_dbens", "fit_dbranch", "fit_dbranch_best_subset", "fit_dbranch_dev",
    "fit_decision_tree", "fit_random_forest", "fit_select", "full_scan",
    "make_subsets", "merge_boxsets", "predict_boxes", "query_index",
    "range_query",
]
