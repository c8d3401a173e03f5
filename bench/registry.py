"""Finding what a cell needs, by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration is ``bench/configs/<config>.json``; it names its
plain reference, ``bench/reference/<reference>.py``. The traffic mix is
``bench/traffic/<traffic>.json``; it names the job that reads it,
``bench/jobs/<job>.py``. A per-layer metric is the reader
``bench/metrics/<metric>.py``. Adding a cell, a configuration, a mix or
a metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = SPEC) -> dict:
    return json.loads(Path(path).read_text())


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in {SPEC.name}")


def cell(bm: dict, name: str) -> dict:
    return _by_name(bm["workloads"], name, "workload")


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def job(name: str) -> ModuleType:
    return importlib.import_module(f"bench.jobs.{name}")


def reference(name: str) -> ModuleType:
    return importlib.import_module(f"bench.reference.{name}")


def metric_reader(name: str) -> ModuleType:
    """``bench/metrics/<name>.py``, loaded from its path (a metric's name
    may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"no reader for the metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(bm: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics the cell reports: those without a
    ``workloads`` key, and those that list it."""
    return [m for m in bm["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(bm: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics read in the cell's traced run: those that
    list it, and those without a ``workloads`` key whose end-to-end
    metric the cell reports."""
    reported = {m["name"] for m in end_to_end(bm, cell_name)}
    return [m for m in bm["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def cell_parts(bm: dict, cell_name: str) -> Dict:
    """Everything one cell's run reads: the cell, its configuration, its
    traffic mix, the job and the reference."""
    c = cell(bm, cell_name)
    cfg = config(c["config"])
    tr = traffic(c["traffic"])
    return {"cell": c, "config": cfg, "traffic": tr, "job": job(tr["job"]),
            "reference": reference(cfg["reference"])}
