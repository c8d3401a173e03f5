"""The benchmark's files: every cell, configuration, traffic mix, job,
reference and per-layer metric is found by its name, and
``BENCHMARK.json`` keeps to the form the harness and its checker read."""
from __future__ import annotations

import json
import re

import pytest

from bench import registry

BM = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BM["workloads"]]
PER_LAYER = [m["name"] for m in BM["per_layer"]]


def test_top_level_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["paths"] == ["bench"]
    assert BM["command"][1] == "bench/run.py"
    assert 1 <= BM["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    parts = registry.cell_parts(BM, cell)
    assert parts["cell"]["name"] == cell
    assert hasattr(parts["job"], "run") and hasattr(parts["job"], "controls")
    assert parts["traffic"]["job"] == parts["job"].__name__.split(".")[-1]
    want = {"feature_gap"} if parts["traffic"]["job"] == "embed" \
        else {"loss_gap", "grad_gap", "change_gap"}
    assert parts["traffic"]["limits"]
    assert set(parts["traffic"]["limits"]) <= want
    assert all(v > 0 for v in parts["traffic"]["limits"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_per_layer(cell):
    e2e = {m["name"] for m in registry.end_to_end(BM, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per = registry.per_layer(BM, cell)
    assert per and all(m["moves"] in e2e for m in per)


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_reader_matches_its_entry(name):
    entry = next(m for m in BM["per_layer"] if m["name"] == name)
    mod = registry.metric_reader(name)
    assert callable(mod.read)
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["unit"], entry["layer"], entry["moves"])


def test_names_units_and_whys():
    names = ([c["name"] for c in BM["configs"]] + CELLS
             + [m["name"] for m in BM["end_to_end"] + BM["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BM["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for x in BM["configs"] + BM["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    pairs = {(w["config"], w["traffic"]) for w in BM["workloads"]}
    assert len(pairs) == len(CELLS)


@pytest.mark.parametrize("entry", BM["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    cfg = json.loads((registry.ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("bench/configs/")
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert registry.reference(cfg["reference"])


def test_config_fields_are_the_ports():
    """Every key a job hands the port's ModelConfig is one of its
    fields."""
    import dataclasses
    from repro_torch.configs.base import ModelConfig
    from bench.jobs import embed, train
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    assert set(embed.MODEL_KEYS) <= fields
    assert set(train.MODEL_KEYS) <= fields


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        registry.cell(BM, "no_such_cell")
    with pytest.raises(FileNotFoundError):
        registry.traffic("no_such_mix")
