"""The controls against each cell's limits, at a size a CPU test holds:
the reference in the program's place, computed in the precision below
the configuration's (TF32 products for the ViT's float32, fp8 for the
LM's bf16), has to come out not correct, by the same ``harness.checks``
and ``harness.correct`` that decide a benchmark run's ``correct``. On
the card the same ``controls`` ran at each cell's own size
(``bench/calibrate.py``, which prints that verdict beside them)."""
from __future__ import annotations

import pytest

from bench import harness

from conftest import tiny_ctx


def verdict(ctx, readings: dict) -> bool:
    return harness.correct(harness.checks(ctx.traffic, readings), 0)


@pytest.mark.parametrize("cell", ["vit_t.embed_400", "internlm2.train_4k",
                                  "internlm2.train_32k"])
def test_control_fails_a_limit(cell):
    _, parts, ctx = tiny_ctx(cell)
    readings = parts["job"].controls(ctx)
    control = readings["tf32" if cell.startswith("vit") else "fp8"]
    assert verdict(ctx, control) is False, (control,
                                            ctx.traffic["limits"])


def test_half_batch_reading_fails_a_limit():
    _, parts, ctx = tiny_ctx("internlm2.train_4k")
    g = parts["job"].controls(ctx)["half_batch"]
    assert verdict(ctx, g) is False, (g, ctx.traffic["limits"])


@pytest.mark.parametrize("readings,failed,want", [
    ({"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-4}, 0, True),
    ({"loss_gap": 1e-5, "grad_gap": 1.0, "change_gap": 1e-4}, 0, False),
    ({"loss_gap": float("nan"), "grad_gap": 1e-3, "change_gap": 1e-4}, 0,
     False),
    ({"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-4}, 1, False),
    ({"not_a_limit": 1.0}, 0, False),
])
def test_correct_needs_every_compared_number_within_its_limit(
        readings, failed, want):
    _, _, ctx = tiny_ctx("internlm2.train_4k")
    found = harness.checks(ctx.traffic, readings)
    assert {c.name for c in found} <= set(ctx.traffic["limits"])
    assert harness.correct(found, failed) is want
