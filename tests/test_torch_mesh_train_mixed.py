"""The port's LM training step on a mesh for the MoE, SSM and hybrid
archs (qwen3-moe with router jitter 0.5, mamba2's SSD, recurrentgemma's
RG-LRU and local attention, its embeddings tied), against its single-
device step: tests/test_torch_mesh_train.py's worlds, layouts, checks
and tolerances (its docstring), and the MoE's dispatch integers bitwise
on every rank in every layout.
"""
from __future__ import annotations

import pytest

from test_torch_mesh_train import (LAYOUTS, check_dispatch, check_flash,
                                   check_step, run_world, single_device)

ARCHS = ("qwen3-moe-235b-a22b", "mamba2-1.3b", "recurrentgemma-2b")


@pytest.fixture(scope="module")
def single():
    with pytest.MonkeyPatch.context() as mp_:
        return single_device(ARCHS, mp_)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train_mixed")
    return {w: run_world(w, {"archs": ARCHS}, tmp) for w in (4, 3)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_single_device(single, worlds, arch, layout):
    check_step(single, worlds, arch, layout)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_flash_route_on_every_rank(single, worlds, arch, layout):
    check_flash(single, worlds, arch, layout)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_moe_dispatch_is_the_single_device_one(single, worlds, layout):
    check_dispatch(single, worlds, "qwen3-moe-235b-a22b", layout)
