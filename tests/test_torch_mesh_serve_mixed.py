"""The port's LM serving path on a mesh for the MoE, SSM and hybrid
architectures (tests/test_torch_mesh_serve.py has the others and says
what is checked): mamba2's SSD and recurrentgemma's RG-LRU blocks run
replicated over the model axis on gathered parameters and states, their
states placed back by the cache rule; llama4's and qwen3's expert banks
split over the model axis (4 experts: one a rank at (1, 4), whole on
every rank at (1, 3)), their dispatch integers bitwise the single-device
port's on every rank. ``seq_parallel`` serves only the dense, vlm and
audio families (the reference's ``make_parallel_ctx``), so here
"ctxpar" runs head mode. Two worlds of gloo ranks, as there.
"""
from __future__ import annotations

import pytest

from test_torch_mesh_serve import (MODES, check_dispatch, check_flash,
                                   check_outputs, check_shards,
                                   run_reference, run_worlds)

ARCHS = ("mamba2-1.3b", "recurrentgemma-2b", "llama4-maverick-400b-a17b",
         "qwen3-moe-235b-a22b")
MOE = ("llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b")


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp_:
        return run_reference(ARCHS, mp_)


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    return run_worlds(reference, tmp_path_factory.mktemp("mesh_mixed"),
                      extra=False)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serve_matches_reference(reference, worlds, arch, mode):
    check_outputs(reference, worlds, arch, mode)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_shards_are_reference_shards(worlds, arch, mode):
    check_shards(worlds, arch, mode)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_flash_runs_on_each_rank_heads(worlds, arch, mode):
    check_flash(worlds, arch, mode)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", MOE)
def test_moe_dispatch_bitwise(reference, worlds, arch, mode):
    check_dispatch(reference, worlds, arch, mode)
