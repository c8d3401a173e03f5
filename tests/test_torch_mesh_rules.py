"""The port's sharding rules against the reference's, spec for spec.

``param_spec`` (``launch/sharding.py``) reads only ``mesh.shape`` and
``mesh.axis_names``, so a small stand-in mesh serves both packages in
this process: every leaf of all ten architectures' reduced parameters,
at mesh shapes (4, 2), (2, 4), (8, 1), (1, 8) and pod (2, 2, 2), in modes
fsdp_tp and zero3. The port's per-layer tensors map to the reference's
block-stacked leaves (``sharding.lm_param_specs``). ``batch_shardings``,
``cache_shardings`` and the shard shapes of the rules (zero3's joint
("pod", "data", "model") among them) are checked against the reference
run in one subprocess with 8 fake CPU devices, as
tests/test_distributed.py runs it. ``opt_shardings`` (on an
AbstractMesh), ``elastic_mesh_shape`` for n in 1..512,
``make_parallel_ctx``'s choices and ``specs.input_specs`` for every arch
x shape (meta tensors: shapes and dtypes, nothing allocated) complete the
file. No ranks are spawned.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ServeConfig, TrainConfig
from repro_torch.core.convert import lm_stacks
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import specs as tspecs
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = tuple(tconfigs.ASSIGNED_ARCHS)
MESHES = {(4, 2): ("data", "model"), (2, 4): ("data", "model"),
          (8, 1): ("data", "model"), (1, 8): ("data", "model"),
          (2, 2, 2): ("pod", "data", "model")}
MODES = ("fsdp_tp", "zero3")


def _stand_in(shape, axes):
    return SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)


def _norm(spec) -> tuple:
    """A spec as a tuple, one-axis tuples as their axis (jax prints
    ('data',) as 'data')."""
    out = []
    for s in tuple(spec):
        if isinstance(s, (tuple, list)):
            s = s[0] if len(s) == 1 else tuple(s)
        out.append(s)
    return tuple(out)


def _path(path) -> str:
    return jsharding._path_str(path)


def _ref_leaves(arch):
    cfg = jconfigs.get_reduced_config(arch)
    tree = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                  cfg))
    return cfg, {_path(p): tuple(l.shape) for p, l in
                 jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference(arch, mode):
    """Every reference leaf, every mesh shape: the port's rule gives the
    reference's spec; each port tensor's spec is its stacked leaf's with
    the stack dim dropped."""
    _, leaves = _ref_leaves(arch)
    tc = tconfigs.get_reduced_config(arch)
    model = tlm.LM(tc, device="meta")
    for shape, axes in MESHES.items():
        m = _stand_in(shape, axes)
        want = {k: _norm(jsharding.param_spec(k, s, m, mode))
                for k, s in leaves.items()}
        got = {k: _norm(tsharding.param_spec(k, s, m, mode))
               for k, s in leaves.items()}
        assert got == want, (shape, mode)
        specs = tsharding.lm_param_specs(model, tc, m, mode)
        for name, p in model.named_parameters():
            path, rshape, stacked = tsharding.reference_leaf(
                name, tuple(p.shape), tc)
            assert leaves[path] == rshape, name
            ref = want[path][1:] if stacked else want[path]
            assert _norm(specs[name]) == ref, (name, shape, mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_leaves_cover_the_port(arch):
    """reference_leaf maps the port's parameters onto the reference's
    leaves one to one (a stacked leaf from its nblocks layers), as the
    optimizer's lm_stacks groups them."""
    _, leaves = _ref_leaves(arch)
    tc = tconfigs.get_reduced_config(arch)
    named = dict(tlm.LM(tc, device="meta").named_parameters())
    seen = {}
    for name, p in named.items():
        path, _, stacked = tsharding.reference_leaf(name, tuple(p.shape), tc)
        seen.setdefault(path, []).append(name)
    assert set(seen) == set(leaves)
    stacks = lm_stacks(named, tc)
    for path, names in seen.items():
        if path.startswith("blocks/"):
            assert stacks[path.replace("/", ".")] == names


def test_parallel_ctx_fields_are_the_references_read_ones():
    """The port's ParallelCtx has the reference's fields but the two no
    layer of either package reads (moe_impl, moe_chunk_tokens), plus its
    collective counter."""
    import dataclasses
    from repro.models.common import ParallelCtx as JCtx
    from repro_torch.models.common import ParallelCtx as TCtx
    names = lambda c: {f.name for f in dataclasses.fields(c)}
    assert names(TCtx) == names(JCtx) - {"moe_impl", "moe_chunk_tokens"} \
        | {"comm"}
    with pytest.raises(TypeError):
        TCtx(moe_impl="a2a_ep")


def test_elastic_mesh_shape_matches_reference():
    for m in (1, 2, 4, 8, 16):
        for n in range(1, 513):
            assert tmesh.elastic_mesh_shape(n, m) == \
                jmesh.elastic_mesh_shape(n, m), (n, m)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_parallel_ctx_matches_reference(arch):
    """The context's fields and the attention mode for the reference's
    branch order (zero3 on a mesh, seq_parallel by family, head when the
    heads divide the model axis, else qseq)."""
    jc = jconfigs.get_reduced_config(arch)
    tc = tconfigs.get_reduced_config(arch)
    for shape, axes in MESHES.items():
        jm = _stand_in(shape, axes)
        tm = SimpleNamespace(mesh_dim_names=axes, size=lambda i, s=shape:
                             s[i])
        for kw in ({"sv": (JServeConfig(), ServeConfig())},
                   {"sv": (JServeConfig(seq_parallel=True),
                           ServeConfig(seq_parallel=True))},
                   {"sv": (JServeConfig(decode_seq_parallel=False),
                           ServeConfig(decode_seq_parallel=False))},
                   {"tc": (JTrainConfig(sharding_mode="zero3"),
                           TrainConfig(sharding_mode="zero3"))},
                   {"tc": (JTrainConfig(sequence_parallel=True),
                           TrainConfig(sequence_parallel=True))}):
            (k, (jv, tv)), = kw.items()
            want = jsteps.make_parallel_ctx(jm, cfg=jc, **{k: jv})
            got = tsteps.make_parallel_ctx(tm, cfg=tc, **{k: tv})
            for f in ("dp_axes", "tp_axis", "sequence_parallel",
                      "decode_seq_parallel", "seq_shard_acts"):
                assert getattr(got, f) == getattr(want, f), (f, shape, kw)
            assert got.seq_axis == want.seq_axis
            if got.tp_axis is not None:
                assert got.tp_degree == want.tp_degree
                assert tlm.attn_parallel_mode(tc, got) == \
                    jlm.attn_parallel_mode(jc, want)
    assert tsteps.make_parallel_ctx(None).mesh is None
    assert tlm.attn_parallel_mode(tc, tsteps.make_parallel_ctx(None)) == \
        jlm.attn_parallel_mode(jc, jsteps.make_parallel_ctx(None)) == "none"


def _same_meta(got: torch.Tensor, want) -> None:
    assert got.device.type == "meta"
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_shardings_match_reference(arch):
    """AdamW's moments mirror their parameters' specs (the fsdp_tp rule),
    the step replicates — the reference's opt_shardings on its stacked
    moments, the stack dim dropped."""
    from jax.sharding import AbstractMesh
    from repro_torch.train.optimizer import AdamWState
    jc = jconfigs.get_reduced_config(arch)
    tc = tconfigs.get_reduced_config(arch)
    params = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    jc))
    jopt = jsteps.make_optimizer(JTrainConfig())
    jstate = jax.eval_shape(jopt.init, params)
    meta = dict(tlm.LM(tc, device="meta").named_parameters())
    state = AdamWState(meta, meta, 0)
    for shape, axes in MESHES.items():
        want = jsharding.opt_shardings(jstate, params,
                                       AbstractMesh(shape, axes))
        got = tsharding.opt_shardings(state, tc, _stand_in(shape, axes))
        assert got.step.spec == () and _norm(want.step.spec) == ()
        for part in ("m", "v"):
            leaves = {_path(p): sh.spec for p, sh in
                      jax.tree_util.tree_leaves_with_path(
                          getattr(want, part), is_leaf=lambda x: hasattr(
                              x, "spec"))}
            for name, sh in getattr(got, part).items():
                path, _, stacked = tsharding.reference_leaf(
                    name, tuple(meta[name].shape), tc)
                w = _norm(leaves[path])
                assert _norm(sh.spec) == (w[1:] if stacked else w), \
                    (name, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Every shape cell: the meta-device params (per layer, stacked as the
    reference's leaves), the batch, the prefill args and the decode
    caches / token / position carry the reference's shapes and dtypes."""
    for shape in JSHAPES:
        want = jspecs.input_specs(arch, shape.name)
        got = tspecs.input_specs(arch, shape.name)
        assert got["model"].name == want["model"].name
        assert got["shape"].name == want["shape"].name
        leaves = {_path(p): l for p, l in
                  jax.tree_util.tree_leaves_with_path(want["params"])}
        cfg = got["model"]
        stacked = {}
        for name, p in got["params"].named_parameters():
            path, rshape, _ = tsharding.reference_leaf(name, tuple(p.shape),
                                                      cfg)
            assert tuple(leaves[path].shape) == rshape, name
            assert str(p.dtype).replace("torch.", "") == \
                str(leaves[path].dtype), name
            assert p.device.type == "meta"
            stacked[path] = True
        assert set(stacked) == set(leaves)
        if shape.kind == "train":
            for k in ("inputs", "targets"):
                _same_meta(got["batch"][k], want["batch"][k])
        elif shape.kind == "prefill":
            _same_meta(got["args"][0], want["args"][0])
        else:
            caches, token, pos = got["args"]
            jcaches, jtoken, jpos = want["args"]
            _same_meta(token, jtoken)
            _same_meta(pos, jpos)
            pattern, nblocks, tail = cfg.scan_pattern()
            n = len(pattern)
            for i, c in enumerate(caches):
                ref = (jcaches["blocks"][f"slot{i % n}"] if i < nblocks * n
                       else jcaches["tail"][f"layer{i - nblocks * n}"])
                leaves_t = c._asdict() if isinstance(c, tuple) else c
                leaves_r = ref._asdict() if isinstance(ref, tuple) else ref
                for k, t in leaves_t.items():
                    r = leaves_r[k]
                    rs = tuple(r.shape)[1:] if i < nblocks * n else \
                        tuple(r.shape)
                    assert tuple(t.shape) == rs, (i, k)
                    assert t.device.type == "meta"
                    assert str(t.dtype).replace("torch.", "") == \
                        str(r.dtype)


# ----------------------------------------------------------------------
# against the reference on 8 fake devices
# ----------------------------------------------------------------------

BATCHES = {"b8": (8, 32), "b2": (2, 32), "b1": (1, 32), "b6": (6, 32)}
CACHE_LENS = (36, 40)


def _reference_shardings() -> dict:
    """The reference's batch_shardings / cache_shardings specs and its
    NamedSharding shard shapes of every param spec, on real meshes of 8
    fake CPU devices, in one subprocess."""
    prog = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import json
        import jax
        import jax.numpy as jnp
        import numpy as np
        assert len(jax.devices()) == 8
        from jax.sharding import NamedSharding
        from repro import configs
        from repro.launch import sharding as shd
        from repro.models import lm
        MESHES = %s
        BATCHES = %s
        LENS = %s
        ARCHS = %s
        def spec(s):
            return [list(a) if isinstance(a, tuple) else a for a in s]
        out = {"batch": {}, "cache": {}, "shard": {}}
        for key, axes in MESHES:
            mesh = jax.make_mesh(tuple(key), tuple(axes))
            mk = "x".join(map(str, key))
            for mode in ("fsdp_tp", "zero3"):
                b = {k: jax.ShapeDtypeStruct(tuple(v), jnp.int32)
                     for k, v in BATCHES.items()}
                out["batch"][mk + "/" + mode] = {
                    k: spec(s.spec) for k, s in
                    shd.batch_shardings(b, mesh, mode).items()}
            for arch in ARCHS:
                cfg = configs.get_reduced_config(arch)
                for n in LENS:
                    for sp in (True, False):
                        c = jax.eval_shape(lambda: lm.init_caches(cfg, 2, n))
                        sh = shd.cache_shardings(c, cfg, mesh, sp)
                        out["cache"]["/".join([mk, arch, str(n), str(sp)])] = [
                            [shd._path_str(p), spec(s.spec)] for p, s in
                            jax.tree_util.tree_leaves_with_path(
                                sh, is_leaf=lambda x: isinstance(
                                    x, NamedSharding))]
                params = jax.eval_shape(
                    lambda: lm.init_params(jax.random.PRNGKey(0), cfg))
                for mode in ("fsdp_tp", "zero3"):
                    sh = shd.params_shardings(params, mesh, mode)
                    out["shard"]["/".join([mk, arch, mode])] = [
                        [shd._path_str(p), list(s.shard_shape(l.shape))]
                        for (p, s), l in zip(
                            jax.tree_util.tree_leaves_with_path(
                                sh, is_leaf=lambda x: isinstance(
                                    x, NamedSharding)),
                            jax.tree_util.tree_leaves(params))]
        print("RESULT:" + json.dumps(out))
    """) % (json.dumps([[list(k), list(v)] for k, v in MESHES.items()]),
            json.dumps(BATCHES), json.dumps(CACHE_LENS), json.dumps(ARCHS))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
    for line in out.stdout.splitlines():
        if line.startswith("RESULT:"):
            return json.loads(line[len("RESULT:"):])
    raise AssertionError(f"no RESULT line in stdout:\n{out.stdout[-2000:]}")


@pytest.fixture(scope="module")
def reference():
    return _reference_shardings()


def _mk(shape) -> str:
    return "x".join(map(str, shape))


def _jnorm(spec) -> tuple:
    return _norm(tuple(tuple(s) if isinstance(s, list) else s
                       for s in spec))


@pytest.mark.parametrize("mode", MODES)
def test_batch_shardings_match_reference(reference, mode):
    for shape, axes in MESHES.items():
        m = _stand_in(shape, axes)
        batch = {k: torch.empty(v, device="meta")
                 for k, v in BATCHES.items()}
        got = tsharding.batch_shardings(batch, m, mode)
        want = reference["batch"][f"{_mk(shape)}/{mode}"]
        for k in BATCHES:
            assert _norm(got[k].spec) == _jnorm(want[k]), (shape, mode, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(reference, arch):
    """The port's per-layer caches (meta) against the reference's stacked
    tree: each layer's leaf spec is its stacked leaf's without the stack
    dim, at both cache lengths, with and without seq_parallel."""
    tc = tconfigs.get_reduced_config(arch)
    pattern, nblocks, tail = tc.scan_pattern()
    n = len(pattern)
    for shape, axes in MESHES.items():
        m = _stand_in(shape, axes)
        for length in CACHE_LENS:
            caches = tlm.init_caches(tc, 2, length, device="meta")
            for sp in (True, False):
                want = dict((p, s) for p, s in reference["cache"][
                    "/".join([_mk(shape), arch, str(length), str(sp)])])
                got = tsharding.cache_shardings(caches, tc, m, sp)
                assert len(got) == tc.num_layers
                for i, c in enumerate(got):
                    leaves = c._asdict() if isinstance(c, tuple) else c
                    where = (f"blocks/slot{i % n}" if i < nblocks * n
                             else f"tail/layer{i - nblocks * n}")
                    for k, sh in leaves.items():
                        w = _jnorm(want[f"{where}/{k}"])
                        if i < nblocks * n:
                            assert w[0] is None
                            w = w[1:]
                        assert _norm(sh.spec) == w, (shape, length, sp, i, k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_match_reference(reference, arch, mode):
    """Every parameter's shard shape (joint zero3 sharding included): the
    port's NamedSharding on its per-layer tensor, at every mesh position,
    equals the reference's shard of the stacked leaf without the stack
    dim."""
    tc = tconfigs.get_reduced_config(arch)
    model = tlm.LM(tc, device="meta")
    for shape, axes in MESHES.items():
        m = _stand_in(shape, axes)
        want = dict((p, s) for p, s in reference["shard"][
            "/".join([_mk(shape), arch, mode])])
        shardings = tsharding.params_shardings(model, tc, m, mode)
        coords = np.stack(np.meshgrid(*[range(k) for k in shape],
                                      indexing="ij"), -1).reshape(-1,
                                                                 len(shape))
        for name, p in model.named_parameters():
            path, _, stacked = tsharding.reference_leaf(name, tuple(p.shape),
                                                       tc)
            w = tuple(want[path][1:] if stacked else want[path])
            sh = shardings[name]
            assert sh.shard_shape(tuple(p.shape)) == w, (name, shape, mode)
            for c in coords:
                sl = sh.shard_slices(tuple(p.shape), dict(zip(axes, c)))
                assert tuple(s.stop - s.start for s in sl) == w
