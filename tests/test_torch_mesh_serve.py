"""The port's LM serving path on a mesh against the reference's single-
device outputs (what GSPMD promises the reference's mesh gives).

Ranks are processes on the CPU (gloo, ``spawn``, a ``FileStore`` under
``tmp_path``, one thread each), at most 4, so the 6 tier-1 test workers
keep their cores. Each file spawns two worlds: 4 ranks for ``head`` on
(1, 4), ``ctxpar`` on (1, 4) with ``ServeConfig(seq_parallel=True)`` and
data x model on (2, 2) (batch 2), and 3 ranks for ``qseq`` (4 heads on a
model axis of 3). Every rank runs ``make_prefill_step``, ``pad_caches``,
4 ``make_decode_step`` steps and ``lm_feature_fn`` on the reduced f32
configs, the parameters placed by ``lm_from_numpy(..., mesh=)``, with
``FLASH_THRESHOLD`` 16 in both packages so a 32-token prefill takes the
flash branch. Checked: the gathered logits and the features against the
reference's within 1e-4 of their max; each rank's parameter and cache
shards (and ``init_caches(..., ctx=)``'s) of the reference's shard
shapes (its ``param_spec`` and ``cache_shardings``); the flash kernel's
route (its plain version here)
once a layer on every rank in ``head``, never in qseq / ctxpar; the MoE
dispatch's integers bitwise the single-device port's (which
tests/test_torch_lm_moe.py holds bitwise to the reference's).
``flash_attention_kvscan`` on each rank's rows and ``decode_attention``
over a cache sharded along the sequence against the reference's
functions within 1e-5, ``simulate_failure_and_restart`` from a (4, 1)
world to 2 survivors keeping every leaf exactly, and the mesh
constructors over the world. This file holds the
dense, vlm and audio archs; tests/test_torch_mesh_serve_mixed.py the MoE,
SSM and hybrid ones.
"""
from __future__ import annotations

import queue
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.configs.base import ServeConfig as JServeConfig
from repro.features import extract as jextract
from repro.launch import sharding as jsharding
from repro.models import attention as jattention
from repro.models import lm as jlm
from repro.models.common import ParallelCtx
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ServeConfig
from repro_torch.core.convert import lm_from_numpy
from repro_torch.launch import sharding as tsharding
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models.common import gather_placed

ARCHS = ("granite-20b", "nemotron-4-15b", "internlm2-1.8b", "llama3-8b",
         "llava-next-mistral-7b", "musicgen-medium")
B, S, T = 2, 32, 4                 # batch, prompt, decode steps
FLASH_AT = 16
# mode -> (mesh shape, seq_parallel, world)
MODES = {"head": ((1, 4), False, 4), "ctxpar": ((1, 4), True, 4),
         "data_model": ((2, 2), False, 4), "qseq": ((1, 3), False, 3)}
TOL = 1e-4
KV_TOL = 1e-5
JOIN_S = 300
CTX = ParallelCtx()
JSV = JServeConfig(cache_dtype="float32")


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return rng.normal(0, 1, (B, S + T, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)


def _close(got, want, rel=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(1.0, float(np.abs(want).max())), err


def _dispatch_recorder(moe_mod, store: list):
    """Wraps ``moe_mod._dispatch_group`` to append each dispatch's
    integers (expert_idx, sorted_token, safe_rank, keep) to ``store``."""
    raw = moe_mod._dispatch_group

    def rec(*a, **kw):
        d = raw(*a, **kw)
        store.append(tuple(t.numpy().copy() for t in (
            d.expert_idx, d.sorted_token, d.safe_rank, d.keep)))
        return d
    moe_mod._dispatch_group = rec
    return raw


def run_reference(archs, monkeypatch_ctx) -> dict:
    """The reference's single-device outputs (jitted; flash branch at 16)
    and the single-device port's MoE dispatch integers, per arch."""
    from repro_torch.models import moe as tmoe
    monkeypatch_ctx.setattr(jlm, "FLASH_THRESHOLD", FLASH_AT)
    monkeypatch_ctx.setattr(tlm, "FLASH_THRESHOLD", FLASH_AT)
    out = {}
    for arch in archs:
        jc = jconfigs.get_reduced_config(arch)
        tc = tconfigs.get_reduced_config(arch)
        params = jlm.init_params(jax.random.PRNGKey(0), jc)
        pnp = jax.tree_util.tree_map(np.asarray, params)
        x = _inputs(jc)
        pre = jax.jit(lambda p, a: jlm.prefill(p, a, jc, CTX, JSV))
        dec = jax.jit(lambda p, c, a, s: jlm.decode_step(p, c, a, s, jc,
                                                         CTX, JSV))
        logits, caches = pre(params, jnp.asarray(x[:, :S]))
        want = {"prefill": np.asarray(logits), "decode": []}
        caches = jlm.pad_caches(caches, jc, S + T)
        for t in range(S, S + T):
            lg, caches = dec(params, caches, jnp.asarray(x[:, t:t + 1]),
                             jnp.asarray(t))
            want["decode"].append(np.asarray(lg))
        want["features"] = np.asarray(jax.jit(jextract.lm_feature_fn(
            jc, CTX))(params, jnp.asarray(x[:, :S])))
        dispatch = []
        if tc.num_experts:
            raw = _dispatch_recorder(tmoe, dispatch)
            try:
                sv = ServeConfig(cache_dtype="float32")
                model = lm_from_numpy(pnp, tc, device="cpu")
                _, c = tlm.prefill(model, x[:, :S], sv)
                c = tlm.pad_caches(c, tc, S + T)
                for t in range(S, S + T):
                    _, c = tlm.decode_step(model, c, x[:, t:t + 1], t, sv)
            finally:
                tmoe._dispatch_group = raw
        out[arch] = {"params": pnp, "x": x, "want": want,
                     "dispatch": dispatch}
    return out


# ----------------------------------------------------------------------
# the ranks
# ----------------------------------------------------------------------

def _local_shapes(tree) -> dict:
    """{leaf: local shape} of a per-layer cache list (DTensor leaves)."""
    out = {}
    for i, c in enumerate(tree):
        leaves = c._asdict() if isinstance(c, tuple) else c
        for k, t in leaves.items():
            out[f"layers.{i}.{k}"] = tuple(t.to_local().shape)
    return out


def _serve_on(mesh, seq_parallel, arch, job, counts):
    """One arch's serving path on ``mesh``: (rank 0's gathered outputs,
    this rank's shard shapes, its dispatch integers, its flash calls)."""
    from repro_torch.features.extract import lm_feature_fn
    from repro_torch.models import moe as tmoe
    tc = tconfigs.get_reduced_config(arch)
    sv = ServeConfig(cache_dtype="float32", seq_parallel=seq_parallel)
    model = lm_from_numpy(job["params"], tc, device="cpu", mesh=mesh)
    prefill = tsteps.make_prefill_step(tc, sv, mesh)
    decode = tsteps.make_decode_step(tc, sv, mesh)
    x = job["x"]
    dispatch = []
    raw = _dispatch_recorder(tmoe, dispatch)
    try:
        counts["flash"] = 0
        logits, caches = prefill(model, x[:, :S])
        flash = counts["flash"]
        shapes = {"params": {k: tuple(p.to_local().shape)
                             for k, p in model.named_parameters()},
                  "prefill_caches": _local_shapes(caches)}
        caches = tlm.pad_caches(caches, tc, S + T, prefill.ctx)
        shapes["caches"] = _local_shapes(caches)
        shapes["init_caches"] = _local_shapes(tlm.init_caches(
            tc, B, S + T, sv, device="cpu", ctx=prefill.ctx))
        got = {"prefill": gather_placed(logits).numpy(), "decode": []}
        for t in range(S, S + T):
            lg, caches = decode(model, caches, x[:, t:t + 1], t)
            got["decode"].append(gather_placed(lg).numpy())
    finally:
        tmoe._dispatch_group = raw
    got["features"] = lm_feature_fn(model, prefill.ctx)(
        torch.from_numpy(x[:, :S])).numpy()
    got["mode"] = tlm.attn_parallel_mode(tc, prefill.ctx)
    return got, shapes, dispatch, flash


def _functions_on(mesh, kv) -> dict:
    """flash_attention_kvscan on this rank's query rows and the
    sequence-sharded decode_attention, gathered whole."""
    from repro_torch.models import attention as tattention
    from repro_torch.models.common import all_gather, rows
    ctx = tsteps.make_parallel_ctx(mesh)
    q, k, v = (torch.from_numpy(a) for a in kv["qkv"])
    lo, hi = rows(ctx, q.shape[1], "model")
    part = tattention.flash_attention_kvscan(
        q[:, lo:hi], k, v, causal=True, kv_chunk=kv["kv_chunk"],
        q_offset=lo)
    scan = all_gather(part, ctx, "model", 1, q.shape[1]).numpy()
    dq, dk, dv = (torch.from_numpy(a) for a in kv["decode"])
    lo, hi = rows(ctx, dk.shape[1], "model")
    dec = tattention.decode_attention(dq, dk[:, lo:hi], dv[:, lo:hi],
                                      kv["pos"], ctx=ctx, seq_offset=lo)
    return {"kvscan": scan, "decode": dec.numpy(),
            "comm": ctx.comm.snapshot()}


def _elastic_on(world_mesh_of, job) -> dict:
    """A (4, 1) placement of internlm2's parameters resharded onto 2
    survivors; the survivors gather every leaf back whole."""
    from repro_torch.train.elastic import simulate_failure_and_restart
    tc = tconfigs.get_reduced_config("internlm2-1.8b")
    old = world_mesh_of((4, 1), ("data", "model"), "cpu")
    model = lm_from_numpy(job["params"], tc, device="cpu", mesh=old)
    state = dict(model.named_parameters())
    shapes = [(k, p.shape) for k, p in state.items()]
    new_mesh, new = simulate_failure_and_restart(
        state, lambda m: tsharding.params_shardings(shapes, tc, m),
        old_mesh=old, surviving_devices=2, model_axis=1)
    out = {"new_shape": tuple(new_mesh.shape),
           "on_mesh": new_mesh.get_coordinate() is not None}
    if out["on_mesh"]:
        out["leaves"] = {k: gather_placed(t).numpy() for k, t in new.items()}
    else:
        out["leaves"] = {k: t for k, t in new.items() if t is not None}
    return out


def _constructors_on(tmesh) -> dict:
    """make_mesh / make_host_mesh over the world, the production mesh's
    refusal of a world of 4."""
    from repro_torch.configs.base import MeshConfig
    out = {"make_mesh": tuple(tmesh.make_mesh(
               MeshConfig(shape=(2, 2), axes=("data", "model")), "cpu").shape),
           "host": tuple(tmesh.make_host_mesh(2, "cpu").shape),
           "host_names": tmesh.make_host_mesh(1, "cpu").mesh_dim_names}
    for name, fn in (("production", lambda: tmesh.make_production_mesh(
                          device_type="cpu")),
                     ("host_3", lambda: tmesh.make_host_mesh(3, "cpu"))):
        try:
            fn()
            out[name] = "built"
        except ValueError as e:
            out[name] = str(e)
    return out


def _rank_main(rank, world, init_file, jobs_file, q):
    """One rank: every (mode, arch) job of its world (read from
    ``jobs_file``), then the extra checks; puts (rank, result or a
    traceback) on ``q``."""
    import pickle

    import torch.distributed as dist
    from repro_torch.kernels import ops as tops
    from repro_torch.launch import mesh as tmesh
    torch.set_num_threads(1)
    try:
        with open(jobs_file, "rb") as f:
            jobs = pickle.load(f)
        tmesh.init_process_group("gloo", rank=rank, world_size=world,
                                 init_method=f"file://{init_file}")
        tlm.FLASH_THRESHOLD = FLASH_AT
        counts = {"flash": 0}
        raw_flash = tops.flash_attention

        def counted(*a, **kw):
            counts["flash"] += 1
            return raw_flash(*a, **kw)
        tops.flash_attention = counted
        res = {"serve": {}, "shapes": {}, "dispatch": {}, "flash": {}}
        meshes = {}
        for mode, (shape, seqp, w) in MODES.items():
            if w != world:
                continue
            if shape not in meshes:
                meshes[shape] = tmesh.mesh_of(shape, ("data", "model"),
                                              "cpu")
            for arch, job in jobs["archs"].items():
                got, shapes, disp, flash = _serve_on(
                    meshes[shape], seqp, arch, job, counts)
                if rank == 0:
                    res["serve"][(arch, mode)] = got
                res["shapes"][(arch, mode)] = shapes
                res["dispatch"][(arch, mode)] = disp
                res["flash"][(arch, mode)] = flash
        if jobs.get("kv") is not None:
            mesh = meshes.get((1, world)) or tmesh.mesh_of(
                (1, world), ("data", "model"), "cpu")
            res["functions"] = _functions_on(mesh, jobs["kv"])
        if jobs.get("elastic") is not None and world == 4:
            res["elastic"] = _elastic_on(tmesh.mesh_of, jobs["elastic"])
            res["constructors"] = _constructors_on(tmesh)
        q.put((rank, res))
    except Exception:
        q.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(world: int, jobs: dict, tmp_path) -> dict:
    """Spawn ``world`` ranks on ``jobs``; {rank: result}. Every rank is
    joined under a timeout, and any failure raises. The jobs go through a
    file, so that starting a rank never waits on another's imports."""
    import pickle
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = tmp_path / f"store_{world}"
    jobs_file = tmp_path / f"jobs_{world}.pkl"
    with open(jobs_file, "wb") as f:
        pickle.dump(jobs, f)
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(init),
                                                  str(jobs_file), q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, res = q.get(timeout=JOIN_S)
            results[rank] = res
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    bad = {r: v for r, v in results.items() if isinstance(v, str)}
    assert not bad, "\n".join(bad.values())
    assert len(results) == world, f"ranks answered: {sorted(results)}"
    assert all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return results


def function_inputs(seed=1) -> dict:
    """q / k / v [2, 64, 4 / 2, 16] for kvscan (kv chunks of 16), and a
    decode query against a 40-slot cache valid to 29."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return {"qkv": (f(2, 64, 4, 16), f(2, 64, 2, 16), f(2, 64, 2, 16)),
            "kv_chunk": 16,
            "decode": (f(2, 1, 4, 16), f(2, 40, 2, 16), f(2, 40, 2, 16)),
            "pos": 29}


def run_worlds(reference: dict, tmp_path, extra: bool) -> dict:
    jobs = {"archs": {a: {"params": r["params"], "x": r["x"]}
                      for a, r in reference.items()}}
    if extra:
        jobs["kv"] = function_inputs()
        jobs["elastic"] = {"params": reference["internlm2-1.8b"]["params"]}
    return {w: run_world(w, jobs, tmp_path) for w in (4, 3)}


# ----------------------------------------------------------------------
# what the ranks must hold: the reference's shard shapes
# ----------------------------------------------------------------------

def _shard(shape, spec, sizes) -> tuple:
    out = []
    for n, s in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if s is None else (s if isinstance(s, tuple) else (s,))
        for a in axes:
            n //= sizes[a]
        out.append(n)
    return tuple(out)


def reference_param_shards(arch, mesh_shape) -> dict:
    """{port parameter name: the reference's shard shape of its stacked
    leaf (param_spec, fsdp_tp), the stack dim dropped}."""
    from types import SimpleNamespace
    tc = tconfigs.get_reduced_config(arch)
    sizes = dict(zip(("data", "model"), mesh_shape))
    stand_in = SimpleNamespace(shape=sizes, axis_names=("data", "model"))
    out = {}
    for name, p in tlm.LM(tc, device="meta").named_parameters():
        path, rshape, stacked = tsharding.reference_leaf(name,
                                                         tuple(p.shape), tc)
        sh = _shard(rshape, jsharding.param_spec(path, rshape, stand_in),
                    sizes)
        out[name] = sh[1:] if stacked else sh
    return out


def reference_cache_shards(arch, mesh_shape, length) -> dict:
    """{layers.<i>.<leaf>: the reference's cache_shardings shard shape}
    of a batch-B cache of ``length`` (on an AbstractMesh)."""
    jc = jconfigs.get_reduced_config(arch)
    mesh = AbstractMesh(tuple(mesh_shape), ("data", "model"))
    caches = jax.eval_shape(lambda: jlm.init_caches(jc, B, length))
    sh = jsharding.cache_shardings(caches, jc, mesh)
    pattern, nblocks, tail = jc.scan_pattern()
    n = len(pattern)
    out = {}
    for i in range(jc.num_layers):
        stacked = i < nblocks * n
        where = (caches["blocks"][f"slot{i % n}"], sh["blocks"][f"slot{i % n}"]
                 ) if stacked else (caches["tail"][f"layer{i - nblocks * n}"],
                                    sh["tail"][f"layer{i - nblocks * n}"])
        leaves = where[0]._asdict() if isinstance(where[0], tuple) \
            else where[0]
        shs = where[1]._asdict() if isinstance(where[1], tuple) else where[1]
        for k, leaf in leaves.items():
            s = tuple(shs[k].shard_shape(leaf.shape))
            out[f"layers.{i}.{k}"] = s[1:] if stacked else s
    return out


# ----------------------------------------------------------------------
# fixtures and checks, shared with test_torch_mesh_serve_mixed.py
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp_:
        return run_reference(ARCHS, mp_)


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    return run_worlds(reference, tmp_path_factory.mktemp("mesh_serve"),
                      extra=True)


def _result(worlds, mode, rank=0):
    return worlds[MODES[mode][2]][rank]


def check_outputs(reference, worlds, arch, mode):
    got = _result(worlds, mode)["serve"][(arch, mode)]
    want = reference[arch]["want"]
    tc = tconfigs.get_reduced_config(arch)
    jmode = "ctxpar" if mode == "ctxpar" and tc.family in (
        "dense", "vlm", "audio") else (
        "qseq" if mode == "qseq" and tc.num_heads % 3 else "head")
    assert got["mode"] == jmode
    _close(got["prefill"], want["prefill"])
    assert len(got["decode"]) == T
    for g, w in zip(got["decode"], want["decode"]):
        _close(g, w)
    _close(got["features"], want["features"])


def check_shards(worlds, arch, mode):
    shape, _, world = MODES[mode]
    params = reference_param_shards(arch, shape)
    prefill = reference_cache_shards(arch, shape, S)
    caches = reference_cache_shards(arch, shape, S + T)
    for rank in range(world):
        got = worlds[world][rank]["shapes"][(arch, mode)]
        assert got["params"] == params, rank
        assert got["prefill_caches"] == prefill, rank
        assert got["caches"] == caches, rank
        assert got["init_caches"] == caches, rank


def check_flash(worlds, arch, mode):
    """The flash route once an attention layer (AD / AM) a prefill on
    every rank in head mode, never under qseq / ctxpar (kvscan)."""
    tc = tconfigs.get_reduced_config(arch)
    world = MODES[mode][2]
    mode_used = worlds[world][0]["serve"][(arch, mode)]["mode"]
    layers = sum(k in ("AD", "AM") for k in tc.layer_kinds())
    want = layers if mode_used == "head" else 0
    for rank in range(world):
        assert worlds[world][rank]["flash"][(arch, mode)] == want, rank


def check_dispatch(reference, worlds, arch, mode):
    want = reference[arch]["dispatch"]
    assert want
    world = MODES[mode][2]
    for rank in range(world):
        got = worlds[world][rank]["dispatch"][(arch, mode)]
        assert len(got) == len(want), rank
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert np.array_equal(a, b), rank


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


@pytest.mark.parametrize("world", [4, 3])
def test_kvscan_rows_and_sharded_decode_match_reference(worlds, world):
    """Each rank's query rows of flash_attention_kvscan (an uneven split
    at 3) and flash-decoding over each rank's cache slice equal the
    reference's functions on the whole tensors."""
    kv = function_inputs()
    q, k, v = (jnp.asarray(a) for a in kv["qkv"])
    want_scan = np.asarray(jattention.flash_attention_kvscan(
        q, k, v, causal=True, kv_chunk=kv["kv_chunk"]))
    dq, dk, dv = (jnp.asarray(a) for a in kv["decode"])
    want_dec = np.asarray(jattention.decode_attention(
        dq, dk, dv, jnp.asarray(kv["pos"])))
    for rank in range(world):
        got = worlds[world][rank]["functions"]
        _close(got["kvscan"], want_scan, KV_TOL)
        _close(got["decode"], want_dec, KV_TOL)
        assert got["comm"]["calls"]["all_reduce"] == 2   # max, then sums


def test_elastic_restart_preserves_every_leaf(reference, worlds):
    """simulate_failure_and_restart: a (4, 1) world loses 2 ranks; the
    (2, 1) mesh's survivors hold every leaf exactly, the others none."""
    from repro_torch.core.convert import lm_arrays
    tc = tconfigs.get_reduced_config("internlm2-1.8b")
    arrays = lm_arrays(reference["internlm2-1.8b"]["params"], tc)
    for rank in range(4):
        el = worlds[4][rank]["elastic"]
        assert el["new_shape"] == (2, 1)
        assert el["on_mesh"] == (rank < 2)
        if rank < 2:
            assert set(el["leaves"]) == set(arrays)
            for k, a in el["leaves"].items():
                assert np.array_equal(a, np.asarray(arrays[k])), k
        else:
            assert el["leaves"] == {}


def test_mesh_constructors_over_the_world(worlds):
    """make_mesh and make_host_mesh build (data, model) meshes over the
    world; a world of 4 is no production mesh (256 / 512 ranks) and has no
    (data, 3) host mesh."""
    for rank in range(4):
        c = worlds[4][rank]["constructors"]
        assert c["make_mesh"] == (2, 2)
        assert c["host"] == (2, 2)
        assert c["host_names"] == ("data", "model")
        assert "256" in c["production"]
        assert "no (data, 3) mesh" in c["host_3"]


def test_mesh_step_refuses_an_unplaced_model():
    """A step made for a mesh refuses a model not placed on it, and a
    placed-less context refuses nothing of the single-device path."""
    from types import SimpleNamespace
    tc = tconfigs.get_reduced_config("internlm2-1.8b")
    model = tlm.init_params(tc, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    x = _inputs(tc)[:, :S]
    stand_in = SimpleNamespace(mesh_dim_names=("data", "model"))
    step = tsteps.make_prefill_step(tc, ServeConfig(), stand_in)
    with pytest.raises(ValueError, match="not placed"):
        step(model, x)
    assert tsteps.make_prefill_step(tc, ServeConfig()).ctx.mesh is None
