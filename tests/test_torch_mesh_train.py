"""The port's LM training step on a mesh against its single-device step
(which tests/test_torch_lm_train.py holds to the reference's), and one
case against the reference's single-device step itself (what GSPMD
promises the reference's mesh step computes; that step stops at C6).

Ranks are processes on the CPU (gloo, ``spawn``, a ``FileStore`` under
``tmp_path``, one thread each), at most 4. Each file spawns a world of
4 ranks for fsdp_tp ``head`` on (1, 4), ``data_model`` on (2, 2), zero3
on (2, 2) and (1, 4) and 2 microbatches on (2, 2), and a world of 3 for
``qseq`` on (1, 3) (4 heads). The reduced float32 configs, batch 4 x 16,
remat "full", loss chunks of 8, z-loss 1e-4, lr 1e-2 from step 1, the
flash branch at 8 in both packages' single-device runs and every rank.
Every rank draws the state from seed 0 as the single device does
(``init_train_state(..., mesh=)``: parameters and moments placed as
``sharding.params_shardings`` in the layout's mode) and runs
``step.loss_and_grads`` and one ``make_train_step(cfg, tc, mesh)`` step
on the same batch.

Tolerances, against the single device at the same seed: the loss and
the grad norm within 1e-5 relative (LOSS_RTOL; the loss equal on every
rank); every gradient, gathered whole, within 1e-4 of its max |value|
(GRAD_TOL); the parameters and AdamW's moments after the step (gathered
by ``train_state_to_numpy``) within ``test_torch_lm_train._step_close``'s
limits; the MoE dispatch integers bitwise; the flash route twice an
attention layer a step on every rank (the forward and remat's recompute)
in head and zero3, never under qseq, and its backward once.

Also (this file): internlm2 in zero3 on (2, 2) from the reference's own
initial state against the reference's jitted single-device step; a
``Trainer(mesh=...)`` on (2, 2) that saves a checkpoint, restored by a
Trainer on (1, 4) in zero3 and by one on one device with every leaf
exact, each resuming one step (``resumed_from``); ``simulate_failure_
and_restart`` of a TrainState from (4, 1) to 2 survivors, every leaf
exact; two Adafactor updates of internlm2's parameters on (2, 2) shards
within 1e-6 of one device's; ``compressed_cross_pod_mean`` on a ("pod",
"data") (2, 2) world:
on replicated gradients the reference's own bound (error <= scale), on
per-pod gradients the mean of the reference's ``Int8ErrorFeedback``
compress / decompress of each pod's within 1e-6 (COMP_TOL) and the error
feedback bitwise; without ranks, AdamW's sliced update bitwise the whole
one, and qseq's kvscan differentiated on 3 blocks of query rows within
1e-5 of full attention's gradients. tests/test_torch_mesh_train_mixed.py
holds the MoE, SSM and hybrid archs.
"""
from __future__ import annotations

import dataclasses
import queue
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.train import compression as jcomp
from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig
from repro_torch.core.convert import (lm_arrays, train_state_from_numpy,
                                      train_state_to_numpy)
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from test_torch_lm_train import _step_close

ARCHS = ("internlm2-1.8b", "llava-next-mistral-7b")
B, S = 4, 16
FLASH_AT = 8
# name -> (sharding mode, mesh shape, microbatches, world)
LAYOUTS = {"head": ("fsdp_tp", (1, 4), 1, 4),
           "data_model": ("fsdp_tp", (2, 2), 1, 4),
           "zero3_2x2": ("zero3", (2, 2), 1, 4),
           "zero3_1x4": ("zero3", (1, 4), 1, 4),
           "micro2": ("fsdp_tp", (2, 2), 2, 4),
           "qseq": ("fsdp_tp", (1, 3), 1, 3)}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
COMP_TOL = 1e-6
JOIN_S = 300
STEP_SEED, INIT_SEED = 2, 0


def train_config(mode: str, m: int) -> TrainConfig:
    return TrainConfig(sharding_mode=mode, microbatches=m, remat="full",
                       z_loss=1e-4, loss_chunk=8, learning_rate=1e-2,
                       warmup_steps=1)


def config(arch: str):
    """The reduced config; the MoE with router jitter on, so the mesh
    must draw what the single device draws."""
    cfg = tconfigs.get_reduced_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, router_jitter=0.5)
    return cfg


def batch(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    y = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"inputs": x, "targets": y}


def _rel(got, want) -> float:
    return abs(float(got) / float(want) - 1.0)


class Recorder:
    """Counts the flash route's calls and its backward's, and records
    every MoE dispatch's integers, while installed."""

    def __init__(self):
        from repro_torch.kernels import flash_attention as tfa
        from repro_torch.kernels import ops as tops
        from repro_torch.models import moe as tmoe
        self.mods = (tops, tmoe, tfa)
        self.flash, self.dispatch = 0, []

    def __enter__(self):
        tops, tmoe, tfa = self.mods
        self.raw = (tops.flash_attention, tmoe._dispatch_group)
        self.bwd0 = tfa.backward_calls

        def flash(*a, **kw):
            self.flash += 1
            return self.raw[0](*a, **kw)

        def disp(*a, **kw):
            d = self.raw[1](*a, **kw)
            self.dispatch.append(tuple(t.numpy().copy() for t in (
                d.expert_idx, d.sorted_token, d.safe_rank, d.keep)))
            return d
        tops.flash_attention, tmoe._dispatch_group = flash, disp
        return self

    def __exit__(self, *exc):
        tops, tmoe, tfa = self.mods
        tops.flash_attention, tmoe._dispatch_group = self.raw
        self.backward = tfa.backward_calls - self.bwd0


def one_step(cfg, tc, data, mesh=None, state=None) -> dict:
    """``loss_and_grads`` then one train step from ``state`` (default:
    ``init_train_state`` from INIT_SEED): the metrics, the grad norm, the
    gradients gathered whole, the new state as the reference's arrays
    (gathered), the flash and backward counts and dispatch integers of
    ``loss_and_grads``. Every rank of ``mesh`` calls it."""
    from repro_torch.compat import like_placed
    from repro_torch.models.common import gather_placed
    from repro_torch.train.optimizer import global_norm
    if state is None:
        state = tsteps.init_train_state(
            cfg, tc, generator=torch.Generator().manual_seed(INIT_SEED),
            device="cpu", mesh=mesh)
    step = tsteps.make_train_step(cfg, tc, mesh)
    params = dict(state.model.named_parameters())
    with Recorder() as rec:
        metrics, grads = step.loss_and_grads(
            state, data, torch.Generator().manual_seed(STEP_SEED))
    like = params if mesh is not None else None
    gnorm = float(global_norm(grads, like))
    with torch.no_grad():
        whole = {k: (gather_placed(like_placed(g, params[k]))
                     if mesh is not None else g).numpy().copy()
                 for k, g in grads.items()}
    placed = None
    if mesh is not None:
        from repro_torch.launch.sharding import params_shardings
        rules = params_shardings(state.model, cfg, mesh, tc.sharding_mode)
        placed = all(t.placements == rules[k].placements
                     for tree in (params, state.opt.m, state.opt.v)
                     for k, t in tree.items())
    step.ctx.comm.reset()
    new, met = step(state, data, torch.Generator().manual_seed(STEP_SEED))
    comm = step.ctx.comm.snapshot()
    return {"loss": float(metrics["ce_loss"]), "grad_norm": gnorm,
            "placed_by_rules": placed,
            "grads": whole, "step_metrics": {k: float(v)
                                             for k, v in met.items()},
            "state": train_state_to_numpy(new, cfg),
            "flash": rec.flash, "backward": rec.backward,
            "dispatch": rec.dispatch, "comm": comm}


def single_device(archs, mp_) -> dict:
    """The port's single-device step for every (arch, microbatches)."""
    mp_.setattr(tlm, "FLASH_THRESHOLD", FLASH_AT)
    out = {}
    for arch in archs:
        cfg = config(arch)
        for m in sorted({lay[2] for lay in LAYOUTS.values()}):
            out[(arch, m)] = one_step(cfg, train_config("fsdp_tp", m),
                                      batch(cfg))
    return out


# ----------------------------------------------------------------------
# the ranks
# ----------------------------------------------------------------------

def _reference_on(mesh, job) -> dict:
    """internlm2 in zero3 on ``mesh`` from the reference's initial state."""
    cfg = config("internlm2-1.8b")
    tc = train_config("zero3", 1)
    state = train_state_from_numpy(job["state"], cfg, tc, device="cpu",
                                   mesh=mesh)
    return one_step(cfg, tc, job["batch"], mesh, state)


def _trainer_on(tmesh, job) -> dict:
    """A Trainer on (2, 2) takes 2 steps and saves; a Trainer on (1, 4) in
    zero3 restores (its state gathered whole) and takes one step."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer
    cfg = config("internlm2-1.8b")
    dc = DataConfig(seq_len=S, global_batch=B, vocab_size=cfg.vocab_size,
                    seed=3)
    d = job["dir"]
    a = Trainer(cfg, train_config("fsdp_tp", 1), dc, device="cpu",
                mesh=tmesh.mesh_of((2, 2), ("data", "model"), "cpu"),
                checkpoint_dir=d, checkpoint_every=0)
    state, rep_a = a.run(2, log_every=0)
    a.ckpt.save(int(state.step), state)
    saved = train_state_to_numpy(state, cfg)
    b = Trainer(cfg, train_config("zero3", 1), dc, device="cpu",
                mesh=tmesh.mesh_of((1, 4), ("data", "model"), "cpu"),
                checkpoint_dir=d)
    restored = b.init_or_restore(b.tc.seed)
    got = train_state_to_numpy(restored, cfg)
    _, rep_b = b.run(1, state=restored, log_every=0)
    return {"saved": saved, "restored": got, "losses_a": rep_a.losses,
            "resumed_from": rep_b.resumed_from, "loss_b": rep_b.losses}


def _elastic_on(tmesh) -> dict:
    """A TrainState on (4, 1) resharded onto 2 survivors."""
    from repro_torch.train.elastic import simulate_failure_and_restart
    cfg = config("internlm2-1.8b")
    tc = train_config("fsdp_tp", 1)
    old = tmesh.mesh_of((4, 1), ("data", "model"), "cpu")
    init = lambda m: tsteps.init_train_state(
        cfg, tc, generator=torch.Generator().manual_seed(5), device="cpu",
        mesh=m)
    state = init(old)
    before = train_state_to_numpy(state, cfg)
    new_mesh, new = simulate_failure_and_restart(
        state, init, old_mesh=old, surviving_devices=2, model_axis=1)
    out = {"shape": tuple(new_mesh.shape), "before": before, "after": None}
    if new is not None:
        out["after"] = train_state_to_numpy(new, cfg)
    return out


def adafactor_grads(cfg, step: int) -> dict:
    """Seeded whole gradients {parameter: array} of an LM of ``cfg``."""
    rng = np.random.default_rng(100 + step)
    return {k: rng.normal(0, 1, tuple(p.shape)).astype(np.float32)
            for k, p in tlm.LM(cfg, device="meta").named_parameters()}


def adafactor_steps(mesh=None) -> dict:
    """Two Adafactor updates (the reference's stacked leaves) of
    internlm2's parameters from seed 7 with adafactor_grads, on ``mesh``
    (each rank its shards of the gradients) or one device; the new
    parameters whole."""
    from repro_torch.compat import DTensor
    from repro_torch.core.convert import lm_stacks
    from repro_torch.launch.sharding import placed_slices
    from repro_torch.models.common import gather_placed
    from repro_torch.train.optimizer import Adafactor, cosine_schedule
    cfg = config("internlm2-1.8b")
    state = tsteps.init_train_state(
        cfg, train_config("fsdp_tp", 1),
        generator=torch.Generator().manual_seed(7), device="cpu", mesh=mesh)
    params = dict(state.model.named_parameters())
    opt = Adafactor(cosine_schedule(1e-2, 1, 10),
                    stacks=lm_stacks(params, cfg))
    st = opt.init(params)
    for i in range(2):
        whole = adafactor_grads(cfg, i)
        grads = {k: torch.from_numpy(np.ascontiguousarray(
            whole[k][placed_slices(p)] if isinstance(p, DTensor)
            else whole[k])) for k, p in params.items()}
        _, st = opt.update(grads, st, params)
    with torch.no_grad():
        return {k: gather_placed(p).numpy().copy() for k, p in params.items()}


def _compression_on(tmesh, job) -> dict:
    """compressed_cross_pod_mean on a (pod, data) (2, 2) mesh: replicated
    gradients, then each pod's own (two rounds, the error feedback
    carried)."""
    from repro_torch.train.compression import (Int8ErrorFeedback,
                                               compressed_cross_pod_mean)
    mesh = tmesh.mesh_of((2, 2), ("pod", "data"), "cpu")
    pod = mesh.get_coordinate()[0]
    comp = Int8ErrorFeedback()
    g = {k: torch.from_numpy(v) for k, v in job["replicated"].items()}
    out, _ = compressed_cross_pod_mean(g, comp.init(g), mesh, axis="pod")
    rounds = []
    ef = None
    for r in job["per_pod"]:
        g = {k: torch.from_numpy(v[pod]) for k, v in r.items()}
        ef = comp.init(g) if ef is None else ef
        mean, ef = compressed_cross_pod_mean(g, ef, mesh, axis="pod")
        rounds.append(({k: v.numpy() for k, v in mean.items()},
                       {k: v.numpy() for k, v in ef.items()}))
    return {"replicated": {k: v.numpy() for k, v in out.items()},
            "rounds": rounds, "pod": pod}


def _rank_main(rank, world, init_file, jobs_file, q):
    """One rank: every (layout, arch) of its world, then the extra checks;
    puts (rank, result or a traceback) on ``q``."""
    import pickle

    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    torch.set_num_threads(1)
    try:
        with open(jobs_file, "rb") as f:
            jobs = pickle.load(f)
        tmesh.init_process_group("gloo", rank=rank, world_size=world,
                                 init_method=f"file://{init_file}")
        tlm.FLASH_THRESHOLD = FLASH_AT
        res = {"steps": {}}
        for name, (mode, shape, m, w) in LAYOUTS.items():
            if w != world:
                continue
            mesh = tmesh.mesh_of(shape, ("data", "model"), "cpu")
            for arch in jobs["archs"]:
                cfg = config(arch)
                got = one_step(cfg, train_config(mode, m), batch(cfg), mesh)
                if rank != 0:
                    got = {k: got[k] for k in ("loss", "grad_norm",
                                               "step_metrics", "flash",
                                               "backward", "dispatch",
                                               "placed_by_rules")}
                got["mode"] = tlm.attn_parallel_mode(
                    cfg, tsteps.make_parallel_ctx(mesh, train_config(mode,
                                                                     m)))
                res["steps"][(arch, name)] = got
        if jobs.get("reference") is not None and world == 4:
            mesh = tmesh.mesh_of((2, 2), ("data", "model"), "cpu")
            res["reference"] = _reference_on(mesh, jobs["reference"])
        if jobs.get("trainer") is not None and world == 4:
            res["trainer"] = _trainer_on(tmesh, jobs["trainer"])
            res["elastic"] = _elastic_on(tmesh)
            res["adafactor"] = adafactor_steps(
                tmesh.mesh_of((2, 2), ("data", "model"), "cpu"))
        if jobs.get("compression") is not None and world == 4:
            res["compression"] = _compression_on(tmesh, jobs["compression"])
        q.put((rank, res))
    except Exception:
        q.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(world: int, jobs: dict, tmp_path) -> dict:
    """Spawn ``world`` ranks on ``jobs``; {rank: result}. Every rank is
    joined under a timeout, and any failure raises."""
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


# ----------------------------------------------------------------------
# checks, shared with test_torch_mesh_train_mixed.py
# ----------------------------------------------------------------------

def grads_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), (name, err)


def check_step(single, worlds, arch, layout):
    """The mesh step of (arch, layout) against the single device's."""
    mode, shape, m, world = LAYOUTS[layout]
    cfg = config(arch)
    want = single[(arch, m)]
    got = worlds[world][0]["steps"][(arch, layout)]
    heads_split = cfg.num_heads % shape[1] == 0
    assert got["mode"] == ("none" if mode == "zero3" else
                           "head" if heads_split else "qseq")
    for rank in range(world):
        r = worlds[world][rank]["steps"][(arch, layout)]
        assert r["placed_by_rules"], rank      # params and moments
        assert _rel(r["loss"], want["loss"]) <= LOSS_RTOL, rank
        assert _rel(r["grad_norm"], want["grad_norm"]) <= LOSS_RTOL, rank
        for k in ("loss", "ce_loss", "grad_norm"):
            assert _rel(r["step_metrics"][k],
                        want["step_metrics"][k]) <= LOSS_RTOL, (rank, k)
        assert set(r["step_metrics"]) == set(want["step_metrics"])
    grads_close(got["grads"], want["grads"])
    tc = train_config(mode, m)
    new = train_state_from_numpy(got["state"], cfg, tc, device="cpu")
    assert new.step == new.opt.step == 1
    _step_close(new, want["state"], cfg, tc)


def check_flash(single, worlds, arch, layout):
    """The flash route twice an attention layer (forward and remat's
    recompute) on every rank where the heads are whole or split (none /
    head), never under qseq; its backward once; as the single device."""
    world = LAYOUTS[layout][3]
    m = LAYOUTS[layout][2]
    want = single[(arch, m)]
    mode = worlds[world][0]["steps"][(arch, layout)]["mode"]
    for rank in range(world):
        r = worlds[world][rank]["steps"][(arch, layout)]
        if mode == "qseq":
            assert (r["flash"], r["backward"]) == (0, 0), rank
        else:
            assert (r["flash"], r["backward"]) == (want["flash"],
                                                   want["backward"]), rank


def check_dispatch(single, worlds, arch, layout):
    world, m = LAYOUTS[layout][3], LAYOUTS[layout][2]
    want = single[(arch, m)]["dispatch"]
    assert want
    for rank in range(world):
        got = worlds[world][rank]["steps"][(arch, layout)]["dispatch"]
        assert len(got) == len(want), rank
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert np.array_equal(a, b), rank


def leaves_equal(got, want) -> None:
    """Two reference-layout numpy trees, every leaf bitwise."""
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    g, w = flat(got), flat(want)
    assert set(g) == set(w)
    for k in w:
        assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k


# ----------------------------------------------------------------------
# fixtures and tests
# ----------------------------------------------------------------------

def reference_job():
    """The reference's initial state and jitted single-device step of
    internlm2 in zero3 (no mesh: the reference's mesh step stops at C6)."""
    jc = jconfigs.get_reduced_config("internlm2-1.8b")
    jtc = JTrainConfig(**dataclasses.asdict(train_config("zero3", 1)))
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jc, jtc)
    data = batch(config("internlm2-1.8b"), seed=9)
    jnew, jmet = jax.jit(jsteps.make_train_step(jc, jtc, None))(
        jstate, {k: jnp.asarray(v) for k, v in data.items()},
        jax.random.PRNGKey(2))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return ({"state": np_(jstate), "batch": data},
            {"new": np_(jnew), "metrics": {k: float(v)
                                           for k, v in jmet.items()}})


def compression_job(seed=4) -> dict:
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return {"replicated": {"w": f(16, 16), "b": f(7)},
            "per_pod": [{"w": f(2, 16, 16), "b": f(2, 7)} for _ in range(2)]}


@pytest.fixture(scope="module")
def single():
    with pytest.MonkeyPatch.context() as mp_:
        return single_device(ARCHS, mp_)


@pytest.fixture(scope="module")
def reference():
    return reference_job()


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    jobs = {"archs": ARCHS, "reference": reference[0],
            "trainer": {"dir": str(tmp / "ckpt")},
            "compression": compression_job()}
    out = {w: run_world(w, jobs, tmp) for w in (4, 3)}
    out["ckpt_dir"] = tmp / "ckpt"
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_single_device(single, worlds, arch, layout):
    check_step(single, worlds, arch, layout)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_flash_route_on_every_rank(single, worlds, arch, layout):
    check_flash(single, worlds, arch, layout)


def test_zero3_mesh_step_matches_reference_single_device(reference, worlds):
    """internlm2 in zero3 on (2, 2) from the reference's initial state:
    the loss and grad norm within 1e-5 of the reference's jitted single-
    device step on every rank, the new parameters and moments within
    _step_close's limits."""
    want = reference[1]
    cfg = config("internlm2-1.8b")
    tc = train_config("zero3", 1)
    for rank in range(4):
        got = worlds[4][rank]["reference"]
        for k in ("loss", "ce_loss", "grad_norm"):
            assert _rel(got["step_metrics"][k], want["metrics"][k]) \
                <= LOSS_RTOL, (rank, k)
    new = train_state_from_numpy(worlds[4][0]["reference"]["state"], cfg,
                                 tc, device="cpu")
    _step_close(new, want["new"], cfg, tc)


def test_checkpoint_moves_between_meshes_and_one_device(worlds, tmp_path):
    """A Trainer on (2, 2) saves after 2 steps; a zero3 Trainer on (1, 4)
    restores every leaf exactly and resumes at step 2; so does a Trainer
    on one device, its resumed loss within 1e-5 of the mesh's."""
    import shutil

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer
    for rank in range(4):
        t = worlds[4][rank]["trainer"]
        leaves_equal(t["restored"], t["saved"])
        assert t["resumed_from"] == 2 and len(t["loss_b"]) == 1
        assert np.isfinite(t["losses_a"] + t["loss_b"]).all()
    t = worlds[4][0]["trainer"]
    cfg = config("internlm2-1.8b")
    d = tmp_path / "ckpt"
    src = sorted((worlds["ckpt_dir"]).glob("step_*"))
    assert [p.name for p in src] == ["step_00000002"]
    shutil.copytree(src[0], d / src[0].name)
    dc = DataConfig(seq_len=S, global_batch=B, vocab_size=cfg.vocab_size,
                    seed=3)
    one = Trainer(cfg, train_config("fsdp_tp", 1), dc, device="cpu",
                  checkpoint_dir=d)
    state = one.init_or_restore(one.tc.seed)
    leaves_equal(train_state_to_numpy(state, cfg), t["saved"])
    _, rep = one.run(1, state=state, log_every=0)
    assert rep.resumed_from == 2
    assert _rel(rep.losses[0], t["loss_b"][0]) <= LOSS_RTOL


def test_elastic_restart_of_a_train_state(worlds):
    """simulate_failure_and_restart of a TrainState on (4, 1): the (2, 1)
    mesh's survivors hold every leaf (parameters, moments, steps)
    exactly, the others none."""
    for rank in range(4):
        el = worlds[4][rank]["elastic"]
        assert el["shape"] == (2, 1)
        if rank < 2:
            leaves_equal(el["after"], el["before"])
        else:
            assert el["after"] is None


def test_adafactor_on_shards_matches_one_device(worlds):
    """Adafactor on (2, 2) shards, its row / column means and RMS clip
    all-reduced over the axes sharding them: two updates give every
    parameter within 1e-6 of its max |value| of one device's."""
    want = adafactor_steps()
    for rank in range(4):
        got = worlds[4][rank]["adafactor"]
        assert set(got) == set(want)
        for k, w in want.items():
            err = float(np.abs(got[k] - w).max())
            assert err <= COMP_TOL * max(1.0, float(np.abs(w).max())), \
                (rank, k, err)


def test_compressed_cross_pod_mean(worlds):
    """Replicated gradients: every rank's mean within the reference's
    bound of the input (error <= scale). Per-pod gradients, two rounds:
    the mean of the reference's compress / decompress of each pod's
    gradients (its error feedback carried) within 1e-6, and each rank's
    error feedback bitwise the reference's for its pod."""
    job = compression_job()
    comp = jcomp.Int8ErrorFeedback()
    for rank in range(4):
        got = worlds[4][rank]["compression"]
        for k, g in job["replicated"].items():
            err = float(np.abs(got["replicated"][k] - g).max())
            assert err <= float(np.abs(g).max()) / 127.0 * 1.01 + 1e-7, k
    efs = [None, None]
    for i, r in enumerate(job["per_pod"]):
        deq = []
        for pod in range(2):
            g = {k: jnp.asarray(v[pod]) for k, v in r.items()}
            ef = comp.init(g) if efs[pod] is None else efs[pod]
            qt, efs[pod] = comp.compress(g, ef)
            deq.append(comp.decompress(qt))
        for rank in range(4):
            got = worlds[4][rank]["compression"]
            mean, ef = got["rounds"][i]
            for k in r:
                want = (np.asarray(deq[0][k]) + np.asarray(deq[1][k])) / 2
                assert np.abs(mean[k] - want).max() <= COMP_TOL, (rank, k)
                assert np.array_equal(ef[k], np.asarray(
                    efs[got["pod"]][k])), (rank, k)


def test_mesh_pieces_refuse_a_non_mesh():
    """The train step, the state, the Trainer and the cross-pod mean take
    a DeviceMesh or None: anything else is a ValueError."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.compression import compressed_cross_pod_mean
    from repro_torch.train.trainer import Trainer
    cfg = config("internlm2-1.8b")
    tc = train_config("zero3", 1)
    for fn in (lambda: tsteps.make_train_step(cfg, tc, object()),
               lambda: tsteps.init_train_state(
                   cfg, tc, generator=torch.Generator(), device="cpu",
                   mesh=object()),
               lambda: Trainer(cfg, tc, DataConfig(), mesh=object(),
                               device="cpu"),
               lambda: compressed_cross_pod_mean({}, {}, object())):
        with pytest.raises(ValueError, match="DeviceMesh"):
            fn()


def test_adamw_update_in_slices_is_the_whole_update(monkeypatch):
    """AdamW.update runs a large tensor in slices along its first dim
    (UPDATE_CHUNK_ELEMS, so a rank's expert bank keeps its float32
    temporaries small): every op is elementwise, so the parameters and
    moments are bitwise those of one slice, decay and no decay."""
    from repro_torch.train import optimizer as topt
    rng = np.random.default_rng(3)
    shapes = {"w": (9, 5, 3), "b": (11,), "s": ()}
    params = {k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
              for k, s in shapes.items()}
    grads = {k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
             for k, s in shapes.items()}
    out = []
    for elems in (topt.UPDATE_CHUNK_ELEMS, 30):
        monkeypatch.setattr(topt, "UPDATE_CHUNK_ELEMS", elems)
        p = {k: v.clone() for k, v in params.items()}
        opt = tsteps.make_optimizer(train_config("fsdp_tp", 1))
        state = opt.init(p)
        for _ in range(2):
            _, state = opt.update(grads, state, p)
        out.append((p, state))
    assert len(topt._chunks(torch.zeros(9, 5, 3))) == 5     # 2 rows a slice
    for k in shapes:
        assert torch.equal(out[0][0][k], out[1][0][k]), k
        assert torch.equal(out[0][1].m[k], out[1][1].m[k]), k
        assert torch.equal(out[0][1].v[k], out[1][1].v[k]), k


def test_kvscan_rows_differentiate_as_full_attention():
    """qseq's attention: flash_attention_kvscan on 3 blocks of query rows
    (an uneven split, KV chunks of 8) is plain torch; the gradients of q,
    k and v through the blocks equal full attention's within 1e-5 of
    their max."""
    from repro_torch.launch.sharding import split
    from repro_torch.models import attention as tattention
    rng = np.random.default_rng(11)
    f = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32)).requires_grad_(True)
    q, k, v = f(2, 32, 4, 16), f(2, 32, 2, 16), f(2, 32, 2, 16)
    w = torch.from_numpy(rng.normal(0, 1, (2, 32, 4, 16)).astype(np.float32))
    parts = []
    for r in range(3):
        lo, hi = split(32, 3, r)
        parts.append((tattention.flash_attention_kvscan(
            q[:, lo:hi], k, v, causal=True, kv_chunk=8, q_offset=lo)
            * w[:, lo:hi]).sum())
    got = torch.autograd.grad(sum(parts), (q, k, v))
    want = torch.autograd.grad(
        (tattention.full_attention(q, k, v, causal=True) * w).sum(),
        (q, k, v))
    for g, t in zip(got, want):
        assert float((g - t).abs().max()) <= LOSS_RTOL * float(t.abs().max())
