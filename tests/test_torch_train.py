"""The port's training substrate against the reference's: optimizers,
checkpoints, gradient compression, failure handling, the Trainer and the
training CLI (twins of tests/test_substrate.py's optimizer, checkpoint,
compression and trainer tests, which stay as they are).

- Optimizers: the reference's closed-form tests run on the port; AdamW,
  Adafactor, clipping and the schedule fed the reference's own gradients
  (a small random tree) give the reference's new parameters and moments
  within 1e-6 relative (of each tensor's max |value|); the same on a
  reduced LM is tests/test_torch_train_lm_update.py.
- Checkpoints: the same TrainState gives byte-equal leaf files and an
  equal manifest in both packages (float32 and a bfloat16 model); each
  package restores the other's; keep-N GC, a partial directory ignored,
  the async save waited for.
- Compression: the int8 error-feedback bounds and ``compression_ratio``
  equal to the reference's (quantised payloads bitwise).
- The Trainer from the reference's initial state on the same
  ``TokenSource``: 10 losses within 1e-3 relative of the reference
  Trainer's; a resume reproduces the data order and ``resumed_from``;
  the loss decreases; ``launch.train --reduced --device cpu`` prints the
  reference's line.
- The mesh pieces (ROADMAP A13c) raise NotImplementedError naming it.
On the CPU.
"""
from __future__ import annotations

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models.common import ParallelCtx
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JTrainer
from repro_torch import configs as tconfigs
from repro_torch import train as ttrain
from repro_torch.configs.base import TrainConfig
from repro_torch.core.convert import (BF16_BITS, lm_arrays,
                                      train_state_from_numpy,
                                      train_state_to_numpy)
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.launch import steps as tsteps
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compression as tcomp
from repro_torch.train import elastic as telastic
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer

CTX = ParallelCtx()
OPT_RTOL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _close(got, want, rtol=OPT_RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rtol * max(float(np.abs(want).max()), 1e-30), err


# ----------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------

def test_adamw_single_step_closed_form():
    opt = topt.AdamW(lambda step: 0.1, beta1=0.9, beta2=0.99,
                     weight_decay=0.0)
    p = {"w": torch.tensor([[1.0, 2.0]])}
    g = {"w": torch.tensor([[0.5, -0.5]])}
    newp, _ = opt.update(g, opt.init(p), p)
    want = np.asarray([[1.0, 2.0]]) - 0.1 * np.sign([[0.5, -0.5]])
    np.testing.assert_allclose(newp["w"].numpy(), want, rtol=1e-4)


def test_adamw_weight_decay_skips_vectors():
    opt = topt.AdamW(lambda s: 0.1, weight_decay=0.5)
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    newp, _ = opt.update(g, opt.init(p), p)
    assert float(newp["w"][0, 0]) < 1.0
    np.testing.assert_allclose(newp["b"].numpy(), 1.0)


def test_cosine_schedule_matches_reference():
    for args in ((1.0, 10, 100), (3e-4, 100, 10_000), (1e-3, 0, 7)):
        ours, ref = topt.cosine_schedule(*args), jopt.cosine_schedule(*args)
        for step in (0, 1, 5, 10, 11, 50, 99, 100, 150, 10_000):
            assert ours(step) == float(ref(step)), (args, step)
    s = topt.cosine_schedule(1.0, warmup=10, total=100)
    assert s(0) == 0.0 and abs(s(10) - 1.0) < 1e-6
    assert s(100) < s(50) < 1.0


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(0, 3, (4, 5)).astype(np.float32),
            "b": rng.normal(0, 3, (7,)).astype(np.float32)}
    for max_norm in (1.0, 1e3):
        want, wnorm = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
        got, norm = topt.clip_by_global_norm(_t(tree), max_norm)
        _close(norm, wnorm)
        for k in tree:
            _close(got[k], want[k])
    g = {"a": torch.ones(4) * 10.0}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(topt.global_norm(clipped)), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(float(norm), 20.0, rtol=1e-5)


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (6, 5)).astype(np.float32),
            "e": rng.normal(0, 1, (3, 4, 5)).astype(np.float32),
            "b": rng.normal(0, 1, (5,)).astype(np.float32)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_on_its_gradients(state_dtype):
    """Five steps of the reference's gradients (new random ones each
    step): params and moments within 1e-6 relative."""
    sched = (1e-2, 2, 10)
    jo = jopt.AdamW(jopt.cosine_schedule(*sched), weight_decay=0.1,
                    state_dtype=state_dtype)
    to = topt.AdamW(topt.cosine_schedule(*sched), weight_decay=0.1,
                    state_dtype=state_dtype)
    jp = {k: jnp.asarray(v) for k, v in _random_tree(0).items()}
    tp = _t(_random_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = _random_tree(step + 1)
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update(_t(g), ts, tp)
        for k in jp:
            _close(tp[k], jp[k])
            for which in ("m", "v"):
                got = getattr(ts, which)[k]
                assert str(got.dtype).endswith(state_dtype)
                _close(got, np.asarray(getattr(js, which)[k], np.float32))
    assert ts.step == int(js.step) == 5


def test_adafactor_matches_reference_on_its_gradients():
    jo, to = jopt.Adafactor(lambda s: 0.05), topt.Adafactor(lambda s: 0.05)
    jp = {k: jnp.asarray(v) for k, v in _random_tree(0).items()}
    tp = _t(_random_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = _random_tree(step + 10)
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update(_t(g), ts, tp)
        for k in jp:
            _close(tp[k], jp[k])
            for n, v in ts["factored"][k].items():
                _close(v, js["factored"][k][n])
    assert ts["step"] == int(js["step"]) == 5


def test_adafactor_reduces_loss():
    opt = topt.Adafactor(lambda s: 0.1)
    w = {"w": torch.tensor(np.random.default_rng(0).normal(0, 1, (8, 8)),
                           dtype=torch.float32)}
    st = opt.init(w)
    l0 = float(torch.sum(w["w"] ** 2))
    for _ in range(20):
        g = {"w": 2 * w["w"]}
        w, st = opt.update(g, st, w)
    assert float(torch.sum(w["w"] ** 2)) < l0 * 0.5


# ----------------------------------------------------------------------
# checkpoint
# ----------------------------------------------------------------------

def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"params": {"w": r.normal(0, 1, (4, 4)).astype(np.float32),
                       "b": r.normal(0, 1, (4,)).astype(np.float32)},
            "step": np.asarray(7, np.int32)}


def _same_tree(a, b):
    fa, fb = tckpt._flatten_with_names(a), tckpt._flatten_with_names(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (_, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    cm = tckpt.CheckpointManager(tmp_path)
    t = _tree()
    cm.save(7, t)
    _same_tree(cm.restore(jax.tree.map(np.zeros_like, t)), t)


def test_checkpoint_latest_and_gc(tmp_path):
    cm = tckpt.CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree(s))
    assert cm.list_steps() == [3, 4]
    assert cm.latest_step() == 4


def test_checkpoint_async_and_wait(tmp_path):
    cm = tckpt.CheckpointManager(tmp_path)
    t = _tree()
    cm.save_async(5, t)
    cm.wait()
    assert cm.latest_step() == 5
    _same_tree(cm.restore(jax.tree.map(np.zeros_like, t), step=5), t)


def test_checkpoint_atomicity_ignores_partial(tmp_path):
    cm = tckpt.CheckpointManager(tmp_path)
    cm.save(1, _tree())
    bad = tmp_path / "step_00000009"
    bad.mkdir()
    (bad / "params__w.npy").write_bytes(b"garbage")
    (tmp_path / "step_00000010.tmp0").mkdir()
    assert cm.list_steps() == [1]
    assert cm.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(tmp_path / "empty").restore(_tree())


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("arch,dtype", [("internlm2-1.8b", "float32"),
                                        ("recurrentgemma-2b", "float32"),
                                        ("llama3-8b", "bfloat16")])
def test_checkpoint_files_equal_the_reference(tmp_path, arch, dtype):
    """The same TrainState (the reference's init, one step taken in the
    reference so the moments are not zero) saved by both packages: every
    leaf file byte for byte, the manifests equal; each package restores
    the other's."""
    over = {"param_dtype": dtype}
    jc = jconfigs.get_reduced_config(arch, **over)
    tc = tconfigs.get_reduced_config(arch, **over)
    kw = dict(opt_state_dtype=dtype, z_loss=0.0, remat="none")
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jc, jtc)
    rng = np.random.default_rng(2)
    batch = {k: jnp.asarray(rng.integers(0, jc.vocab_size, (2, 8)),
                            jnp.int32) for k in ("inputs", "targets")}
    jstate, _ = jax.jit(jsteps.make_train_step(jc, jtc, None))(
        jstate, batch, jax.random.PRNGKey(0))
    host = jax.device_get(jstate)
    state = train_state_from_numpy(_np(host), tc, ttc, device="cpu")
    assert state.step == state.opt.step == 1

    jdir, tdir = tmp_path / "ref", tmp_path / "port"
    jckpt.CheckpointManager(jdir).save(1, host)
    tckpt.CheckpointManager(tdir).save(1, state)
    want, got = _files(jdir / "step_00000001"), _files(tdir / "step_00000001")
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    manifest = json.loads(got["manifest.json"])
    assert "params/blocks/slot0/norm1" in manifest["leaves"]
    assert manifest["leaves"]["opt/step"] == {"shape": [], "dtype": "int32"}
    if dtype == "bfloat16":
        assert manifest["leaves"]["params/embed"]["dtype"] == "bfloat16"

    # the port restores the reference's checkpoint into a fresh state
    fresh = tsteps.init_train_state(tc, ttc, generator=torch.Generator(),
                                    device="cpu")
    back = tckpt.CheckpointManager(jdir).restore(fresh)
    assert back.step == back.opt.step == 1
    for name, want_t in dict(state.model.named_parameters()).items():
        assert torch.equal(dict(back.model.named_parameters())[name], want_t)
    for which in ("m", "v"):
        for name, want_t in getattr(state.opt, which).items():
            assert torch.equal(getattr(back.opt, which)[name], want_t)
    # the reference restores the port's checkpoint: the same arrays as
    # its own restore of its own (a bfloat16 leaf as the raw 2-byte bits)
    jmine = jckpt.CheckpointManager(jdir).restore(host)
    jtheirs = jckpt.CheckpointManager(tdir).restore(host)
    for a, b in zip(jax.tree.leaves(jmine), jax.tree.leaves(jtheirs)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if dtype == "bfloat16":
        # ROADMAP C11: those raw bits are all the reference gets back, and
        # JAX refuses them (its Trainer cannot resume a bfloat16 state)
        assert jmine.params["embed"].dtype.kind == "V"
        with pytest.raises(TypeError):
            jnp.asarray(jmine.params["embed"])


def test_train_state_crosses_both_ways():
    jc = jconfigs.get_reduced_config("llama4-maverick-400b-a17b")
    tc = tconfigs.get_reduced_config("llama4-maverick-400b-a17b")
    jstate = _np(jsteps.init_train_state(jax.random.PRNGKey(3), jc,
                                         JTrainConfig()))
    state = train_state_from_numpy(jstate, tc, TrainConfig(), device="cpu")
    back = train_state_to_numpy(state, tc)
    _same_tree(back, jstate)
    assert all(p.requires_grad for p in state.model.parameters())
    with pytest.raises(ValueError, match="no dtype is cast"):
        train_state_from_numpy(jstate, tc,
                               TrainConfig(opt_state_dtype="bfloat16"),
                               device="cpu")


def test_bf16_leaf_is_written_as_the_reference_writes_it(tmp_path):
    """The bits of a bfloat16 tensor as ``np.save`` writes an ml_dtypes
    bfloat16 array ('<V2' and the raw bits), and read back as bfloat16."""
    import ml_dtypes
    vals = np.asarray([1.5, -2.25, 3e-3, 65504.0], np.float32)
    want = jckpt.npy_bytes(vals.astype(ml_dtypes.bfloat16))
    t = torch.tensor(vals).to(torch.bfloat16)
    bits = t.view(torch.int16).numpy().view(BF16_BITS)
    assert tckpt._leaf_bytes(bits) == want
    cm = tckpt.CheckpointManager(tmp_path)
    cm.save(0, {"w": bits})
    got = cm.restore({"w": bits})["w"]
    assert got.dtype == BF16_BITS and got.tobytes() == bits.tobytes()


# ----------------------------------------------------------------------
# compression and the refused mesh pieces
# ----------------------------------------------------------------------

def test_int8_error_feedback_matches_reference():
    rng = np.random.default_rng(0)
    comp, jc = tcomp.Int8ErrorFeedback(), jcomp.Int8ErrorFeedback()
    g0 = {"w": rng.normal(0, 1, (64, 64)).astype(np.float32),
          "b": rng.normal(0, 1, (32,)).astype(np.float32)}
    ef, jef = comp.init(_t(g0)), jc.init({k: jnp.asarray(v)
                                          for k, v in g0.items()})
    total_raw, total_deq = np.zeros(32), np.zeros(32)
    for step in range(20):
        g = {k: rng.normal(0, 1, v.shape).astype(np.float32)
             for k, v in g0.items()}
        q, ef = comp.compress(_t(g), ef)
        jq, jef = jc.compress({k: jnp.asarray(v) for k, v in g.items()}, jef)
        for k in g:
            assert q[k].q.dtype == torch.int8
            np.testing.assert_array_equal(q[k].q.numpy(), np.asarray(jq[k].q))
            assert float(q[k].scale) == float(jq[k].scale)
        back = comp.decompress(q)
        if step == 0:     # the quantisation error bound (no feedback yet)
            err = float((back["w"] - torch.tensor(g["w"])).abs().max())
            assert err <= float(np.abs(g["w"]).max()) / 127.0 * 0.5 + 1e-7
        total_raw += g["b"]
        total_deq += back["b"].numpy()
    # the telescoping identity of error feedback
    np.testing.assert_allclose(total_deq + ef["b"].numpy(), total_raw,
                               rtol=1e-4, atol=1e-4)


def test_compression_ratio_matches_reference():
    for shapes in (((1000,),), ((64, 64), (7,))):
        g = {str(i): torch.zeros(s) for i, s in enumerate(shapes)}
        jg = {str(i): jnp.zeros(s) for i, s in enumerate(shapes)}
        assert tcomp.compression_ratio(g) == jcomp.compression_ratio(jg)
    assert 0.24 < tcomp.compression_ratio({"w": torch.zeros(1000)}) < 0.27


def test_mesh_pieces_refuse_naming_a13c():
    with pytest.raises(NotImplementedError, match="A13c"):
        tcomp.compressed_cross_pod_mean({}, {}, mesh=object())
    with pytest.raises(NotImplementedError, match="A13c"):
        telastic.remesh(8)
    with pytest.raises(NotImplementedError, match="A13c"):
        telastic.reshard_state({}, {})
    with pytest.raises(NotImplementedError, match="A13c"):
        telastic.simulate_failure_and_restart(
            {}, None, old_mesh=None, surviving_devices=4)
    cfg = tconfigs.get_reduced_config("internlm2-1.8b")
    with pytest.raises(NotImplementedError, match="A13c"):
        Trainer(cfg, TrainConfig(), DataConfig(), mesh=object(),
                device="cpu")


def test_train_package_exports_the_reference_names():
    import repro.train as jtrain
    assert sorted(ttrain.__all__) == sorted(jtrain.__all__)
    for name in ttrain.__all__:
        assert getattr(ttrain, name) is not None
    assert ttrain.Trainer is Trainer


def test_heartbeat_and_preemption():
    import signal
    import time
    fired = []
    hb = telastic.Heartbeat(0.05, fired.append)
    try:
        time.sleep(0.3)
    finally:
        hb.close()
    assert len(fired) == 1 and fired[0] > 0.05
    pre = telastic.Preemption(signals=(signal.SIGUSR1,))
    try:
        signal.raise_signal(signal.SIGUSR1)
        assert pre.requested
    finally:
        pre.restore()


# ----------------------------------------------------------------------
# the Trainer
# ----------------------------------------------------------------------

def _small(vocab=128):
    over = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=vocab)
    return (jconfigs.get_reduced_config("internlm2-1.8b", **over),
            tconfigs.get_reduced_config("internlm2-1.8b", **over))


def test_trainer_matches_reference_from_its_initial_state():
    """The reference Trainer's 10 steps from PRNGKey(tc.seed), and the
    port's Trainer from that state, on the same TokenSource: every loss
    within 1e-3 relative."""
    jc, tc = _small()
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20,
              z_loss=1e-4, loss_chunk=16)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    dkw = dict(seq_len=32, global_batch=4, vocab_size=128)
    jtr = JTrainer(jc, jtc, JDataConfig(**dkw), step_deadline_s=600)
    _, jrep = jtr.run(10, log_every=0)
    init = _np(jsteps.init_train_state(jax.random.PRNGKey(jtc.seed), jc,
                                       jtc))
    tr = Trainer(tc, ttc, DataConfig(**dkw), step_deadline_s=600,
                 device="cpu")
    state, rep = tr.run(10, state=train_state_from_numpy(init, tc, ttc,
                                                         device="cpu"),
                        log_every=0)
    assert rep.steps_run == jrep.steps_run == 10 and state.step == 10
    assert rep.resumed_from is None
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=1e-3)


def test_trainer_runs_checkpoints_and_resumes(tmp_path):
    _, cfg = _small()
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=20,
                     z_loss=0.0)
    dc = DataConfig(seq_len=32, global_batch=4, vocab_size=128)
    tr = Trainer(cfg, tc, dc, checkpoint_dir=tmp_path, checkpoint_every=5,
                 step_deadline_s=600, device="cpu")
    state, report = tr.run(10, log_every=0)
    assert report.steps_run == 10
    assert np.isfinite(report.final_loss) and report.tokens_per_s > 0
    tr.ckpt.wait()
    assert tr.ckpt.list_steps() == [5, 10]
    # an uninterrupted run's steps 10-12
    _, more = tr.run(3, state=state, log_every=0)

    # resume: the next run starts from step 10 and sees the same batches
    tr2 = Trainer(cfg, tc, dc, checkpoint_dir=tmp_path, checkpoint_every=5,
                  step_deadline_s=600, device="cpu")
    state2, report2 = tr2.run(3, log_every=0)
    assert report2.resumed_from == 10
    assert report2.steps_run == 3 and state2.step == 13
    assert report2.losses == more.losses


def test_resume_reproduces_the_data_order(tmp_path):
    """A source that records the steps it serves: a resumed run asks for
    the steps an uninterrupted one would."""
    _, cfg = _small()
    tc = TrainConfig(warmup_steps=1, total_steps=10, z_loss=0.0)
    dc = DataConfig(seq_len=16, global_batch=2, vocab_size=128)

    class Recording(TokenSource):
        served = []

        def batch(self, step):
            Recording.served.append(step)
            return super().batch(step)
    tr = Trainer(cfg, tc, dc, checkpoint_dir=tmp_path, checkpoint_every=4,
                 step_deadline_s=600, source=Recording(dc), device="cpu")
    tr.run(4, log_every=0)
    Recording.served.clear()
    tr2 = Trainer(cfg, tc, dc, checkpoint_dir=tmp_path, checkpoint_every=4,
                  step_deadline_s=600, source=Recording(dc), device="cpu")
    _, rep = tr2.run(2, log_every=0)
    assert rep.resumed_from == 4
    assert Recording.served[:2] == [4, 5]


def test_trainer_loss_decreases():
    _, cfg = _small(vocab=64)
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60,
                     z_loss=0.0)
    dc = DataConfig(seq_len=64, global_batch=8, vocab_size=64)
    _, report = Trainer(cfg, tc, dc, step_deadline_s=600,
                        device="cpu").run(60, log_every=0)
    first, last = np.mean(report.losses[:5]), np.mean(report.losses[-5:])
    assert last < first - 0.3, (first, last)


def test_reference_trainer_needs_init_before_a_given_state():
    """ROADMAP C10: the reference's ``Trainer.run(state=...)`` reads
    ``_resumed_from``, which only ``init_or_restore`` sets; the port's
    Trainer starts it at None."""
    jc, tc = _small()
    dkw = dict(seq_len=16, global_batch=2, vocab_size=128)
    jtc = JTrainConfig(z_loss=0.0)
    init = jsteps.init_train_state(jax.random.PRNGKey(0), jc, jtc)
    with pytest.raises(AttributeError, match="_resumed_from"):
        JTrainer(jc, jtc, JDataConfig(**dkw)).run(1, state=init,
                                                  log_every=0)
    state = train_state_from_numpy(_np(init), tc, TrainConfig(z_loss=0.0),
                                   device="cpu")
    _, rep = Trainer(tc, TrainConfig(z_loss=0.0), DataConfig(**dkw),
                     device="cpu").run(1, state=state, log_every=0)
    assert rep.resumed_from is None and rep.steps_run == 1


LINE = re.compile(r"^arch=(\S+) steps=(\d+) loss\[first\]=(\d+\.\d{4}) "
                  r"loss\[last\]=(\d+\.\d{4}) tokens/s=[\d,]+ "
                  r"resumed_from=(\S+) preempted=(\S+)$")


def test_train_cli_prints_the_reference_line(capsys, monkeypatch, tmp_path):
    from repro.launch import train as jcli
    from repro_torch.launch import train as tcli
    args = ["--arch", "internlm2-1.8b", "--reduced", "--steps", "2",
            "--batch", "2", "--seq-len", "16", "--log-every", "0"]
    assert tcli.main(args + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr("sys.argv", ["train"] + args)
    assert jcli.main() == 0
    theirs = capsys.readouterr().out.strip().splitlines()[-1]
    mo, mt = LINE.match(ours), LINE.match(theirs)
    assert mo and mt, (ours, theirs)
    # the same fields; the losses differ (the port draws its own init)
    assert mo.group(1, 2, 5, 6) == mt.group(1, 2, 5, 6) == (
        "internlm2-1.8b-reduced", "2", "None", "False")
    # without --device the CLI runs on CUDA, and refuses where there is none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(args)
