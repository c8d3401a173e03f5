"""The port's DINO training (``repro_torch.features.dino``) and the
attention backward under it, against the reference's.

On the CPU, at tests/test_serve_features.py's ViT (2 layers, d 32, 2
heads of 16, 16x16 images at /8):

- ``kernels/ref.flash_attention_bwd_ref`` against autograd through
  ``flash_attention_ref`` (to 1e-5), and ``ops.flash_attention``'s
  autograd Function against ``jax.vjp`` of the reference ViT's plain
  softmax attention and of ``repro.models.attention.flash_attention``'s
  custom VJP (to 1e-5 of the gradient's largest entry);
- ``apply_augment`` fed the reference's draws against
  ``repro.features.dino.augment``, bitwise;
- ``core.convert.dino_state_from_numpy`` carrying a reference state
  across;
- three steps from one carried state on the reference's own views: the
  losses to 1e-5 relative; step 1's gradients, which the reference's first
  Adam moment holds as (1 - b1) g, to 1e-5 of each tensor's largest
  entry (1e-4 at the paper ViT-T's 12 layers, GRAD_TOL); the state after three steps within STATE_TOL_LR learning rates
  (Adam's update is near lr sign(g), so where |g| is near 1e-7 the two
  packages' rounding moves it by up to ~1e-2 lr);
- twins of tests/test_serve_features.py's ``test_dino_step_trains`` and
  ``test_dino_features_improve_knn_separability``;
- the step's attention forward goes to the kernel wherever the tensors
  are not on the CPU (the kernel stubbed), never to the plain version.

On a CUDA card (marker ``gpu``; skipped without one): the backward and
one small step, card against CPU. Run them there with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_dino.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.data.synthetic import PatchDatasetConfig, generate_patches
from repro.features import dino as jdino
from repro.models.attention import flash_attention as jflash
from repro.models.common import ParallelCtx
from repro_torch.configs.base import ModelConfig
from repro_torch.core.convert import dino_state_from_numpy
from repro_torch.features import dino as tdino
from repro_torch.features.vit import extract_features
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

CTX = ParallelCtx()
IMAGE, PATCH = 16, 8
LR = 1e-3
BWD_TOL = 1e-5          # the explicit backward against autograd / JAX
LOSS_RTOL = 1e-5
# of each gradient tensor's largest |entry|: 1e-5 at the small ViT; 1e-4
# at the paper's 12 layers, where the deep layers' wq / wk gradients
# (~2e-5 at most) come out of the cancellation in p (dout v^T - delta)
# and so carry the summation order of 12 layers (measured up to 4.9e-5)
GRAD_TOL = {"small": 1e-5, "paper": 1e-4}
STATE_TOL_LR = 0.05     # parameters after three steps, in units of lr


def _jcfg() -> JModelConfig:
    """tests/test_serve_features.py's ViT."""
    return JModelConfig(name="vit-test", family="vit", num_layers=2,
                        d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
                        d_ff=64, vocab_size=0, mlp_gated=False)


def _cfg(j: JModelConfig = None) -> ModelConfig:
    j = j or _jcfg()
    return ModelConfig(**{f.name: getattr(j, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _images(n, seed=0, size=IMAGE):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, size, size, 3)).astype(np.float32)


def _carried(seed=0, jcfg=None, image=IMAGE, patch=PATCH):
    """A reference DinoState and the port's copy of it (on the CPU)."""
    jcfg = jcfg or _jcfg()
    js = jdino.init_dino(jax.random.PRNGKey(seed), jcfg, image_size=image,
                         patch_size=patch)
    return js, _as_port(js, jcfg, image, patch)


def _as_port(js, jcfg=None, image=IMAGE, patch=PATCH):
    return dino_state_from_numpy(_np_tree(js), _cfg(jcfg), image_size=image,
                                 patch_size=patch, device="cpu")


# ----------------------------------------------------------------------
# the attention backward
# ----------------------------------------------------------------------

def _kernel_inputs(bh, s, g, d, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(bh, s, g, d, generator=gen),
            torch.randn(bh, s, d, generator=gen),
            torch.randn(bh, s, d, generator=gen),
            torch.randn(bh, s, g, d, generator=gen))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("d", [16, 64])
def test_bwd_ref_matches_autograd(causal, g, d):
    q, k, v, dout = _kernel_inputs(3, 13, g, d, seed=g * d)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tref.flash_attention_ref(*leaves, causal=causal)
    out.backward(dout)
    fwd, lse = tref.flash_attention_ref(q, k, v, causal=causal,
                                        return_lse=True)
    got = tref.flash_attention_bwd_ref(q, k, v, fwd, lse, dout,
                                       causal=causal)
    for name, a, want in zip("qkv", got, leaves):
        assert a.dtype == torch.float32 and a.shape == want.shape
        torch.testing.assert_close(a, want.grad, rtol=BWD_TOL,
                                   atol=BWD_TOL, msg=name)


def _model_inputs(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv, hq)]


def _jax_vit_attention(q, k, v):
    """The reference ViT's attention (repro/features/vit.py:80-82)."""
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    probs = jax.nn.softmax(scores.astype(jnp.float32), -1)
    return jnp.einsum("bhqk,bkhd->bqhd", probs, v)


def _port_grads(q, k, v, dout, causal):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    n0 = tflash.backward_calls
    out = tops.flash_attention(*leaves, causal=causal)
    out.backward(torch.from_numpy(dout))
    assert tflash.backward_calls == n0 + 1
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("case", [
    ("vit", 2, 17, 2, 2, 16, False),
    ("vjp", 2, 16, 2, 2, 16, False),
    ("vjp", 1, 32, 4, 2, 32, True),         # GQA, causal, two chunks
    ("vjp", 2, 24, 4, 1, 64, True),         # MQA
])
def test_bwd_matches_reference(case):
    """ops.flash_attention's autograd Function (model layout, the CPU's
    plain forward and the explicit backward) against jax.vjp of the
    reference ViT's attention and of models/attention.py's custom VJP
    (chunks of 16 where S allows)."""
    kind, b, s, hq, hkv, d, causal = case
    q, k, v, dout = _model_inputs(b, s, hq, hkv, d, seed=s + hq)
    if kind == "vit":
        fn = _jax_vit_attention
    else:
        chunk = 16 if s % 16 == 0 else s

        def fn(q, k, v):
            return jflash(q, k, v, causal=causal, q_chunk=chunk,
                          kv_chunk=chunk)
    want_out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    out, got = _port_grads(q, k, v, dout, causal)
    np.testing.assert_allclose(out, np.asarray(want_out), atol=BWD_TOL,
                               rtol=BWD_TOL)
    for name, a, w in zip("qkv", got, want):
        w = np.asarray(w)
        err = np.abs(a - w).max() / np.abs(w).max()
        assert err <= BWD_TOL, (name, err)


def test_grad_off_saves_nothing():
    """Without grad (extraction, the teacher) the op is one forward call:
    no graph, no backward."""
    q, k, v, _ = _model_inputs(2, 9, 2, 2, 16, seed=1)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with torch.no_grad():
        out = tops.flash_attention(*leaves, causal=False)
    assert out.grad_fn is None and not out.requires_grad
    out = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=False)
    assert out.grad_fn is None


# ----------------------------------------------------------------------
# augment, state and step against the reference
# ----------------------------------------------------------------------

def _reference_draws(rng, n):
    """repro.features.dino.augment's draws for ``rng``, as it makes them."""
    r = jax.random.split(rng, 4)
    flip = jax.random.bernoulli(r[0], shape=(n, 1, 1, 1))
    gain = 1.0 + 0.2 * jax.random.normal(r[1], (n, 1, 1, 3))
    bias = 0.1 * jax.random.normal(r[2], (n, 1, 1, 3))
    shift = jax.random.randint(r[3], (2,), -4, 5)
    return (np.array(flip).reshape(n), np.array(gain).reshape(n, 3),
            np.array(bias).reshape(n, 3), tuple(int(s) for s in shift))


def _reference_views(rng, imgs):
    """The two views the reference's loss_fn makes for ``rng``."""
    r1, r2 = jax.random.split(rng)
    x = jnp.asarray(imgs)
    return (np.asarray(jdino.augment(r1, x)),
            np.asarray(jdino.augment(r2, x)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_augment_matches_reference(seed):
    imgs = _images(6, seed) * 1.2 - 0.1            # some values clip
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jdino.augment(rng, jnp.asarray(imgs)))
    got = tdino.apply_augment(torch.from_numpy(imgs),
                              *_reference_draws(rng, 6)).numpy()
    np.testing.assert_array_equal(got, want)


def test_augment_draws_from_the_cpu_generator():
    """One seed, one view; shifts in [-4, 4]; ``augment`` is
    ``apply_augment`` of ``augment_draws``."""
    imgs = torch.from_numpy(_images(8))
    a = tdino.augment(imgs, torch.Generator().manual_seed(3))
    b = tdino.apply_augment(imgs, *tdino.augment_draws(
        8, torch.Generator().manual_seed(3)))
    assert torch.equal(a, b)
    assert float(a.min()) >= 0 and float(a.max()) <= 1
    gen = torch.Generator().manual_seed(0)
    shifts = {tdino.augment_draws(4, gen)[3] for _ in range(200)}
    assert {s for pair in shifts for s in pair} == set(range(-4, 5))


def test_carried_state():
    js, ts = _carried()
    tree = _np_tree(js)
    train = ts.trainables()
    assert set(ts.opt_m) == set(ts.opt_v) == set(train)
    # the reference's leaves, a stacked layer leaf once a layer
    assert len(train) == 5 + 8 * _jcfg().num_layers + 2
    assert all(p.requires_grad for p in train.values())
    assert not any(p.requires_grad for p in ts.teacher.parameters())
    assert not any(w.requires_grad for w in ts.head_t.values())
    for (n, p), t in zip(ts.student.named_parameters(),
                         ts.teacher.parameters()):
        assert torch.equal(p, t), n
    for w in ("w1", "w2"):
        np.testing.assert_array_equal(ts.head_s[w].detach().numpy(),
                                      tree.head_s[w])
        assert torch.equal(ts.head_s[w], ts.head_t[w])
    np.testing.assert_array_equal(ts.student.layers[1].wv.detach().numpy(),
                                  tree.student["layers"]["attn"]["wv"][1])
    assert all(not m.any() for m in (*ts.opt_m.values(),
                                     *ts.opt_v.values()))
    assert ts.step == 0 and ts.center.shape == (256,) and not ts.center.any()
    # the port's own init gives the same names and shapes
    own = tdino.init_dino(_cfg(), image_size=IMAGE, patch_size=PATCH,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert {n: p.shape for n, p in own.trainables().items()} == {
        n: p.shape for n, p in train.items()}
    assert all(torch.equal(p, t) for p, t in zip(
        own.student.parameters(), own.teacher.parameters()))


def _lr_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach() - b.detach()).abs().max()) / LR


@pytest.mark.parametrize("case", ["small", "paper"])
def test_steps_match_reference(case):
    """Three steps from one carried state, each on the reference's own
    views of the batch; the reference's states are carried across to be
    compared by name. paper: the ViT-T's full widths and 12 layers at
    64x64 /16, a batch of 2."""
    if case == "small":
        cfg, image, patch, n = _jcfg(), IMAGE, PATCH, 8
    else:
        cfg, image, patch, n = jget_config("rapidearth-vit-t"), 64, 16, 2
    js, ts = _carried(0, cfg, image, patch)
    jstep = jax.jit(jdino.make_dino_step(cfg, image_size=image,
                                         patch_size=patch, ctx=CTX, lr=LR))
    tstep = tdino.make_dino_step(_cfg(cfg), image_size=image,
                                 patch_size=patch, lr=LR)
    imgs = _images(n, size=image)
    for i in range(3):
        rng = jax.random.PRNGKey(i)
        v1, v2 = _reference_views(rng, imgs)
        js, jm = jstep(js, jnp.asarray(imgs), rng)
        loss, center, grads = tstep.loss_and_grads(
            ts, torch.tensor(v1), torch.tensor(v2))
        want = float(jm["loss"])
        assert abs(float(loss) - want) <= LOSS_RTOL * abs(want), (i, loss,
                                                                 want)
        if i == 0:
            # the reference's first moment after step 1 is (1 - b1) g
            ref = _as_port(js, cfg, image, patch)
            assert set(grads) == set(ref.opt_m)
            for n, g in grads.items():
                w = ref.opt_m[n] / np.float32(1 - tdino.ADAM_B1)
                err = float((g - w).abs().max() / w.abs().max())
                assert err <= GRAD_TOL[case], (n, err)
        ts = tstep.update(ts, grads, center)
    ref = _as_port(js, cfg, image, patch)
    assert ts.step == ref.step == 3
    for mine, want in ((ts.student, ref.student), (ts.teacher, ref.teacher)):
        for (n, p), w in zip(mine.named_parameters(), want.parameters()):
            assert _lr_err(p, w) <= STATE_TOL_LR, n
    for mine, want in ((ts.head_s, ref.head_s), (ts.head_t, ref.head_t)):
        for w in ("w1", "w2"):
            assert _lr_err(mine[w], want[w]) <= STATE_TOL_LR, w
    for n, m in ts.opt_m.items():
        scale = float(ref.opt_m[n].abs().max())
        assert float((m - ref.opt_m[n]).abs().max()) <= GRAD_TOL[case] \
            * scale, n
    torch.testing.assert_close(ts.center, ref.center, atol=1e-6, rtol=1e-5)


# ----------------------------------------------------------------------
# the port's own training
# ----------------------------------------------------------------------

def _init(seed=0):
    return tdino.init_dino(_cfg(), image_size=IMAGE, patch_size=PATCH,
                           generator=torch.Generator().manual_seed(seed),
                           device="cpu")


def test_dino_step_trains():
    """Twin of tests/test_serve_features.py::test_dino_step_trains."""
    state = _init(0)
    step = tdino.make_dino_step(_cfg(), image_size=IMAGE, patch_size=PATCH)
    imgs = _images(8)
    t0 = next(state.teacher.parameters()).detach().clone()
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(3):
        state, m = step(state, imgs, gen)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(l) for l in losses)
    # teacher moved (EMA of student updates)
    assert not torch.allclose(next(state.teacher.parameters()), t0)
    assert state.step == 3


def test_dino_features_improve_knn_separability():
    """Twin of tests/test_serve_features.py::
    test_dino_features_improve_knn_separability: after a few DINO steps
    the features have not collapsed."""
    data = generate_patches(PatchDatasetConfig(n_patches=64, patch_size=16,
                                               seed=2))
    state = _init(1)
    step = tdino.make_dino_step(_cfg(), image_size=IMAGE, patch_size=PATCH)
    imgs = data["images"][:, :16, :16]
    gen = torch.Generator().manual_seed(10)
    for _ in range(3):
        state, _ = step(state, imgs[:16], gen)
    with torch.no_grad():
        f = extract_features(state.student, imgs).numpy()
    assert np.isfinite(f).all()
    assert f.std() > 1e-4          # not collapsed


def test_step_refuses_another_vit():
    step = tdino.make_dino_step(_cfg(), image_size=32, patch_size=PATCH)
    with pytest.raises(ValueError, match="16x16"):
        step(_init(), _images(2), torch.Generator().manual_seed(0))
    deeper = dataclasses.replace(_cfg(), name="vit-3", num_layers=3)
    step = tdino.make_dino_step(deeper, image_size=IMAGE, patch_size=PATCH)
    with pytest.raises(ValueError, match="vit-3"):
        step(_init(), _images(2), torch.Generator().manual_seed(0))


def test_init_dino_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdino.init_dino(_cfg(), image_size=IMAGE, patch_size=PATCH,
                        generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dino_state_from_numpy(_np_tree(_carried()[0]), _cfg(),
                              image_size=IMAGE, patch_size=PATCH)


def test_forward_off_the_cpu_launches_the_kernel(monkeypatch):
    """With the tensors taken for a card's (``ops._on_cpu`` false) every
    attention forward of a step, teacher's and student's, goes to the
    kernel's wrapper (stubbed by the plain version plus its counter) and
    none to ``flash_attention_ref`` itself; the student's backward runs
    once a layer and view, each on the backward kernel's wrapper (stubbed
    likewise)."""
    plain, plain_bwd = tref.flash_attention_ref, tref.flash_attention_bwd_ref
    calls = {"kernel": 0, "backward_kernel": 0}

    def kernel(q, k, v, *, causal=True, return_lse=False):
        assert not torch.is_grad_enabled()
        calls["kernel"] += 1
        return plain(q, k, v, causal=causal, return_lse=return_lse)

    def backward_kernel(q, k, v, out, lse, dout, *, causal=True):
        calls["backward_kernel"] += 1
        return plain_bwd(q, k, v, out, lse, dout, causal=causal)

    def refused(*args, **kwargs):
        raise AssertionError("flash_attention_ref called in a forward")
    monkeypatch.setattr(tops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(tflash, "flash_attention", kernel)
    monkeypatch.setattr(tflash, "flash_attention_bwd", backward_kernel)
    monkeypatch.setattr(tref, "flash_attention_ref", refused)
    monkeypatch.setattr(tflash, "backward_calls", 0)
    state = _init()
    step = tdino.make_dino_step(_cfg(), image_size=IMAGE, patch_size=PATCH)
    state, m = step(state, _images(4), torch.Generator().manual_seed(0))
    layers = _cfg().num_layers
    assert calls["kernel"] == 2 * 2 * layers       # (teacher, student) x views
    assert tflash.backward_calls == 2 * layers
    assert calls["backward_kernel"] == 2 * layers
    assert np.isfinite(float(m["loss"]))


# ----------------------------------------------------------------------
# card against CPU (on a card only)
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(python -m pytest -m gpu tests/test_torch_dino.py)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("s,hq,hkv,d", [(17, 3, 3, 64), (67, 4, 2, 32)])
def test_bwd_cuda_matches_cpu(cuda, s, hq, hkv, d):
    """The Function on the card (kernel forward and backward) against
    the CPU's (the plain versions), within the forward's f32 tolerance
    2e-4."""
    q, k, v, dout = _model_inputs(2, s, hq, hkv, d, seed=s)
    _, want = _port_grads(q, k, v, dout, causal=False)
    leaves = [torch.from_numpy(a).to(cuda).requires_grad_(True)
              for a in (q, k, v)]
    n0, b0 = tflash.launches, tflash.backward_calls
    k0 = tflash.backward_launches
    out = tops.flash_attention(*leaves, causal=False)
    out.backward(torch.from_numpy(dout).to(cuda))
    torch.cuda.synchronize()
    assert (tflash.launches, tflash.backward_calls,
            tflash.backward_launches) == (n0 + 1, b0 + 1, k0 + 1)
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.cpu().numpy(), w, atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.gpu
def test_dino_step_cuda_matches_cpu(cuda):
    """One step from one seed on the card and on the CPU, on the same
    views: loss to 1e-4 relative, each gradient to 1e-3 of its largest
    entry, the parameters after it within 2 lr (Adam's first step moves
    each by at most lr)."""
    gen = torch.Generator().manual_seed(0)
    states = [tdino.init_dino(_cfg(), image_size=IMAGE, patch_size=PATCH,
                              generator=torch.Generator().manual_seed(0),
                              device=dev) for dev in ("cpu", cuda)]
    imgs = torch.from_numpy(_images(8))
    v1, v2 = tdino.augment(imgs, gen), tdino.augment(imgs, gen)
    step = tdino.make_dino_step(_cfg(), image_size=IMAGE, patch_size=PATCH,
                                lr=LR)
    n0 = tflash.launches
    (lc, cc, gc), (lg, cg, gg) = (
        step.loss_and_grads(st, v1.to(dev), v2.to(dev))
        for st, dev in zip(states, ("cpu", cuda)))
    torch.cuda.synchronize()
    assert tflash.launches == n0 + 4 * _cfg().num_layers
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc))
    for n, g in gc.items():
        assert float((gg[n].cpu() - g).abs().max()) <= 1e-3 * float(
            g.abs().max()), n
    a = step.update(states[0], gc, cc)
    b = step.update(states[1], gg, cg)
    for p, q in zip(a.student.parameters(), b.student.parameters()):
        assert float((p.detach() - q.detach().cpu()).abs().max()) <= 2 * LR


@pytest.mark.gpu
def test_raw_entry_refuses_grad(cuda):
    """The kernel's own entry stays forward only and points to ops."""
    q, k, v, _ = (torch.from_numpy(a).to(cuda) for a in
                  _model_inputs(1, 8, 1, 1, 32, seed=0))
    qk, kk, vk = tops.kernel_layout(q.requires_grad_(True), k, v)
    with pytest.raises(NotImplementedError, match="ops.flash_attention"):
        tflash.flash_attention(qk, kk, vk)
