"""The port's feature-extraction slice against the reference's.

The same seeded numpy inputs go through ``repro`` and ``repro_torch``:
``patchify`` bitwise; ``extract_features`` of the port's ViT, holding a
reference ``init_vit`` tree carried across by ``vit_from_numpy``, at a
small config and at the paper's ViT-T (atol 1e-5, rtol 1e-4: the
attention's plain version and the products sum in another order than
XLA's); the GELU (tanh, as ``jax.nn.gelu``); ``extract_catalog``'s
padded tail; the synthetic data and pipeline copies bitwise; and the
slice end to end, patches -> features -> both engines -> ``query_batch``,
ids and scores equal. Everything here runs on the CPU (``device="cpu"``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.core.engine import SearchEngine as JSearchEngine
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.features import extract as jextract
from repro.features import vit as jvit
from repro.models.common import ParallelCtx
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import SearchEngine
from repro_torch.core.convert import vit_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.features import extract as textract
from repro_torch.features import vit as tvit
from repro_torch.models.common import gelu, rms_norm

CTX = ParallelCtx()
ATOL, RTOL = 1e-5, 1e-4


def _small_cfg() -> JModelConfig:
    """tests/test_serve_features.py's ViT."""
    return JModelConfig(name="vit-test", family="vit", num_layers=2,
                        d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
                        d_ff=64, vocab_size=0, mlp_gated=False)


def _port_cfg(cfg: JModelConfig) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _pair(cfg: JModelConfig, image_size: int, patch_size: int, seed=0):
    """A reference ViT tree and the port's ViT holding the same weights."""
    params = jvit.init_vit(jax.random.PRNGKey(seed), cfg,
                           image_size=image_size, patch_size=patch_size)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = vit_from_numpy(tree, _port_cfg(cfg), image_size=image_size,
                           patch_size=patch_size, device="cpu")
    return params, model


def _images(n, size, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, size, size, 3)).astype(np.float32)


def test_patchify_bitwise():
    imgs = _images(3, 32, seed=1)
    want = np.asarray(jvit.patchify(jnp.asarray(imgs), 8))
    got = tvit.patchify(torch.from_numpy(imgs), 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_config_matches_reference():
    want = jget_config("rapidearth-vit-t")
    got = get_config("rapidearth-vit-t")
    assert _port_cfg(want) == got
    assert (got.resolved_head_dim, got.q_dim) == (want.resolved_head_dim,
                                                 want.q_dim)
    # the LM configs are ported too (tests/test_torch_lm.py holds all ten)
    assert dataclasses.asdict(get_config("llama3-8b")) == \
        dataclasses.asdict(jget_config("llama3-8b"))


@pytest.mark.parametrize("case", ["small", "paper", "paper400"])
def test_vit_features_match_reference(case):
    """paper400: the paper's own 400x400 patches at /16 (626 tokens), the
    ViT-T's widths with 2 of its 12 layers, a batch of 2."""
    if case == "small":
        cfg, image, patch, n = _small_cfg(), 16, 8, 10
    elif case == "paper":
        cfg, image, patch, n = jget_config("rapidearth-vit-t"), 64, 16, 8
    else:
        cfg = dataclasses.replace(jget_config("rapidearth-vit-t"),
                                  num_layers=2)
        image, patch, n = 400, 16, 2
    params, model = _pair(cfg, image, patch)
    imgs = _images(n, image)
    want = np.asarray(jvit.extract_features(params, jnp.asarray(imgs), cfg,
                                            CTX, patch_size=patch))
    got = tvit.extract_features(model, imgs)
    assert got.shape == (n, 2 * cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    if case != "small":
        return
    toks = np.asarray(jvit.vit_forward(params, jnp.asarray(imgs), cfg, CTX,
                                       patch_size=patch))
    np.testing.assert_allclose(tvit.vit_forward(model, imgs).numpy(), toks,
                               atol=ATOL, rtol=RTOL)


def test_gelu_is_tanh_approximation():
    """One MLP of the paper ViT on the same inputs: the port's GELU path
    matches jax.nn.gelu to 1e-6, where torch's default exact-erf GELU
    misses by more than 1e-4."""
    rng = np.random.default_rng(3)
    h = rng.normal(0, 1, (64, 192)).astype(np.float32)
    w_in = rng.normal(0, 192 ** -0.5, (192, 768)).astype(np.float32)
    w_out = rng.normal(0, 768 ** -0.5, (768, 192)).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(h) @ w_in) @ w_out)
    th, ti, to = (torch.from_numpy(a) for a in (h, w_in, w_out))
    got = (gelu(th @ ti) @ to).numpy()
    erf = (F.gelu(th @ ti) @ to).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    assert np.abs(erf - want).max() > 1e-4


def test_rms_norm_matches_reference():
    from repro.models.common import rms_norm as jrms
    rng = np.random.default_rng(5)
    x = rng.normal(0, 3, (4, 7, 24)).astype(np.float32)
    scale = rng.normal(0, 0.1, (24,)).astype(np.float32)
    want = np.asarray(jrms(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_vit_refuses_other_image_sizes():
    _, model = _pair(_small_cfg(), 16, 8)
    with pytest.raises(ValueError, match="positions"):
        model(_images(2, 24))


def test_extract_catalog_ragged_tail():
    """10 images in batches of 4: the padded tail, trimmed, equals the
    direct call, and both equal the reference's extract_catalog."""
    cfg = _small_cfg()
    params, model = _pair(cfg, 16, 8)
    imgs = _images(10, 16)
    fn = textract.vit_feature_fn(model)
    feats = textract.extract_catalog(imgs, fn, batch=4, device="cpu")
    assert feats.shape == (10, 2 * cfg.d_model) and feats.dtype == np.float32
    direct = fn(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(feats, direct, rtol=2e-5, atol=2e-5)
    want = jextract.extract_catalog(
        params, imgs, jextract.vit_feature_fn(cfg, CTX, patch_size=8),
        batch=4)
    np.testing.assert_allclose(feats, want, atol=ATOL, rtol=RTOL)


def test_extract_catalog_pads_by_repeating_last_row():
    seen = []

    def fn(x):
        seen.append(x.clone())
        return x.reshape(x.shape[0], -1)[:, :3] * 2
    x = np.arange(7 * 4, dtype=np.float32).reshape(7, 2, 2)
    out = textract.extract_catalog(x, fn, batch=3, device="cpu")
    assert [s.shape[0] for s in seen] == [3, 3, 3]
    tail = seen[-1].numpy()
    np.testing.assert_array_equal(tail, np.stack([x[6]] * 3))
    np.testing.assert_array_equal(out, x.reshape(7, -1)[:, :3] * 2)


def test_extraction_throughput_reports_rate():
    _, model = _pair(_small_cfg(), 16, 8)
    r = textract.extraction_throughput(textract.vit_feature_fn(model),
                                       _images(2, 16), batch=8, iters=2,
                                       device="cpu")
    assert r["batch"] == 8 and r["patches_per_s"] > 0


def test_lm_feature_fn_is_not_ported():
    """(Named when the LM feature head was refused.) lm_feature_fn of
    the port against the reference's at reduced internlm2, as
    tests/test_serve_features.py drives it: [3, d] features within 1e-4
    of the reference's largest, also through extract_catalog's padded
    tail."""
    from repro.configs import get_reduced_config as jreduced
    from repro.models import lm as jlm
    from repro_torch.configs import get_reduced_config
    from repro_torch.core.convert import lm_from_numpy
    jc = jreduced("internlm2-1.8b")
    params = jlm.init_params(jax.random.PRNGKey(0), jc)
    model = lm_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                          get_reduced_config("internlm2-1.8b"), device="cpu")
    toks = np.random.default_rng(0).integers(0, jc.vocab_size,
                                             (3, 16)).astype(np.int32)
    want = np.asarray(jextract.lm_feature_fn(jc, CTX)(params,
                                                      jnp.asarray(toks)))
    fn = textract.lm_feature_fn(model)
    got = fn(torch.from_numpy(toks)).numpy()
    assert got.shape == (3, jc.d_model)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol
    feats = textract.extract_catalog(toks, fn, batch=2, device="cpu")
    assert float(np.abs(feats - want).max()) <= tol


@pytest.mark.parametrize("n,size,seed", [(300, 16, 0), (64, 64, 3)])
def test_synthetic_patches_bitwise(n, size, seed):
    cfg = dict(n_patches=n, patch_size=size, seed=seed)
    want = jsyn.generate_patches(jsyn.PatchDatasetConfig(**cfg))
    got = tsyn.generate_patches(tsyn.PatchDatasetConfig(**cfg))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(
        tsyn.handcrafted_features(got["images"]),
        jsyn.handcrafted_features(want["images"]))
    assert tsyn.CLASSES == jsyn.CLASSES and tsyn.CLASS_IDS == jsyn.CLASS_IDS


def test_pipeline_sources_bitwise():
    dcfg = dict(seq_len=16, global_batch=4, vocab_size=50, seed=3)
    pcfg = dict(n_patches=40, patch_size=16, seed=1)
    jp = jpipe.PatchSource(jpipe.DataConfig(**dcfg),
                           jsyn.PatchDatasetConfig(**pcfg))
    tp = tpipe.PatchSource(tpipe.DataConfig(**dcfg),
                           tsyn.PatchDatasetConfig(**pcfg))
    jt = jpipe.TokenSource(jpipe.DataConfig(**dcfg))
    tt = tpipe.TokenSource(tpipe.DataConfig(**dcfg))
    for step in (0, 1, 7):
        for a, b in ((jp.batch(step), tp.batch(step)),
                     (jt.batch(step), tt.batch(step))):
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
    pf = tpipe.Prefetcher(tp, start_step=2)
    try:
        for step in (2, 3, 4):
            b = next(pf)
            np.testing.assert_array_equal(b["ids"], jp.batch(step)["ids"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_slice_end_to_end_matches_reference():
    """2,048 synthetic 16x16 patches -> the small ViT in both packages ->
    normalised features -> the reference and the port engines ->
    query_batch (dbranch and dbens, 15 positives of one class, 80
    negatives): ids and scores equal."""
    cfg = _small_cfg()
    data = jsyn.generate_patches(jsyn.PatchDatasetConfig(
        n_patches=2048, patch_size=16, seed=0))
    imgs, labels = data["images"], data["labels"]
    params, model = _pair(cfg, 16, 8)
    want = jextract.extract_catalog(
        params, imgs, jextract.vit_feature_fn(cfg, CTX, patch_size=8),
        batch=128)
    got = textract.extract_catalog(imgs, textract.vit_feature_fn(model),
                                   batch=128, device="cpu")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    norm = lambda f: ((f - f.mean(0)) / (f.std(0) + 1e-6)).astype(
        np.float32)
    rng = np.random.default_rng(1)
    reqs = []
    for i, c in enumerate((1, 2, 3, 4)):
        reqs.append({
            "pos_ids": rng.choice(np.nonzero(labels == c)[0], 15,
                                  replace=False),
            "neg_ids": rng.choice(np.nonzero(labels != c)[0], 80,
                                  replace=False),
            "model": ("dbranch", "dbens")[i % 2], "max_results": 50})
    kw = dict(n_subsets=8, block=64, seed=0, use_jax_fit=False)
    je = JSearchEngine(norm(want), **kw)
    te = SearchEngine(norm(got), device="cpu", **kw)
    found = 0
    for a, b in zip(je.query_batch(reqs), te.query_batch(reqs)):
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_array_equal(b.scores, a.scores)
        found += b.n_found
    assert found > 0
