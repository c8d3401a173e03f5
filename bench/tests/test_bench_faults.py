"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run
(``bench.run.run_cell``) at a tiny size on the CPU, with the cell's own
limits, once sound and once for each fault the cell can have: an answer
altered where it is produced, half of the batch left out (the mean over
the rest), a step that returns its state unchanged. No cell runs across
chips, so none has an exchange between chips to leave out."""
from __future__ import annotations

import pytest
import torch

from bench import run as bench_run

from conftest import tiny_ctx


def drive(cell: str, hooks=None, seed: int = 2_200_000_017):
    bm, parts, ctx = tiny_ctx(cell, seed=seed, hooks=hooks)
    code, out = bench_run.run_cell(bm, parts, ctx, "cpu", 1)
    assert code == 0
    return out


def altered_answer(fn):
    """One feature of the first patch of every batch altered."""
    def broken(images):
        f = fn(images).clone()
        f[0, 0] += 0.05 * f[0].abs().max()
        return f
    return broken


def half_batch_features(fn):
    """Features of the first half of the batch only; the second half
    given their mean."""
    def broken(images):
        h = images.shape[0] // 2
        f = fn(images[:h])
        return torch.cat([f, f.mean(0, keepdim=True).expand(
            images.shape[0] - h, -1)])
    return broken


def state_unchanged(step_fn):
    """The step's forward and backward, and the state handed back as it
    came."""
    def broken(state, batch, generator=None):
        metrics, _ = step_fn.loss_and_grads(state, batch, generator)
        metrics["loss"] = metrics["ce_loss"]
        return state, metrics
    return broken


def half_batch_step(step_fn):
    """The step on the first half of the batch's rows: the mean over the
    rest."""
    def broken(state, batch, generator=None):
        h = batch["inputs"].shape[0] // 2
        return step_fn(state, {k: v[:h] for k, v in batch.items()},
                       generator)
    return broken


def test_embed_sound_run_is_correct():
    out = drive("vit_t.embed_400")
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"


def test_embed_altered_answer_is_not_correct():
    out = drive("vit_t.embed_400", {"feature_fn": altered_answer})
    assert out["correct"] is False


def test_embed_half_batch_is_not_correct():
    out = drive("vit_t.embed_400", {"feature_fn": half_batch_features})
    assert out["correct"] is False


@pytest.mark.parametrize("cell", ["internlm2.train_4k",
                                  "internlm2.train_32k"])
def test_train_sound_run_is_correct(cell):
    out = drive(cell)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(tiny_ctx(cell)[2].traffic["limits"])


def test_train_state_unchanged_is_not_correct():
    out = drive("internlm2.train_4k", {"step_fn": state_unchanged})
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == 1.0


def test_train_half_batch_is_not_correct():
    out = drive("internlm2.train_4k", {"step_fn": half_batch_step})
    assert out["correct"] is False


def test_train_32k_state_unchanged_is_not_correct():
    out = drive("internlm2.train_32k", {"step_fn": state_unchanged})
    assert out["correct"] is False
