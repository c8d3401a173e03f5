"""DINO-lite self-supervised training of the ViT extractor (paper §3);
counterpart of ``repro.features.dino``.

Self-distillation with no labels [Caron et al., ICCV'21], reduced as the
reference reduces it:

  * student and teacher share the architecture; the teacher is the EMA
    of the student, its head the EMA of the student's head;
  * two augmented views per image; cross-entropy between the teacher's
    centred, sharpened targets on one view and the student on the other;
  * centring (an EMA of the teacher's outputs) prevents collapse.

Every attention layer of the teacher and the student runs
``kernels.ops.flash_attention``: on the card the hand-written CUDA
kernel forward, and for the student under autograd the hand-written
backward kernel (``kernels.flash_attention.flash_attention_bwd``).
The random draws (initial weights, augmentations) come from a CPU
``torch.Generator``, so one seed gives the same state and the same views
on every device; they are not JAX's draws. ``apply_augment`` takes the
draws as arguments, so the reference's own draws can be fed to it.

The step updates the state in place (Adam, the EMAs, the centre, all
without grad on the state's device) and returns it.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.features.vit import ViT, extract_features, init_vit
from repro_torch.models.common import dense_init, gelu

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass
class DinoState:
    """The reference's ``DinoState``: the student ViT (parameters require
    grad), the teacher ViT (no grad), the heads {w1, w2}, the centre
    [proj_dim], Adam's moments keyed by the names ``trainables`` gives,
    and the number of steps taken."""
    student: ViT
    teacher: ViT
    head_s: Dict[str, torch.Tensor]
    head_t: Dict[str, torch.Tensor]
    center: torch.Tensor
    opt_m: Dict[str, torch.Tensor]
    opt_v: Dict[str, torch.Tensor]
    step: int

    def trainables(self) -> Dict[str, torch.Tensor]:
        """What Adam updates, the reference's pytree (student, head_s):
        ``student.<ViT parameter name>`` and ``head_s.w1``, ``head_s.w2``."""
        return {**{f"student.{n}": p
                   for n, p in self.student.named_parameters()},
                **{f"head_s.{n}": p for n, p in self.head_s.items()}}


def _init_head(generator: torch.Generator, in_dim: int, proj_dim: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    return {"w1": dense_init(generator, (in_dim, in_dim)).to(device),
            "w2": dense_init(generator, (in_dim, proj_dim)).to(device)}


def _head(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """gelu(x @ w1) @ w2, each row divided by (its L2 norm + 1e-6)."""
    h = gelu(x @ p["w1"]) @ p["w2"]
    return h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-6)


def init_dino(cfg: ModelConfig, *, image_size: int, patch_size: int,
              proj_dim: int = 256, generator: torch.Generator,
              device=None) -> DinoState:
    """The student by ``init_vit`` and then its head, both drawn on the
    CPU from ``generator``; the teacher and its head copies of them; the
    centre and the moments zero. ``device=None`` means CUDA (and raises
    without it)."""
    student = init_vit(cfg, image_size=image_size, patch_size=patch_size,
                       generator=generator, device=device)
    head_s = _init_head(generator, 2 * cfg.d_model, proj_dim,
                        student.device)
    teacher = copy.deepcopy(student)
    head_t = {k: w.clone() for k, w in head_s.items()}
    student.requires_grad_(True)
    for w in head_s.values():
        w.requires_grad_(True)
    state = DinoState(student, teacher, head_s, head_t,
                      torch.zeros(proj_dim, dtype=torch.float32,
                                  device=student.device), {}, {}, 0)
    train = state.trainables()
    state.opt_m = {n: torch.zeros_like(p) for n, p in train.items()}
    state.opt_v = {n: torch.zeros_like(p) for n, p in train.items()}
    return state


def augment_draws(n: int, generator: torch.Generator):
    """The draws of one view of ``n`` images, on the CPU: a flip per image
    [n] bool, a gain 1 + 0.2 N(0, 1) and a bias 0.1 N(0, 1) per image and
    channel [n, 3], and one roll shift per batch, two ints in [-4, 4]."""
    flip = torch.rand(n, generator=generator) < 0.5
    gain = 1.0 + 0.2 * torch.randn(n, 3, generator=generator)
    bias = 0.1 * torch.randn(n, 3, generator=generator)
    shift = torch.randint(-4, 5, (2,), generator=generator)
    return flip, gain, bias, (int(shift[0]), int(shift[1]))


def apply_augment(images: torch.Tensor, flip, gain, bias,
                  shift) -> torch.Tensor:
    """The reference's ``augment`` given its draws: images [B, H, W, 3]
    flipped over the width where ``flip`` [B], times ``gain`` [B, 3] plus
    ``bias`` [B, 3], rolled by ``shift`` (rows, columns), clipped to
    [0, 1]."""
    dev = images.device
    flip = torch.as_tensor(flip, device=dev).reshape(-1, 1, 1, 1)
    gain = torch.as_tensor(gain, dtype=torch.float32, device=dev)
    bias = torch.as_tensor(bias, dtype=torch.float32, device=dev)
    x = torch.where(flip, images.flip(2), images)
    x = x * gain.reshape(-1, 1, 1, 3) + bias.reshape(-1, 1, 1, 3)
    x = torch.roll(x, shifts=(int(shift[0]), int(shift[1])), dims=(1, 2))
    return x.clamp(0.0, 1.0)


def augment(images: torch.Tensor, generator: torch.Generator
            ) -> torch.Tensor:
    """One stochastic view: flips, brightness / channel jitter and a
    roll-crop, drawn on the CPU from ``generator``."""
    return apply_augment(images, *augment_draws(images.shape[0], generator))


def adam_scale(step: int) -> float:
    """sqrt(1 - b2^step) / (1 - b1^step), in float32 as the reference
    takes it."""
    s = np.float32(step)
    return float(np.sqrt(np.float32(1) - np.float32(ADAM_B2) ** s)
                 / (np.float32(1) - np.float32(ADAM_B1) ** s))


class DinoStep:
    """The reference's ``dino_step``: ``step(state, images, generator)``
    takes two views of ``images`` and one training step; ``on_views``
    takes the step on two given views; ``loss_and_grads`` and ``update``
    are its two halves."""

    def __init__(self, cfg: ModelConfig, *, image_size: int,
                 patch_size: int, lr: float = 1e-3,
                 teacher_temp: float = 0.04, student_temp: float = 0.1,
                 ema: float = 0.996, center_ema: float = 0.9):
        self.cfg = cfg
        self.image_size, self.patch_size = int(image_size), int(patch_size)
        self.lr, self.ema, self.center_ema = lr, ema, center_ema
        self.teacher_temp, self.student_temp = teacher_temp, student_temp

    def _check(self, state: DinoState) -> None:
        """The state's ViT must be the one this step was made for."""
        s = state.student
        if (s.image_size, s.patch_size) != (self.image_size,
                                            self.patch_size):
            raise ValueError(f"the state's ViT is for {s.image_size}x"
                             f"{s.image_size} at /{s.patch_size}, the step "
                             f"for {self.image_size}x{self.image_size} at "
                             f"/{self.patch_size}")
        if s.cfg != self.cfg:
            raise ValueError(f"the state's ViT is {s.cfg.name}, the step "
                             f"was made for {self.cfg.name}")

    def _ce(self, t, s, center) -> torch.Tensor:
        pt = torch.softmax((t - center) / self.teacher_temp, dim=-1)
        ls = torch.log_softmax(s / self.student_temp, dim=-1)
        return -(pt * ls).sum(-1).mean()

    def loss_and_grads(self, state: DinoState, v1: torch.Tensor,
                       v2: torch.Tensor):
        """(loss, batch centre [proj_dim], {trainable name: gradient}) of
        the step on views v1, v2; the state is not changed."""
        self._check(state)
        names, params = zip(*state.trainables().items())
        with torch.no_grad():
            t1 = _head(state.head_t, extract_features(state.teacher, v1))
            t2 = _head(state.head_t, extract_features(state.teacher, v2))
        s1 = _head(state.head_s, extract_features(state.student, v1))
        s2 = _head(state.head_s, extract_features(state.student, v2))
        loss = 0.5 * (self._ce(t1, s2, state.center)
                      + self._ce(t2, s1, state.center))
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), (t1 + t2).mean(0) / 2.0, dict(zip(names,
                                                                grads))

    @torch.no_grad()
    def update(self, state: DinoState, grads: Dict[str, torch.Tensor],
               batch_center: torch.Tensor) -> DinoState:
        """Adam on the trainables in the reference's operation order, then
        the teacher's and its head's EMA and the centre's, in place."""
        names = list(grads)
        train = state.trainables()
        params = [train[n] for n in names]
        g = [grads[n] for n in names]
        m = [state.opt_m[n] for n in names]
        v = [state.opt_v[n] for n in names]
        step = state.step + 1
        torch._foreach_mul_(m, ADAM_B1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - ADAM_B1))
        torch._foreach_mul_(v, ADAM_B2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, 1 - ADAM_B2), g))
        # p - lr * sc * m / (sqrt(v) + eps), lr * sc in float32
        step_size = float(np.float32(self.lr) * np.float32(adam_scale(step)))
        den = torch._foreach_add(torch._foreach_sqrt(v), ADAM_EPS)
        torch._foreach_sub_(params, torch._foreach_div(
            torch._foreach_mul(m, step_size), den))
        for t, s in ((list(state.teacher.parameters()),
                      list(state.student.parameters())),
                     ([state.head_t[k] for k in ("w1", "w2")],
                      [state.head_s[k] for k in ("w1", "w2")])):
            torch._foreach_mul_(t, self.ema)
            torch._foreach_add_(t, torch._foreach_mul(s, 1 - self.ema))
        state.center.mul_(self.center_ema).add_(
            (1 - self.center_ema) * batch_center)
        state.step = step
        return state

    def on_views(self, state: DinoState, v1: torch.Tensor,
                 v2: torch.Tensor) -> Tuple[DinoState, Dict]:
        """One step on the given views -> (state, {"loss": 0-d tensor})."""
        loss, batch_center, grads = self.loss_and_grads(state, v1, v2)
        return self.update(state, grads, batch_center), {"loss": loss}

    def __call__(self, state: DinoState, images, generator: torch.Generator
                 ) -> Tuple[DinoState, Dict]:
        """Two views of ``images`` (uploaded to the state's device; the
        draws from ``generator`` on the CPU), then one step."""
        x = torch.as_tensor(images, dtype=torch.float32,
                            device=state.student.device)
        return self.on_views(state, augment(x, generator),
                             augment(x, generator))


def make_dino_step(cfg: ModelConfig, *, image_size: int, patch_size: int,
                   lr: float = 1e-3, teacher_temp: float = 0.04,
                   student_temp: float = 0.1, ema: float = 0.996,
                   center_ema: float = 0.9) -> DinoStep:
    """Returns ``dino_step(state, images, generator) -> (state,
    {"loss"})``, with ``dino_step.on_views(state, v1, v2)`` beside it."""
    return DinoStep(cfg, image_size=image_size, patch_size=patch_size,
                    lr=lr, teacher_temp=teacher_temp,
                    student_temp=student_temp, ema=ema,
                    center_ema=center_ema)
