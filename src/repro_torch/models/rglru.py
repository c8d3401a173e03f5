"""RG-LRU recurrent block (Griffin / RecurrentGemma) — counterpart of
``repro.models.rglru``. [arXiv:2402.19427]

Block: y = W_out( GeLU(W_gate x) * RGLRU(conv4(W_in x)) ).
RG-LRU (diagonal linear recurrence with input and recurrence gates):

    r_t = sigmoid(W_a u_t + b_a)
    i_t = sigmoid(W_x u_t + b_x)
    log a_t = c * r_t * log sigmoid(Lambda)        (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Train / prefill solve the recurrence h = a h + b over the sequence with
an inclusive scan of the pairs (a, b) under (a1, b1) . (a2, b2) = (a1 a2,
a2 b1 + b2), as the reference's ``jax.lax.associative_scan``; the port
combines in log2(S) doubling steps (Hillis-Steele), which associates the
products in another order than the reference's tree. Decode is one step.

On a mesh (``ctx.mesh``) the parameters and states are placed by the
rules (the width over model, the input projections also over data), but
the reference puts no sharding constraint inside the block, so the port
gathers what the block needs: every parameter whole and the state whole
for this rank's batch rows, computes the block replicated over the
model axis, and places the new state back by the cache rule.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (Layout, ParallelCtx, fill_dense_,
                                       fill_normal_, fill_uniform_,
                                       from_cache, gathered, gelu, param,
                                       to_cache)

_C = 8.0


class LRUState(NamedTuple):
    conv: torch.Tensor   # [B, W-1, w] trailing conv inputs
    h: torch.Tensor      # [B, w] recurrent state


class RGLRU(nn.Module):
    """``w_in`` / ``w_gate`` [d, w], the width-4 ``conv_w`` / ``conv_b``,
    float32 gates ``gate_a`` / ``gate_x`` [w, w] with their biases and
    ``lam`` [w], ``out_proj`` [w, d]."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        f32 = torch.float32
        self.w_in = param((d, w), dtype, device)
        self.w_gate = param((d, w), dtype, device)
        self.conv_w = param((4, w), dtype, device)
        self.conv_b = param((w,), dtype, device)
        self.gate_a = param((w, w), f32, device)
        self.gate_a_b = param((w,), f32, device)
        self.gate_x = param((w, w), f32, device)
        self.gate_x_b = param((w,), f32, device)
        self.lam = param((w,), f32, device)
        self.out_proj = param((w, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: Lambda from u ~ U(0.9^2, 0.999^2) so that
        a^c spans ~[0.9, 0.999] (paper appendix), projections N(0,
        1/fan_in), conv N(0, 0.2^2), zero biases."""
        u = fill_uniform_(torch.empty_like(self.lam), generator,
                          0.9 ** 2, 0.999 ** 2)
        root = u ** (1.0 / _C)
        self.lam.copy_(torch.log(root / (1.0 - root)))      # sigmoid^-1
        for w in (self.w_in, self.w_gate, self.gate_a, self.gate_x,
                  self.out_proj):
            fill_dense_(w, generator)
        fill_normal_(self.conv_w, generator, 0.2)
        for b in (self.conv_b, self.gate_a_b, self.gate_x_b):
            b.zero_()


def init_rglru(cfg: ModelConfig, dtype, *, generator: torch.Generator,
               device) -> RGLRU:
    p = RGLRU(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    width = w.shape[0]
    s = x.shape[1]
    out = x * w[-1]
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[width - 1 - i]
    return out + b


def _gates(p: RGLRU, u: torch.Tensor):
    """u: [..., w] float32 -> (a, b) of the recurrence h = a h + b."""
    r = torch.sigmoid(u @ p.gate_a + p.gate_a_b)
    i = torch.sigmoid(u @ p.gate_x + p.gate_x_b)
    log_a = _C * r * F.logsigmoid(p.lam)                     # <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * u)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t from h = 0 along dim 1:
    (prod_{s<=t} a_s, h_t), by doubling steps."""
    s = a.shape[1]
    step = 1
    while step < s:
        a_prev = F.pad(a, (0, 0, step, 0), value=1.0)[:, :s]
        b_prev = F.pad(b, (0, 0, step, 0))[:, :s]
        b = a * b_prev + b
        a = a_prev * a
        step *= 2
    return a, b


def _rglru_forward(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[LRUState] = None
                  ) -> Tuple[torch.Tensor, Optional[LRUState]]:
    """x: [B, S, d] -> (y [B, S, d], final state; None without a state
    in)."""
    gate = gelu(x @ p.w_gate.to(x.dtype))
    u = x @ p.w_in.to(x.dtype)
    if state is not None:
        w1 = state.conv.shape[1]
        full = torch.cat([state.conv.to(u.dtype), u], dim=1)
        u = _causal_conv(full, p.conv_w, p.conv_b)[:, w1:]
        new_conv = full[:, -(p.conv_w.shape[0] - 1):]
    else:
        u = _causal_conv(u, p.conv_w, p.conv_b)
        new_conv = None
    u = u.to(torch.float32)
    a, b = _gates(p, u)                                      # [B,S,w]
    a_pref, h = linear_scan(a, b)
    if state is not None:
        h = h + a_pref * state.h[:, None, :].to(torch.float32)
    y = (h.to(x.dtype) * gate) @ p.out_proj.to(x.dtype)
    new_state = LRUState(new_conv, h[:, -1]) if state is not None else None
    return y, new_state


def _rglru_decode_step(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                      state: LRUState) -> Tuple[torch.Tensor, LRUState]:
    """x: [B, 1, d]."""
    gate = gelu(x @ p.w_gate.to(x.dtype))
    u = x @ p.w_in.to(x.dtype)                               # [B,1,w]
    full = torch.cat([state.conv.to(u.dtype), u], dim=1)     # [B,W,w]
    u = (full * p.conv_w[None]).sum(1, keepdim=True) + p.conv_b
    new_conv = full[:, 1:]
    u = u.to(torch.float32)
    a, b = _gates(p, u)
    h = a[:, 0] * state.h.to(torch.float32) + b[:, 0]        # [B,w]
    y = (h[:, None].to(x.dtype) * gate) @ p.out_proj.to(x.dtype)
    return y, LRUState(new_conv, h)


def init_lru_state(cfg: ModelConfig, batch: int, dtype,
                   device) -> LRUState:
    w = cfg.lru_width or cfg.d_model
    return LRUState(
        conv=torch.zeros((batch, 3, w), dtype=dtype, device=device),
        h=torch.zeros((batch, w), dtype=torch.float32, device=device))


def _gathered(p: RGLRU, state, ctx: ParallelCtx):
    """The block's parameters whole, and its state whole for this rank's
    batch rows."""
    whole = gathered(p, tuple(n for n, _ in p.named_parameters()), ctx)
    if state is not None:
        state = LRUState(*(from_cache(t, ctx) for t in state))
    return whole, state


def _placed(state, ctx: ParallelCtx, lay: Layout):
    if state is None:
        return None
    return LRUState(*(to_cache(t, n, ctx, lay.b)
                    for n, t in zip(LRUState._fields, state)))


def rglru_forward(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[LRUState] = None,
                  ctx: Optional[ParallelCtx] = None,
                  lay: Optional[Layout] = None):
    """x: [B, S, d_model] -> (y, final state; None without a state in).
    On a mesh (``ctx``, ``lay``): x is this rank's batch rows, the state
    a placed one (or this rank's rows, whole)."""
    if ctx is None or ctx.mesh is None:
        return _rglru_forward(p, x, cfg, state)
    whole, state = _gathered(p, state, ctx)
    y, new = _rglru_forward(whole, x, cfg, state)
    return y, _placed(new, ctx, lay)


def rglru_decode_step(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                      state: LRUState, ctx: Optional[ParallelCtx] = None,
                      lay: Optional[Layout] = None):
    """x: [B, 1, d_model]; one step of the state. On a mesh as
    ``rglru_forward``."""
    if ctx is None or ctx.mesh is None:
        return _rglru_decode_step(p, x, cfg, state)
    whole, state = _gathered(p, state, ctx)
    y, new = _rglru_decode_step(whole, x, cfg, state)
    return y, _placed(new, ctx, lay)
