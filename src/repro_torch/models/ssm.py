"""Mamba2 / SSD (state-space duality) block — counterpart of
``repro.models.ssm``. [arXiv:2405.21060]

Chunked SSD for train / prefill (a loop over sequence chunks carrying
the [B, nh, hd, N] state), O(S * L) with chunk L; O(1)-state
single-token decode. ngroups = 1 (B/C shared across heads).

On a mesh (``ctx.mesh``) the parameters and states are placed by the
rules (``in_proj`` / ``out_proj`` over data and model, the state's
channels and heads over model), but the reference puts no sharding
constraint inside the block, so the port gathers what the block needs:
every parameter whole and the state whole for this rank's batch rows,
computes the block replicated over the model axis, and places the new
state back by the cache rule.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (Layout, ParallelCtx, fill_dense_,
                                       fill_normal_, from_cache, gathered,
                                       param, to_cache)


class SSMState(NamedTuple):
    conv: torch.Tensor   # [B, W-1, d_conv_ch] trailing conv inputs
    ssd: torch.Tensor    # [B, nh, hd, N]


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


class SSD(nn.Module):
    """``in_proj`` [d, 2 di + 2 N + nh] (z, x, B, C, dt), the depthwise
    ``conv_w`` [W, C] / ``conv_b``, float32 ``A_log`` / ``D`` /
    ``dt_bias`` [nh], ``norm_scale`` [di], ``out_proj`` [di, d]."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        ch = conv_channels(cfg)
        f32 = torch.float32
        self.in_proj = param((d, 2 * di + 2 * n + nh), dtype, device)
        self.conv_w = param((cfg.ssm_conv_width, ch), dtype, device)
        self.conv_b = param((ch,), dtype, device)
        self.A_log = param((nh,), f32, device)
        self.D = param((nh,), f32, device)
        self.dt_bias = param((nh,), f32, device)
        self.norm_scale = param((di,), dtype, device)
        self.out_proj = param((di, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's init: projections N(0, 1/fan_in), conv N(0,
        0.2^2), A = 1..16 (log), D = 1, dt_bias = softplus^-1(0.01),
        zero bias and norm."""
        nh = self.A_log.shape[0]
        fill_dense_(self.in_proj, generator)
        fill_normal_(self.conv_w, generator, 0.2)
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh)))
        self.D.fill_(1.0)
        self.dt_bias.copy_(torch.log(torch.expm1(torch.full((nh,), 0.01))))
        self.norm_scale.zero_()
        fill_dense_(self.out_proj, generator)


def init_ssd(cfg: ModelConfig, dtype, *, generator: torch.Generator,
             device) -> SSD:
    p = SSD(cfg, dtype, device)
    p.reset_parameters(generator)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width W: x [B, S, C], w [W, C]."""
    width = w.shape[0]
    s = x.shape[1]
    out = x * w[-1]
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[width - 1 - i]
    return out + b


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    di, n = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di: di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xbc, dt


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    var = y.to(torch.float32).square().mean(-1, keepdim=True)
    y = y.to(torch.float32) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(z.dtype)


def _ssd_forward(p: SSD, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[SSMState] = None
                ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """x: [B, S, d_model] -> (y, final state; None without a state in).
    Chunked SSD; S is padded to a chunk multiple with padded steps given
    dt = 0 (identity transition, zero input), so y[:S] and the final
    state are exact."""
    b, s, _ = x.shape
    di, n, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    L = min(cfg.ssm_chunk, s)
    s_orig = s
    if s % L:
        x = F.pad(x, (0, 0, 0, L - s % L))
        s = x.shape[1]
    nc = s // L
    valid = (torch.arange(s, device=x.device) < s_orig)[None, :, None]

    proj = x @ p.in_proj.to(x.dtype)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    if state is not None:
        w1 = state.conv.shape[1]
        full = torch.cat([state.conv, xbc], dim=1)
        xbc = _causal_conv(full, p.conv_w, p.conv_b)[:, w1:]
        # trailing W-1 *real* (unpadded) conv inputs
        new_conv = full[:, s_orig:s_orig + cfg.ssm_conv_width - 1]
    else:
        xbc = _causal_conv(xbc, p.conv_w, p.conv_b)
        new_conv = None
    xbc = F.silu(xbc.to(torch.float32))
    xs = xbc[..., :di].reshape(b, s, nh, hd)                 # [B,S,nh,hd]
    Bm = xbc[..., di: di + n]                                # [B,S,N]
    Cm = xbc[..., di + n:]                                   # [B,S,N]
    dt = F.softplus(dt_raw.to(torch.float32) + p.dt_bias)    # [B,S,nh]
    dt = dt * valid                                          # zero padding
    A = -torch.exp(p.A_log)                                  # [nh]
    a = dt * A                                               # log-decay

    xs_c = xs.reshape(b, nc, L, nh, hd)
    B_c = Bm.reshape(b, nc, L, n)
    C_c = Cm.reshape(b, nc, L, n)
    dt_c = dt.reshape(b, nc, L, nh)
    a_c = a.reshape(b, nc, L, nh)

    h = state.ssd if state is not None else torch.zeros(
        (b, nh, hd, n), dtype=torch.float32, device=x.device)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for ci in range(nc):
        xc, bc, cc = xs_c[:, ci], B_c[:, ci], C_c[:, ci]
        dtc, ac = dt_c[:, ci], a_c[:, ci]
        acum = torch.cumsum(ac, dim=1)                       # [B,L,nh]
        atot = acum[:, -1]                                   # [B,nh]
        # intra-chunk (quadratic within the chunk only)
        seg = acum[:, :, None, :] - acum[:, None, :, :]      # [B,L,L,nh]
        decay = torch.where(causal[None, :, :, None], torch.exp(seg), 0.0)
        g = torch.einsum("btn,bsn->bts", cc, bc)             # [B,L,L]
        m = g[..., None] * decay * dtc[:, None, :, :]        # [B,L,L,nh]
        y_intra = torch.einsum("btsh,bshd->bthd", m, xc)
        # inter-chunk contribution from the carried state
        y_inter = torch.einsum("btn,bhdn->bthd", cc, h) \
            * torch.exp(acum)[..., None]
        # state update
        w = torch.exp(atot[:, None, :] - acum) * dtc         # [B,L,nh]
        dh = torch.einsum("blh,blhd,bln->bhdn", w, xc, bc)
        h = h * torch.exp(atot)[:, :, None, None] + dh
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, nh, hd)
    y = y + xs * p.D[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)[:, :s_orig]
    y = _gated_norm(y, z[:, :s_orig], p.norm_scale, cfg.norm_eps)
    out = y @ p.out_proj.to(y.dtype)
    new_state = SSMState(new_conv, h) if state is not None else None
    return out, new_state


def _ssd_decode_step(p: SSD, x: torch.Tensor, cfg: ModelConfig,
                    state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """x: [B, 1, d_model], O(1) state update."""
    b = x.shape[0]
    di, n, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    proj = x @ p.in_proj.to(x.dtype)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    full = torch.cat([state.conv, xbc], dim=1)               # [B, W, C]
    conv_out = (full * p.conv_w[None]).sum(1, keepdim=True) + p.conv_b
    new_conv = full[:, 1:]
    xbc = F.silu(conv_out.to(torch.float32))                 # [B,1,C]
    xs = xbc[..., :di].reshape(b, nh, hd)
    Bm = xbc[:, 0, di: di + n]                               # [B,N]
    Cm = xbc[:, 0, di + n:]
    dt = F.softplus(dt_raw[:, 0].to(torch.float32) + p.dt_bias)  # [B,nh]
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)                                # [B,nh]
    dh = torch.einsum("bh,bhd,bn->bhdn", dt, xs, Bm)
    h = state.ssd * decay[:, :, None, None] + dh
    y = torch.einsum("bn,bhdn->bhd", Cm, h) + xs * p.D[None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = _gated_norm(y, z, p.norm_scale, cfg.norm_eps)
    return y @ p.out_proj.to(y.dtype), SSMState(new_conv, h)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype,
                   device) -> SSMState:
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_channels(cfg)),
                         dtype=dtype, device=device),
        ssd=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=device))


def _gathered(p: SSD, state, ctx: ParallelCtx):
    """The block's parameters whole, and its state whole for this rank's
    batch rows."""
    whole = gathered(p, tuple(n for n, _ in p.named_parameters()), ctx)
    if state is not None:
        state = SSMState(*(from_cache(t, ctx) for t in state))
    return whole, state


def _placed(state, ctx: ParallelCtx, lay: Layout):
    if state is None:
        return None
    return SSMState(*(to_cache(t, n, ctx, lay.b)
                    for n, t in zip(SSMState._fields, state)))


def ssd_forward(p: SSD, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[SSMState] = None,
                ctx: Optional[ParallelCtx] = None,
                lay: Optional[Layout] = None):
    """x: [B, S, d_model] -> (y, final state; None without a state in).
    On a mesh (``ctx``, ``lay``): x is this rank's batch rows, the state
    a placed one (or this rank's rows, whole)."""
    if ctx is None or ctx.mesh is None:
        return _ssd_forward(p, x, cfg, state)
    whole, state = _gathered(p, state, ctx)
    y, new = _ssd_forward(whole, x, cfg, state)
    return y, _placed(new, ctx, lay)


def ssd_decode_step(p: SSD, x: torch.Tensor, cfg: ModelConfig,
                    state: SSMState, ctx: Optional[ParallelCtx] = None,
                    lay: Optional[Layout] = None):
    """x: [B, 1, d_model]; one step of the state. On a mesh as
    ``ssd_forward``."""
    if ctx is None or ctx.mesh is None:
        return _ssd_decode_step(p, x, cfg, state)
    whole, state = _gathered(p, state, ctx)
    y, new = _ssd_decode_step(whole, x, cfg, state)
    return y, _placed(new, ctx, lay)
