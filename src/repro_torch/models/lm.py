"""Unified causal LM covering every assigned architecture family —
counterpart of ``repro.models.lm``, its serving half.

The layer stack is ``cfg.layer_kinds()``: ``pattern * num_blocks +
tail`` of ``ModelConfig.scan_pattern``, held as one flat
``nn.ModuleList`` in layer order (layer i is block i // len(pattern),
slot i % len(pattern) of the reference's scanned ``blocks``, then the
``tail``). Each layer is one of the kinds:

    AD  attention + dense MLP          (granite/nemotron/internlm2/llama3/
                                        llava backbone/musicgen)
    AM  attention + MoE MLP            (qwen3, llama4 odd layers)
    AL  local sliding-window attention (recurrentgemma every 3rd layer)
    S   Mamba2 SSD block               (mamba2)
    R   RG-LRU recurrent block + MLP   (recurrentgemma)

Entry points:
    init_params(cfg, *, generator, device)        -> LM
    prefill(model, inputs, serve)                 -> (last_logits, caches)
    decode_step(model, caches, token, pos, serve) -> (logits, caches)

Caches are a list, one entry a layer: {"k", "v"} for attention,
``SSMState`` for S, ``LRUState`` for R. Attention layers whose sequence
exceeds ``FLASH_THRESHOLD`` run ``attention.flash_attention``, the CUDA
flash kernel on the card. Training (``forward_train``, the chunked
loss) is ROADMAP A13b; the mesh (``ParallelCtx``'s modes) A13c.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (apply_rope, fill_dense_,
                                       fill_normal_, param, rms_norm,
                                       torch_dtype)
from repro_torch.models.mlp import MLP, mlp
from repro_torch.models.moe import MoE, moe_mlp
from repro_torch.models.rglru import (LRUState, RGLRU, init_lru_state,
                                      rglru_decode_step, rglru_forward)
from repro_torch.models.ssm import (SSD, SSMState, init_ssm_state,
                                    ssd_decode_step, ssd_forward)

FLASH_THRESHOLD = 2048     # flash attention above this sequence length

Cache = Union[Dict[str, torch.Tensor], SSMState, LRUState]


# ======================================================================
# parameters
# ======================================================================

class Attention(nn.Module):
    """``wq`` [d, q_dim], ``wk`` / ``wv`` [d, kv_dim], ``wo`` [q_dim, d]."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.wq = param((d, cfg.q_dim), dtype, device)
        self.wk = param((d, cfg.kv_dim), dtype, device)
        self.wv = param((d, cfg.kv_dim), dtype, device)
        self.wo = param((cfg.q_dim, d), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            fill_dense_(w, generator)


class Layer(nn.Module):
    """One layer of kind ``kind``: ``norm1`` and its mixer (``attn``,
    ``ssd`` or ``rec``), and but for S ``norm2`` and its MLP (``mlp`` or
    ``moe``) — the reference's per-layer tree, key for key."""

    def __init__(self, kind: str, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.kind = kind
        d = cfg.d_model
        self.norm1 = param((d,), dtype, device)
        if kind == "S":
            self.ssd = SSD(cfg, dtype, device)
            return
        self.norm2 = param((d,), dtype, device)
        if kind == "R":
            self.rec = RGLRU(cfg, dtype, device)
            self.mlp = MLP(d, cfg.d_ff, cfg.mlp_gated, dtype, device)
            return
        self.attn = Attention(cfg, dtype, device)
        if kind == "AM":
            self.moe = MoE(d, cfg.d_ff, cfg.num_experts,
                           cfg.num_shared_experts, cfg.mlp_gated, dtype,
                           device)
        else:                                            # AD / AL
            self.mlp = MLP(d, cfg.d_ff, cfg.mlp_gated, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Norms zero, every submodule its own init."""
        for name, p in self.named_parameters(recurse=False):
            p.zero_()
        for m in self.children():
            m.reset_parameters(generator)


class LM(nn.Module):
    """The whole model: ``embed`` [padded_vocab, d], ``layers``,
    ``final_norm`` and, untied, ``unembed`` [d, padded_vocab], in
    ``cfg.param_dtype`` (the MoE router, SSD's A/D/dt and RG-LRU's gates
    in float32, as the reference). Parameters start uninitialised:
    ``init_params`` draws them, ``core.convert.lm_from_numpy`` carries a
    reference tree across. ``device=None`` means CUDA."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.param_dtype)
        self.cfg = cfg
        d = cfg.d_model
        self.embed = param((cfg.padded_vocab, d), dtype, dev) \
            if cfg.vocab_size else None
        self.final_norm = param((d,), dtype, dev)
        self.unembed = param((d, cfg.padded_vocab), dtype, dev) \
            if cfg.vocab_size and not cfg.tie_embeddings else None
        self.layers = nn.ModuleList(Layer(kind, cfg, dtype, dev)
                                    for kind in cfg.layer_kinds())

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """embed N(0, 1) (scaled by d^-0.5 where the config scales the
        embedding), unembed N(0, 1/d), final norm zero, every layer its
        own init."""
        cfg = self.cfg
        if self.embed is not None:
            fill_normal_(self.embed, generator,
                         cfg.d_model ** -0.5 if cfg.scale_embed else 1.0)
        if self.unembed is not None:
            fill_dense_(self.unembed, generator)
        self.final_norm.zero_()
        for layer in self.layers:
            layer.reset_parameters(generator)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None) -> LM:
    """An LM with the reference's initial distributions, drawn from
    ``generator`` on its own device in float32 chunks of at most
    ``common.DRAW_CHUNK_ELEMS`` and cast to the parameter dtype, so a
    full-width model on the card is drawn there by a CUDA generator
    without a full-size float32 transient. The draws are not JAX's: for
    the reference's weights use ``core.convert.lm_from_numpy``."""
    model = LM(cfg, device=device)
    model.reset_parameters(generator)
    return model


# ======================================================================
# layer application
# ======================================================================

def _attn_apply(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                kind: str, mode: str, positions: torch.Tensor, cache=None,
                pos: Optional[int] = None, cache_dtype=torch.bfloat16):
    """Returns (out, new_cache or None). x: [B, S, d].

    decode: the new token's k/v are written into the caches in place, at
    ``pos`` (a Python int, clamped to the last slot as
    ``lax.dynamic_update_slice`` clamps: without ``pad_caches``, position
    S overwrites slot S - 1), or at ``pos % window`` in a local layer's
    ring; the caches are returned. prefill: the caches are k/v in
    ``cache_dtype``; a local layer keeps the trailing window in ring
    layout (slot = p % W; a short prompt right-padded to W)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    cdt = torch_dtype(cfg.compute_dtype)
    q = (x @ p.wq.to(cdt)).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p.wk.to(cdt)).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p.wv.to(cdt)).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    window = cfg.local_window if kind == "AL" else 0
    new_cache = None
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs the layer's cache")
        kc, vc = cache["k"], cache["v"]
        if window:
            slot = pos % window                  # ring buffer of size W
            valid_to = window - 1 if pos >= window else pos
        else:
            slot = min(pos, kc.shape[1] - 1)
            valid_to = pos
        kc[:, slot] = k[:, 0].to(kc.dtype)
        vc[:, slot] = v[:, 0].to(vc.dtype)
        out = attn_mod.decode_attention(q, kc, vc, valid_to)
        new_cache = {"k": kc, "v": vc}
    else:
        if window:
            out = attn_mod.local_attention(q, k, v, window=window)
        elif s > FLASH_THRESHOLD:
            out = attn_mod.flash_attention(q, k, v, causal=True)
        else:
            out = attn_mod.full_attention(q, k, v, causal=True)
        if mode == "prefill":
            if window:
                if s < window:
                    # short prompt: token p sits at slot p; right-pad to W
                    pad = window - s
                    wk = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
                    wv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
                    wk, wv = wk.to(cache_dtype), wv.to(cache_dtype)
                else:
                    shift = s % window
                    wk = torch.roll(k[:, -window:].to(cache_dtype), shift, 1)
                    wv = torch.roll(v[:, -window:].to(cache_dtype), shift, 1)
                new_cache = {"k": wk, "v": wv}
            else:
                new_cache = {"k": k.to(cache_dtype), "v": v.to(cache_dtype)}
    out = out.reshape(b, out.shape[1], cfg.q_dim)
    return out @ p.wo.to(cdt), new_cache


def _apply_layer(layer: Layer, x: torch.Tensor, cfg: ModelConfig, *,
                 mode: str, positions: torch.Tensor, cache=None,
                 pos: Optional[int] = None, rng=None,
                 cache_dtype=torch.bfloat16):
    """One layer. Returns (x, new_cache, aux)."""
    aux = {"load_balance": 0.0, "router_z": 0.0}
    eps = cfg.norm_eps
    kind = layer.kind

    if kind == "S":
        h = rms_norm(x, layer.norm1, eps)
        if mode == "decode":
            y, new_cache = ssd_decode_step(layer.ssd, h, cfg, cache)
        else:
            st = cache if cache is not None else (
                init_ssm_state(cfg, x.shape[0], x.dtype, x.device)
                if mode == "prefill" else None)
            y, new_cache = ssd_forward(layer.ssd, h, cfg, st)
        return x + y, new_cache, aux

    if kind == "R":
        h = rms_norm(x, layer.norm1, eps)
        if mode == "decode":
            y, new_cache = rglru_decode_step(layer.rec, h, cfg, cache)
        else:
            st = cache if cache is not None else (
                init_lru_state(cfg, x.shape[0], x.dtype, x.device)
                if mode == "prefill" else None)
            y, new_cache = rglru_forward(layer.rec, h, cfg, st)
        x = x + y
        h = rms_norm(x, layer.norm2, eps)
        return x + mlp(layer.mlp, h, cfg.mlp_activation), new_cache, aux

    # attention kinds
    h = rms_norm(x, layer.norm1, eps)
    y, new_cache = _attn_apply(layer.attn, h, cfg, kind=kind, mode=mode,
                               positions=positions, cache=cache, pos=pos,
                               cache_dtype=cache_dtype)
    x = x + y
    h = rms_norm(x, layer.norm2, eps)
    if kind == "AM":
        y, aux = moe_mlp(layer.moe, h, experts_per_token=cfg.experts_per_token,
                         act_name=cfg.mlp_activation,
                         capacity_factor=cfg.moe_capacity_factor,
                         router_jitter=cfg.router_jitter, rng=rng)
    else:
        y = mlp(layer.mlp, h, cfg.mlp_activation)
    return x + y, new_cache, aux


# ======================================================================
# embedding / head
# ======================================================================

def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-np.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[:, None].to(torch.float32) * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_inputs(model: LM, inputs: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Token ids [B, S] (or, for ``input_mode == "embeddings"``, float
    embeddings [B, S, d]) -> the first layer's input in the compute
    dtype: the embedding rows, scaled by sqrt(d) (rounded to the compute
    dtype) where the config scales, plus the sinusoidal table for
    ``pos_embed == "sinusoidal"``."""
    cfg = model.cfg
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.input_mode == "embeddings" and inputs.dtype in (
            torch.float32, torch.bfloat16):
        x = inputs.to(cdt)
    else:
        x = torch.nn.functional.embedding(inputs.long(), model.embed).to(cdt)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt)
    if cfg.pos_embed == "sinusoidal":
        pe = _sinusoidal(positions, cfg.d_model).to(cdt)
        x = x + (pe[None] if pe.dim() == 2 else pe)
    return x


def unembed(model: LM, x: torch.Tensor) -> torch.Tensor:
    """[..., d] -> logits [..., padded_vocab] in the compute dtype (the
    pad columns are not masked)."""
    cdt = torch_dtype(model.cfg.compute_dtype)
    w = model.embed.T if model.cfg.tie_embeddings else model.unembed
    return x @ w.to(cdt)


# ======================================================================
# stack
# ======================================================================

def _stack_forward(model: LM, x: torch.Tensor, *, mode: str,
                   positions: torch.Tensor,
                   caches: Optional[List[Cache]] = None,
                   pos: Optional[int] = None, rng=None,
                   cache_dtype=torch.bfloat16):
    """Run the full layer stack, ``mode`` one of train / prefill / decode.
    Returns (x after the final norm, new caches (prefill / decode) or
    None, aux sums)."""
    cfg = model.cfg
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    lb, zz = 0.0, 0.0
    new_caches = [] if mode in ("prefill", "decode") else None
    for i, layer in enumerate(model.layers):
        c = caches[i] if caches is not None else None
        x, nc, aux = _apply_layer(layer, x, cfg, mode=mode,
                                  positions=positions, cache=c, pos=pos,
                                  rng=rng, cache_dtype=cache_dtype)
        lb = lb + aux["load_balance"]
        zz = zz + aux["router_z"]
        if new_caches is not None:
            new_caches.append(nc)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x, new_caches, {"load_balance": lb, "router_z": zz}


def _as_input(model: LM, inputs) -> torch.Tensor:
    if isinstance(inputs, torch.Tensor):
        return inputs.to(model.device)
    return torch.from_numpy(np.ascontiguousarray(inputs)).to(model.device)


@torch.no_grad()
def prefill(model: LM, inputs, serve: ServeConfig = ServeConfig()):
    """inputs: token ids [B, S] (or embeddings [B, S, d]), a tensor or a
    numpy array. Returns (logits [B, 1, padded_vocab] of the last
    position, caches sized to the prompt in ``serve.cache_dtype``)."""
    inputs = _as_input(model, inputs)
    s = inputs.shape[1]
    positions = torch.arange(s, device=model.device)
    x = embed_inputs(model, inputs, positions)
    x, caches, _ = _stack_forward(
        model, x, mode="prefill", positions=positions,
        cache_dtype=torch_dtype(serve.cache_dtype))
    return unembed(model, x[:, -1:]), caches


@torch.no_grad()
def decode_step(model: LM, caches: List[Cache], token, pos: int,
                serve: ServeConfig = ServeConfig()):
    """token: [B, 1] ids (or [B, 1, d] embeddings); ``pos``: the token's
    position, a Python int (so neither the ring slot nor the mask costs a
    host sync). Returns (logits [B, 1, padded_vocab], caches); the
    attention caches are updated in place."""
    pos = int(pos)
    token = _as_input(model, token)
    positions = torch.arange(pos, pos + 1, device=model.device)
    x = embed_inputs(model, token, positions)
    x, new_caches, _ = _stack_forward(
        model, x, mode="decode", positions=positions, caches=caches,
        pos=pos, cache_dtype=torch_dtype(serve.cache_dtype))
    return unembed(model, x), new_caches


# ======================================================================
# cache init
# ======================================================================

def _layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                 cdt, device) -> Cache:
    if kind == "S":
        return init_ssm_state(cfg, batch, cdt, device)
    if kind == "R":
        return init_lru_state(cfg, batch, cdt, device)
    size = cfg.local_window if kind == "AL" else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


def pad_caches(caches: List[Cache], cfg: ModelConfig,
               max_len: int) -> List[Cache]:
    """Grow full-attention KV caches (seq axis) to ``max_len`` for decode.

    Prefill returns caches sized to the prompt; decode writes at pos >=
    S, which needs head-room. Ring-buffer (AL), SSM and LRU states are
    fixed-size and pass through untouched."""
    out = []
    for kind, c in zip(cfg.layer_kinds(), caches):
        if kind in ("S", "R", "AL") or c is None:
            out.append(c)
            continue
        out.append({name: torch.nn.functional.pad(
            a, (0, 0, 0, 0, 0, max(0, max_len - a.shape[1])))
            for name, a in c.items()})
    return out


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                serve: ServeConfig = ServeConfig(), *,
                device=None) -> List[Cache]:
    """Zero caches for every layer; ``device=None`` means CUDA."""
    dev = resolve_device(device)
    cdt = torch_dtype(serve.cache_dtype)
    return [_layer_cache(kind, cfg, batch, max_len, cdt, dev)
            for kind in cfg.layer_kinds()]
