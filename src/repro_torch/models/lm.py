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
    forward_train(model, inputs, targets, ...)    -> (loss, metrics)
    prefill(model, inputs, serve)                 -> (last_logits, caches)
    decode_step(model, caches, token, pos, serve) -> (logits, caches)

Caches are a list, one entry a layer: {"k", "v"} for attention,
``SSMState`` for S, ``LRUState`` for R. Attention layers whose sequence
exceeds ``FLASH_THRESHOLD`` run ``attention.flash_attention``, the CUDA
flash kernel on the card (in training its forward and, under
``kernels.ops``' autograd Function, the backward kernel).

On a mesh (``ctx``, a ``ParallelCtx`` holding a ``DeviceMesh``; one
process a mesh device) the parameters are DTensors placed by
``launch.sharding`` (``init_params(..., mesh=)``,
``core.convert.lm_from_numpy(..., mesh=)``), and prefill, decode, the
feature pass and ``forward_train`` compute on each rank's shards with
explicit collectives, the single-device result as the reference's GSPMD
gives it (in training, with the gradients of ``models.common``'s
convention: the vocab-sharded loss by ``_ce_chunk``). The
activations are this rank's batch rows (``Layout``); the attention's
mode is the reference's ``attn_parallel_mode``:

    none    no model axis (ZeRO-3 training): every weight gathered
            whole, each rank its batch rows;
    head    query heads split over `model`: each rank its heads (the
            flash kernel on them), K/V whole, ``wo`` row-parallel;
    qseq    heads the model axis does not divide: each rank its query
            rows (``flash_attention_kvscan``), K/V whole, the rows
            gathered after ``wo``;
    ctxpar  ``ServeConfig.seq_parallel`` (dense / vlm / audio): the
            residual stays split along the sequence, K/V all-gathered,
            weights whole.

The embedding reads a vocab-sharded table (each rank its rows, an all-
reduce), the logits come out sharded on vocab (a DTensor), the caches
are DTensors placed by ``sharding.cache_spec`` (KV sharded along the
sequence under ``decode_seq_parallel``, decoded by flash-decoding).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.compat import DTensor
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (Layout, ParallelCtx, all_gather,
                                       all_reduce, apply_rope, fill_dense_,
                                       fill_normal_, from_cache,
                                       gather_placed, layout, local, matmul,
                                       mshard, param, rms_norm, row_out,
                                       rows, sharded_dim, to_cache,
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
        self.mesh = None          # the DeviceMesh its DTensors lie on

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """embed N(0, 1) (scaled by d^-0.5 where the config scales the
        embedding), unembed N(0, 1/d), final norm zero, every layer its
        own init."""
        _reset_top(self.embed, self.unembed, self.final_norm, self.cfg,
                   generator)
        for layer in self.layers:
            layer.reset_parameters(generator)


@torch.no_grad()
def _reset_top(embed, unembed, final_norm, cfg: ModelConfig,
               generator: torch.Generator) -> None:
    if embed is not None:
        fill_normal_(embed, generator,
                     cfg.d_model ** -0.5 if cfg.scale_embed else 1.0)
    if unembed is not None:
        fill_dense_(unembed, generator)
    final_norm.zero_()


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None, mesh=None, mode: str = "fsdp_tp") -> LM:
    """An LM with the reference's initial distributions, drawn from
    ``generator`` on its own device in float32 chunks of at most
    ``common.DRAW_CHUNK_ELEMS`` and cast to the parameter dtype, so a
    full-width model on the card is drawn there by a CUDA generator
    without a full-size float32 transient. The draws are not JAX's: for
    the reference's weights use ``core.convert.lm_from_numpy``.

    ``mesh``: the model's parameters become this rank's shards (DTensors
    placed by ``sharding.param_spec`` in ``mode``); the same numbers as
    without a mesh, drawn a module at a time (the top tensors, then one
    layer) whole on ``device`` and cut, so no rank holds the whole
    model."""
    if mesh is None:
        model = LM(cfg, device=device)
        model.reset_parameters(generator)
        return model
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    model = LM(cfg, device="meta")
    specs = sharding.lm_param_specs(model, cfg, mesh, mode)
    top = {n: None if getattr(model, n) is None
           else torch.empty(getattr(model, n).shape, dtype=dtype, device=dev)
           for n in ("embed", "unembed", "final_norm")}
    _reset_top(top["embed"], top["unembed"], top["final_norm"], cfg,
               generator)
    for k, v in top.items():
        if v is not None:
            place_param(model, k, v, specs[k], mesh)
    del top
    for i, kind in enumerate(cfg.layer_kinds()):
        layer = Layer(kind, cfg, dtype, dev)
        layer.reset_parameters(generator)
        for k, v in layer.named_parameters():
            place_param(model, f"layers.{i}.{k}", v, specs[f"layers.{i}.{k}"],
                        mesh)
        del layer
    return model


def place_param(model: LM, name: str, full, spec, mesh, device=None,
                dtype=None) -> None:
    """Parameter ``name`` of ``model`` <- this rank's shard of ``full`` (a
    tensor or numpy array of the whole parameter) under ``spec``, a
    DTensor parameter on ``mesh`` (``device`` / ``dtype``: the shard's,
    default ``full``'s)."""
    prefix, _, leaf = name.rpartition(".")
    placed = sharding.place(full, sharding.NamedSharding(mesh, spec),
                            device=device, dtype=dtype)
    setattr(model.get_submodule(prefix), leaf,
            nn.Parameter(placed, requires_grad=False))
    model.mesh = mesh


# ======================================================================
# layer application
# ======================================================================

def attn_parallel_mode(cfg: ModelConfig, ctx: Optional[ParallelCtx]) -> str:
    """'ctxpar' when activations are sequence-sharded (serving), 'head' TP
    when query heads divide the model axis, else 'qseq' (query-sequence
    context parallelism) — covers any head count. 'none' = no model axis
    (single device, or ZeRO-3 where `model` is data-parallel)."""
    if ctx is None or ctx.mesh is None or ctx.tp_axis is None:
        return "none"
    if ctx.seq_shard_acts:
        return "ctxpar"
    return "head" if cfg.num_heads % ctx.tp_degree == 0 else "qseq"


def _attention(q, k, v, *, s: int, window: int, q_offset=None):
    """The layer's attention of q over the whole k / v (length s): the
    local band for a window layer, flash above FLASH_THRESHOLD, else the
    materialised scores. ``q_offset`` (qseq / ctxpar): q holds the rows
    from that position on, and the flash branch is
    ``flash_attention_kvscan``."""
    if q_offset is None:
        if window:
            return attn_mod.local_attention(q, k, v, window=window)
        if s > FLASH_THRESHOLD:
            return attn_mod.flash_attention(q, k, v, causal=True)
        return attn_mod.full_attention(q, k, v, causal=True)
    if window:
        return attn_mod.full_attention(q, k, v, causal=True, window=window,
                                       q_offset=q_offset)
    if s > FLASH_THRESHOLD:
        return attn_mod.flash_attention_kvscan(q, k, v, causal=True,
                                               q_offset=q_offset)
    return attn_mod.full_attention(q, k, v, causal=True, q_offset=q_offset)


def _prefill_kv(k, v, window: int, cache_dtype):
    """The prefill cache of a layer from its whole k / v [B, S, kv, hd]:
    k / v in ``cache_dtype``, or for a window layer the trailing window in
    ring layout (slot = p % W; a short prompt right-padded to W)."""
    s = k.shape[1]
    if not window:
        return k.to(cache_dtype), v.to(cache_dtype)
    if s < window:
        # short prompt: token p sits at slot p; right-pad to W
        pad = window - s
        wk = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        wv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        return wk.to(cache_dtype), wv.to(cache_dtype)
    shift = s % window
    return (torch.roll(k[:, -window:].to(cache_dtype), shift, 1),
            torch.roll(v[:, -window:].to(cache_dtype), shift, 1))


def _kv_heads(k, v, h0: int, hl: int, g: int):
    """The K/V heads query heads h0 .. h0 + hl - 1 read (g query heads a
    kv head): a run of whole kv heads (GQA) where hl is a multiple of g,
    else one kv head a query head (the reference's repeat to MHA)."""
    if hl % g == 0:
        return k[:, :, h0 // g:(h0 + hl) // g], v[:, :, h0 // g:(h0 + hl) // g]
    idx = torch.arange(h0, h0 + hl, device=k.device) // g
    return k[:, :, idx], v[:, :, idx]


def _attn_mesh(p: Attention, x: torch.Tensor, cfg: ModelConfig,
               ctx: ParallelCtx, lay: Layout, *, kind: str, mode: str,
               positions: torch.Tensor, cache=None,
               pos: Optional[int] = None, cache_dtype=torch.bfloat16):
    """``_attn_apply`` on a mesh. x: this rank's rows [b, sl, d] (sl: its
    sequence rows under ctxpar, else all). Returns (out laid out as x,
    the layer's cache: DTensors by ``sharding.cache_spec``)."""
    b, sl, _ = x.shape
    hd, nh, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    cdt = torch_dtype(cfg.compute_dtype)
    tp = ctx.tp_axis
    window = cfg.local_window if kind == "AL" else 0
    rope = (lambda t, at: apply_rope(t, at, cfg.rope_theta)) \
        if cfg.pos_embed == "rope" else (lambda t, at: t)

    if mode == "decode":
        # projections column- / row-parallel by their rules, the heads
        # whole on every rank; the cache sharded along the sequence
        q = rope(matmul(x, p.wq, ctx).reshape(b, 1, nh, hd), positions)
        k = rope(matmul(x, p.wk, ctx).reshape(b, 1, nkv, hd), positions)
        v = matmul(x, p.wv, ctx).reshape(b, 1, nkv, hd)
        kc, vc = cache["k"], cache["v"]
        length = kc.shape[1]
        if window:
            slot = pos % window                  # ring buffer of size W
            valid_to = window - 1 if pos >= window else pos
        else:
            slot = min(pos, length - 1)
            valid_to = pos
        kl, vl = local(kc), local(vc)
        off = rows(ctx, length, tp)[0] if sharded_dim(kc, tp) == 1 else None
        if 0 <= slot - (off or 0) < kl.shape[1]:
            kl[:, slot - (off or 0)] = k[:, 0].to(kl.dtype)
            vl[:, slot - (off or 0)] = v[:, 0].to(vl.dtype)
        out = attn_mod.decode_attention(q, kl, vl, valid_to, ctx=ctx,
                                        seq_offset=off)
        return matmul(out.reshape(b, 1, cfg.q_dim), p.wo, ctx), \
            {"k": kc, "v": vc}

    s = lay.s
    pmode = attn_parallel_mode(cfg, ctx)
    lo, hi = rows(ctx, s, tp)
    if pmode in ("ctxpar", "qseq"):
        wq, wk, wv, wo = (gather_placed(w, ctx).to(cdt)
                          for w in (p.wq, p.wk, p.wv, p.wo))
        xq = x if pmode == "ctxpar" else x[:, lo:hi]
        q = rope((xq @ wq).reshape(b, hi - lo, nh, hd), positions[lo:hi])
        if pmode == "ctxpar":
            # this rank's rows' K/V, all-gathered over the model axis
            k = rope((x @ wk).reshape(b, sl, nkv, hd), positions[lo:hi])
            v = (x @ wv).reshape(b, sl, nkv, hd)
            k, v = (all_gather(t, ctx, tp, 1, s) for t in (k, v))
        else:
            k = rope((x @ wk).reshape(b, s, nkv, hd), positions)
            v = (x @ wv).reshape(b, s, nkv, hd)
        out = _attention(q, k, v, s=s, window=window, q_offset=lo)
        y = out.reshape(b, hi - lo, cfg.q_dim) @ wo
        if pmode == "qseq":
            y = all_gather(y, ctx, tp, 1, s)
    else:
        # head: this rank's query heads (the flash kernel on them), K/V
        # whole, wo row-parallel
        wq = gather_placed(p.wq, ctx, keep=(tp,)).to(cdt)
        hl = wq.shape[1] // hd
        h0 = ctx.index(tp) * hl if hl < nh else 0
        q = rope((x @ wq).reshape(b, s, hl, hd), positions)
        k = rope((x @ gather_placed(p.wk, ctx).to(cdt)).reshape(
            b, s, nkv, hd), positions)
        v = (x @ gather_placed(p.wv, ctx).to(cdt)).reshape(b, s, nkv, hd)
        kr, vr = _kv_heads(k, v, h0, hl, nh // nkv)
        out = _attention(q, kr, vr, s=s, window=window)
        y = out.reshape(b, s, hl * hd)
        y = row_out(y, p.wo, ctx) if hl < nh \
            else y @ gather_placed(p.wo, ctx).to(cdt)
    new_cache = None
    if mode == "prefill":
        kc, vc = _prefill_kv(k, v, window, cache_dtype)
        new_cache = {n: to_cache(t, n, ctx, lay.b, ctx.decode_seq_parallel)
                     for n, t in (("k", kc), ("v", vc))}
    return y, new_cache


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
        out = _attention(q, k, v, s=s, window=window)
        if mode == "prefill":
            kc, vc = _prefill_kv(k, v, window, cache_dtype)
            new_cache = {"k": kc, "v": vc}
    out = out.reshape(b, out.shape[1], cfg.q_dim)
    return out @ p.wo.to(cdt), new_cache


def _apply_layer(layer: Layer, x: torch.Tensor, cfg: ModelConfig, *,
                 mode: str, positions: torch.Tensor, cache=None,
                 pos: Optional[int] = None, rng=None,
                 cache_dtype=torch.bfloat16,
                 ctx: Optional[ParallelCtx] = None,
                 lay: Optional[Layout] = None):
    """One layer. Returns (x, new_cache, aux). ``ctx`` / ``lay``: on a
    mesh, x is this rank's rows laid out as ``lay`` says."""
    aux = {"load_balance": 0.0, "router_z": 0.0}
    eps = cfg.norm_eps
    kind = layer.kind
    mesh = ctx is not None and ctx.mesh is not None
    if mesh and lay.seq_axis is not None and kind in ("S", "R", "AM"):
        raise ValueError(f"a {kind} layer runs with the sequence whole; "
                         f"context parallelism (seq_parallel) serves the "
                         f"dense, vlm and audio families")
    on = {"ctx": ctx, "lay": lay} if mesh else {}
    norm1 = local(layer.norm1)

    if kind == "S":
        h = rms_norm(x, norm1, eps)
        if mode == "decode":
            y, new_cache = ssd_decode_step(layer.ssd, h, cfg, cache, **on)
        else:
            st = cache if cache is not None else (
                init_ssm_state(cfg, x.shape[0], x.dtype, x.device)
                if mode == "prefill" else None)
            y, new_cache = ssd_forward(layer.ssd, h, cfg, st, **on)
        return x + y, new_cache, aux

    norm2 = local(layer.norm2)
    if kind == "R":
        h = rms_norm(x, norm1, eps)
        if mode == "decode":
            y, new_cache = rglru_decode_step(layer.rec, h, cfg, cache, **on)
        else:
            st = cache if cache is not None else (
                init_lru_state(cfg, x.shape[0], x.dtype, x.device)
                if mode == "prefill" else None)
            y, new_cache = rglru_forward(layer.rec, h, cfg, st, **on)
        x = x + y
        h = rms_norm(x, norm2, eps)
        return x + mlp(layer.mlp, h, cfg.mlp_activation, ctx), new_cache, \
            aux

    # attention kinds
    h = rms_norm(x, norm1, eps)
    kw = {"kind": kind, "mode": mode, "positions": positions, "cache": cache,
          "pos": pos, "cache_dtype": cache_dtype}
    y, new_cache = _attn_mesh(layer.attn, h, cfg, ctx, lay, **kw) if mesh \
        else _attn_apply(layer.attn, h, cfg, **kw)
    x = x + y
    h = rms_norm(x, norm2, eps)
    if kind == "AM":
        y, aux = moe_mlp(layer.moe, h, experts_per_token=cfg.experts_per_token,
                         act_name=cfg.mlp_activation,
                         capacity_factor=cfg.moe_capacity_factor,
                         router_jitter=cfg.router_jitter, rng=rng,
                         global_aux=mesh and mode == "train", **on)
    else:
        y = mlp(layer.mlp, h, cfg.mlp_activation, ctx,
                seq_sharded=mesh and lay.seq_axis is not None)
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


def embed_inputs(model: LM, inputs: torch.Tensor, positions: torch.Tensor,
                 ctx: Optional[ParallelCtx] = None,
                 lay: Optional[Layout] = None) -> torch.Tensor:
    """Token ids [B, S] (or, for ``input_mode == "embeddings"``, float
    embeddings [B, S, d]) -> the first layer's input in the compute
    dtype: the embedding rows, scaled by sqrt(d) (rounded to the compute
    dtype) where the config scales, plus the sinusoidal table for
    ``pos_embed == "sinusoidal"``.

    On a mesh (``ctx``, ``lay``): ``inputs`` / ``positions`` are the whole
    batch, alike on every rank, and the result this rank's rows. The
    table is sharded on vocab over the model axis: each rank looks up the
    ids in its rows (zeros elsewhere) for the whole sequence, and an
    all-reduce sums the one non-zero row a token has (then, under
    ctxpar, each rank keeps its sequence rows)."""
    cfg = model.cfg
    cdt = torch_dtype(cfg.compute_dtype)
    mesh = ctx is not None and ctx.mesh is not None
    if mesh:
        inputs = mshard(inputs, ctx, lay.bax)
        positions = mshard(positions, ctx, lay.seq_axis)
    if cfg.input_mode == "embeddings" and inputs.dtype in (
            torch.float32, torch.bfloat16):
        x = inputs.to(cdt)
    elif not mesh:
        x = torch.nn.functional.embedding(inputs.long(), model.embed).to(cdt)
    else:
        tp = ctx.tp_axis
        table = gather_placed(model.embed, ctx, keep=(tp,))
        ids = inputs.long()
        if table.shape[0] == model.embed.shape[0]:
            x = torch.nn.functional.embedding(ids, table)
        else:
            ids = ids - rows(ctx, model.embed.shape[0], tp)[0]
            mine = (ids >= 0) & (ids < table.shape[0])
            x = torch.nn.functional.embedding(
                ids.clamp(0, table.shape[0] - 1), table) * mine[..., None]
            x = all_reduce(x, ctx, tp)
        x = x.to(cdt)
    if mesh:
        x = mshard(x, ctx, None, lay.seq_axis)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt)
    if cfg.pos_embed == "sinusoidal":
        pe = _sinusoidal(positions, cfg.d_model).to(cdt)
        x = x + (pe[None] if pe.dim() == 2 else pe)
    return x


def _unembed_weight(model: LM, ctx: Optional[ParallelCtx] = None):
    """(the unembedding [d, V_local] in the parameter dtype, the vocab
    index of its first column): the whole table without a mesh; on a mesh
    this rank's vocab block where the rule shards the vocab over the model
    axis, gathered over every other axis."""
    cfg = model.cfg
    if ctx is None or ctx.mesh is None:
        return (model.embed.T if cfg.tie_embeddings else model.unembed), 0
    keep = (ctx.tp_axis,)
    w = gather_placed(model.embed, ctx, keep).T if cfg.tie_embeddings \
        else gather_placed(model.unembed, ctx, keep)
    v0 = 0 if w.shape[1] == cfg.padded_vocab \
        else rows(ctx, cfg.padded_vocab, ctx.tp_axis)[0]
    return w, v0


def unembed(model: LM, x: torch.Tensor,
            ctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """[..., d] -> logits [..., padded_vocab] in the compute dtype (the
    pad columns are not masked). On a mesh: this rank's block of the
    vocab where the rule shards it over the model axis."""
    cdt = torch_dtype(model.cfg.compute_dtype)
    return x @ _unembed_weight(model, ctx)[0].to(cdt)


def _logits(model: LM, x: torch.Tensor, ctx: ParallelCtx,
            lay: Layout) -> DTensor:
    """The logits of this rank's rows ``x`` [b, s, d] as a DTensor of
    [B, s, padded_vocab], sharded as the reference's ``mshard(logits,
    dp, None, model)`` places them: batch over ``lay.bax``, vocab over the
    model axis where the table is so sharded."""
    table = model.embed if model.cfg.tie_embeddings else model.unembed
    vdim = 0 if model.cfg.tie_embeddings else 1
    vocab = ctx.tp_axis if sharded_dim(table, ctx.tp_axis) == vdim \
        else None
    out = unembed(model, x, ctx)
    spec = (lay.bax or None, None, vocab)
    return sharding.from_local(out, sharding.NamedSharding(ctx.mesh, spec),
                               (lay.b, x.shape[1], model.cfg.padded_vocab))


def _last_row(x: torch.Tensor, ctx: ParallelCtx,
              lay: Layout) -> torch.Tensor:
    """x[:, -1:] of the whole sequence: under ctxpar the rank holding the
    last row gives it, the others zeros, summed by an all-reduce."""
    if lay.seq_axis is None:
        return x[:, -1:]
    lo, hi = rows(ctx, lay.s, lay.seq_axis)
    row = x[:, -1:] if hi == lay.s and hi > lo else torch.zeros_like(
        x[:, :1])
    return all_reduce(row.contiguous(), ctx, lay.seq_axis)


# ======================================================================
# stack
# ======================================================================

# the reference's remat policies (jax.checkpoint of each scanned block):
# "full" recomputes a whole layer in the backward; "dots" keeps the
# outputs of the products without batch dims (checkpoint_dots_with_no_
# batch_dims: mm / addmm, not bmm) and recomputes the rest
REMAT_MODES = ("none", "full", "dots")
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.matmul.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return _ckpt.create_selective_checkpoint_contexts(_dots_policy)


def _layer_keys(cfg: ModelConfig) -> List[int]:
    """Each layer's key for its jitter generator, the reference's
    ``fold_in`` data: bi * 131 + si for slot si of scanned block bi,
    7919 + ti for tail layer ti."""
    pattern, nblocks, tail = cfg.scan_pattern()
    n = len(pattern)
    return ([bi * 131 + si for bi in range(nblocks) for si in range(n)]
            + [7919 + ti for ti in range(len(tail))])


def derive_seed(seed: int, key: int) -> int:
    """A 63-bit seed from (seed, key): splitmix64's finaliser of their
    mix, so nearby keys give unrelated streams."""
    z = (seed * 0x9E3779B97F4A7C15 + key + 1) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (z ^ (z >> 31)) & (2 ** 63 - 1)


def _layer_generator(layer: Layer, cfg: ModelConfig, seed: Optional[int],
                     key: int, device):
    """A MoE layer's own jitter generator (None without jitter or a step
    seed), made inside the layer's (checkpointed) function so a recompute
    draws the same."""
    if seed is None or layer.kind != "AM" or not cfg.router_jitter:
        return None
    return torch.Generator(device=device).manual_seed(derive_seed(seed, key))


def _stack_forward(model: LM, x: torch.Tensor, *, mode: str,
                   positions: torch.Tensor,
                   caches: Optional[List[Cache]] = None,
                   pos: Optional[int] = None, seed: Optional[int] = None,
                   remat: str = "none", cache_dtype=torch.bfloat16,
                   ctx: Optional[ParallelCtx] = None,
                   lay: Optional[Layout] = None):
    """Run the full layer stack, ``mode`` one of train / prefill / decode.
    ``seed`` (train): the step's seed, from which each layer derives the
    generator of its router jitter; ``remat`` (train): each layer under
    ``torch.utils.checkpoint`` ("full") or its selective form ("dots").
    ``ctx`` / ``lay``: on a mesh, x is this rank's rows (``Layout``) and
    ``positions`` the whole sequence's. Returns (x after the final norm,
    new caches (prefill / decode) or None, aux sums)."""
    cfg = model.cfg
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {remat!r}: one of {REMAT_MODES}")
    lb, zz = 0.0, 0.0
    new_caches = [] if mode in ("prefill", "decode") else None
    keys = _layer_keys(cfg)
    for i, layer in enumerate(model.layers):
        c = caches[i] if caches is not None else None

        def run(x, layer=layer, c=c, key=keys[i]):
            rng = _layer_generator(layer, cfg, seed, key, x.device)
            return _apply_layer(layer, x, cfg, mode=mode,
                                positions=positions, cache=c, pos=pos,
                                rng=rng, cache_dtype=cache_dtype, ctx=ctx,
                                lay=lay)
        if remat == "none" or mode != "train":
            x, nc, aux = run(x)
        else:
            kw = {"context_fn": _dots_context} if remat == "dots" else {}
            x, nc, aux = _ckpt.checkpoint(run, x, use_reentrant=False,
                                          **kw)
        lb = lb + aux["load_balance"]
        zz = zz + aux["router_z"]
        if new_caches is not None:
            new_caches.append(nc)
    x = rms_norm(x, local(model.final_norm), cfg.norm_eps)
    return x, new_caches, {"load_balance": lb, "router_z": zz}


def _as_input(model: LM, inputs) -> torch.Tensor:
    if isinstance(inputs, torch.Tensor):
        return inputs.to(model.device)
    return torch.from_numpy(np.ascontiguousarray(inputs)).to(model.device)


def _ce_chunk(w: torch.Tensor, h: torch.Tensor, t: torch.Tensor, v0: int,
              cfg: ModelConfig, ctx: Optional[ParallelCtx] = None):
    """(sum of -log p(target), sum of logsumexp^2) over one chunk of rows
    ``h``, the logits (``h @ w``, vocab columns [v0, v0 + w.shape[1]))
    in float32 with the vocab padding at -1e30. Where ``w`` is a block of
    the vocab (a mesh), the log-sum-exp takes the max over the model axis
    (a shift, no gradient) and the sum of exp by an all-reduce, and the
    gold logit comes from the rank whose block holds the target (zeros
    elsewhere, an all-reduce)."""
    vl = w.shape[1]
    logits = (h @ w.to(h.dtype)).to(torch.float32)
    col = torch.arange(v0, v0 + vl, device=h.device)
    logits = torch.where(col >= cfg.vocab_size, -1e30, logits)
    if vl == cfg.padded_vocab:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t[..., None].long())[..., 0]
        return (lse - gold).sum(), (lse ** 2).sum()
    tp = ctx.tp_axis
    m = all_reduce(logits.detach().amax(-1), ctx, tp, "max")
    se = all_reduce(torch.exp(logits - m[..., None]).sum(-1), ctx, tp)
    lse = m + torch.log(se)
    idx = t.long() - v0
    mine = (idx >= 0) & (idx < vl)
    g = torch.gather(logits, -1, idx.clamp(0, vl - 1)[..., None])[..., 0]
    gold = all_reduce(torch.where(mine, g, torch.zeros_like(g)), ctx, tp)
    return (lse - gold).sum(), (lse ** 2).sum()


def chunked_ce_loss(model: LM, hidden: torch.Tensor, targets: torch.Tensor,
                    chunk: int = 0, z_loss: float = 0.0,
                    ctx: Optional[ParallelCtx] = None,
                    lay: Optional[Layout] = None) -> torch.Tensor:
    """Cross-entropy over the vocab in sequence chunks of ``chunk`` (the
    whole sequence where it is 0 or does not divide S). Each chunk runs
    under ``torch.utils.checkpoint``, so no chunk's [B, chunk, V] float32
    logits are held for the backward; the sums go in float32 in chunk
    order as the reference's scan. Returns the mean NLL plus ``z_loss``
    times the mean logsumexp^2.

    On a mesh (``ctx``, ``lay``): ``hidden`` / ``targets`` are this rank's
    rows, the unembedding is fetched once (its vocab block where the rule
    shards the vocab over the model axis: ``_ce_chunk``), and the sums
    are all-reduced over the batch axes, so the loss is the global
    batch's mean on every rank."""
    b, s, _ = hidden.shape
    if chunk <= 0 or s % chunk:
        chunk = s
    cfg = model.cfg
    mesh = ctx is not None and ctx.mesh is not None
    w, v0 = _unembed_weight(model, ctx)
    chunk_fn = lambda h, t: _ce_chunk(w, h, t, v0, cfg, ctx)
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    zl = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        h, t = hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            n, z = _ckpt.checkpoint(chunk_fn, h, t, use_reentrant=False)
        else:
            n, z = chunk_fn(h, t)
        nll = nll + n
        zl = zl + z
    ntok = b * s
    if mesh:
        nll, zl = all_reduce(torch.stack([nll, zl]), ctx, lay.bax)
        ntok = lay.b * s
    loss = nll / ntok
    if z_loss:
        loss = loss + z_loss * zl / ntok
    return loss


def forward_train(model: LM, inputs, targets, *,
                  generator: Optional[torch.Generator] = None,
                  remat: str = "none", loss_chunk: int = 0,
                  z_loss: float = 0.0, lb_coef: float = 0.0,
                  ctx: Optional[ParallelCtx] = None):
    """inputs / targets: token ids [B, S] (inputs may be embeddings [B, S,
    d]), tensors or numpy arrays. Returns (loss, {"ce_loss",
    "load_balance"}), 0-d float32 tensors; ``ce_loss`` is the loss (the
    z and load-balance terms included), as the reference reports it.

    ``generator``: the step's generator; each layer draws its router
    jitter from its own generator seeded by (``generator.initial_seed()``,
    the layer's key), so a recompute under remat draws the same, and the
    step's generator is not advanced. The draws are torch's, not JAX's
    threefry numbers. ``remat``: "none", "full" or "dots" (REMAT_MODES);
    none changes a value.

    ``ctx`` with a mesh (the model placed on it): ``inputs`` / ``targets``
    are the whole batch on every rank, each rank computes its rows (the
    batch split over ``sharding.batch_shardings``' axes), and the loss and
    the load-balance term are the global batch's on every rank. Its
    gradients follow ``models.common``'s convention: differentiate
    ``loss * common.loss_scale(ctx)`` on every rank."""
    inputs, targets = _as_input(model, inputs), _as_input(model, targets)
    b, s = inputs.shape[:2]
    positions = torch.arange(s, device=model.device)
    seed = None if generator is None else generator.initial_seed()
    lay = None
    if _on_mesh(model, ctx):
        lay = layout(ctx, b, s)
        targets = mshard(targets, ctx, lay.bax)
    else:
        ctx = None
    x = embed_inputs(model, inputs, positions, ctx, lay)
    x, _, aux = _stack_forward(model, x, mode="train", positions=positions,
                               seed=seed, remat=remat, ctx=ctx, lay=lay)
    loss = chunked_ce_loss(model, x, targets, loss_chunk, z_loss, ctx, lay)
    lb = torch.as_tensor(aux["load_balance"], dtype=torch.float32,
                         device=model.device)
    if lb_coef and model.cfg.num_experts:
        loss = loss + lb_coef * lb
    return loss, {"ce_loss": loss, "load_balance": lb}


def _on_mesh(model: LM, ctx: Optional[ParallelCtx]) -> bool:
    """Whether a call runs on a mesh; the model must be placed on the
    context's mesh (and a placed model needs one)."""
    mesh = None if ctx is None else ctx.mesh
    if mesh is model.mesh:
        return mesh is not None
    if model.mesh is None:
        raise ValueError("the context has a mesh and the model is not placed "
                         "on it (init_params(..., mesh=) or core.convert."
                         "lm_from_numpy(..., mesh=))")
    if mesh is None:
        raise ValueError("a model placed on a mesh runs with a ParallelCtx "
                         "on that mesh")
    raise ValueError("the model's parameters lie on another mesh than the "
                     "context's")


@torch.no_grad()
def prefill(model: LM, inputs, serve: ServeConfig = ServeConfig(),
            ctx: Optional[ParallelCtx] = None):
    """inputs: token ids [B, S] (or embeddings [B, S, d]), a tensor or a
    numpy array. Returns (logits [B, 1, padded_vocab] of the last
    position, caches sized to the prompt in ``serve.cache_dtype``).

    ``ctx`` with a mesh: ``inputs`` is the whole batch on every rank; the
    logits are a DTensor (batch over the data axes, vocab over the model
    axis), the caches DTensors placed by ``sharding.cache_spec``."""
    inputs = _as_input(model, inputs)
    b, s = inputs.shape[:2]
    positions = torch.arange(s, device=model.device)
    cdt = torch_dtype(serve.cache_dtype)
    if not _on_mesh(model, ctx):
        x = embed_inputs(model, inputs, positions)
        x, caches, _ = _stack_forward(model, x, mode="prefill",
                                      positions=positions, cache_dtype=cdt)
        return unembed(model, x[:, -1:]), caches
    lay = layout(ctx, b, s, ctx.seq_axis)
    x = embed_inputs(model, inputs, positions, ctx, lay)
    x, caches, _ = _stack_forward(model, x, mode="prefill",
                                  positions=positions, cache_dtype=cdt,
                                  ctx=ctx, lay=lay)
    return _logits(model, _last_row(x, ctx, lay), ctx, lay), caches


@torch.no_grad()
def decode_step(model: LM, caches: List[Cache], token, pos: int,
                serve: ServeConfig = ServeConfig(),
                ctx: Optional[ParallelCtx] = None):
    """token: [B, 1] ids (or [B, 1, d] embeddings); ``pos``: the token's
    position, a Python int (so neither the ring slot nor the mask costs a
    host sync). Returns (logits [B, 1, padded_vocab], caches); the
    attention caches are updated in place. ``ctx`` with a mesh: as
    ``prefill``, the caches the placed ones it returned."""
    pos = int(pos)
    token = _as_input(model, token)
    positions = torch.arange(pos, pos + 1, device=model.device)
    cdt = torch_dtype(serve.cache_dtype)
    if not _on_mesh(model, ctx):
        x = embed_inputs(model, token, positions)
        x, new_caches, _ = _stack_forward(
            model, x, mode="decode", positions=positions, caches=caches,
            pos=pos, cache_dtype=cdt)
        return unembed(model, x), new_caches
    lay = layout(ctx, token.shape[0], 1)
    x = embed_inputs(model, token, positions, ctx, lay)
    x, new_caches, _ = _stack_forward(
        model, x, mode="decode", positions=positions, caches=caches,
        pos=pos, cache_dtype=cdt, ctx=ctx, lay=lay)
    return _logits(model, x, ctx, lay), new_caches


@torch.no_grad()
def features(model: LM, tokens, ctx: Optional[ParallelCtx] = None
             ) -> torch.Tensor:
    """The final hidden state (after the final norm) mean-pooled over the
    sequence: [B, d_model] in the compute dtype (``lm_feature_fn``). On a
    mesh: the whole [B, d_model] on every rank (each rank's sums
    all-reduced over the sequence's axis, the batch rows all-gathered)."""
    tokens = _as_input(model, tokens)
    b, s = tokens.shape[:2]
    positions = torch.arange(s, device=tokens.device)
    if not _on_mesh(model, ctx):
        x = embed_inputs(model, tokens, positions)
        x, _, _ = _stack_forward(model, x, mode="train", positions=positions)
        return x.mean(dim=1)
    lay = layout(ctx, b, s, ctx.seq_axis)
    x = embed_inputs(model, tokens, positions, ctx, lay)
    x, _, _ = _stack_forward(model, x, mode="train", positions=positions,
                             ctx=ctx, lay=lay)
    if lay.seq_axis is None:
        pooled = x.mean(dim=1)
    else:
        pooled = all_reduce(x.to(torch.float32).sum(dim=1), ctx,
                            lay.seq_axis).div_(s).to(x.dtype)
    return all_gather(pooled, ctx, lay.bax, 0)


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


def _leaves(c: Cache):
    return c._asdict() if isinstance(c, tuple) else c


def _rebuild(like: Cache, leaves: dict) -> Cache:
    return type(like)(**leaves) if isinstance(like, tuple) else leaves


def pad_caches(caches: List[Cache], cfg: ModelConfig, max_len: int,
               ctx: Optional[ParallelCtx] = None) -> List[Cache]:
    """Grow full-attention KV caches (seq axis) to ``max_len`` for decode.

    Prefill returns caches sized to the prompt; decode writes at pos >=
    S, which needs head-room. Ring-buffer (AL), SSM and LRU states are
    fixed-size and pass through untouched. On a mesh a grown cache is
    gathered along the sequence and placed anew by the cache rule."""
    mesh = ctx is not None and ctx.mesh is not None
    out = []
    for kind, c in zip(cfg.layer_kinds(), caches):
        if kind in ("S", "R", "AL") or c is None:
            out.append(c)
            continue
        grown = {}
        for name, a in c.items():
            t = from_cache(a, ctx) if mesh else a
            t = torch.nn.functional.pad(
                t, (0, 0, 0, 0, 0, max(0, max_len - t.shape[1])))
            grown[name] = to_cache(t, name, ctx, a.shape[0],
                                   ctx.decode_seq_parallel) if mesh else t
        out.append(grown)
    return out


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                serve: ServeConfig = ServeConfig(), *,
                device=None, ctx: Optional[ParallelCtx] = None
                ) -> List[Cache]:
    """Zero caches for every layer; ``device=None`` means CUDA. ``ctx``
    with a mesh: each leaf this rank's shard (a DTensor) as
    ``sharding.cache_spec`` places it (KV along the sequence where
    ``ctx.decode_seq_parallel``)."""
    dev = resolve_device(device)
    cdt = torch_dtype(serve.cache_dtype)
    if ctx is None or ctx.mesh is None:
        return [_layer_cache(kind, cfg, batch, max_len, cdt, dev)
                for kind in cfg.layer_kinds()]
    out = []
    for kind in cfg.layer_kinds():
        like = _layer_cache(kind, cfg, batch, max_len, cdt, "meta")
        placed = {}
        for name, t in _leaves(like).items():
            shape = tuple(t.shape)
            sh = sharding.NamedSharding(ctx.mesh, sharding.cache_spec(
                name, shape, ctx.mesh, ctx.decode_seq_parallel))
            placed[name] = sharding.from_local(torch.zeros(
                sh.shard_shape(shape), dtype=t.dtype, device=dev), sh, shape)
        out.append(_rebuild(like, placed))
    return out
