"""GQA attention: full, flash (the CUDA kernel), block-local, decode —
counterpart of ``repro.models.attention``.

Shapes follow [B, S, H, D] (batch, seq, heads, head_dim); query head h
belongs to kv head h // G (G = Hq / Hkv). Scores are taken in float32
whatever the inputs' dtype, masked entries set to ``NEG_INF`` (a finite
-1e30, not -inf, as the reference), and outputs cast back to q's dtype.

``flash_attention`` is the LM's long-sequence path: where the reference
runs its chunked online softmax (``kernels/flash_attention.py`` being
"the Pallas kernel this scope promises on TPU"), the port launches its
hand-written CUDA kernel through ``kernels.ops.flash_attention`` (on the
CPU, its plain version ``kernels/ref.flash_attention_ref``). The
reference's routing is kept: a length that its (2048, 1024) chunks do
not divide takes ``full_attention``.

On a mesh: ``flash_attention_kvscan`` is the reference's online softmax
over KV chunks for the query rows this rank holds (query-sequence and
context parallelism, ``lm.attn_parallel_mode`` "qseq" / "ctxpar"); the
reference runs it as plain jnp, not Pallas, and the port as plain torch.
``decode_attention`` over a KV cache sharded along the sequence
(``seq_offset`` given) is flash-decoding: each rank's masked max, sum and
weighted V over its slice, all-reduced in float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash_kernel
from repro_torch.kernels import ops
from repro_torch.models.common import ParallelCtx, all_reduce

NEG_INF = -1e30


def _group_heads(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """[B, S, Hq, D] -> [B, S, Hkv, G, D] grouping query heads per kv
    head."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, num_kv, hq // num_kv, d)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   q_offset: int = 0) -> torch.Tensor:
    """Materialised-scores attention. q: [B, Sq, Hq, D], k/v: [B, Sk,
    Hkv, D]. ``q_offset``: absolute position of q[0] (for masks when
    Sq < Sk). ``window`` > 0 applies a sliding-window band mask (local
    attention)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = _group_heads(q, hkv)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * d ** -0.5
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    scores.masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(b, sq, hq, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 2048,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention on the CUDA kernel (its plain version on
    the CPU). ``q_chunk`` / ``kv_chunk`` are the reference's chunk sizes
    and only route: where they do not divide S the reference computes
    ``full_attention``, and so does this. The kernel picks its own tiles.
    A head dim the kernel does not take raises: this path never runs the
    plain version quietly on the card."""
    s, d = q.shape[1], q.shape[3]
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    if s % q_chunk or s % kv_chunk:
        return full_attention(q, k, v, causal=causal)
    if d not in _flash_kernel.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one the "
                         f"kernel takes {_flash_kernel.HEAD_DIMS}")
    return ops.flash_attention(q, k, v, causal=causal)


def flash_attention_kvscan(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           kv_chunk: int = 1024,
                           q_offset: int = 0) -> torch.Tensor:
    """Online-softmax over KV chunks with the query rows live: q [B, Sq,
    Hq, D] at absolute positions ``q_offset`` .. ``q_offset + Sq - 1`` of
    the sequence (the whole of it by default), k/v [B, S, Hkv, D] whole.
    Every op is elementwise over query rows, so a rank that holds some
    rows computes exactly their rows of the whole-q result. Where
    ``kv_chunk`` does not divide S it takes ``full_attention`` (the
    reference's routing)."""
    b, sq, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if s % kv_chunk:
        return full_attention(q, k, v, causal=causal, q_offset=q_offset)
    f32 = torch.float32
    qg = _group_heads(q, hkv).to(f32) * d ** -0.5          # [B,Sq,Hkv,G,D]
    g = qg.shape[3]
    qpos = torch.arange(sq, device=q.device) + q_offset
    acc = torch.zeros((b, hkv, g, sq, d), dtype=f32, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=f32, device=q.device)
    for k0 in range(0, s, kv_chunk):
        kc = k[:, k0:k0 + kv_chunk].to(f32)
        vc = v[:, k0:k0 + kv_chunk].to(f32)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc)    # [B,H,G,Sq,kc]
        if causal:
            kpos = torch.arange(k0, k0 + kv_chunk, device=q.device)
            sc = sc.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                   p, vc)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)       # [B,H,G,Sq,D]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return out.to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, causal: bool = True) -> torch.Tensor:
    """Sliding-window attention via the two-block trick: position p
    attends to [p - window + 1, p]; query block i needs key blocks i - 1
    and i (block size = window), so compute is O(S * W) exact. Falls
    back to the band-masked ``full_attention`` where S <= window or the
    window does not divide S."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if s <= window or s % window:
        return full_attention(q, k, v, causal=causal, window=window)
    nb = s // window
    qg = _group_heads(q, hkv).to(torch.float32)
    g = qg.shape[3]
    qb = qg.reshape(b, nb, window, hkv, g, d) * d ** -0.5
    kb = k.reshape(b, nb, window, hkv, d).to(torch.float32)
    vb = v.reshape(b, nb, window, hkv, d).to(torch.float32)
    # previous block of K/V (block -1 = zeros, masked out anyway)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kb], dim=2)              # [B, nb, 2W, Hkv, D]
    v2 = torch.cat([vprev, vb], dim=2)
    sc = torch.einsum("bnqhgd,bnkhd->bnhgqk", qb, k2)  # [B,nb,H,G,W,2W]
    qpos = torch.arange(window, device=q.device)[:, None] + window
    kpos = torch.arange(2 * window, device=q.device)[None, :]
    mask = (qpos >= kpos) & (qpos - kpos < window)
    # the first block has no previous block: mask its left half
    first = (torch.arange(nb, device=q.device) == 0)[:, None, None]
    valid = mask[None] & ~(first & (kpos < window)[None])
    bias = torch.where(valid, 0.0, NEG_INF)          # [nb, W, 2W]
    sc = sc + bias[None, :, None, None]
    probs = torch.softmax(sc, dim=-1)
    out = torch.einsum("bnhgqk,bnkhd->bnqhgd", probs, v2)
    return out.reshape(b, s, hq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *,
                     ctx: Optional[ParallelCtx] = None,
                     seq_offset: Optional[int] = None) -> torch.Tensor:
    """q: [B, 1, Hq, D]; caches: [B, S, Hkv, D] valid up to ``pos``
    (inclusive; a Python int, so the mask costs no host sync).

    ``seq_offset`` (on a mesh): the caches are this rank's slice, global
    positions ``seq_offset`` .. ``seq_offset + S - 1``, of a cache sharded
    along the sequence over ``ctx.tp_axis``; the scores' max and the
    softmax's sum and weighted V are all-reduced over it in float32
    (flash-decoding)."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    sharded = ctx is not None and ctx.mesh is not None \
        and seq_offset is not None
    qg = _group_heads(q, hkv)[:, 0]                  # [B, Hkv, G, D]
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * d ** -0.5
    kpos = torch.arange(s, device=q.device) + (seq_offset or 0)
    scores = scores.masked_fill(~(kpos <= pos), NEG_INF)
    m = scores.amax(-1, keepdim=True)
    if sharded:
        m = all_reduce(m, ctx, ctx.tp_axis, "max")
    p = torch.exp(scores - m)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.to(torch.float32))
    denom = p.sum(-1, keepdim=True)
    if sharded:
        both = all_reduce(torch.cat([out, denom], -1), ctx, ctx.tp_axis)
        out, denom = both[..., :d], both[..., d:]
    out = out / denom
    return out.reshape(b, 1, hq, d).to(q.dtype)
