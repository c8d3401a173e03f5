"""Plain PyTorch versions of the kernels on the engine's main path.

Counterparts of ``repro.kernels.ref`` (the same comparisons, the same f32
0/1 matmul), plus the two entry points the CUDA kernels add: the per-zone
hit vector and the in-place gathered box scan. The kernel wrappers use
these for tensors on the CPU, and the chip checks hold every kernel
against them on the card, so ``box_scan_ref`` and ``l2dist_ref`` run at
full size there without materialising an [N, B, D] or [N, Q, D] tensor.
"""
from __future__ import annotations

import torch


def zone_prune_ref(zlo: torch.Tensor, zhi: torch.Tensor, blo: torch.Tensor,
                   bhi: torch.Tensor) -> torch.Tensor:
    """[NZ, D] zones x [B, D] boxes -> [NZ, B] bool interval overlap."""
    ov = (zhi[:, None, :] > blo[None]) & (zlo[:, None, :] <= bhi[None])
    return ov.all(-1)


def zone_hits_ref(zlo, zhi, blo, bhi) -> torch.Tensor:
    """[NZ] bool: does zone z overlap any box."""
    return zone_prune_ref(zlo, zhi, blo, bhi).any(1)


def compact_ref(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the first ``size`` set entries of the 1-d ``mask``,
    ascending, 0-filled past the set count — ``jnp.nonzero(mask,
    size=size, fill_value=0)`` without a host sync. Set entries past
    ``size`` and all unset entries write to a dump slot that is cut off."""
    pos = torch.cumsum(mask, 0) - 1
    dest = torch.where(mask & (pos < size), pos,
                       torch.full_like(pos, size))
    out = torch.zeros(size + 1, dtype=torch.int32, device=mask.device)
    out.scatter_(0, dest, torch.arange(mask.shape[0], dtype=torch.int32,
                                       device=mask.device))
    return out[:size]


def zone_candidates_ref(zlo, zhi, blo, bhi, capacity: int):
    """(cand [capacity] int32, n_hit [] int32): the ascending ids of the
    first ``capacity`` zones that overlap any box, 0-filled past n_hit,
    and the number of such zones — zone_hits_ref, its sum and its
    compaction, as the reference's fused_query takes them."""
    hit = zone_hits_ref(zlo, zhi, blo, bhi)
    return compact_ref(hit, int(capacity)), hit.sum(dtype=torch.int32)


# elements of one [rows, B, D] comparison chunk in box_scan_ref: three
# bool intermediates of this size stay near 200 MB
_SCAN_CHUNK_ELEMS = 1 << 26


def box_scan_ref(x: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """x: [N, D]; lo/hi: [B, D] -> [N] int32 membership counts.
    Half-open boxes: inside iff lo < x <= hi on every dim. Rows go in
    chunks that cap the [rows, B, D] intermediate."""
    n, d = x.shape
    nb = lo.shape[0]
    out = torch.zeros(n, dtype=torch.int32, device=x.device)
    if nb == 0 or n == 0:
        return out
    step = max(1, _SCAN_CHUNK_ELEMS // max(nb * d, 1))
    for r0 in range(0, n, step):
        xc = x[r0:r0 + step, None, :]
        inside = (xc > lo[None]) & (xc <= hi[None])
        out[r0:r0 + step] = inside.all(-1).sum(-1, dtype=torch.int32)
    return out


def box_scan_pruned_ref(rows3: torch.Tensor, cand: torch.Tensor,
                        n_hit: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor) -> torch.Tensor:
    """rows3 [NB, block, D], cand [C], n_hit [] -> [NB * block] int32: the
    box counts of the blocks rows3[cand[s]], s < min(n_hit, C), zero in
    every other block. The reference's glue as it is: gather the C slots,
    box_scan_ref them, zero the slots >= n_hit, and scatter-max into
    zeros (fill slots repeat a block with zeroed counts, which lose)."""
    nb, block, d = rows3.shape
    c = cand.shape[0]
    valid = torch.arange(c, device=rows3.device) < n_hit
    sel = rows3.index_select(0, cand.long()).reshape(-1, d)
    counts = box_scan_ref(sel, lo, hi).reshape(c, block) * valid[:, None]
    out = torch.zeros((nb, block), dtype=torch.int32, device=rows3.device)
    out = out.scatter_reduce(0, cand.long()[:, None].expand(-1, block),
                             counts, "amax")
    return out.reshape(-1)


def box_scan_seg_ref(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     onehot: torch.Tensor) -> torch.Tensor:
    """x: [N, D]; lo/hi: [B, D]; onehot: [B, Q] box->segment map ->
    [N, Q] int32 per-segment membership counts."""
    inside = (x[:, None, :] > lo[None]) & (x[:, None, :] <= hi[None])
    member = inside.all(-1).to(torch.float32)                   # [N, B]
    return (member @ onehot.to(torch.float32)).to(torch.int32)


def box_scan_seg_gather_ref(rows3: torch.Tensor, cand: torch.Tensor,
                            n_hit: torch.Tensor, lo, hi,
                            onehot) -> torch.Tensor:
    """box_scan_seg over the gathered blocks rows3[cand] -> [C * block, Q]
    int32, with every row of a slot >= n_hit zeroed."""
    c = cand.shape[0]
    _, block, d = rows3.shape
    x = rows3[cand.long()].reshape(c * block, d)
    counts = box_scan_seg_ref(x, lo, hi, onehot).reshape(c, block, -1)
    valid = torch.arange(c, device=cand.device) < n_hit
    return (counts * valid[:, None, None]).reshape(c * block, -1)


# the NaN of an invalid f32 operation on x86 (inf - inf), bits 0xFFC00000
_X86_DEFAULT_NAN = -0x400000
_QUIET_BIT = 0x400000


def l2dist_ref(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[N, D] x [Q, D] -> [N, Q] f32 squared L2 distances, summed over
    the dims in ascending order: ``t = x_j - q_j; acc = acc + t * t``
    from acc = 0. Every step is a separate, correctly rounded f32 op, so
    the CUDA kernel (which spells the same steps with round-to-nearest
    intrinsics) equals this bitwise.

    NaN rule (x86's, spelled out so that every device gives the same
    bits): an op with a NaN operand returns its first NaN operand,
    quieted (bit 22 set), and an invalid op on numbers (``inf - inf``)
    returns 0xFFC00000, a NaN with its sign bit set. So a NaN distance
    takes its bits from the first dim whose step ``x - q`` is NaN: x's
    NaN, else q's, else 0xFFC00000; each later ``acc + t * t`` returns
    acc. Those bits are tracked beside the sum, as the arithmetic alone
    gives others on the card (CUDA's 0x7FFFFFFF), and torch's CPU
    subtraction can return q's NaN where x and q are both NaN. Nothing
    here reads a value back to the host."""
    x = x.to(torch.float32)
    q = q.to(torch.float32)
    shape = (x.shape[0], q.shape[0])
    acc = torch.zeros(shape, dtype=torch.float32, device=x.device)
    nan_bits = torch.full(shape, _X86_DEFAULT_NAN, dtype=torch.int32,
                          device=x.device)
    open_ = torch.ones(shape, dtype=torch.bool, device=x.device)
    for j in range(x.shape[1]):
        xj, qj = x[:, j, None], q[None, :, j]
        t = xj - qj
        acc = acc + t * t
        step = torch.isnan(t) & open_              # the first NaN step
        bits = torch.where(torch.isnan(xj), xj.view(torch.int32) | _QUIET_BIT,
                           torch.where(torch.isnan(qj),
                                       qj.view(torch.int32) | _QUIET_BIT,
                                       _X86_DEFAULT_NAN))
        nan_bits = torch.where(step, bits, nan_bits)
        open_ &= ~step
    return torch.where(torch.isnan(acc), nan_bits.view(torch.float32), acc)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, return_lse: bool = False):
    """Materialised-softmax attention in the kernel's layout.
    q: [BH, S, G, D]; k/v: [BH, S, D] -> [BH, S, G, D] in q's dtype.
    Scores are taken in float32 and scaled by D^-0.5 after the product;
    causal masking keeps qpos >= kpos and sets the rest to -1e30. With
    ``return_lse`` also each row's log-sum-exp of those scores, lse
    [BH, S * G] float32 in q's row order (the reference's ``m + log l``:
    every row sees a key, so l >= 1 and its 1e-30 floor never binds)."""
    scores = _attention_scores(q, k, causal)
    # [BH, G, S] -> [BH, S * G], the kernel's row order
    lse = (torch.logsumexp(scores, -1).transpose(1, 2).reshape(q.shape[0], -1)
           if return_lse else None)
    out = torch.einsum("bgqk,bkd->bqgd", torch.softmax(scores, dim=-1),
                       v.to(torch.float32)).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              splits: int = 1, rows: int = 128,
                              tile: int = 128, return_lse: bool = False):
    """The forward kernel's key split (csrc/flash_attention.cu, bf16
    route) in plain torch ops, in float32: the M = S * G query rows in
    tiles of ``rows``; a tile's keys up to its last row's position
    (causal) or S, nt tiles of ``tile`` keys, split z taking tiles [nt z /
    splits, nt (z + 1) / splits). Each split gives (o, m, l): its masked
    scores' max (-1e30 where it sees none), sum of exp and unnormalised
    P V; the combine rescales them to the largest m and adds them in split
    order. Same layout, output and lse as ``flash_attention_ref``."""
    bh, s, g, d = q.shape
    m_rows = s * g
    qf = q.reshape(bh, m_rows, d).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    pos = torch.arange(m_rows, device=q.device) // g
    out = torch.empty(bh, m_rows, d, dtype=torch.float32, device=q.device)
    lse = torch.empty(bh, m_rows, dtype=torch.float32, device=q.device)
    for r0 in range(0, m_rows, rows):
        r1 = min(r0 + rows, m_rows)
        kend = min(s, (r1 - 1) // g + 1) if causal else s
        nt = -(-kend // tile)
        parts = []
        for z in range(splits):
            k0, k1 = nt * z // splits * tile, min(nt * (z + 1) // splits
                                                  * tile, kend)
            sc = torch.einsum("bqd,bkd->bqk", qf[:, r0:r1],
                              kf[:, k0:k1]) * d ** -0.5
            if causal:
                kpos = torch.arange(k0, k1, device=q.device)
                sc = sc.masked_fill(kpos[None, None] > pos[None, r0:r1,
                                                           None],
                                    float("-inf"))
            mz = (sc.amax(-1) if k1 > k0 else
                  torch.full(sc.shape[:2], float("-inf"), device=q.device))
            mz = mz.clamp_min(-1e30)
            p = torch.exp(sc - mz[..., None])
            parts.append((mz, p.sum(-1), p @ vf[:, k0:k1]))
        mmax = torch.stack([mz for mz, _, _ in parts]).amax(0)
        acc = torch.zeros_like(out[:, r0:r1])
        lsum = torch.zeros_like(mmax)
        for mz, lz, oz in parts:
            w = torch.exp(mz - mmax)
            lsum = lsum + w * lz
            acc = acc + w[..., None] * oz
        denom = lsum.clamp_min(1e-30)
        out[:, r0:r1] = acc / denom[..., None]
        lse[:, r0:r1] = mmax + torch.log(denom)
    out = out.reshape(q.shape).to(q.dtype)
    return (out, lse) if return_lse else out


def _attention_scores(q: torch.Tensor, k: torch.Tensor,
                      causal: bool) -> torch.Tensor:
    """q k^T D^-0.5 [BH, G, S, S] in float32, the causal entries set to
    -1e30 (scaled and masked in place)."""
    s, d = q.shape[1], q.shape[3]
    scores = torch.einsum("bqgd,bkd->bgqk", q.to(torch.float32),
                          k.to(torch.float32)).mul_(d ** -0.5)
    if causal:
        pos = torch.arange(s, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        scores.masked_fill_(~mask, -1e30)
    return scores


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True):
    """The attention backward in the kernel's layout, unchunked, by the
    kernel's two routes. q, out, dout [BH, S, G, D]; k/v [BH, S, D]; lse
    [BH, S * G] float32 (the forward's) -> (dq, dk, dv) in their inputs'
    dtypes. The scores are recomputed in float32 as in
    ``flash_attention_ref`` (scaled by D^-0.5, causal entries -1e30); with
    dp = dout v^T: dv = p^T dout, ds = p (dp - delta), dq = ds k scale,
    dk = ds^T q scale, dk and dv summed over the G query heads of each kv
    head.

    bfloat16: the reference's ``_flash_core_bwd``
    (``repro.models.attention``) in one piece, p = exp(scores - lse) and
    delta = sum_d dout out (out in the input's dtype).

    float32: p is the softmax of the scores recomputed here and delta =
    sum_k p dp, the softmax's own VJP (as XLA differentiates the reference
    ViT's ``jax.nn.softmax``); out and lse are not read. Both deltas are
    equal in exact arithmetic, but sum_d dout out carries the forward's
    rounding, and set against a recomputed p it leaves ds = p (dp -
    delta) a row sum that is not zero: times the keys' common component,
    that moved DINO's 400x400 wq / wk gradients by 1.5e-3 of their
    largest entry between the card and the CPU. The CUDA kernel's float32
    route takes the same sums."""
    bh, s, g, d = q.shape
    scale = d ** -0.5
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    dof = dout.to(torch.float32)
    scores = _attention_scores(q, k, causal)
    dp = torch.einsum("bqgd,bkd->bgqk", dof, vf)
    if q.dtype == torch.float32:
        p = torch.softmax(scores, dim=-1)
        del scores
        delta = (p * dp).sum(-1, keepdim=True)
    else:
        rows = lambda x: x.reshape(bh, s, g).transpose(1, 2)[..., None]
        # p = exp(scores - lse), in the scores' memory
        p = scores.sub_(rows(lse)).exp_()
        delta = rows((dof * out.to(torch.float32)).sum(-1))
    dv = torch.einsum("bgqk,bqgd->bkd", p, dof)
    # ds = p (dp - delta), in dp's memory
    ds = dp.sub_(delta).mul_(p)
    dq = torch.einsum("bgqk,bkd->bqgd", ds, kf) * scale
    dk = torch.einsum("bgqk,bqgd->bkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
