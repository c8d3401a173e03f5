"""A dense decoder's training steps in plain PyTorch (float32).

The model: token embedding; each layer RMSNorm (scale 1 + w) -> q, k, v
-> RoPE on q and k (the two halves of the head rotated, base
``rope_theta``) -> causal attention, query head h reading kv head
h // (Hq / Hkv), scores scaled by D^-0.5 -> wo -> residual -> RMSNorm
-> (silu(h Wg) * h Wi) Wo -> residual; a final RMSNorm and the
unembedding. The loss is the mean cross-entropy over every token plus
``z_loss`` times the mean squared log-sum-exp, with logits of the vocab
padding masked out. The step is global-norm clipping then AdamW
(decoupled decay on every tensor of a layer and every 2-d top tensor,
the bias corrections of its step, a linear warm-up then a cosine).

To fit at the cells' sizes, each layer and each block of query rows of
the attention run under ``torch.utils.checkpoint``, and the loss goes
over blocks of rows; none of this changes a value.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.common import draw_leaves
from bench.reference.precision import exact_float32, rounder

ATTN_ROWS = 1024         # query rows of one attention block
LOSS_ROWS = 1024         # positions of one loss block
NEG = -1e30


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, mm: Callable) -> torch.Tensor:
    """Causal GQA over blocks of ATTN_ROWS query rows, each block under
    checkpoint so the backward holds one block's scores at a time. q [B,
    S, Hq, D], k / v [B, S, Hkv, D] -> [B, S, Hq, D]."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    kt = k.permute(0, 2, 3, 1)                    # [B, Hkv, D, S]
    vt = v.transpose(1, 2)                        # [B, Hkv, S, D]
    qg = q.reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)  # [B,Hkv,G,S,D]

    def block(qb, kt, vt, q0: int):
        n = qb.shape[3]
        hi = q0 + n
        sc = mm(qb, kt[:, :, None, :, :hi]) * d ** -0.5   # [B,Hkv,G,n,hi]
        qpos = torch.arange(q0, hi, device=q.device)
        kpos = torch.arange(hi, device=q.device)
        sc = sc.masked_fill(kpos[None, :] > qpos[:, None], NEG)
        p = torch.softmax(sc, dim=-1)
        return mm(p, vt[:, :, None, :hi])                  # [B,Hkv,G,n,D]
    outs = []
    for q0 in range(0, s, ATTN_ROWS):
        qb = qg[:, :, :, q0:q0 + ATTN_ROWS]
        outs.append(checkpoint(block, qb, kt, vt, q0, use_reentrant=False)
                    if torch.is_grad_enabled() else block(qb, kt, vt, q0))
    o = torch.cat(outs, dim=3)                    # [B, Hkv, G, S, D]
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d)


def _layer(x, n1, n2, wq, wk, wv, wo, wi, wout, wg, cos, sin, cfg,
           mm: Callable):
    b, s, _ = x.shape
    hq, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    eps = cfg["norm_eps"]
    h = _rms(x, n1, eps)
    q = _rope(mm(h, wq).reshape(b, s, hq, hd), cos, sin)
    k = _rope(mm(h, wk).reshape(b, s, hkv, hd), cos, sin)
    v = mm(h, wv).reshape(b, s, hkv, hd)
    x = x + mm(_attention(q, k, v, mm).reshape(b, s, hq * hd), wo)
    h = _rms(x, n2, eps)
    return x + mm(F.silu(mm(h, wg)) * mm(h, wi), wout)


LAYER_KEYS = ("norm1", "norm2", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
              "mlp.w_in", "mlp.w_out", "mlp.w_gate")


def loss(w: Dict[str, torch.Tensor], inputs: torch.Tensor,
         targets: torch.Tensor, cfg: dict, z_loss: float,
         precision: str = "float32") -> torch.Tensor:
    """The training loss of token ids ``inputs`` / ``targets`` [B, S]."""
    r = rounder(precision)
    mm = lambda a, b: r(a) @ r(b)
    b, s = inputs.shape
    hd = cfg["head_dim"]
    inv = 1.0 / (cfg["rope_theta"] ** (
        torch.arange(hd // 2, dtype=torch.float32, device=inputs.device)
        / (hd // 2)))
    ang = torch.arange(s, dtype=torch.float32, device=inputs.device)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x = F.embedding(inputs, w["embed"])
    for i in range(cfg["num_layers"]):
        args = [w[f"layers.{i}.{k}"] for k in LAYER_KEYS]
        x = checkpoint(_layer, x, *args, cos, sin, cfg, mm,
                       use_reentrant=False)
    x = _rms(x, w["final_norm"], cfg["norm_eps"])
    vocab = cfg["vocab_size"]

    def block(h, t):
        logits = mm(h, w["unembed"])
        col = torch.arange(logits.shape[-1], device=h.device)
        logits = logits.masked_fill(col >= vocab, NEG)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t[..., None])[..., 0]
        return (lse - gold).sum(), lse.square().sum()
    nll = zz = 0.0
    for c0 in range(0, s, LOSS_ROWS):
        n, z = checkpoint(block, x[:, c0:c0 + LOSS_ROWS],
                          targets[:, c0:c0 + LOSS_ROWS], use_reentrant=False)
        nll, zz = nll + n, zz + z
    return nll / (b * s) + z_loss * zz / (b * s)


def learning_rate(tc: dict, step: int) -> float:
    """Linear warm-up to the rate over ``warmup_steps``, then a cosine
    to a tenth of it at ``total_steps`` (``step`` counts from 1)."""
    lr, warm, total = tc["learning_rate"], tc["warmup_steps"], \
        tc["total_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def decays(name: str, t: torch.Tensor) -> bool:
    """Decoupled weight decay: every tensor of a layer (a stacked leaf of
    rank 2 or more) and every top tensor of rank 2 or more."""
    return name.startswith("layers.") or t.dim() >= 2


def train(cfg: dict, tc: dict, leaves: Sequence, seed: int,
          batches: List[Tuple[torch.Tensor, torch.Tensor]], device,
          precision: str = "float32") -> Dict:
    """The first ``len(batches)`` steps from the seeded weights. Returns
    the loss of each step, each tensor's norm of the first step's
    gradient after clipping (what the optimizer gets), the first step's
    global norm before clipping, and each tensor's norm of its change
    over all the steps."""
    with exact_float32():
        w = {n: t.requires_grad_(True)
             for n, t in _weights(leaves, seed, device).items()}
        m = {n: torch.zeros_like(t) for n, t in w.items()}
        v = {n: torch.zeros_like(t) for n, t in w.items()}
        b1, b2, eps = tc["beta1"], tc["beta2"], 1e-8
        out = {"losses": []}
        for step, (inputs, targets) in enumerate(batches, start=1):
            l = loss(w, inputs.long(), targets.long(), cfg, tc["z_loss"],
                     precision)
            grads = torch.autograd.grad(l, list(w.values()))
            out["losses"].append(float(l.detach()))
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(g.square()) for g in grads))
                scale = torch.clamp(tc["grad_clip"]
                                    / torch.clamp(norm, min=1e-9), max=1.0)
                lr = learning_rate(tc, step)
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                first = {}
                for (name, p), g in zip(w.items(), grads):
                    g = g * scale
                    if step == 1:
                        first[name] = float(torch.linalg.vector_norm(g))
                    m[name].mul_(b1).add_(g, alpha=1 - b1)
                    v[name].mul_(b2).add_(g.square(), alpha=1 - b2)
                    delta = (m[name] / bc1) / (torch.sqrt(v[name] / bc2)
                                               + eps)
                    if decays(name, p):
                        delta = delta + tc["weight_decay"] * p
                    p.sub_(lr * delta)
                if step == 1:
                    out["grad_norms"] = first
                    out["grad_global_norm"] = float(norm)
            del grads
        del m, v
        with torch.no_grad():
            out["change_norms"] = change_norms(w, leaves, seed, device)
    return out


def change_norms(params: Dict[str, torch.Tensor], leaves: Sequence,
                 seed: int, device) -> Dict[str, float]:
    """Each tensor's norm of its change from the seeded weights."""
    std = {name: s for name, _, s in leaves}
    out = {}
    for name, w0 in draw_leaves(leaves, seed, device):
        p = params[name].detach().to(torch.float32)
        out[name] = float(torch.linalg.vector_norm(p - w0 * std[name]))
    return out


def _weights(leaves, seed, device) -> Dict[str, torch.Tensor]:
    std = {name: s for name, _, s in leaves}
    return {name: v * std[name]
            for name, v in draw_leaves(leaves, seed, device)}
