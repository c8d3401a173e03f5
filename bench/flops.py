"""Operations and bytes from shapes, and the card's published peaks.

Every count is of the work the inputs need, not of what an
implementation dispatches: each input read once, each output written
once, a causal attention over the (query, key) pairs at or below the
diagonal, and no recompute. A later change to a kernel then leaves its
bound where it was.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def peaks(kind: str) -> Optional[dict]:
    """The published rates of the card ``kind`` (its
    ``torch.cuda.get_device_name()``), or None for a card not listed."""
    return json.loads(PEAKS_FILE.read_text()).get(kind)


def attention_pairs(s: int, causal: bool) -> int:
    """(query, key) pairs an attention over ``s`` positions needs."""
    return s * (s + 1) // 2 if causal else s * s


def vit_flops_per_image(cfg: dict) -> float:
    """A ViT forward's model FLOPs for one image: 2 a parameter of each
    product per token it multiplies (the patch projection over the
    patches, every layer's products over the patches and CLS), plus each
    layer's attention, 4·H·D a (query, key) pair (scores and the
    weighted values)."""
    d, ff, p = cfg["d_model"], cfg["d_ff"], cfg["patch_size"]
    h, hd = cfg["num_heads"], cfg["head_dim"]
    n_patch = (cfg["image_size"] // p) ** 2
    s = n_patch + 1
    q = h * hd
    layer_params = 4 * d * q + 2 * d * ff        # wq wk wv wo, MLP in/out
    dense = 2.0 * (p * p * 3 * d) * n_patch \
        + 2.0 * layer_params * s * cfg["num_layers"]
    attn = 4.0 * h * hd * attention_pairs(s, False) * cfg["num_layers"]
    return dense + attn


def lm_product_params(cfg: dict) -> int:
    """The parameters a training step's model FLOPs count (PaLM,
    arXiv:2204.02311, appendix B): every parameter but the input
    embedding, a gather (the norms' few count too)."""
    d, ff = cfg["d_model"], cfg["d_ff"]
    q = cfg["num_heads"] * cfg["head_dim"]
    kv = cfg["num_kv_heads"] * cfg["head_dim"]
    mlp = (3 if cfg.get("mlp_gated", True) else 2) * d * ff
    layer = d * q + 2 * d * kv + q * d + mlp + 2 * d
    return cfg["num_layers"] * layer + d * cfg["vocab_size"] + d


def lm_train_flops(cfg: dict, batch: int, seq: int) -> float:
    """A training step's model FLOPs: 6 a product parameter a token, and
    3 times the causal attention's two products (4·Hq·D a pair at or below
    the diagonal, forward and twice that backward) in every layer."""
    tokens = batch * seq
    attn = 4.0 * batch * cfg["num_heads"] * cfg["head_dim"] \
        * attention_pairs(seq, True)
    return 6.0 * lm_product_params(cfg) * tokens \
        + 3.0 * cfg["num_layers"] * attn


def flash_fwd_work(b: int, s: int, hq: int, hkv: int, d: int, causal: bool,
                   dtype: str) -> tuple:
    """(FLOPs, bytes) of one attention forward of q [b, s, hq, d] and k,
    v [b, s, hkv, d]: two products over the pairs; q, k and v read once
    and the output written once."""
    flops = 4.0 * b * hq * d * attention_pairs(s, causal)
    nbytes = DTYPE_BYTES[dtype] * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    return flops, float(nbytes)


def flash_bwd_work(b: int, s: int, hq: int, hkv: int, d: int, causal: bool,
                   dtype: str) -> tuple:
    """(FLOPs, bytes) of one attention backward: the four products the
    gradients need over the pairs (dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K,
    dK = dSᵀ·Q; the scores' recompute not counted); q, k, v, the
    output, its gradient and the float32 log-sum-exp read once, dq, dk
    and dv written once."""
    flops = 8.0 * b * hq * d * attention_pairs(s, causal)
    e = DTYPE_BYTES[dtype]
    nbytes = e * (3 * b * s * hq * d + 2 * b * s * hkv * d      # q o dO k v
                  + b * s * hq * d + 2 * b * s * hkv * d) \
        + 4 * b * hq * s                                         # lse
    return flops, float(nbytes)


def bound_s(flops: float, nbytes: float, flops_per_s: float,
            bytes_per_s: float) -> float:
    """The roofline time: the slower of the operations at the peak rate
    and the bytes at the memory bandwidth."""
    return max(flops / flops_per_s, nbytes / bytes_per_s)
