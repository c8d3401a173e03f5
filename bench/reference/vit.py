"""The ViT feature extractor in plain PyTorch (float32): patches of
``patch_size`` flattened as (row, column, channel) and projected, CLS
first, learned positions; each layer RMSNorm (scale 1 + w) -> q, k, v ->
softmax attention over every position -> wo -> residual -> RMSNorm ->
GELU (tanh form) MLP -> residual; a final RMSNorm; the features are CLS
concatenated with the mean of the patch tokens. Weights are the seeded
leaves of ``bench.common.vit_leaves``, in [in, out] layout."""
from __future__ import annotations

import math

import torch

from bench.reference.precision import exact_float32, rounder


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def features(w: dict, images: torch.Tensor, cfg: dict,
             precision: str = "float32") -> torch.Tensor:
    """images [B, H, W, 3] float32 -> features [B, 2 d]."""
    r = rounder(precision)
    mm = lambda a, b: r(a) @ r(b)
    eps, p = cfg["norm_eps"], cfg["patch_size"]
    h_, hd = cfg["num_heads"], cfg["head_dim"]
    with torch.no_grad(), exact_float32():
        b, hh, ww, c = images.shape
        x = images.reshape(b, hh // p, p, ww // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, p * p * c)
        x = mm(x, w["patch_proj"]) + w["patch_bias"]
        x = torch.cat([w["cls"].expand(b, 1, -1), x], 1) + w["pos"]
        s = x.shape[1]
        for i in range(cfg["num_layers"]):
            l = lambda k: w[f"layers.{i}.{k}"]
            h = _rms(x, l("norm1"), eps)
            q, k, v = (mm(h, l(n)).reshape(b, s, h_, hd).transpose(1, 2)
                       for n in ("wq", "wk", "wv"))
            probs = torch.softmax(mm(q, k.transpose(-1, -2)) * hd ** -0.5,
                                  dim=-1)
            o = mm(probs, v).transpose(1, 2).reshape(b, s, h_ * hd)
            x = x + mm(o, l("wo"))
            h = _rms(x, l("norm2"), eps)
            x = x + mm(_gelu(mm(h, l("w_in"))), l("w_out"))
        x = _rms(x, w["final_norm"], eps)
        return torch.cat([x[:, 0], x[:, 1:].mean(1)], dim=-1)
