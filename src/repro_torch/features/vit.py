"""ViT-T feature extractor — the paper's offline stage (§3); counterpart
of ``repro.features.vit``.

Encoder-only vision transformer (bidirectional attention, CLS token,
learned positional embeddings). ``extract_features`` returns the paper's
384-d vector per patch: concat(CLS, mean-pooled patch tokens) of the
192-d trunk.

Each encoder layer's attention is ``kernels.ops.flash_attention`` with
``causal=False`` and one query head per kv head: the hand-written CUDA
kernel on the card, its plain version on the CPU; under autograd its
backward is the CUDA backward kernel on the card
(``kernels.flash_attention.flash_attention_bwd``) and its plain version
``kernels/ref.flash_attention_bwd_ref`` on the CPU. The
projections and the MLP stay ``torch.matmul``, as the reference leaves
them to XLA. Everything computes in float32 (the reference builds f32
parameters and never casts), and the MLP's GELU is the tanh
approximation that ``jax.nn.gelu`` defaults to. Parameters keep the
reference's [in, out] layout (``h @ W``). They are built without grad,
for extraction; a model that trains (the DINO student,
``features/dino.py``) turns it on with ``requires_grad_(True)``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, gelu, normal_init, rms_norm


def num_patches(image_size: int, patch_size: int) -> int:
    return (image_size // patch_size) ** 2


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, N, patch*patch*3], patches in row-major grid
    order, each flattened as (row, col, channel)."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def _zeros(device, *shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


class EncoderLayer(nn.Module):
    """rms_norm -> q/k/v -> attention -> wo -> residual -> rms_norm ->
    GELU MLP -> residual."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        d, qd = cfg.d_model, cfg.q_dim
        self.norm1 = _zeros(device, d)
        self.wq = _zeros(device, d, qd)
        self.wk = _zeros(device, d, qd)
        self.wv = _zeros(device, d, qd)
        self.wo = _zeros(device, qd, d)
        self.norm2 = _zeros(device, d)
        self.w_in = _zeros(device, d, cfg.d_ff)
        self.w_out = _zeros(device, cfg.d_ff, d)

    def qkv(self, x: torch.Tensor):
        """The attention's inputs in model layout, [B, S, heads, head_dim]
        each."""
        b, s, _ = x.shape
        heads, hd = self.cfg.num_heads, self.cfg.resolved_head_dim
        h = rms_norm(x, self.norm1, self.cfg.norm_eps)
        return tuple((h @ w).reshape(b, s, heads, hd)
                     for w in (self.wq, self.wk, self.wv))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        q, k, v = self.qkv(x)
        attn = ops.flash_attention(q, k, v, causal=False).reshape(b, s, -1)
        x = x + attn @ self.wo
        h = rms_norm(x, self.norm2, self.cfg.norm_eps)
        h = gelu(h @ self.w_in)
        return x + h @ self.w_out


class ViT(nn.Module):
    """The ViT for one image size: ``pos`` holds num_patches + 1
    positions, so images of another size are refused. Parameters start at
    zero; ``init_vit`` draws them, ``core.convert.vit_from_numpy`` carries
    a reference parameter tree across. ``device=None`` means CUDA."""

    def __init__(self, cfg: ModelConfig, *, image_size: int,
                 patch_size: int, device=None):
        super().__init__()
        dev = resolve_device(device)
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} is not a multiple of "
                             f"the patch size {patch_size}")
        self.cfg = cfg
        self.image_size = int(image_size)
        self.patch_size = int(patch_size)
        d = cfg.d_model
        n = num_patches(image_size, patch_size)
        self.patch_proj = _zeros(dev, patch_size * patch_size * 3, d)
        self.patch_bias = _zeros(dev, d)
        self.cls = _zeros(dev, 1, 1, d)
        self.pos = _zeros(dev, 1, n + 1, d)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dev)
                                    for _ in range(cfg.num_layers))
        self.final_norm = _zeros(dev, d)

    @property
    def device(self) -> torch.device:
        return self.patch_proj.device

    def embed(self, images) -> torch.Tensor:
        """[B, H, W, 3] images (numpy or tensor) -> the first layer's
        input [B, N+1, d]: projected patches after the CLS token, plus the
        positional embeddings."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        want = (self.image_size, self.image_size, 3)
        if x.dim() != 4 or tuple(x.shape[1:]) != want:
            raise ValueError(f"images must be [B, {want[0]}, {want[1]}, 3] "
                             f"(the size this ViT's positions were made "
                             f"for), got {tuple(x.shape)}")
        x = patchify(x, self.patch_size) @ self.patch_proj + self.patch_bias
        cls = self.cls.expand(x.shape[0], 1, x.shape[-1])
        return torch.cat([cls, x], dim=1) + self.pos

    def forward(self, images) -> torch.Tensor:
        """[B, H, W, 3] -> token embeddings [B, N+1, d] (token 0 = CLS)."""
        x = self.embed(images)
        for layer in self.layers:
            x = layer(x)
        return rms_norm(x, self.final_norm, self.cfg.norm_eps)


def init_vit(cfg: ModelConfig, *, image_size: int, patch_size: int,
             generator: torch.Generator, device=None) -> ViT:
    """A ViT with the reference's initial distributions (``init_vit`` of
    ``repro.features.vit``): dense weights N(0, 1/fan_in), CLS and
    positions N(0, 0.02^2), norms and the patch bias zero. Drawn on the
    CPU from ``generator`` (a CPU ``torch.Generator``), so one seed gives
    the same weights on every device; the draws are not JAX's."""
    model = ViT(cfg, image_size=image_size, patch_size=patch_size,
                device=device)
    g = generator
    d = cfg.d_model
    with torch.no_grad():
        model.patch_proj.copy_(dense_init(g, model.patch_proj.shape))
        model.cls.copy_(normal_init(g, (1, 1, d), 0.02))
        model.pos.copy_(normal_init(g, model.pos.shape, 0.02))
        for layer in model.layers:
            for w in (layer.wq, layer.wk, layer.wv, layer.wo, layer.w_in,
                      layer.w_out):
                w.copy_(dense_init(g, w.shape))
    return model


def vit_forward(model: ViT, images) -> torch.Tensor:
    """[B, H, W, 3] -> token embeddings [B, N+1, d] (token 0 = CLS)."""
    return model(images)


def extract_features(model: ViT, images) -> torch.Tensor:
    """The engine's feature vector: concat(CLS, mean patch tokens) = 2*d
    (= 384 for the paper's ViT-T d=192)."""
    toks = model(images)
    return torch.cat([toks[:, 0], toks[:, 1:].mean(1)], dim=-1)


def load_arrays(model: nn.Module, arrays: dict) -> None:
    """Copy {parameter name: array} into ``model`` (a ViT, the LM or one
    of its modules); every parameter must be given, with its exact shape.
    Values pass through float32 into the parameter's dtype, exact for
    float32 and bfloat16 arrays."""
    params = dict(model.named_parameters())
    if set(arrays) != set(params):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(params) - set(arrays))}, unknown "
                         f"{sorted(set(arrays) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(arrays[name], np.float32)
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(a))
