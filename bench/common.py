"""Seeds and seeded weights, shared by the jobs and the references.

The weights of a cell are drawn here, on the device, in one call: a flat
float32 normal draw from a generator seeded from ``--seed``, cut into the
model's tensors in the order of the job's leaf list and scaled by each
tensor's standard deviation. The program is handed those tensors; the
reference draws them again from the same seed. Nothing here imports the
program.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

MASK64 = (1 << 64) - 1
# keys of the draws made from one seed
WEIGHTS_KEY = 1
INPUTS_KEY = 2
SAMPLE_KEY = 3

Leaf = Tuple[str, Tuple[int, ...], float]      # (name, shape, std)


def derive_seed(seed: int, key: int) -> int:
    """A 63-bit seed from (seed, key): splitmix64's finaliser of their
    mix, so nearby seeds and keys give unrelated streams. Any whole
    ``seed`` (negative or past 64 bits) is taken modulo 2**64."""
    z = ((seed & MASK64) * 0x9E3779B97F4A7C15 + key + 1) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def generator(seed: int, key: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, key)."""
    return torch.Generator(device=device).manual_seed(derive_seed(seed, key))


def draw_leaves(leaves: Sequence[Leaf], seed: int, device
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, view) of each leaf: views into one flat float32 N(0, 1)
    draw, not yet scaled (multiply by the leaf's std). The flat tensor
    lives as long as any view."""
    total = sum(_numel(shape) for _, shape, _ in leaves)
    flat = torch.randn(total, generator=generator(seed, WEIGHTS_KEY, device),
                       dtype=torch.float32, device=device)
    off = 0
    for name, shape, _ in leaves:
        n = _numel(shape)
        yield name, flat[off:off + n].view(shape)
        off += n


def weights(leaves: Sequence[Leaf], seed: int, device) -> dict:
    """{name: float32 tensor} of the seeded weights (each a copy)."""
    std = {name: s for name, _, s in leaves}
    return {name: v * std[name] for name, v in draw_leaves(leaves, seed,
                                                            device)}


def load_weights(params: dict, leaves: Sequence[Leaf], seed: int,
                 device) -> None:
    """Copy the seeded weights into ``params`` ({name: parameter}, every
    leaf one of them with its exact shape), cast to each parameter's
    dtype."""
    if set(params) != {name for name, _, _ in leaves}:
        raise ValueError(f"parameter names differ from the leaf list: "
                         f"{sorted(set(params) ^ {n for n, _, _ in leaves})}")
    std = {name: s for name, _, s in leaves}
    with torch.no_grad():
        for name, v in draw_leaves(leaves, seed, device):
            p = params[name]
            if tuple(p.shape) != tuple(v.shape):
                raise ValueError(f"{name}: shape {tuple(p.shape)}, the "
                                 f"leaf list says {tuple(v.shape)}")
            p.copy_(v)
            p.mul_(std[name])


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def vit_leaves(cfg: dict) -> List[Leaf]:
    """The ViT's tensors (the port's parameter names) and their draws:
    dense weights N(0, 1/fan_in), CLS, positions and patch bias
    N(0, 0.02^2), norm scales N(0, 0.1^2)."""
    d, ff, p = cfg["d_model"], cfg["d_ff"], cfg["patch_size"]
    q = cfg["num_heads"] * cfg["head_dim"]
    n_tok = (cfg["image_size"] // p) ** 2 + 1
    pdim = p * p * 3
    out: List[Leaf] = [("patch_proj", (pdim, d), pdim ** -0.5),
                       ("patch_bias", (d,), 0.02),
                       ("cls", (1, 1, d), 0.02),
                       ("pos", (1, n_tok, d), 0.02)]
    for i in range(cfg["num_layers"]):
        pre = f"layers.{i}."
        out += [(pre + "norm1", (d,), 0.1),
                (pre + "wq", (d, q), d ** -0.5),
                (pre + "wk", (d, q), d ** -0.5),
                (pre + "wv", (d, q), d ** -0.5),
                (pre + "wo", (q, d), q ** -0.5),
                (pre + "norm2", (d,), 0.1),
                (pre + "w_in", (d, ff), d ** -0.5),
                (pre + "w_out", (ff, d), ff ** -0.5)]
    out.append(("final_norm", (d,), 0.1))
    return out


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 128) * 128


def lm_leaves(cfg: dict) -> List[Leaf]:
    """A dense gated LM's tensors (the port's parameter names) and their
    draws: embedding N(0, 1), products N(0, 1/fan_in), norm scales
    N(0, 0.1^2)."""
    d, ff = cfg["d_model"], cfg["d_ff"]
    q = cfg["num_heads"] * cfg["head_dim"]
    kv = cfg["num_kv_heads"] * cfg["head_dim"]
    v = padded_vocab(cfg["vocab_size"])
    out: List[Leaf] = [("embed", (v, d), 1.0), ("final_norm", (d,), 0.1),
                       ("unembed", (d, v), d ** -0.5)]
    for i in range(cfg["num_layers"]):
        pre = f"layers.{i}."
        out += [(pre + "norm1", (d,), 0.1), (pre + "norm2", (d,), 0.1),
                (pre + "attn.wq", (d, q), d ** -0.5),
                (pre + "attn.wk", (d, kv), d ** -0.5),
                (pre + "attn.wv", (d, kv), d ** -0.5),
                (pre + "attn.wo", (q, d), q ** -0.5),
                (pre + "mlp.w_in", (d, ff), d ** -0.5),
                (pre + "mlp.w_out", (ff, d), ff ** -0.5),
                (pre + "mlp.w_gate", (d, ff), d ** -0.5)]
    return out
