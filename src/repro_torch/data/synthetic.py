"""Procedural synthetic aerial imagery — the engine's test dataset.

The paper's catalog is 90.4M Denmark aerial patches (400x400 px) with
objects like solar panels, forests and water. Offline we cannot ship
that, so we generate a *procedural analogue*: each patch is terrain noise
plus zero or more object archetypes, with the object class recorded as
ground truth. This gives every benchmark and test labelled data with the
paper's structure (rare positives in a large catalog), fully
deterministic from a seed.

Patches are small (default 64x64x3) stand-ins for the 400x400 originals;
classification operates on extracted features, so patch resolution only
scales the extractor, not the engine.

A numpy copy of ``repro.data.synthetic`` (the port imports nothing of
``repro``); its outputs are bitwise the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

CLASSES = ("background", "solar_panel", "forest", "water", "building")
CLASS_IDS = {c: i for i, c in enumerate(CLASSES)}


@dataclass(frozen=True)
class PatchDatasetConfig:
    n_patches: int = 4096
    patch_size: int = 64
    positive_class: str = "solar_panel"
    class_probs: Tuple[float, ...] = (0.80, 0.05, 0.06, 0.05, 0.04)
    seed: int = 0


def _terrain(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """Low-frequency multi-octave noise terrain, [n, size, size, 3]."""
    img = np.zeros((n, size, size, 3), np.float32)
    for octave in (4, 8, 16):
        coarse = rng.normal(0.0, 1.0, (n, octave, octave, 3)).astype(np.float32)
        reps = size // octave
        up = np.repeat(np.repeat(coarse, reps, axis=1), reps, axis=2)
        img += up / octave
    img = 0.45 + 0.1 * img
    # greenish-brown base
    img[..., 0] *= 0.9
    img[..., 2] *= 0.7
    return img


def _paint(img: np.ndarray, cls: str, rng: np.random.Generator) -> None:
    """Paint one object archetype in-place on a single [S, S, 3] patch."""
    s = img.shape[0]
    if cls == "solar_panel":
        # dark blue rectangular array with grid lines
        w, h = rng.integers(s // 4, s // 2, 2)
        x0, y0 = rng.integers(2, s - max(w, h) - 2, 2)
        img[y0:y0 + h, x0:x0 + w] = [0.08, 0.10, 0.35]
        img[y0:y0 + h:4, x0:x0 + w] = [0.25, 0.28, 0.5]
        img[y0:y0 + h, x0:x0 + w:4] = [0.25, 0.28, 0.5]
    elif cls == "forest":
        # dense dark-green blobs
        for _ in range(rng.integers(25, 60)):
            cx, cy = rng.integers(0, s, 2)
            r = rng.integers(2, 5)
            y, x = np.ogrid[:s, :s]
            m = (x - cx) ** 2 + (y - cy) ** 2 <= r * r
            img[m] = [0.08, 0.30 + 0.1 * rng.random(), 0.08]
    elif cls == "water":
        # smooth dark blue gradient band
        y = np.linspace(0, 1, s, dtype=np.float32)[:, None, None]
        img[:] = np.array([0.10, 0.22, 0.45], np.float32) * (0.8 + 0.4 * y)
    elif cls == "building":
        # bright rectangular roof with shadow edge
        w, h = rng.integers(s // 5, s // 3, 2)
        x0, y0 = rng.integers(2, s - max(w, h) - 2, 2)
        img[y0:y0 + h, x0:x0 + w] = [0.7, 0.45, 0.35]
        img[y0 + h:min(y0 + h + 2, s), x0:x0 + w] = [0.15, 0.15, 0.15]


def generate_patches(cfg: PatchDatasetConfig) -> Dict[str, np.ndarray]:
    """Returns {"images": [N,S,S,3] f32 in [0,1], "labels": [N] int32,
    "geo": [N,2] f32 lat/lon-like coordinates}."""
    rng = np.random.default_rng(cfg.seed)
    imgs = _terrain(rng, cfg.n_patches, cfg.patch_size)
    labels = rng.choice(len(CLASSES), cfg.n_patches, p=cfg.class_probs)
    for i in range(cfg.n_patches):
        if labels[i] != 0:
            _paint(imgs[i], CLASSES[labels[i]], rng)
        imgs[i] += rng.normal(0, 0.015, imgs[i].shape).astype(np.float32)
    np.clip(imgs, 0.0, 1.0, out=imgs)
    # a fake geo grid (row-major tiling of Denmark-ish bbox)
    side = int(np.ceil(np.sqrt(cfg.n_patches)))
    iy, ix = np.divmod(np.arange(cfg.n_patches), side)
    geo = np.stack([54.5 + 3.0 * iy / side, 8.0 + 4.0 * ix / side], 1)
    return {"images": imgs, "labels": labels.astype(np.int32),
            "geo": geo.astype(np.float32)}


def handcrafted_features(images: np.ndarray, n_features: int = 384,
                         seed: int = 7) -> np.ndarray:
    """Cheap deterministic feature extractor (tests / CPU benchmarks).

    Pools color statistics + oriented gradients over a 4x4 grid, then
    projects to ``n_features`` dims with a fixed random matrix — a
    stand-in for the ViT features with the same interface, informative
    enough that classes are separable (which the engine tests rely on).
    """
    n, s, _, _ = images.shape
    feats = []
    for g in (4, 8):                                        # two pooling scales
        cell = s // g
        x = images.reshape(n, g, cell, g, cell, 3)
        feats.append(x.mean((2, 4)).reshape(n, -1))         # [N, g*g*3]
        feats.append(x.var((2, 4)).reshape(n, -1))
        # per-cell extrema catch small high-contrast objects (solar grids,
        # roofs) that mean-pooling washes out
        feats.append(x.min((2, 4)).reshape(n, -1))
        feats.append(x.max((2, 4)).reshape(n, -1))
    gy = np.abs(np.diff(images, axis=1)).reshape(n, -1, 3)
    gx = np.abs(np.diff(images, axis=2)).reshape(n, -1, 3)
    feats.append(np.concatenate([gy.mean(1), gx.mean(1)], 1))   # [N, 6]
    raw = np.concatenate(feats, 1).astype(np.float32)
    rng = np.random.default_rng(seed)
    proj = rng.normal(0, raw.shape[1] ** -0.5,
                      (raw.shape[1], n_features)).astype(np.float32)
    out = raw @ proj
    return (out - out.mean(0)) / (out.std(0) + 1e-6)
