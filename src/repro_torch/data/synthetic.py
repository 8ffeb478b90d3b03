"""Synthetic PlantVillage-38 stand-in, a copy of the JAX package's
``data/synthetic.py`` (numpy only): the same seeds give the same images,
splits and batch order, bit for bit.

The real PlantVillage dataset [arXiv:1511.08060] has 54,305 leaf images,
38 classes, 256x256 JPG. We synthesize a class-separable workload with the
same tensor interface: each class is a distinct procedural texture (a
class-keyed mixture of oriented sinusoidal gratings + class-colored blobs on
a leaf-green base, plus per-sample noise/brightness jitter). A small CNN
reaches high accuracy on it, which is what the reproduction needs: the
paper's claims under test are *relative* (prune -> small drop, fine-tune ->
recover; split-point latency curve), not an absolute ImageNet-style score.

Deterministic: image i of class c depends only on (seed, c, i).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

NUM_CLASSES = 38
IMAGE_HW = 256
CROP_HW = 224


def _class_params(c: int, seed: int) -> np.random.RandomState:
    return np.random.RandomState(seed * 1000003 + c)


def make_image(c: int, i: int, seed: int = 0, hw: int = IMAGE_HW) -> np.ndarray:
    """One (hw, hw, 3) float32 image in [0, 1] for class c, sample i."""
    crs = _class_params(c, seed)
    # class signature: 3 gratings + 2 blob colors
    freqs = crs.uniform(2, 12, size=3)
    orients = crs.uniform(0, np.pi, size=3)
    phases_w = crs.uniform(0.3, 1.0, size=3)
    blob_color = crs.uniform(0, 1, size=(2, 3))
    # per-class mean tint: a strong, linearly-separable disease signature
    # (real PlantVillage classes differ in lesion color statistics too)
    tint = crs.uniform(-1, 1, size=3)
    base_green = np.array([0.18, 0.42, 0.12]) + crs.uniform(-0.05, 0.05, 3)

    srs = np.random.RandomState((seed * 7 + c) * 2654435761 % (2**31) + i)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    img = np.broadcast_to(base_green, (hw, hw, 3)).astype(np.float32).copy()
    img += 0.12 * tint
    for f, o, w in zip(freqs, orients, phases_w):
        ph = srs.uniform(0, 2 * np.pi)
        g = np.sin(2 * np.pi * f * (xx * np.cos(o) + yy * np.sin(o)) + ph)
        img += 0.12 * w * g[..., None]
    # class-colored lesion blobs (disease spots)
    n_blobs = 2 + (c % 3)
    for b in range(n_blobs):
        cy, cx = srs.uniform(0.15, 0.85, 2)
        r = srs.uniform(0.05, 0.15)
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        m = np.exp(-d2 / (2 * r * r))
        img += 0.5 * m[..., None] * (blob_color[b % 2] - img)
    img += srs.normal(0, 0.02, img.shape)
    img *= srs.uniform(0.85, 1.15)
    return np.clip(img, 0, 1).astype(np.float32)


def stratified_split(n_per_class: int, train_frac: float = 0.8,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class index split (paper §4.1: intra-class stratification, 80/20)."""
    rs = np.random.RandomState(seed)
    tr_idx, te_idx = [], []
    for c in range(NUM_CLASSES):
        perm = rs.permutation(n_per_class)
        k = int(round(train_frac * n_per_class))
        tr_idx.append(np.stack([np.full(k, c), perm[:k]], 1))
        te_idx.append(np.stack([np.full(n_per_class - k, c), perm[k:]], 1))
    return np.concatenate(tr_idx), np.concatenate(te_idx)


class PlantVillageSynthetic:
    """Array-backed dataset (materialized once; tiny at smoke scale)."""

    def __init__(self, n_per_class: int = 40, hw: int = 64, seed: int = 0):
        self.hw = hw
        self.n_per_class = n_per_class
        self.train_ids, self.test_ids = stratified_split(n_per_class, 0.8, seed)
        self.seed = seed
        self._cache: Dict[Tuple[int, int], np.ndarray] = {}

    def _img(self, c: int, i: int) -> np.ndarray:
        k = (c, i)
        if k not in self._cache:
            self._cache[k] = make_image(c, i, self.seed, self.hw)
        return self._cache[k]

    def _batch(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        x = np.stack([self._img(int(c), int(i)) for c, i in ids])
        y = ids[:, 0].astype(np.int32)
        return {"image": x, "label": y}

    def iter_train(self, batch_size: int, epochs: int = 1,
                   seed: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        rs = np.random.RandomState(seed)
        for _ in range(epochs):
            perm = rs.permutation(len(self.train_ids))
            for s in range(0, len(perm) - batch_size + 1, batch_size):
                yield self._batch(self.train_ids[perm[s:s + batch_size]])

    def test_batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        for s in range(0, len(self.test_ids), batch_size):
            yield self._batch(self.test_ids[s:s + batch_size])
