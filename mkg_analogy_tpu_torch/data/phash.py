"""Perceptual hashing + best-image selection (RSME FilterGate).

Re-implementation of M-KGE/RSME/filter_gate.py:10 (R6): for each entity,
pick the image most similar to the others by pHash — the "representative"
image fed to the ViT encoder. The pHash here is the standard DCT method:
resize to 32x32 grayscale, 2D DCT, take the top-left 8x8 (minus DC),
threshold at the median.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sqrt(2.0 / n) * np.cos((2 * i + 1) * k * np.pi / (2 * n))
    m[0] = np.sqrt(1.0 / n)
    return m


_DCT32 = _dct_matrix(32)


def phash(gray32: np.ndarray, hash_size: int = 8) -> np.ndarray:
    """64-bit perceptual hash of a (32, 32) grayscale image -> (64,) bool."""
    assert gray32.shape == (32, 32), gray32.shape
    freq = _DCT32 @ gray32.astype(np.float64) @ _DCT32.T
    block = freq[:hash_size, :hash_size].copy()
    flat = block.flatten()[1:]  # drop DC
    med = np.median(flat)
    return flat > med


def hamming(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.count_nonzero(a != b))


def to_gray32(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (32, 32) float grayscale via area-mean pooling."""
    gray = rgb.astype(np.float64) @ np.array([0.299, 0.587, 0.114])
    h, w = gray.shape
    ys = (np.arange(33) * h // 32).clip(1)
    xs = (np.arange(33) * w // 32).clip(1)
    out = np.empty((32, 32))
    for i in range(32):
        for j in range(32):
            y0, y1 = min(ys[i], h - 1), max(ys[i + 1], ys[i] + 1)
            x0, x1 = min(xs[j], w - 1), max(xs[j + 1], xs[j] + 1)
            out[i, j] = gray[y0:y1, x0:x1].mean()
    return out


def best_image_index(images_gray32: Sequence[np.ndarray]) -> int:
    """Index of the image with the minimal total pHash distance to the
    others (filter_gate.py best-image semantics). Single image -> 0."""
    n = len(images_gray32)
    if n <= 1:
        return 0
    hashes = [phash(g) for g in images_gray32]
    totals = [
        sum(hamming(hashes[i], hashes[j]) for j in range(n) if j != i)
        for i in range(n)
    ]
    return int(np.argmin(totals))


def select_best_images(
    entity_images: Dict[str, List[np.ndarray]]
) -> Dict[str, int]:
    """entity -> index of its representative image (gray32 arrays in)."""
    return {e: best_image_index(imgs) for e, imgs in entity_images.items()}
