"""Entity image-feature stores.

The reference loads a ~7GB host-RAM tensor of pre-encoded pixel values and
gathers per example inside the collator Python loop
(MarT/data/data_module.py:121-161) — the input-pipeline bottleneck flagged in
SURVEY.md §3.1. Here the store is a memory-mapped array gathered with one
vectorized ``take`` per batch; missing slots (-1) become zeros, matching the
reference's zero-tensors for text-mode slots.

Variants:
- ``PixelStore``   — (N, 3, H, W) pixel tensors (MKGformer/ViLT/FLAVA path)
- ``RegionStore``  — (N, 36, 2048) detector region features
                     (VisualBERT/ViLBERT path), also yields the
                     visual_attention_mask
- ``ZeroPixelStore`` / synthetic stores for benchmarks and tests.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


class PixelStore:
    """Gather (B, S, 3, H, W) pixel slabs for S image slots per example."""

    def __init__(self, features: np.ndarray):
        assert features.ndim == 4, features.shape  # (N, 3, H, W)
        self.features = features
        self.image_shape = features.shape[1:]

    @classmethod
    def open(cls, path: str, entities=None) -> "PixelStore":
        """Open a feature cache: ``.npy`` (this framework) or the
        reference's ``.pth`` stacked torch tensor
        (entity_image_features.CLIP-VIT-16-32.pth, data_module.py:209)."""
        if path.endswith((".pth", ".pt")):
            import torch

            return cls(torch.load(path, map_location="cpu").numpy())
        return cls(np.load(path, mmap_mode="r"))

    @classmethod
    def random(cls, num_entities: int, image_size: int = 224, seed: int = 0):
        rng = np.random.default_rng(seed)
        feats = rng.standard_normal(
            (num_entities, 3, image_size, image_size), dtype=np.float32
        )
        return cls(feats)

    def gather(self, *slot_indices: np.ndarray) -> np.ndarray:
        """slot_indices: S arrays of (B,) entity ids (-1 -> zeros).
        Returns (B, S, 3, H, W) float32."""
        b = slot_indices[0].shape[0]
        out = np.zeros((b, len(slot_indices)) + self.image_shape, dtype=np.float32)
        for s, idx in enumerate(slot_indices):
            valid = idx >= 0
            if valid.any():
                out[valid, s] = self.features[idx[valid]]
        return out


class ZeroPixelStore(PixelStore):
    def __init__(self, image_size: int = 224):
        self.features = None
        self.image_shape = (3, image_size, image_size)

    def gather(self, *slot_indices: np.ndarray) -> np.ndarray:
        b = slot_indices[0].shape[0]
        return np.zeros((b, len(slot_indices)) + self.image_shape, dtype=np.float32)


class RegionStore:
    """Detector region features: gather (B, S*36, 2048) + attention mask
    (B, S*36), VisualBERT/ViLBERT collator parity
    (data_module.py:129-159)."""

    num_regions: int = 36
    feat_dim: int = 2048

    def __init__(self, features: np.ndarray):
        assert features.ndim == 3, features.shape  # (N, 36, 2048)
        self.features = features

    @classmethod
    def open(cls, path: str, entities=None) -> "RegionStore":
        """Open ``.npy`` (this framework) or the reference's
        ``analogy_entity2vec.pickle`` dict {qid: (36, 2048)}
        (data_module.py:202-205) — the dict form needs the entity order."""
        if path.endswith((".pickle", ".pkl")):
            import pickle

            with open(path, "rb") as f:
                d = pickle.load(f)
            assert entities is not None, "pickle region store needs entity order"
            feats = np.zeros((len(entities), cls.num_regions, cls.feat_dim),
                             np.float32)
            for i, e in enumerate(entities):
                if e in d:
                    feats[i] = np.asarray(d[e], np.float32).reshape(
                        cls.num_regions, cls.feat_dim
                    )
            return cls(feats)
        return cls(np.load(path, mmap_mode="r"))

    @classmethod
    def random(cls, num_entities: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        return cls(
            rng.standard_normal(
                (num_entities, cls.num_regions, cls.feat_dim), dtype=np.float32
            )
        )

    def gather(self, *slot_indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        b = slot_indices[0].shape[0]
        s = len(slot_indices)
        feats = np.zeros((b, s * self.num_regions, self.feat_dim), dtype=np.float32)
        mask = np.zeros((b, s * self.num_regions), dtype=np.float32)
        for j, idx in enumerate(slot_indices):
            valid = idx >= 0
            lo, hi = j * self.num_regions, (j + 1) * self.num_regions
            if valid.any():
                feats[valid, lo:hi] = self.features[idx[valid]]
            mask[valid, lo:hi] = 1.0
        return feats, mask


class ZeroRegionStore(RegionStore):
    def __init__(self):
        self.features = None

    def gather(self, *slot_indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        b = slot_indices[0].shape[0]
        s = len(slot_indices)
        feats = np.zeros((b, s * self.num_regions, self.feat_dim), np.float32)
        mask = np.zeros((b, s * self.num_regions), np.float32)
        for j, idx in enumerate(slot_indices):
            mask[idx >= 0, j * self.num_regions : (j + 1) * self.num_regions] = 1.0
        return feats, mask


def open_store(
    path: Optional[str], num_entities: int, image_size: int = 224,
    kind: str = "pixels", entities=None,
):
    """Open the feature store a model family consumes ("pixels" or
    "regions"); fall back to zeros when no cache is present."""
    if kind == "regions":
        if path and os.path.exists(path):
            return RegionStore.open(path, entities=entities)
        return ZeroRegionStore()
    if path and os.path.exists(path):
        return PixelStore.open(path, entities=entities)
    return ZeroPixelStore(image_size)
