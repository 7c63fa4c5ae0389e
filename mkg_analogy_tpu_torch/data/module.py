"""KGC data module: ties together tokenizer, vocab, features, image stores
and batch iterators (MarT/data/data_module.py:185 KGC).

The port's own copy of ``mkg_analogy_tpu/data/module.py``: fine-tune
features and the pre-train formats ("triple", "analogy", and "mixed", the
diet of both).

Feature caching: stacked feature dicts are persisted as ``.npz`` keyed by
(split, pretrain flag, max_seq, corpus fingerprint, and for pre-training the
seed and the format) — the replacement for the reference's pickle
``cache_results`` decorator (processor.py:26-80).
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, Optional

import numpy as np

from .batching import BatchIterator
from .images import RegionStore, open_store
from .prompt import (
    build_finetune_features,
    build_pretrain_features,
    build_pseudo_analogy_features,
)
from .readers import MARS, MarKG
from .vocab import KGVocab, build_tokenizer


class KGCDataModule:
    def __init__(
        self,
        data_dir: str,
        pretrain_path: str,
        max_seq_length: int = 128,
        pretrain: bool = False,
        vocab_file: Optional[str] = None,
        text_vocab_size: int = 8192,
        cache_dir: Optional[str] = None,
        image_features: Optional[str] = None,
        image_size: int = 224,
        image_kind: str = "pixels",  # "pixels" | "regions"
        overwrite_cache: bool = False,
        seed: int = 1,
        pretrain_format: str = "triple",  # "triple" | "analogy" | "mixed"
    ):
        self.data_dir = data_dir
        self.pretrain = pretrain
        self.pretrain_format = pretrain_format
        self.max_seq_length = max_seq_length
        self.cache_dir = cache_dir
        self.overwrite_cache = overwrite_cache
        self.seed = seed

        self.markg = MarKG(pretrain_path)
        self.mars = MARS(data_dir, self.markg)
        self.tokenizer = build_tokenizer(
            self.markg, cache_dir=cache_dir, vocab_file=vocab_file,
            vocab_size=text_vocab_size,
        )
        self.vocab = KGVocab(self.tokenizer, self.markg, self.mars)
        self.image_kind = image_kind
        self.store = open_store(
            image_features, self.markg.num_entities, image_size, image_kind,
            entities=self.markg.entities,
        )

    # ------------------------------------------------------------- features
    def _corpus_fingerprint(self) -> str:
        """Cheap content hash over the source text files so edited datasets
        never silently reuse stale cached features."""
        h = hashlib.sha256()
        for root in (self.markg.root, getattr(self.mars, "root", None)):
            if not root or not os.path.isdir(root):
                continue
            for name in sorted(os.listdir(root)):
                p = os.path.join(root, name)
                if os.path.isfile(p):
                    st = os.stat(p)
                    h.update(f"{name}:{st.st_size}:{int(st.st_mtime)}".encode())
        return h.hexdigest()[:10]

    def _cache_path(self, split: str, fmt: Optional[str] = None) -> Optional[str]:
        if not self.cache_dir:
            return None
        fmt = fmt or self.pretrain_format
        key = (
            f"{split}_pre{int(self.pretrain)}_L{self.max_seq_length}"
            f"_V{self.vocab.base_size}_C{self._corpus_fingerprint()}"
        )
        if self.pretrain:
            key += f"_S{self.seed}"  # the seed drives the pretrain draws
            if fmt != "triple":
                key += f"_F{fmt}"
        h = hashlib.sha256(key.encode()).hexdigest()[:12]
        return os.path.join(self.cache_dir, f"features_{key}_{h}.npz")

    def features(self, split: str, fmt: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Stacked features for ``split``. ``fmt`` overrides the module's
        pretrain format for one call: the "mixed" diet fetches its two
        components as fmt="triple" and fmt="analogy" (each cached under its
        own key, shared with the single-format runs)."""
        fmt = fmt or self.pretrain_format
        if self.pretrain and fmt == "mixed":
            raise ValueError(
                "mixed is a diet, not a feature format: fetch its components"
                " with fmt='triple' and fmt='analogy'"
            )
        path = self._cache_path(split, fmt=fmt)
        if path and os.path.exists(path) and not self.overwrite_cache:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        if not self.pretrain:
            feats = build_finetune_features(
                self.mars, self.vocab, split, self.max_seq_length
            )
        elif fmt == "analogy":
            feats = build_pseudo_analogy_features(
                self.markg, self.vocab, self.max_seq_length, seed=self.seed
            )
        else:
            feats = build_pretrain_features(
                self.markg, self.vocab, self.max_seq_length, seed=self.seed
            )
        if path:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.savez_compressed(path, **feats)
        return feats

    # -------------------------------------------------------------- attach
    def pixel_attach(self) -> Callable:
        store = self.store
        if self.image_kind == "regions":
            def attach(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
                batch = dict(batch)
                feats, mask = store.gather(batch["img0"], batch["img1"])
                batch["pixel_values"] = feats
                batch["visual_attention_mask"] = mask
                return batch
        else:
            def attach(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
                batch = dict(batch)
                batch["pixel_values"] = store.gather(batch["img0"], batch["img1"])
                return batch

        return attach

    def device_table(self) -> np.ndarray:
        """Entity feature table (with a trailing zero pad row) for
        device-resident gathering (MarTTrainer.set_image_table). Zero stores
        collapse to a single pad row."""
        feats = getattr(self.store, "features", None)
        if feats is None:
            if self.image_kind == "regions":
                return np.zeros((1, RegionStore.num_regions, RegionStore.feat_dim),
                                np.float32)
            return np.zeros((1,) + self.store.image_shape, np.float32)
        pad = np.zeros((1,) + feats.shape[1:], feats.dtype)
        return np.concatenate([np.asarray(feats), pad], axis=0)

    def iterator(
        self, split: str, batch_size: int, shuffle: bool, pad_tail: bool = False
    ) -> BatchIterator:
        # the mixed diet evaluates and tests in the analogy geometry
        fmt = "analogy" if self.pretrain and self.pretrain_format == "mixed" else None
        return BatchIterator(
            self.features(split, fmt=fmt),
            batch_size,
            shuffle=shuffle,
            seed=self.seed,
            attach=self.pixel_attach(),
            pad_tail=pad_tail,
        )
