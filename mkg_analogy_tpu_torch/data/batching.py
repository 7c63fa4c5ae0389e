"""Static-shape batch iteration.

Every batch has identical shapes: train batches drop the
final remainder; eval batches pad the tail with repeated rows and carry a
``valid`` mask so metrics ignore padding.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np

Features = Dict[str, np.ndarray]


def _slice(features: Features, idx: np.ndarray) -> Features:
    return {k: v[idx] for k, v in features.items()}


class BatchIterator:
    """Shuffled, epoch-based iteration over stacked feature dicts, with an
    optional ``attach`` hook for host-side gathers (image features)."""

    def __init__(
        self,
        features: Features,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 7,
        attach: Optional[Callable[[Features], Features]] = None,
        pad_tail: bool = False,
    ):
        self.features = features
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.attach = attach
        self.pad_tail = pad_tail
        self.num_examples = len(next(iter(features.values())))

    def __len__(self) -> int:
        if self.pad_tail:
            return (self.num_examples + self.batch_size - 1) // self.batch_size
        return self.num_examples // self.batch_size

    def __iter__(self) -> Iterator[Features]:
        order = np.arange(self.num_examples)
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        for start in range(0, self.num_examples, bs):
            idx = order[start : start + bs]
            valid = np.ones((bs,), dtype=bool)
            if len(idx) < bs:
                if not self.pad_tail:
                    return
                valid[len(idx) :] = False
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - len(idx))])
            batch = _slice(self.features, idx)
            if self.attach is not None:
                batch = self.attach(batch)
            batch["valid"] = valid
            yield batch
