"""Triple store + Bernoulli negative sampling (the port's own copy of
``mkg_analogy_tpu/kge/sampling.py``: the same numpy calls in the same order,
so its batches and splits are bit-identical to the JAX package's for the
same store and seed).

Semantics follow the reference's executable spec for OpenKE's C sampler
(M-KGE/IKRL_TransAE/DATA_/PyTorchTrainDataLoader.py — SURVEY.md K4):

- per-relation Bernoulli head/tail corruption probability
  ``rig_mean / (rig_mean + lef_mean)``;
- filtered rejection sampling (candidates present in the train set are
  re-drawn);
- OpenKE batch layout: ``[positives(bs) ; ent-negatives(bs*neg_ent) ;
  rel-negatives(bs*neg_rel)]`` with labels 1/0, plus the alternating
  head_batch/tail_batch "cross" mode.

This pure-NumPy sampler is the behavioral reference; the C++ library in
``native/`` exposes the same semantics behind the OpenKE C API for
host-side throughput (``native.api.NativeTrainLoader``, which the trainer
iterates in place of this sampler).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass
class TripleStore:
    """Id-mapped triples + the index structures sampling/eval need."""

    heads: np.ndarray
    tails: np.ndarray
    rels: np.ndarray
    num_entities: int
    num_relations: int

    def __post_init__(self):
        t_of_hr: Dict[Tuple[int, int], set] = {}
        h_of_tr: Dict[Tuple[int, int], set] = {}
        r_of_ht: Dict[Tuple[int, int], set] = {}
        freq: Dict[int, float] = {}
        h_of_r: Dict[int, set] = {}
        t_of_r: Dict[int, set] = {}
        for h, t, r in zip(self.heads, self.tails, self.rels):
            h, t, r = int(h), int(t), int(r)
            t_of_hr.setdefault((h, r), set()).add(t)
            h_of_tr.setdefault((t, r), set()).add(h)
            r_of_ht.setdefault((h, t), set()).add(r)
            freq[r] = freq.get(r, 0.0) + 1.0
            h_of_r.setdefault(r, set()).add(h)
            t_of_r.setdefault(r, set()).add(t)
        self.t_of_hr = {k: np.fromiter(v, np.int64) for k, v in t_of_hr.items()}
        self.h_of_tr = {k: np.fromiter(v, np.int64) for k, v in h_of_tr.items()}
        self.r_of_ht = {k: np.fromiter(v, np.int64) for k, v in r_of_ht.items()}
        # Bernoulli trick: p(corrupt head) = rig_mean / (rig_mean + lef_mean)
        self.lef_mean = {r: freq[r] / len(h_of_r[r]) for r in freq}
        self.rig_mean = {r: freq[r] / len(t_of_r[r]) for r in freq}

    def __len__(self) -> int:
        return len(self.heads)

    @classmethod
    def from_arrays(cls, triples, num_entities: int, num_relations: int):
        arr = np.asarray(triples, dtype=np.int64)  # rows of (h, r, t)
        return cls(arr[:, 0], arr[:, 2], arr[:, 1], num_entities, num_relations)

    @classmethod
    def from_openke_dir(cls, path: str, split: str = "train") -> "TripleStore":
        """Read OpenKE-format id files: first line is the count, then
        ``h t r`` rows (``entity2id.txt``/``relation2id.txt`` give totals)."""

        def count_of(fn):
            with open(os.path.join(path, fn)) as f:
                return int(f.readline())

        ents = count_of("entity2id.txt")
        rels = count_of("relation2id.txt")
        hs, ts, rs = [], [], []
        with open(os.path.join(path, f"{split}2id.txt")) as f:
            n = int(f.readline())
            for _ in range(n):
                h, t, r = f.readline().split()
                hs.append(int(h))
                ts.append(int(t))
                rs.append(int(r))
        return cls(
            np.array(hs, np.int64), np.array(ts, np.int64), np.array(rs, np.int64),
            ents, rels,
        )


def split_store(store: "TripleStore", holdout_frac: float, seed: int = 0):
    """Seeded train/valid/test split of a TripleStore.

    The reference's KGE data has NO held-out link-prediction split —
    its ``valid2id.txt``/``test2id.txt`` are byte-identical copies of
    ``train2id.txt`` (M-KGE/IKRL_TransAE/data/analogy, verified by md5),
    so its reported link prediction is train-set evaluation. This helper
    is the deliberate improvement: carve ``holdout_frac`` each for valid
    and test from the triples (seeded permutation) and train on the rest.
    Entity/relation universes are inherited so embeddings cover held-out
    triples (MarKG entities all appear in multiple triples).
    """
    n = len(store)
    n_hold = int(n * holdout_frac)
    if not 0 < n_hold < n // 2:
        raise ValueError(f"holdout_frac {holdout_frac} infeasible for {n} triples")
    perm = np.random.default_rng(seed).permutation(n)
    parts = {}
    for name, idx in (("test", perm[:n_hold]),
                      ("valid", perm[n_hold:2 * n_hold]),
                      ("train", perm[2 * n_hold:])):
        parts[name] = TripleStore(
            store.heads[idx], store.tails[idx], store.rels[idx],
            store.num_entities, store.num_relations,
        )
    return parts["train"], parts["valid"], parts["test"]


class NegativeSampler:
    """Epoch iterator producing OpenKE-layout training batches."""

    def __init__(
        self,
        store: TripleStore,
        batch_size: Optional[int] = None,
        nbatches: Optional[int] = None,
        neg_ent: int = 25,
        neg_rel: int = 25,
        bern: bool = True,
        filter_flag: bool = True,
        sampling_mode: str = "normal",
        seed: int = 0,
        native=None,
    ):
        self.store = store
        if batch_size is None:
            assert nbatches, "need batch_size or nbatches"
            batch_size = len(store) // nbatches
        self.batch_size = batch_size
        self.nbatches = len(store) // batch_size
        self.neg_ent = neg_ent
        self.neg_rel = neg_rel
        self.bern = bern
        self.filter_flag = filter_flag
        self.sampling_mode = sampling_mode
        self.rng = np.random.default_rng(seed)
        self._cross_flag = 0
        self.native = native  # optional object with epoch(sampler) -> batches

    # ------------------------------------------------------------ corrupt
    def _rejection_draw(self, n: int, high: int, banned: Optional[np.ndarray]):
        """Draw n ids uniform [0, high) avoiding `banned` (filtered)."""
        if not self.filter_flag or banned is None or banned.size == 0:
            return self.rng.integers(0, high, size=n)
        out = np.empty((0,), np.int64)
        while out.size < n:
            cand = self.rng.integers(0, high, size=(n - out.size) * 2)
            cand = cand[~np.isin(cand, banned, assume_unique=False)]
            out = np.concatenate([out, cand])
        return out[:n]

    def corrupt_head(self, t: int, r: int, n: int) -> np.ndarray:
        return self._rejection_draw(
            n, self.store.num_entities, self.store.h_of_tr.get((t, r))
        )

    def corrupt_tail(self, h: int, r: int, n: int) -> np.ndarray:
        return self._rejection_draw(
            n, self.store.num_entities, self.store.t_of_hr.get((h, r))
        )

    def corrupt_rel(self, h: int, t: int, n: int) -> np.ndarray:
        return self._rejection_draw(
            n, self.store.num_relations, self.store.r_of_ht.get((h, t))
        )

    # -------------------------------------------------------------- batch
    def _normal_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = self.store
        bs = len(idx)
        cols = 1 + self.neg_ent + self.neg_rel
        h = np.repeat(s.heads[idx][:, None], cols, axis=1)
        t = np.repeat(s.tails[idx][:, None], cols, axis=1)
        r = np.repeat(s.rels[idx][:, None], cols, axis=1)
        for i, j in enumerate(idx):
            hh, tt, rr = int(s.heads[j]), int(s.tails[j]), int(s.rels[j])
            # p(corrupt head) = lef/(lef+rig) = tph/(tph+hpt): the TransH
            # bern rule as the reference's EXECUTED Base.so implements it
            # (verified head-to-head, tools/race_base_so.py). The repo's
            # unused fallback PyTorchTrainDataLoader.py:167 flips the two
            # sides relative to its own Base.so — a documented quirk we do
            # NOT reproduce.
            prob = (
                s.lef_mean[rr] / (s.rig_mean[rr] + s.lef_mean[rr])
                if self.bern
                else 0.5
            )
            n_h = int(np.sum(self.rng.random(self.neg_ent) < prob))
            n_t = self.neg_ent - n_h
            col = 1
            if n_h:
                h[i, col : col + n_h] = self.corrupt_head(tt, rr, n_h)
                col += n_h
            if n_t:
                t[i, col : col + n_t] = self.corrupt_tail(hh, rr, n_t)
                col += n_t
            if self.neg_rel:
                r[i, col : col + self.neg_rel] = self.corrupt_rel(
                    hh, tt, self.neg_rel
                )
        y = np.concatenate(
            [np.ones((bs, 1), np.float32), np.zeros((bs, cols - 1), np.float32)],
            axis=1,
        )
        # OpenKE layout: column-major flatten -> [pos block ; neg blocks]
        return dict(
            batch_h=h.T.reshape(-1),
            batch_t=t.T.reshape(-1),
            batch_r=r.T.reshape(-1),
            batch_y=y.T.reshape(-1),
            mode="normal",
        )

    def _cross_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        s = self.store
        self._cross_flag = 1 - self._cross_flag
        cols = 1 + self.neg_ent
        if self._cross_flag == 0:  # head_batch
            h = np.repeat(s.heads[idx][:, None], cols, axis=1)
            for i, j in enumerate(idx):
                h[i, 1:] = self.corrupt_head(
                    int(s.tails[j]), int(s.rels[j]), self.neg_ent
                )
            return dict(
                batch_h=h.T.reshape(-1),
                batch_t=s.tails[idx],
                batch_r=s.rels[idx],
                batch_y=None,
                mode="head_batch",
            )
        t = np.repeat(s.tails[idx][:, None], cols, axis=1)
        for i, j in enumerate(idx):
            t[i, 1:] = self.corrupt_tail(int(s.heads[j]), int(s.rels[j]), self.neg_ent)
        return dict(
            batch_h=s.heads[idx],
            batch_t=t.T.reshape(-1),
            batch_r=s.rels[idx],
            batch_y=None,
            mode="tail_batch",
        )

    def __len__(self) -> int:
        return self.nbatches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.native is not None:
            yield from self.native.epoch(self)
            return
        order = self.rng.permutation(len(self.store))
        for b in range(self.nbatches):
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            if self.sampling_mode == "normal":
                yield self._normal_batch(idx)
            else:
                yield self._cross_batch(idx)
