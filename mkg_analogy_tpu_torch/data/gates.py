"""Relation-level image gates: MRP (Median Rank Percentage) and its
sigmoid-alpha / binary forget-gate conversions.

Re-implementation of M-KGE/RSME/MRP.py:76 (calculate_MRP) and
M-KGE/RSME/utils.py:8-98 (R6): for each relation, rank the true tail among
all entities using ONLY image cosine similarity; the median of
rank/num_entities over that relation's triples is its MRP. Low MRP means
images are informative for the relation ->

- ``sigmoid alpha``  per-relation fusion weight: sigmoid(k*(0.5 - MRP));
- ``forget gate``    binary: 1 for the ``remember_rate`` fraction of
  relations with the lowest MRP (utils.py mrp100 keeps all gated-in
  relations whose MRP clears the threshold).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def image_only_ranks(
    triples: np.ndarray,  # (N, 3) [lhs, rel, rhs]
    img_vec: np.ndarray,  # (E, D)
) -> np.ndarray:
    """Rank of each true rhs among all entities by image cosine sim."""
    v = img_vec / np.maximum(np.linalg.norm(img_vec, axis=1, keepdims=True), 1e-8)
    lhs = v[triples[:, 0]]  # (N, D)
    scores = lhs @ v.T  # (N, E)
    gold = scores[np.arange(len(triples)), triples[:, 2]]
    return 1 + (scores > gold[:, None]).sum(axis=1)


def calculate_mrp(
    triples: np.ndarray, img_vec: np.ndarray, num_relations: int
) -> np.ndarray:
    """(R,) median of rank/num_entities per relation (MRP.py:76)."""
    ranks = image_only_ranks(triples, img_vec) / img_vec.shape[0]
    mrp = np.ones((num_relations,), np.float64)
    for r in range(num_relations):
        sel = ranks[triples[:, 1] == r]
        if sel.size:
            mrp[r] = np.median(sel)
    return mrp


def mrp_to_sigmoid_alpha(mrp: np.ndarray, k: float = 10.0) -> np.ndarray:
    """Per-relation fusion weight in (0, 1): informative relations (low
    MRP) get high alpha (utils.py rel_MPR_SIG semantics)."""
    return (1.0 / (1.0 + np.exp(-k * (0.5 - mrp)))).astype(np.float32)[:, None]


def mrp_to_forget_gate(
    mrp: np.ndarray, remember_rate: int = 100
) -> np.ndarray:
    """Binary gate keeping the remember_rate% most image-informative
    relations (utils.py rel_MPR_PD_mrp{rate} semantics)."""
    keep = max(1, int(len(mrp) * remember_rate / 100))
    order = np.argsort(mrp)  # ascending: low MRP = informative
    gate = np.zeros((len(mrp),), np.float32)
    gate[order[:keep]] = 1.0
    return gate[:, None]


def build_gates(
    triples: np.ndarray,
    img_vec: np.ndarray,
    num_relations: int,
    remember_rate: int = 100,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (mrp, sigmoid_alpha, forget_gate) for the base relations;
    callers concatenate a reciprocal copy (ComplEx doubles relations)."""
    mrp = calculate_mrp(triples, img_vec, num_relations)
    return mrp, mrp_to_sigmoid_alpha(mrp), mrp_to_forget_gate(mrp, remember_rate)
