"""Ranking and Hits@k / MR / MRR metrics (``mkg_analogy_tpu/ops/ranking.py``).

The reference ranks by double argsort of descending scores
(lit_models/transformer.py:162-164). With a stable sort, the rank of the
label equals::

    1 + #{j : s_j > s_label} + #{j < label : s_j == s_label}

which is computed directly: O(C) per row, on whatever device the scores are.

One deliberate deviation from the JAX package: a row whose gold score is not
finite (a fit that diverged) gets the last rank, the candidate count, and a
tie group of one. No comparison with NaN is true, so the formula above would
rank it 1, and a diverged run would report Hits@1 = 1. The evaluations count
such rows (``nonfinite_gold``) beside their metrics. Finite gold scores get
JAX's ranks exactly.
"""

from __future__ import annotations

from typing import Dict

import torch


def nonfinite_gold(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the rows whose gold score is NaN or infinite."""
    return ~torch.isfinite(torch.gather(scores, 1, labels.long()[:, None])[:, 0])


def ranks_from_scores(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Ranks (1-based) of ``labels`` under descending stable sort of ``scores``;
    the candidate count where the gold score is not finite.

    scores: (B, C) float; labels: (B,) int. Returns (B,) int32.
    """
    labels = labels.long()
    s_label = torch.gather(scores, 1, labels[:, None])  # (B, 1)
    greater = (scores > s_label).sum(dim=1)
    col = torch.arange(scores.shape[1], device=scores.device)[None, :]
    ties_before = ((scores == s_label) & (col < labels[:, None])).sum(dim=1)
    ranks = greater + ties_before + 1
    ranks = torch.where(nonfinite_gold(scores, labels), scores.shape[1], ranks)
    return ranks.to(torch.int32)


def tie_counts(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Size of the score tie-group containing the label (>=1; 1 = unique);
    1 where the gold score is not finite, which ranks alone at the end."""
    s_label = torch.gather(scores, 1, labels.long()[:, None])
    ties = (scores == s_label).sum(dim=1)
    return torch.where(nonfinite_gold(scores, labels), 1, ties).to(torch.int32)


def rank_metrics(ranks: torch.Tensor, ks=(1, 3, 5, 10, 20)) -> Dict[str, torch.Tensor]:
    """Hits@k / mean-rank / MRR over a vector of 1-based ranks (float32)."""
    r = ranks.to(torch.float32)
    out = {f"hits{k}": (r <= k).to(torch.float32).mean() for k in ks}
    out["mean_rank"] = r.mean()
    out["mrr"] = (1.0 / r).mean()
    return out


def rank_score(ranks):
    """(hits10, hits5, hits1, mrr) tuple — lit_models/utils.py:4 parity."""
    m = rank_metrics(torch.as_tensor(ranks), ks=(1, 5, 10))
    return (float(m["hits10"]), float(m["hits5"]), float(m["hits1"]),
            float(m["mrr"]))
