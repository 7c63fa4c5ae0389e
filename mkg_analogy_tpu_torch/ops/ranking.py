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

Scores may come as ``ShardedLogits`` (the tied decoder over a vocab-parallel
table, the counterpart of JAX's ``_shard_eval_logits``): the gold score is
summed over the group from the rank that holds its column, each rank counts
what beats it among its columns, and the counts are summed. The ranks are
those of the whole scores.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..parallel.collectives import ShardedLogits, all_reduce_


def _gold(scores, labels: torch.Tensor) -> torch.Tensor:
    """(B, 1) gold scores, from whichever rank holds them."""
    if isinstance(scores, ShardedLogits):
        value, _ = scores.label_values(labels)
        return all_reduce_(value.clone(), scores.group)[:, None]
    return torch.gather(scores, 1, labels.long()[:, None])


def _count(scores, keep) -> torch.Tensor:
    """(B,) int64 count of the columns where ``keep(values, columns)``, over
    every rank's columns."""
    if isinstance(scores, ShardedLogits):
        n = keep(scores.values, scores.cols[None, :]).sum(dim=1)
        return all_reduce_(n, scores.group)
    col = torch.arange(scores.shape[1], device=scores.device)[None, :]
    return keep(scores, col).sum(dim=1)


def nonfinite_gold(scores, labels: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the rows whose gold score is NaN or infinite."""
    return ~torch.isfinite(_gold(scores, labels)[:, 0])


def ranks_from_scores(scores, labels: torch.Tensor) -> torch.Tensor:
    """Ranks (1-based) of ``labels`` under descending stable sort of ``scores``;
    the candidate count where the gold score is not finite.

    scores: (B, C) float, or ``ShardedLogits``; labels: (B,) int. Returns
    (B,) int32.
    """
    labels = labels.long()
    s_label = _gold(scores, labels)  # (B, 1)
    greater = _count(scores, lambda v, c: v > s_label)
    ties_before = _count(scores, lambda v, c: (v == s_label) & (c < labels[:, None]))
    ranks = greater + ties_before + 1
    ranks = torch.where(~torch.isfinite(s_label[:, 0]), scores.shape[1], ranks)
    return ranks.to(torch.int32)


def tie_counts(scores, labels: torch.Tensor) -> torch.Tensor:
    """Size of the score tie-group containing the label (>=1; 1 = unique);
    1 where the gold score is not finite, which ranks alone at the end."""
    s_label = _gold(scores, labels)
    ties = _count(scores, lambda v, c: v == s_label)
    return torch.where(~torch.isfinite(s_label[:, 0]), 1, ties).to(torch.int32)


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
