"""KGE evaluation: filtered link prediction, analogical reasoning, triple
classification (``mkg_analogy_tpu/kge/eval.py``).

The reference streams per-triple full-entity score buffers into C
(Base.so testHead/testTail -> test_link_prediction, IKRL.py:276-297). Here
the candidate matrices are computed on the device in batches, and the
filtered ranking runs on the host over them, with the JAX package's numpy
code: the filter mask (known positives from train+valid+test, OpenKE's
l_filter semantics) is a host-built boolean matrix per batch.

Rank convention: energies — lower is better; rank = 1 + #{strictly better}
(OpenKE counts strictly smaller scores). The fine-tune path ranks CE-trained
logits descending with ``ops.ranking.ranks_from_scores`` (IKRL.py:299-316).
Unlike the JAX package, a gold score that is not finite (a diverged fit)
ranks last, at the candidate count, in both conventions, and each result
counts such rows under ``nonfinite_gold``: no comparison with NaN is true,
so the counts above would rank it 1.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.ranking import nonfinite_gold, rank_metrics, ranks_from_scores, tie_counts
from .sampling import TripleStore


def build_filters(*stores: TripleStore):
    """(h, r) -> all known tails, (t, r) -> all known heads, over every
    split (filtered evaluation, OpenKE importTestFiles semantics)."""
    t_of_hr: Dict[Tuple[int, int], set] = {}
    h_of_tr: Dict[Tuple[int, int], set] = {}
    for s in stores:
        for h, t, r in zip(s.heads, s.tails, s.rels):
            t_of_hr.setdefault((int(h), int(r)), set()).add(int(t))
            h_of_tr.setdefault((int(t), int(r)), set()).add(int(h))
    return t_of_hr, h_of_tr


def _filter_mask(pairs, gold, filt, num_entities) -> np.ndarray:
    """(B, E) bool: True where the candidate is a *different* known positive
    and must be skipped."""
    mask = np.zeros((len(pairs), num_entities), dtype=bool)
    for i, ((a, r), g) in enumerate(zip(pairs, gold)):
        known = filt.get((a, r))
        if known:
            mask[i, list(known)] = True
        mask[i, g] = False  # never filter the gold answer itself
    return mask


def rank_metrics_of(ranks: np.ndarray, ks) -> Dict[str, float]:
    """``ops.ranking.rank_metrics`` of host ranks, as floats."""
    return {k: float(v) for k, v in rank_metrics(torch.from_numpy(ranks), ks=ks).items()}


def _ids(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


@torch.no_grad()
def link_prediction(
    candidate_fn: Callable,
    test: TripleStore,
    filters,
    num_entities: int,
    batch_size: int = 64,
    task_mode: str = "text",
    seed: int = 0,
    device="cpu",
    return_ranks: bool = False,
):
    """Head and tail prediction with raw + filtered metrics.

    candidate_fn(h_idx, r_idx, task_mode, corrupt) -> (B, E) energies
    (lower = better), given int64 tensors on ``device``. ``task_mode``:
    "text" (deterministic 0) or "random" (reference parity —
    Tester.get_task_mode draws 0.4/0.3/0.3 at test time, IKRL.py:263-274).
    With ``return_ranks`` also returns the raw and filtered ranks, in the
    order (batch, tail then head side, row).
    """
    t_of_hr, h_of_tr = filters
    rng = np.random.default_rng(seed)
    all_ranks = {"raw": [], "filter": []}
    n_nonfinite = 0
    n = len(test)
    for start in range(0, n, batch_size):
        sl = slice(start, min(start + batch_size, n))
        hs = test.heads[sl]
        ts = test.tails[sl]
        rs = test.rels[sl]
        if task_mode == "random":
            tm = rng.choice([0, 1, 2], size=len(hs), p=[0.4, 0.3, 0.3])
        else:
            tm = np.zeros(len(hs), np.int64)
        for corrupt, anchor, gold, filt in (
            ("tail", hs, ts, t_of_hr),
            ("head", ts, hs, h_of_tr),
        ):
            energies = candidate_fn(_ids(anchor, device), _ids(rs, device),
                                    _ids(tm, device), corrupt)
            energies = energies.to(torch.float32).cpu().numpy()
            gold_e = energies[np.arange(len(gold)), gold]
            # a non-finite gold energy ranks last, at the candidate count
            last = np.where(np.isfinite(gold_e), 0, energies.shape[1])
            n_nonfinite += int((last > 0).sum())
            raw_rank = np.maximum(1 + (energies < gold_e[:, None]).sum(axis=1), last)
            fmask = _filter_mask(list(zip(anchor, rs)), gold, filt, num_entities)
            filt_e = np.where(fmask, np.inf, energies)
            filt_rank = np.maximum(1 + (filt_e < gold_e[:, None]).sum(axis=1), last)
            all_ranks["raw"].append(raw_rank)
            all_ranks["filter"].append(filt_rank)
    out = {}
    ranks = {kind: np.concatenate(r) for kind, r in all_ranks.items()}
    for kind, r in ranks.items():
        for k, v in rank_metrics_of(r, (1, 3, 10)).items():
            out[f"{kind}/{k}"] = v
    # headline keys match getTestLink* (filtered)
    out.update(
        mrr=out["filter/mrr"], mr=out["filter/mean_rank"],
        hit10=out["filter/hits10"], hit3=out["filter/hits3"],
        hit1=out["filter/hits1"], nonfinite_gold=float(n_nonfinite),
    )
    if return_ranks:
        return out, ranks
    return out


@torch.no_grad()
def analogical_reasoning(
    finetune_scores_fn: Callable,
    tuples: np.ndarray,
    batch_size: int = 128,
    return_ranks: bool = False,
    device="cpu",
):
    """Double-argsort ranking of the answer among all entities
    (IKRL.py:299-316). With ``return_ranks`` also returns the per-example
    ranks and the size of the score tie group holding the answer (tuples
    order; ``ops.ranking.tie_counts``) — the KGE-silo counterpart of the
    MarT trainer's test_ranks.npz dump (tools/analyze_ranks.py)."""
    ranks, ties, n_nonfinite = [], [], 0
    for start in range(0, len(tuples), batch_size):
        rows = tuples[start : start + batch_size]
        scores = finetune_scores_fn(_ids(rows[:, 0], device), _ids(rows[:, 1], device),
                                    _ids(rows[:, 2], device), _ids(rows[:, 5], device))
        labels = _ids(rows[:, 3], device)
        ranks.append(ranks_from_scores(scores, labels).cpu().numpy())
        ties.append(tie_counts(scores, labels).cpu().numpy())
        n_nonfinite += int(nonfinite_gold(scores, labels).sum())
    r = np.concatenate(ranks)
    metrics = rank_metrics_of(r, (1, 3, 5, 10))
    metrics["nonfinite_gold"] = float(n_nonfinite)
    if return_ranks:
        return metrics, r, np.concatenate(ties)
    return metrics


def best_threshold(scores: np.ndarray, labels: np.ndarray) -> Tuple[float, float]:
    """Accuracy-maximizing threshold for triple classification
    (Tester.get_best_threshlod semantics, IKRL.py:318-343): candidates
    sorted ascending; positives score below the threshold (energy
    convention)."""
    order = np.argsort(scores, kind="stable")
    s, y = scores[order], labels[order]
    total = float(len(s))
    total_true = float(y.sum())
    total_false = total - total_true
    cum_true = 0.0
    best_acc, best_thr = -1.0, s[0]
    for i in range(len(s)):
        acc = (2 * cum_true + total_false - i) / total
        if acc > best_acc:
            best_acc, best_thr = acc, s[i]
        if y[i] == 1:
            cum_true += 1.0
    return float(best_thr), float(best_acc)


@torch.no_grad()
def triple_classification(
    score_fn: Callable,
    pos: TripleStore,
    neg: TripleStore,
    threshold: Optional[float] = None,
    device="cpu",
) -> Tuple[float, float]:
    """Accuracy with learned threshold: triples scoring below it (energies)
    are classified positive."""

    def scores_of(store):
        return score_fn(
            _ids(store.heads, device), _ids(store.tails, device),
            _ids(store.rels, device), torch.zeros(len(store), dtype=torch.int64,
                                                  device=device),
        ).cpu().numpy()

    s = np.concatenate([scores_of(pos), scores_of(neg)])
    y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    if threshold is None:
        threshold, _ = best_threshold(s, y)
    pred = (s < threshold).astype(np.float64)
    acc = float((pred == y).mean())
    return acc, threshold
