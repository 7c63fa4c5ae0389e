"""Loss functions (``mkg_analogy_tpu/ops/losses.py``).

- ``label_smoothing_cross_entropy`` — MarT/lit_models/utils.py:30
  (LabelSmoothSoftmaxCEV1): the smoothed target is ``s/C`` on every class
  with ``1-s`` *replacing* the label cell, and rows at ``ignore_index`` drop
  out of the mean. ``F.cross_entropy(label_smoothing=)`` adds ``s/C`` to the
  label cell instead, so it is not used.
- ``relaxation_loss`` — MarT/lit_models/transformer.py:103-108: pull the
  example-pair relation representation toward the question-pair relation,
  push the question head away from the answer head.

Each is written out as the JAX code is, with ``torch.maximum`` /
``torch.amax`` where JAX has ``jnp.maximum`` / ``jnp.max``, so that the
gradients agree at ties too (both split them evenly).

On a mesh (``parallel/``) each takes what its axes need:

- ``dp_group``: this rank holds a slice of the batch rows, and the loss it
  returns is its share of the global mean: its rows' sum over the global
  count of valid rows, which an all-reduce counts. The shares sum to JAX's
  mean, so their gradients, summed over ``dp``, are its gradient. (A mean
  of per-rank means would not be: the triple pre-train batch splits its
  -100 rows unevenly across the ranks.)
- logits as ``ShardedLogits`` (the tied decoder over a vocab-parallel
  table): each rank holds some columns, and the row max, the sum of
  exponentials, the label's logit and the row sum are reduced over ``tp``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.collectives import ShardedLogits, all_reduce_, reduce_from


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    shifted = x - torch.amax(x, dim=-1, keepdim=True)
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=-1, keepdim=True))


def _sharded_logp_terms(logits: ShardedLogits, labels: torch.Tensor):
    """(logp[label], sum over classes of logp), each (B,), of logits whose
    classes are split over ``logits.group``: the max (no gradient: logp
    does not depend on it), the sum of exponentials, the label's shifted
    logit and the shifted row sum reduced over the group."""
    x = logits.values.to(torch.float32)
    group = logits.group
    if x.shape[1]:
        m = torch.amax(x, dim=-1).detach()
    else:
        m = x.new_full(x.shape[:1], float("-inf"))
    all_reduce_(m, group, op=dist.ReduceOp.MAX)
    shifted = x - m[:, None]
    log_sum = torch.log(reduce_from(torch.sum(torch.exp(shifted), dim=-1), group))
    label_shifted, _ = ShardedLogits(shifted, logits.cols, logits.num_classes,
                                     group).label_values(labels)
    label_logp = reduce_from(label_shifted, group) - log_sum
    sum_logp = reduce_from(torch.sum(shifted, dim=-1), group) - logits.num_classes * log_sum
    return label_logp, sum_logp


def label_smoothing_cross_entropy(
    logits,
    labels: torch.Tensor,
    smoothing: float = 0.1,
    ignore_index: int = -100,
    dp_group=None,
) -> torch.Tensor:
    """Mean label-smoothed CE. logits (B, C), computed in fp32, or
    ``ShardedLogits``; labels (B,). With ``dp_group``, this rank's share of
    the mean over the group's rows."""
    num_classes = logits.shape[-1]
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels)).long()
    if isinstance(logits, ShardedLogits):
        label_logp, sum_logp = _sharded_logp_terms(logits, safe_labels)
    else:
        logp = _log_softmax(logits.to(torch.float32))
        label_logp = torch.gather(logp, 1, safe_labels[:, None])[:, 0]
        sum_logp = torch.sum(logp, dim=-1)
    lb_pos = 1.0 - smoothing
    lb_neg = smoothing / num_classes
    # <target, logp> = (lb_pos - lb_neg) * logp[label] + lb_neg * sum(logp)
    loss = -((lb_pos - lb_neg) * label_logp + lb_neg * sum_logp)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    n_valid = all_reduce_(torch.sum(valid.to(torch.float32)), dp_group)
    return torch.sum(loss) / torch.clamp_min(n_valid, 1.0)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity; each vector's norm clamped at ``eps`` on
    its own (not the product of the norms)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    floor = a.new_tensor(eps)
    na = torch.maximum(torch.linalg.vector_norm(a, dim=-1), floor)
    nb = torch.maximum(torch.linalg.vector_norm(b, dim=-1), floor)
    return torch.sum(a * b, dim=-1) / (na * nb)


def relaxation_loss(
    q_head_hidden: torch.Tensor,
    a_head_hidden: torch.Tensor,
    rel_hidden: torch.Tensor,
    r_hidden: torch.Tensor,
    dp_group=None,
) -> torch.Tensor:
    """mean( relu(cos(q_head, a_head)) + 1 - cos(rel_example, rel_question) );
    with ``dp_group``, this rank's share of the mean over the group's rows
    (every rank holds as many)."""
    cos = cosine_similarity(q_head_hidden, a_head_hidden)
    ent_term = torch.maximum(cos, torch.zeros_like(cos))
    rel_term = 1.0 - cosine_similarity(rel_hidden, r_hidden)
    if dp_group is None:
        return torch.mean(ent_term + rel_term)
    return torch.sum(ent_term + rel_term) / (cos.shape[0] * dist.get_world_size(dp_group))
