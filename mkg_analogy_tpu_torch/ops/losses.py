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
"""

from __future__ import annotations

import torch


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    shifted = x - torch.amax(x, dim=-1, keepdim=True)
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=-1, keepdim=True))


def label_smoothing_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    smoothing: float = 0.1,
    ignore_index: int = -100,
) -> torch.Tensor:
    """Mean label-smoothed CE. logits (B, C), computed in fp32; labels (B,)."""
    logits = logits.to(torch.float32)
    num_classes = logits.shape[-1]
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = _log_softmax(logits)
    label_logp = torch.gather(logp, 1, safe_labels[:, None])[:, 0]
    lb_pos = 1.0 - smoothing
    lb_neg = smoothing / num_classes
    # <target, logp> = (lb_pos - lb_neg) * logp[label] + lb_neg * sum(logp)
    loss = -((lb_pos - lb_neg) * label_logp + lb_neg * torch.sum(logp, dim=-1))
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    n_valid = torch.clamp_min(torch.sum(valid.to(torch.float32)), 1.0)
    return torch.sum(loss) / n_valid


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
) -> torch.Tensor:
    """mean( relu(cos(q_head, a_head)) + 1 - cos(rel_example, rel_question) )."""
    cos = cosine_similarity(q_head_hidden, a_head_hidden)
    ent_term = torch.maximum(cos, torch.zeros_like(cos))
    rel_term = 1.0 - cosine_similarity(rel_hidden, r_hidden)
    return torch.mean(ent_term + rel_term)
