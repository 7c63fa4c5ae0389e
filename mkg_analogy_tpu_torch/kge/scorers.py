"""KG-embedding scoring functions as broadcastable tensor ops
(``mkg_analogy_tpu/kge/scorers.py``).

The reference implements these inside nn.Modules with per-row Python loops
and boolean index_put (IKRL.py:447-486, 645-650; RSME models.py:216-222).
Here each scorer is a shape-polymorphic function over embedding tensors:
broadcasting replaces the loops, and full-vocabulary scoring is one matmul.

Conventions:
- ``*_distance`` / ``*_energy``: LOWER is better (margin-loss family).
- ``*_score``: HIGHER is better (softmax-CE family).

Where the JAX functions take ``jnp.maximum`` of a differentiated value, these
take ``torch.maximum`` with a tensor bound, which splits a tie's gradient
evenly as JAX does (never ``clamp``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize(p=2) parity (norm clamped at eps)."""
    n = torch.maximum(torch.linalg.norm(x, dim=-1, keepdim=True), _const(eps, x))
    return x / n


def transe_distance(
    h: torch.Tensor,
    t: torch.Tensor,
    r: torch.Tensor,
    p_norm: int = 1,
    normalize: bool = True,
) -> torch.Tensor:
    """|| h + r - t ||_p with optional L2-normalized inputs
    (IKRL.py:430-445 TransE._calc semantics; the head_batch/tail_batch
    reshapes are handled by broadcasting at the call site)."""
    if normalize:
        h, r, t = l2_normalize(h), l2_normalize(r), l2_normalize(t)
    diff = h + r - t
    if p_norm == 1:
        return torch.sum(torch.abs(diff), dim=-1)
    if p_norm == 2:
        return torch.linalg.norm(diff, dim=-1)
    return torch.pow(torch.sum(torch.pow(torch.abs(diff), p_norm), dim=-1), 1.0 / p_norm)


def analogy_energy(
    h_re: torch.Tensor, h_im: torch.Tensor, h: torch.Tensor,
    t_re: torch.Tensor, t_im: torch.Tensor, t: torch.Tensor,
    r_re: torch.Tensor, r_im: torch.Tensor, r: torch.Tensor,
) -> torch.Tensor:
    """ANALOGY energy: negated (ComplEx-part + DistMult-part); lower is
    better (IKRL.py:645-650 _calc)."""
    cplx = torch.sum(
        r_re * h_re * t_re
        + r_re * h_im * t_im
        + r_im * h_re * t_im
        - r_im * h_im * t_re,
        dim=-1,
    )
    dist = torch.sum(h * t * r, dim=-1)
    return -(cplx + dist)


def split_complex(x: torch.Tensor, rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return x[..., :rank], x[..., rank:]


def complex_score(
    lhs: torch.Tensor, rel: torch.Tensor, rhs: torch.Tensor, rank: int
) -> torch.Tensor:
    """Re(<lhs, rel, conj(rhs)>) per row; embeddings are [re ; im] of width
    2*rank (RSME models.py:216-222)."""
    l_re, l_im = split_complex(lhs, rank)
    r_re, r_im = split_complex(rel, rank)
    o_re, o_im = split_complex(rhs, rank)
    return torch.sum(
        (l_re * r_re - l_im * r_im) * o_re + (l_re * r_im + l_im * r_re) * o_im,
        dim=-1,
    )


def complex_queries(lhs: torch.Tensor, rel: torch.Tensor, rank: int) -> torch.Tensor:
    """Query vector q(lhs, rel) with score(q, rhs) = q @ rhs
    (RSME models.py get_queries)."""
    l_re, l_im = split_complex(lhs, rank)
    r_re, r_im = split_complex(rel, rank)
    return torch.cat([l_re * r_re - l_im * r_im, l_re * r_im + l_im * r_re], dim=-1)


def distmult_score(h: torch.Tensor, r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.sum(h * r * t, dim=-1)


def margin_loss(
    p_dist: torch.Tensor, n_dist: torch.Tensor, margin: float
) -> torch.Tensor:
    """mean(max(p - n, -margin)) + margin — MarginLoss parity
    (IKRL.py:171-196). p_dist (B,) or (B,1); n_dist (B, N)."""
    if p_dist.ndim < n_dist.ndim:
        p_dist = p_dist[..., None]
    return torch.mean(torch.maximum(p_dist - n_dist, _const(-margin, n_dist))) + margin


def softplus_loss(p_score: torch.Tensor, n_score: torch.Tensor) -> torch.Tensor:
    """(mean(softplus(-p)) + mean(softplus(n))) / 2 — SoftplusLoss parity
    (IKRL.py:887-911). Scores here follow the energy convention of the
    caller (IKRL passes raw energies). softplus is ``logaddexp(x, 0)``, as
    in JAX (``F.softplus`` turns linear above its threshold)."""

    def sp(x):
        return torch.logaddexp(x, torch.zeros_like(x))

    return (torch.mean(sp(-p_score)) + torch.mean(sp(n_score))) / 2.0
