"""Attention-mask construction, vectorized (``mkg_analogy_tpu/ops/masks.py``).

The reference mutates per-example attention-score slices in a Python loop
(modeling_unimo.py:342-349):

    scores[i, :, :idx2, idx2:] *= clamp(w0, 0.0, 0.5)   # example -> answer
    scores[i, :, idx2:, idx2:] *= clamp(w1, 0.5, 1.0)   # answer  -> answer

where ``idx2 = sep_idx[i][2]`` is the example/question boundary. Here it is
one broadcast multiplier tensor built from index comparisons. The per-family
geometries (``row_start``, ``text_len``, ``compat_img_offset``) are those of
the JAX module; see its docstring for their reference sources.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_BIAS = -10000.0  # reference padding bias (modeling_unimo.py:56)


def attention_bias(attention_mask: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, L) {0,1} padding mask -> (B, 1, 1, L) additive bias of 0 / -1e4."""
    bias = (1.0 - attention_mask.to(dtype)) * NEG_BIAS
    return bias[:, None, None, :]


def analogy_score_multiplier(
    boundary: torch.Tensor,
    seq_len: int,
    w_example_to_answer: torch.Tensor,
    w_answer_to_answer: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    text_len: Optional[int] = None,
    row_start: int = 0,
    compat_img_offset: Optional[int] = None,
) -> torch.Tensor:
    """Per-example (B, 1, L, L) multiplier for raw attention scores.

    boundary: (B,) int — sep_idx[:, 2]. Columns >= boundary (and inside the
    text block) are scaled by w0 for example rows (``row_start`` <= row <
    boundary) and w1 for answer rows; everything else keeps 1.
    ``compat_img_offset`` reproduces the reference's shifted single-stream
    geometry and is mutually exclusive with ``text_len``.
    """
    w0 = w_example_to_answer.clamp(0.0, 0.5).to(dtype)
    w1 = w_answer_to_answer.clamp(0.5, 1.0).to(dtype)
    pos = torch.arange(seq_len, device=boundary.device)
    if compat_img_offset is not None:
        if text_len is not None:
            raise ValueError("compat offset replaces text-coord clamping")
        boundary = boundary + compat_img_offset
        row_start = compat_img_offset + 1
        is_text = torch.ones_like(pos, dtype=torch.bool)
    else:
        is_text = pos < (seq_len if text_len is None else text_len)
    bnd = boundary[:, None]
    row_is_example = ((pos[None, :] >= row_start) & (pos[None, :] < bnd))[:, :, None]
    row_is_answer = (pos[None, :] >= bnd)[:, :, None]
    col_is_answer = ((pos[None, :] >= bnd) & is_text[None, :])[:, None, :]
    row_in_scope = (row_is_example | row_is_answer) & is_text[None, :, None]
    one = torch.ones((), dtype=dtype, device=boundary.device)
    mult = torch.where(
        col_is_answer & row_in_scope,
        torch.where(row_is_example, w0, w1),
        one,
    )
    return mult[:, None, :, :]
