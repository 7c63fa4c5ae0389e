"""Fused multi-head attention, forward and backward: the CUDA kernels, their
wrappers and their plain PyTorch versions.

The port of ``mkg_analogy_tpu/kernels/attention.py:fused_attention`` (the
Pallas ``_fwd_kernel`` and ``_bwd_kernel`` under a ``jax.custom_vjp``). One
call computes, per (batch row, head)::

    softmax(d^-1/2 · Q Kᵀ ∘ analogy multiplier + (1 - mask) · -1e4) · V

with fp32 scores and softmax, attention dropout, and the probabilities cast
to the compute dtype before the product with V, on the packed
(B, L, heads·d) layout of the projection GEMMs, in and out.

- ``fused_attention`` is the entry point, with the JAX signature, and is
  differentiable: a ``torch.autograd.Function`` that saves q, k, v, the
  mask, the boundary, (w0, w1) and the dropout seed — never the
  probabilities — and recomputes them in the backward, as the JAX custom VJP
  does. A CUDA tensor launches the hand-written kernels, built at first use
  by ``kernels/build.py``, and the dtype alone picks them: bf16, which every
  main path runs, the tensor-core kernels (``csrc/fused_attention_fwd_mma.cu``,
  ``csrc/fused_attention_bwd_mma.cu``: ``mma.sync`` products on ``ldmatrix``
  fragments, ``cp.async`` staging, helpers in ``csrc/attention_mma.cuh``);
  fp32, whose bar of 2e-5 TF32 cannot meet, the tiled CUDA-core kernels
  (``csrc/fused_attention_fwd.cu``, ``csrc/fused_attention_bwd.cu``, helpers
  in ``csrc/attention_fp32.cuh``: register micro-tiles of exact fp32 FMAs,
  one sweep over the keys with an online softmax, shared memory set by the
  head width alone). The fp32 forward also writes each row's max and the log
  of its sum (``lse``, (B, heads, Lq, 2)), and the fp32 route's autograd
  function saves its output and that lse, from which the backward rebuilds
  P and delta = rowsum(g · out) in one sweep of each pass. Both routes take
  any key count, as the JAX kernel does (it stages a head's whole K/V of any
  length). A CPU tensor takes the plain versions. Nothing falls back from
  one to another.
  The clamps of w0/w1 stay outside, so autograd chains them.
- ``fused_attention_reference`` is the plain forward (the
  ``AttentionCore._einsum`` math on the packed layout) and
  ``fused_attention_bwd_reference`` the plain backward: the formula of
  ``_bwd_kernel`` written out, with its cast points, not autograd through the
  forward. The CPU tests hold both to the JAX kernels in interpret mode, and
  ``chip_smoke.py`` holds the CUDA kernels to them on the card.
  ``_tiled_fwd`` and ``_tiled_bwd`` mirror the fp32 kernels' algorithm in
  plain PyTorch (key tiles, the online softmax and its lse, the backward
  from lse and delta), for the tests alone.
- The kernels take every head_dim d from 1 to 256 (``MAX_HEAD_DIM``; above
  it the wrapper raises ``ValueError``). Each CUDA library exports the
  instantiations at 64 (BERT-base, ViT-B) and 128 (ViLBERT's visual stream,
  1024 wide with 8 heads); any other width runs the instance of its padded
  width Dp (d rounded up to a multiple of 16 up to 128: MiniLM's 32, the
  small recipes' 16; to 192 or 256 above: MKGformer's 768 over 3 heads)
  from a library of its own (``kernels/build.py:library_width``,
  ``csrc/attention_width.cuh``). The launchers pass the width of the call
  (``hd // num_heads``) and its scale ``d ** -0.5``, of the real width,
  never Dp's.
- ``LAUNCHES`` and ``LAUNCHES_BWD`` count kernel launches, so a run can show
  that its main path went through the kernels; ``LAUNCHES_D128`` and
  ``LAUNCHES_BWD_D128`` count the head_dim-128 ones among them, and
  ``WIDTH_LAUNCHES`` every launch by ("fwd" or "bwd", head_dim).

Dropout masks come from the counter hash of the JAX kernel's interpret mode
(``_dropout_keep``: lowbias32 on ``row * Lk + col`` xor ``seed *
0x9E3779B9``, per-(b, head) seed ``seed + b * heads + head``), in the plain
versions and in both kernels, so the backward regenerates the forward's
mask. A rank of a mesh holds a slice of the batch rows and of the heads: it
passes ``cell_stride`` (the global head count) and ``cell_offset`` (the
global cell of its first row and head), and its (b, head) takes the seed
``seed + cell_offset + b * cell_stride + head``, the one the whole call
gives that global row and head; without them a call keys its own rows and
heads. The offset is folded into the seed on the host (``_resolve``), so
the kernels and the plain versions take the seed and the stride. The plain
versions match the JAX interpret-mode kernels bit for bit in their masks,
and the CUDA kernels match the plain versions; none reproduces the TPU's
hardware random bits.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from . import build

NEG_BIAS = -10000.0  # reference padding bias (modeling_unimo.py:56)
MAX_HEAD_DIM = build.MAX_HEAD_DIM  # the widest head the kernels take
ROWS_PER_BLOCK = 64  # query rows per block of every kernel (csrc kRowsPerBlock, kTile)
LAUNCHES = 0         # forward kernel launches since import (or a caller's reset)
LAUNCHES_BWD = 0     # backward kernel launches, likewise
LAUNCHES_D128 = 0    # the head_dim-128 forward launches among LAUNCHES
LAUNCHES_BWD_D128 = 0  # the head_dim-128 backward launches among LAUNCHES_BWD
WIDTH_LAUNCHES = collections.Counter()  # ("fwd" | "bwd", head_dim) -> launches

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant, without leaving int64's range (PyTorch has no uint32 math)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def keep_bits(idx: torch.Tensor, seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """Keep bits of the JAX interpret-mode ``_dropout_keep`` at int64 element
    indices ``idx`` under int64 ``seeds`` (broadcast against each other):
    lowbias32 of ``idx`` xor ``seed * 0x9E3779B9``."""
    x = idx ^ _mul32(seeds & _M32, 0x9E3779B9)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= int(rate * float(2 ** 32))


def hash_keep(seeds: torch.Tensor, rows: int, cols: int, rate: float) -> torch.Tensor:
    """(..., rows, cols) keep mask of the JAX interpret-mode ``_dropout_keep``
    on a (rows, cols) plane for each int64 seed in ``seeds`` (any shape):
    the keep bits of ``row * cols + col``."""
    idx = (torch.arange(rows, device=seeds.device)[:, None] * cols
           + torch.arange(cols, device=seeds.device)[None, :])
    return keep_bits(idx, seeds[..., None, None], rate)


def dropout_cells(batch: int, num_heads: int, stride, device) -> torch.Tensor:
    """(B, heads) int64 dropout cells ``b * stride + head`` of a call's (b,
    head); ``stride`` None: the call's own heads."""
    stride = num_heads if stride is None else stride
    return (torch.arange(batch, device=device)[:, None] * stride
            + torch.arange(num_heads, device=device)[None, :])


def dropout_keep(batch: int, num_heads: int, lq: int, lk: int, rate: float,
                 seed: int, device, stride=None) -> torch.Tensor:
    """(B, heads, Lq, Lk) keep mask of the JAX interpret-mode kernel
    (attention.py:_dropout_keep with the seeds of ``_cell_seed``). A slice of
    a larger call's rows and heads passes that call's head count as
    ``stride`` and, folded into ``seed``, the cell of its first row and
    head."""
    return hash_keep(dropout_cells(batch, num_heads, stride, device) + seed, lq, lk, rate)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """Scores, softmax and sums run in fp32 (fp64 for fp64 inputs, which
    only the gradient checks use)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _geometry_planes(boundary, w, lq, lk, geometry):
    """(mult, region0, region1), each (B, 1, Lq, Lk), of the analogy geometry
    (attention.py:_geometry_planes); ``w`` holds the clamped (w0, w1) and
    region0/region1 are the 0/1 planes of the dw0/dw1 sums."""
    row_start, text_len, offset = geometry
    rows = torch.arange(lq, device=boundary.device)[:, None]
    cols = torch.arange(lk, device=boundary.device)[None, :]
    bnd = (boundary.long() + offset)[:, None, None]
    col_is_answer = (cols >= bnd) & (cols < text_len)
    row_is_example = (rows >= row_start) & (rows < bnd)
    row_is_answer = rows >= bnd
    row_in_scope = (row_is_example | row_is_answer) & (rows < text_len)
    region0 = col_is_answer & row_in_scope & row_is_example
    region1 = col_is_answer & row_in_scope & ~row_is_example
    one = torch.ones((), dtype=w.dtype, device=boundary.device)
    mult = torch.where(region0, w[0], torch.where(region1, w[1], one))
    return mult[:, None], region0[:, None].to(w.dtype), region1[:, None].to(w.dtype)


def _resolve(q, boundary, w0, w1, text_len, row_start, offset, dropout_rate,
             deterministic, dropout_seed, cell_offset=0, seeds_per_cell=1):
    """The call's normalised arguments, as attention.py:fused_attention
    resolves them: the int32 boundary (zeros when absent), (w0, w1) as one
    tensor (ones when absent), the geometry (row_start, text_len, offset) or
    None, the dropout rate in effect (0 when deterministic) and the seed,
    with ``cell_offset`` cells of ``seeds_per_cell`` seeds each (1 here; a
    flash call's tile count) folded in."""
    b, lq = q.shape[0], q.shape[1]
    acc = _acc_dtype(q)
    if w0 is None:
        w = torch.ones(2, dtype=acc, device=q.device)
    else:
        w = torch.stack([w0.reshape(()), w1.reshape(())]).to(acc)
    geometry = None
    if boundary is None:
        bnd = torch.zeros(b, dtype=torch.int32, device=q.device)
    else:
        bnd = boundary.to(device=q.device, dtype=torch.int32).reshape(b)
        geometry = (int(row_start), lq if text_len is None else int(text_len),
                    int(offset))
    rate = 0.0 if deterministic else float(dropout_rate)
    seed = int(dropout_seed or 0) + int(cell_offset) * seeds_per_cell
    return bnd, w, geometry, rate, seed


def _split_heads(x, num_heads, dtype):
    b, length, hd = x.shape
    return x.reshape(b, length, num_heads, hd // num_heads).transpose(1, 2).to(dtype)


def _merge_heads(x, dtype):
    b, h, length, d = x.shape
    return x.transpose(1, 2).reshape(b, length, h * d).to(dtype)


def _score(products, scale, mult, bias):
    """(s_raw, s) of the raw q·k products as XLA computes the JAX kernels'
    ``s_raw = dot * scale; s = s_raw * mult + bias`` inside them (their
    interpret mode, on the CPU): s_raw rounded, and s contracted into one
    multiply-add, ``dot * scale + bias`` without the analogy multiplier,
    ``s_raw * mult + bias`` with it. Where a row's keys are all masked its
    scores sit at -1e4, where an fp32 ulp is 9.8e-4, and a product rounded
    first moves a score there by a whole ulp now and then. The port's
    products themselves still sum in torch.matmul's order, not XLA's dot's,
    which no plain PyTorch call reproduces."""
    s_raw = products * scale
    if mult is None:
        return s_raw, _fma(products, scale, bias)
    return s_raw, _fma(s_raw, mult, bias)


def _fma(a, b, c):
    """a * b + c rounded once to a's dtype: the product of two fp32 values
    is exact in fp64, and the fp64 sum rounds to another fp32 value than
    the exact one only where 29 bits below fp32's last one happen to read
    1000...0. fp64 inputs (the gradient checks) take a plain a * b + c."""
    if a.dtype == torch.float64:
        return a * b + c
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _qk_products(qh, kh):
    """The raw q·k products of (B, heads, L, d) heads: the (possibly bf16)
    inputs upcast to the accumulation dtype, multiplied and summed there."""
    acc = _acc_dtype(qh)
    return torch.matmul(qh.to(acc), kh.to(acc).transpose(-1, -2))


def _scores(q, k, mask, num_heads, bnd, w, geometry, qk_products=_qk_products):
    """(s_raw, planes or None, p): the scaled scores, the geometry planes
    and the softmax, (B, heads, Lq, Lk) in the accumulation dtype.
    ``qk_products`` forms the raw products from the heads (the plain route
    may give one with another backward, models/common.py:_qk_scores_bf16grad)."""
    products = qk_products(_split_heads(q, num_heads, q.dtype),
                           _split_heads(k, num_heads, k.dtype))
    return _softmax_scores(products, mask, bnd, w, geometry,
                           float(q.shape[2] // num_heads) ** -0.5)


def _softmax_scores(products, mask, bnd, w, geometry, scale):
    """_scores from the raw (B, heads, Lq, Lk) q·k products."""
    lq, lk = products.shape[-2:]
    planes = None if geometry is None else _geometry_planes(bnd, w, lq, lk, geometry)
    bias = ((1.0 - mask.to(products.dtype)) * NEG_BIAS)[:, None, None, :]
    s_raw, s = _score(products, scale, None if planes is None else planes[0], bias)
    return s_raw, planes, torch.softmax(s, dim=-1)


def _plain_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed,
               compute_dtype, qk_products=_qk_products, stride=None):
    b, lq, _ = q.shape
    lk = k.shape[1]
    _, _, p = _scores(q, k, mask, num_heads, bnd, w, geometry, qk_products)
    if rate > 0.0:
        keep = dropout_keep(b, num_heads, lq, lk, rate, seed, q.device, stride)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros((), dtype=p.dtype,
                                                           device=q.device))
    ctx = torch.matmul(p.to(compute_dtype), _split_heads(v, num_heads, compute_dtype))
    return _merge_heads(ctx, q.dtype)


def _plain_bwd(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed,
               compute_dtype, stride=None):
    """attention.py:_bwd_kernel :163-233, written out with its cast points."""
    b, lq, _ = q.shape
    lk = k.shape[1]
    acc = _acc_dtype(q)
    scale = float(q.shape[2] // num_heads) ** -0.5
    s_raw, planes, p = _scores(q, k, mask, num_heads, bnd, w, geometry)
    zero = torch.zeros((), dtype=acc, device=q.device)
    keep = None
    p_drop = p
    if rate > 0.0:
        keep = dropout_keep(b, num_heads, lq, lk, rate, seed, q.device, stride)
        inv = 1.0 / (1.0 - rate)
        p_drop = torch.where(keep, p * inv, zero)
    gh = _split_heads(g, num_heads, acc)
    # the forward casts the probabilities before ·V; so does dv (:199)
    p_cast = p_drop.to(compute_dtype).to(acc)
    dv = torch.matmul(p_cast.transpose(-1, -2), gh)
    dp = torch.matmul(gh, _split_heads(v, num_heads, acc).transpose(-1, -2))
    if keep is not None:
        dp = torch.where(keep, dp * inv, zero)                      # :208-209
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))         # :210
    if planes is not None:
        mult, region0, region1 = planes
        dw = torch.stack([torch.sum(ds * s_raw * region0),          # :212-213
                          torch.sum(ds * s_raw * region1)])
        ds = ds * mult
    else:
        dw = torch.zeros(2, dtype=acc, device=q.device)
    ds_raw = (ds * scale).to(compute_dtype).to(acc)                 # :217
    dq = torch.matmul(ds_raw, _split_heads(k, num_heads, acc))
    dk = torch.matmul(ds_raw.transpose(-1, -2), _split_heads(q, num_heads, acc))
    return (_merge_heads(dq, q.dtype), _merge_heads(dk, k.dtype),
            _merge_heads(dv, v.dtype), dw.to(w.dtype))


def _tiled_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, stride=None,
               block_k=64):
    """(out, lse) of the fp32 forward kernel's algorithm in plain PyTorch
    (csrc/fused_attention_fwd.cu; the tests use it, no route does): the keys
    in tiles of ``block_k``, an online softmax (each row's running max and
    sum, its accumulator rescaled when the max moves), and lse (B, heads,
    Lq, 2), each row's max and the log of its sum."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    acc = _acc_dtype(q)
    qh, kh, vh = (_split_heads(x, num_heads, acc) for x in (q, k, v))
    scale = float(hd // num_heads) ** -0.5
    mult = None if geometry is None else _geometry_planes(bnd, w, lq, lk, geometry)[0]
    bias = ((1.0 - mask.to(acc)) * NEG_BIAS)[:, None, None, :]
    keep = None
    if rate > 0.0:
        keep = dropout_keep(b, num_heads, lq, lk, rate, seed, q.device, stride)
    m = torch.full((b, num_heads, lq, 1), -float("inf"), dtype=acc, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qh)
    for j0 in range(0, lk, block_k):
        j = slice(j0, min(lk, j0 + block_k))
        _, s = _score(qh @ kh[:, :, j].transpose(-1, -2), scale,
                      None if mult is None else mult[..., j], bias[..., j])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., j], p, torch.zeros((), dtype=acc, device=q.device))
        o = o * corr + p @ vh[:, :, j]
        m = m_new
    o = o / l
    if rate > 0.0:
        o = o / (1.0 - rate)
    return _merge_heads(o, q.dtype), torch.cat([m, torch.log(l)], dim=-1)


def _tiled_bwd(q, k, v, mask, g, out, lse, num_heads, bnd, w, geometry, rate, seed,
               stride=None, block=64):
    """(dq, dk, dv, dw) of the fp32 backward kernels' algorithm in plain
    PyTorch (csrc/fused_attention_bwd.cu; the tests use it): P rebuilt from
    the forward's lse as exp((s - max) - log sum), delta = rowsum(g · out)
    (rowsum(dP · P) where every key fits one tile, as the kernel takes it
    there); the dq pass over key tiles (dq and the dw sums), the dK/dV pass
    over query tiles, each tile of ``block`` (the kernels' 64 up to head_dim
    64)."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    acc = _acc_dtype(q)
    qh, kh, vh, gh, oh = (_split_heads(x, num_heads, acc) for x in (q, k, v, g, out))
    scale = float(hd // num_heads) ** -0.5
    planes = None if geometry is None else _geometry_planes(bnd, w, lq, lk, geometry)
    bias = ((1.0 - mask.to(acc)) * NEG_BIAS)[:, None, None, :]
    keep = None
    if rate > 0.0:
        keep = dropout_keep(b, num_heads, lq, lk, rate, seed, q.device, stride)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    zero = torch.zeros((), dtype=acc, device=q.device)
    m, logl = lse[..., :1].to(acc), lse[..., 1:].to(acc)
    # every pass computes a score and a dP with the same instructions (the
    # kernels' row_dots), so here each product is formed once
    products = qh @ kh.transpose(-1, -2)
    gv = gh @ vh.transpose(-1, -2)

    def tile(r, j):
        """(s_raw, P, P~, dropped dP, dS, dS_raw, the region planes) of rows
        r and keys j."""
        mult = None if planes is None else planes[0][..., r, j]
        s_raw, s = _score(products[:, :, r, j], scale, mult, bias[..., j])
        p = torch.exp((s - m[:, :, r]) - logl[:, :, r])
        dp = gv[:, :, r, j]
        p_drop = p
        if keep is not None:
            kept = keep[:, :, r, j]
            p_drop = torch.where(kept, p * inv, zero)
            dp = torch.where(kept, dp * inv, zero)
        ds = p * (dp - delta[:, :, r])
        regions = None
        ds_w = ds
        if planes is not None:
            regions = (planes[1][..., r, j], planes[2][..., r, j])
            ds_w = ds * mult
        return s_raw, p, p_drop, dp, ds, ds_w * scale, regions

    rows = slice(0, lq)
    if lk <= block:  # rowsum(dP · P) of the one key tile
        delta = torch.zeros_like(m)  # (tile's dS, unused here, reads it)
        _, p, _, dp, _, _, _ = tile(rows, slice(0, lk))
        delta = (dp * p).sum(dim=-1, keepdim=True)
    else:
        delta = (gh * oh).sum(dim=-1, keepdim=True)

    dq, dk, dv = torch.zeros_like(qh), torch.zeros_like(kh), torch.zeros_like(vh)
    dw = torch.zeros(2, dtype=acc, device=q.device)
    for j0 in range(0, lk, block):  # the dq pass
        j = slice(j0, min(lk, j0 + block))
        s_raw, _, _, _, ds, ds_raw, regions = tile(rows, j)
        dq += ds_raw @ kh[:, :, j]
        if regions is not None:
            dw = dw + torch.stack([torch.sum(ds * s_raw * regions[0]),
                                   torch.sum(ds * s_raw * regions[1])])
    keys = slice(0, lk)
    for i0 in range(0, lq, block):  # the dK/dV pass
        r = slice(i0, min(lq, i0 + block))
        _, _, p_drop, _, _, ds_raw, _ = tile(r, keys)
        dv += p_drop.transpose(-1, -2) @ gh[:, :, r]
        dk += ds_raw.transpose(-1, -2) @ qh[:, :, r]
    return (_merge_heads(dq, q.dtype), _merge_heads(dk, k.dtype), _merge_heads(dv, v.dtype),
            dw.to(w.dtype))


def fused_attention_reference(
    q: torch.Tensor,              # (B, Lq, heads*d) packed
    k: torch.Tensor,              # (B, Lk, heads*d)
    v: torch.Tensor,              # (B, Lk, heads*d)
    mask: torch.Tensor,           # (B, Lk) 1=attend, 0=pad
    num_heads: int,
    *,
    boundary: Optional[torch.Tensor] = None,
    w0: Optional[torch.Tensor] = None,
    w1: Optional[torch.Tensor] = None,
    text_len: Optional[int] = None,
    row_start: int = 0,
    offset: int = 0,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    dropout_seed: Optional[int] = None,
    cell_stride: Optional[int] = None,
    cell_offset: int = 0,
    compute_dtype: torch.dtype = torch.bfloat16,
    qk_products=_qk_products,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_attention` (same arguments).
    Autograd differentiates it as it stands: the attention of
    ``--fused_attention 0``. ``qk_products`` forms the raw q·k products of
    the (B, heads, L, d) heads (default: upcast and multiplied in fp32)."""
    bnd, w, geometry, rate, seed = _resolve(q, boundary, w0, w1, text_len, row_start,
                                            offset, dropout_rate, deterministic,
                                            dropout_seed, cell_offset)
    return _plain_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed,
                      compute_dtype, qk_products, cell_stride)


def fused_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    g: torch.Tensor,              # (B, Lq, heads*d) cotangent of the output
    num_heads: int,
    *,
    boundary: Optional[torch.Tensor] = None,
    w0: Optional[torch.Tensor] = None,
    w1: Optional[torch.Tensor] = None,
    text_len: Optional[int] = None,
    row_start: int = 0,
    offset: int = 0,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    dropout_seed: Optional[int] = None,
    cell_stride: Optional[int] = None,
    cell_offset: int = 0,
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """Plain PyTorch version of the backward: (dq, dk, dv, dw), dw the (2,)
    gradient of the clamped (w0, w1) (zeros without a geometry)."""
    bnd, w, geometry, rate, seed = _resolve(q, boundary, w0, w1, text_len, row_start,
                                            offset, dropout_rate, deterministic,
                                            dropout_seed, cell_offset)
    return _plain_bwd(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed,
                      compute_dtype, cell_stride)


@functools.cache
def _lib(width=None) -> ctypes.CDLL:
    """The fp32 forward's library (at a padded head ``width``, or the one of
    64 and 128); so the three below."""
    lib = build.load("fused_attention_fwd", width)
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.mkg_fused_attention_fwd.argtypes = [
        p, p, p, p, p, p, p, p,     # q k v mask boundary w out lse
        i, i, i, i, i,              # batch lq lk num_heads head_dim
        f,                          # scale
        i, i, i, i,                 # has_geometry row_start text_len offset
        i, u, f, u,                 # dropout threshold keep_div seed
        u,                          # cell_stride
        p,                          # stream
    ]
    lib.mkg_fused_attention_fwd.restype = ctypes.c_int
    lib.mkg_fused_attention_fwd_smem.argtypes = [i]  # head_dim
    lib.mkg_fused_attention_fwd_smem.restype = ctypes.c_size_t
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_bwd(width=None) -> ctypes.CDLL:
    lib = build.load("fused_attention_bwd", width)
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.mkg_fused_attention_bwd.argtypes = [
        p, p, p, p, p, p, p,        # q k v g mask boundary w
        p, p,                       # out lse (the forward's)
        p, p, p, p, p,              # dq dk dv delta dw_part
        i, i, i, i, i,              # batch lq lk num_heads head_dim
        f,                          # scale
        i, i, i, i,                 # has_geometry row_start text_len offset
        i, u, f, u,                 # dropout threshold inv_keep seed
        u,                          # cell_stride
        p,                          # stream
    ]
    lib.mkg_fused_attention_bwd.restype = ctypes.c_int
    lib.mkg_fused_attention_bwd_smem.argtypes = [i]  # head_dim
    lib.mkg_fused_attention_bwd_smem.restype = ctypes.c_size_t
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_mma(width=None) -> ctypes.CDLL:
    lib = build.load("fused_attention_fwd_mma", width)
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.mkg_fused_attention_fwd_mma.argtypes = [
        p, p, p, p, p, p, p,        # q k v mask boundary w out
        i, i, i, i, i,              # batch lq lk num_heads head_dim
        f,                          # scale
        i, i, i, i,                 # has_geometry row_start text_len offset
        i, u, f, u,                 # dropout threshold inv_keep seed
        u,                          # cell_stride
        p,                          # stream
    ]
    lib.mkg_fused_attention_fwd_mma.restype = ctypes.c_int
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_bwd_mma(width=None) -> ctypes.CDLL:
    lib = build.load("fused_attention_bwd_mma", width)
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.mkg_fused_attention_bwd_mma.argtypes = [
        p, p, p, p, p, p, p,        # q k v g mask boundary w
        p, p, p, p, p,              # dq dk dv stats dw_part
        i, i, i, i, i,              # batch lq lk num_heads head_dim
        f,                          # scale
        i, i, i, i,                 # has_geometry row_start text_len offset
        i, u, f, u,                 # dropout threshold inv_keep seed
        u,                          # cell_stride
        p,                          # stream
    ]
    lib.mkg_fused_attention_bwd_mma.restype = ctypes.c_int
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_tensor(name, t, q):
    if t.device != q.device or t.dtype != q.dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, q: {q.dtype} on {q.device}")
    if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"(B, L, heads*d) tensor, got {tuple(t.shape)}")


def _check_inputs(q, k, v, mask, num_heads, compute_dtype, kernel="fused_attention"):
    if q.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{kernel} kernel takes bfloat16 or float32, got {q.dtype}")
    if compute_dtype != q.dtype:
        raise ValueError(
            f"{kernel} kernel computes in the inputs' dtype ({q.dtype}), "
            f"got compute_dtype={compute_dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, t, q)
    b, lq, hd = q.shape
    lk = k.shape[1]
    if hd % num_heads or not 1 <= hd // num_heads <= MAX_HEAD_DIM:
        raise ValueError(f"{kernel} kernel takes head_dim 1 to {MAX_HEAD_DIM}: width {hd} "
                         f"for {num_heads} heads")
    if k.shape != (b, lk, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if lq < 1 or lk < 1:
        raise ValueError(f"{kernel} needs at least one query and one key")
    if mask.shape != (b, lk):
        raise ValueError(f"mask {tuple(mask.shape)} is not (B, Lk) = {(b, lk)}")


def _head_dim(q, num_heads):
    return q.shape[2] // num_heads


def _check_smem(smem, q, what, hint="the device is not an H100-class card"):
    """Raise where a block of a kernel needs more shared memory than the
    device lets it have (the fp32 single-block kernels: a size set by the
    head width alone, never above an H100's 227 KB, at any length)."""
    limit = torch.cuda.get_device_properties(q.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"{what} needs {smem} bytes of shared memory per block, above the "
            f"device's {limit}: {hint}")


def _geometry_args(geometry, lq):
    row_start, text_len, offset = geometry if geometry is not None else (0, lq, 0)
    return int(geometry is not None), row_start, text_len, offset


def _raise_if(err, lib, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: " + lib.mkg_cuda_error_string(err).decode())


def _seed_args(seed, stride, num_heads):
    """(seed, cell stride) as the kernels take them, mod 2^32; ``stride``
    None: the call's own heads."""
    return seed & _M32, (num_heads if stride is None else stride) & _M32


def scale_of(head_dim: int) -> float:
    """The scores' scale: ``head_dim ** -0.5`` of the call's real width (a
    padded instance's tile width never enters it)."""
    return float(head_dim) ** -0.5


def _call_tail(q, head_dim, geometry, rate, seed, stride, keep):
    """The arguments every launcher ends with: the scale of the head width,
    the geometry, the dropout flag, threshold and ``keep`` (how the kernel
    scales a kept probability: its divisor 1 - rate or its factor
    1 / (1 - rate)), the seed and the cell stride, the stream."""
    return (scale_of(head_dim), *_geometry_args(geometry, q.shape[1]),
            int(rate > 0.0), int(rate * float(2 ** 32)), keep,
            *_seed_args(seed, stride, q.shape[2] // head_dim),
            torch.cuda.current_stream(q.device).cuda_stream)


def _inv_keep(rate):
    return (1.0 / (1.0 - rate)) if rate > 0.0 else 1.0


def _count_fwd(head_dim):
    global LAUNCHES, LAUNCHES_D128
    LAUNCHES += 1
    LAUNCHES_D128 += head_dim == 128
    WIDTH_LAUNCHES["fwd", head_dim] += 1


def _count_bwd(head_dim):
    global LAUNCHES_BWD, LAUNCHES_BWD_D128
    LAUNCHES_BWD += 1
    LAUNCHES_BWD_D128 += head_dim == 128
    WIDTH_LAUNCHES["bwd", head_dim] += 1


def _check_fp32(q, what):
    if q.dtype != torch.float32:
        raise ValueError(f"{what} takes float32 (bf16 takes the tensor-core kernels), "
                         f"got {q.dtype}")


def _fwd_cuda_cores(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, stride=None):
    """(out, lse) of one launch of the fp32 forward (csrc/fused_attention_fwd.cu),
    uncounted: lse is the (B, heads, Lq, 2) fp32 row statistics the backward
    takes, each row's max and the log of its sum."""
    _check_fp32(q, "the CUDA-core forward")
    b, lq, _ = q.shape
    lk = k.shape[1]
    d = _head_dim(q, num_heads)
    lib = _lib(build.library_width(d))
    _check_smem(lib.mkg_fused_attention_fwd_smem(d), q, f"the fp32 forward at head_dim {d}")
    out = torch.empty_like(q)
    lse = torch.empty(b, num_heads, lq, 2, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mkg_fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), bnd.data_ptr(),
            w.data_ptr(), out.data_ptr(), lse.data_ptr(), b, lq, lk, num_heads, d,
            *_call_tail(q, d, geometry, rate, seed, stride, 1.0 - rate))
    _raise_if(err, lib, "fused_attention_fwd")
    return out, lse


def _launch_fwd_cuda_cores(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, stride=None):
    """The fp32 forward (csrc/fused_attention_fwd.cu, on the CUDA cores):
    (out, lse), one launch counted."""
    out, lse = _fwd_cuda_cores(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, stride)
    _count_fwd(_head_dim(q, num_heads))
    return out, lse


def _launch_fwd_mma(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, stride=None):
    """The tensor-core forward (csrc/fused_attention_fwd_mma.cu), bf16."""
    b, lq, _ = q.shape
    lk = k.shape[1]
    d = _head_dim(q, num_heads)
    lib = _lib_mma(build.library_width(d))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.mkg_fused_attention_fwd_mma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            bnd.data_ptr(), w.data_ptr(), out.data_ptr(), b, lq, lk, num_heads, d,
            *_call_tail(q, d, geometry, rate, seed, stride, _inv_keep(rate)))
    _raise_if(err, lib, "fused_attention_fwd_mma")
    _count_fwd(d)
    return out


def _launch_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, stride=None):
    """The output of one forward launch; the dtype alone picks the kernel."""
    if q.dtype == torch.bfloat16:
        return _launch_fwd_mma(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, stride)
    return _launch_fwd_cuda_cores(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed,
                                  stride)[0]


def _bwd_buffers(q, k, v, g, num_heads, stats_width):
    """(dq, dk, dv, stats, dw_part) of one backward: the results, the
    ``stats_width`` fp32 row statistics that the dq pass hands the dk/dv
    pass (the fp32 kernels' delta; the tensor-core ones' m, 1 / l, delta
    and multiplier), and one (dw0, dw1) partial per (b, head, query
    tile)."""
    _check_tensor("g", g, q)
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} is not q's shape {tuple(q.shape)}")
    b, lq, _ = q.shape
    stats = torch.empty(b, num_heads, lq, stats_width, dtype=torch.float32, device=q.device)
    tiles = -(-lq // ROWS_PER_BLOCK)
    dw_part = torch.empty(b, num_heads, tiles, 2, dtype=torch.float32, device=q.device)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), stats, dw_part


def _bwd_pointers(q, k, v, g, mask, bnd, w, buffers):
    return [t.data_ptr() for t in (q, k, v, g, mask, bnd, w, *buffers)]


def _launch_bwd_cuda_cores(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed,
                           stride=None, out=None, lse=None):
    """The fp32 backward (csrc/fused_attention_bwd.cu: the dq pass, then the
    dK/dV pass) from the forward's ``out`` and ``lse``. A call without them
    (a direct call, as the tests and chip_smoke.py make) has the forward
    kernel rebuild them first, within this backward's one counted launch."""
    _check_fp32(q, "the CUDA-core backward")
    b, lq, _ = q.shape
    lk = k.shape[1]
    d = _head_dim(q, num_heads)
    if out is None or lse is None:
        out, lse = _fwd_cuda_cores(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed,
                                   stride)
    _check_tensor("out", out, q)
    if out.shape != q.shape or lse.shape != (b, num_heads, lq, 2) \
            or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"out {tuple(out.shape)} / lse {tuple(lse.shape)} are not the "
                         f"forward's residuals of q {tuple(q.shape)}")
    buffers = _bwd_buffers(q, k, v, g, num_heads, 1)  # delta a row
    lib = _lib_bwd(build.library_width(d))
    _check_smem(lib.mkg_fused_attention_bwd_smem(d), q, f"the fp32 backward at head_dim {d}")
    with torch.cuda.device(q.device):
        err = lib.mkg_fused_attention_bwd(
            *_bwd_pointers(q, k, v, g, mask, bnd, w, (out, lse, *buffers)), b, lq, lk,
            num_heads, d, *_call_tail(q, d, geometry, rate, seed, stride, _inv_keep(rate)))
    _raise_if(err, lib, "fused_attention_bwd")
    _count_bwd(d)
    dq, dk, dv, _, dw_part = buffers
    return dq, dk, dv, dw_part.sum(dim=(0, 1, 2)).to(w.dtype)


def _launch_bwd_mma(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed, stride=None):
    """The tensor-core backward (csrc/fused_attention_bwd_mma.cu), bf16."""
    b, lq, _ = q.shape
    lk = k.shape[1]
    d = _head_dim(q, num_heads)
    # m, 1 / l, delta and the row's multiplier: 16 bytes a row
    buffers = _bwd_buffers(q, k, v, g, num_heads, 4)
    lib = _lib_bwd_mma(build.library_width(d))
    with torch.cuda.device(q.device):
        err = lib.mkg_fused_attention_bwd_mma(
            *_bwd_pointers(q, k, v, g, mask, bnd, w, buffers), b, lq, lk, num_heads, d,
            *_call_tail(q, d, geometry, rate, seed, stride, _inv_keep(rate)))
    _raise_if(err, lib, "fused_attention_bwd_mma")
    _count_bwd(d)
    dq, dk, dv, _, dw_part = buffers
    return dq, dk, dv, dw_part.sum(dim=(0, 1, 2)).to(w.dtype)


def _launch_bwd(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed, stride=None,
                out=None, lse=None):
    """dq, dk, dv and the (2,) dw of one backward; the dtype alone picks the
    kernels (``out`` and ``lse``, the fp32 forward's residuals, go to the fp32
    ones; bf16 recomputes its statistics). They write one (dw0, dw1) partial
    per (b, head, query tile) and the launcher sums them, so no float atomics
    run and fp32 results repeat from run to run."""
    if q.dtype == torch.bfloat16:
        return _launch_bwd_mma(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed,
                               stride)
    return _launch_bwd_cuda_cores(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed,
                                  stride, out, lse)


def _route(q) -> str:
    """The route of a call: "plain" for a CPU tensor; on the card the dtype
    alone picks "tensor_cores" (bf16) or "cuda_cores" (fp32)."""
    if q.device.type == "cpu":
        return "plain"
    return "tensor_cores" if q.dtype == torch.bfloat16 else "cuda_cores"


class _FusedAttention(torch.autograd.Function):
    """The custom VJP of attention.py:286-383: the forward saves its inputs
    and the seed, the backward recomputes the probabilities and the dropout
    mask. The fp32 CUDA route also saves its output and lse (the row
    statistics its backward rebuilds P from in one sweep); the bf16 and CPU
    routes keep JAX's residuals. Gradients flow to q, k, v and the stacked
    (w0, w1)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bnd, w, num_heads, geometry, rate, seed,
                compute_dtype, stride):
        route = _route(q)
        ctx.call = (route, num_heads, geometry, rate, seed, compute_dtype, stride)
        args = (q, k, v, mask, num_heads, bnd, w, geometry, rate, seed)
        residuals = ()
        if route == "plain":
            out = _plain_fwd(*args, compute_dtype, stride=stride)
        elif route == "tensor_cores":
            out = _launch_fwd_mma(*args, stride)
        else:
            out, lse = _launch_fwd_cuda_cores(*args, stride)
            residuals = (out, lse)
        ctx.save_for_backward(q, k, v, mask, bnd, w, *residuals)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, bnd, w, *residuals = ctx.saved_tensors
        route, num_heads, geometry, rate, seed, compute_dtype, stride = ctx.call
        if route == "plain":
            dq, dk, dv, dw = _plain_bwd(q, k, v, mask, g, num_heads, bnd, w,
                                        geometry, rate, seed, compute_dtype, stride)
        else:
            # g comes from the out-projection's backward
            dq, dk, dv, dw = _launch_bwd(q, k, v, mask, g.to(q.dtype).contiguous(),
                                         num_heads, bnd, w, geometry, rate, seed, stride,
                                         *residuals)
        return dq, dk, dv, None, None, dw, None, None, None, None, None, None


def fused_attention(
    q: torch.Tensor,              # (B, Lq, heads*d) packed
    k: torch.Tensor,              # (B, Lk, heads*d)
    v: torch.Tensor,              # (B, Lk, heads*d)
    mask: torch.Tensor,           # (B, Lk) 1=attend, 0=pad
    num_heads: int,
    *,
    boundary: Optional[torch.Tensor] = None,  # (B,) sep_idx[:, 2]
    w0: Optional[torch.Tensor] = None,        # clamped scalar, shape (1,)
    w1: Optional[torch.Tensor] = None,
    text_len: Optional[int] = None,
    row_start: int = 0,
    offset: int = 0,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    dropout_seed: Optional[int] = None,
    cell_stride: Optional[int] = None,
    cell_offset: int = 0,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """softmax(scale·QKᵀ ∘ analogy_mult + pad_bias) @ V, fused, in the
    packed (B, L, H) head layout of the projection GEMMs; differentiable in
    q, k, v, w0 and w1.

    ``boundary``/``w0``/``w1`` enable the analogy multiplier with the
    ops/masks.py geometry (row_start / text_len / compat offset); w0 and w1
    arrive clamped. On CPU tensors this is the plain forward and backward (any
    head width); on CUDA tensors it launches the kernels (bf16 or fp32,
    head_dim 1 to 256, any key count, compute dtype = the inputs' dtype) or
    raises.
    """
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    bnd, w, geometry, rate, seed = _resolve(q, boundary, w0, w1, text_len, row_start,
                                            offset, dropout_rate, deterministic,
                                            dropout_seed, cell_offset)
    maskf = mask.to(device=q.device, dtype=_acc_dtype(q)).contiguous()
    if q.device.type != "cpu":
        _check_inputs(q, k, v, maskf, num_heads, compute_dtype)
    return _FusedAttention.apply(q, k, v, maskf, bnd.contiguous(), w.contiguous(),
                                 num_heads, geometry, rate, seed, compute_dtype, cell_stride)
