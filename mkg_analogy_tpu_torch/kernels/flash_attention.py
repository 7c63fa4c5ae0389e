"""K-blocked (flash) fused attention, forward and backward: the CUDA kernels,
their wrappers and their plain PyTorch versions.

The port of ``mkg_analogy_tpu/kernels/flash_attention.py:flash_attention``
(the Pallas ``_flash_fwd_kernel``, ``_flash_bwd_kv_kernel`` and
``_flash_bwd_q_kernel`` under a ``jax.custom_vjp``). Same contract as
``kernels/attention.py:fused_attention`` (scaled QKᵀ, the analogy
multiplier, the padding bias, fp32 softmax, attention dropout, ·V, on the
packed (B, L, heads·d) layout), computed as an **online softmax over K
tiles**, so no (Lq, Lk) plane is ever held whole: it takes any sequence
length.

Logical tiles: ``bq = min(block_q, Lq)`` query rows by ``bk = min(block_k,
Lk)`` keys (256 and 512 by default, as in JAX). They fix two things of the
result, so the kernels keep them whatever they stage:

- the dropout mask of a (q-tile, k-tile) is the JAX interpret-mode hash
  (``_dropout_keep``) of ``row_in_tile * bk + col_in_tile`` with the tile
  seed ``seed + ((b·heads + head)·n_qblk + qb)·n_kblk + kb`` (``_tile_seed``),
  the row stride ``bk`` even in a ragged last tile; a rank of a mesh passes
  ``cell_stride`` and ``cell_offset`` (kernels/attention.py), so that
  ``b·heads + head`` is the global cell of its row and head (the offset
  folded into the seed on the host, ``cell_offset·n_qblk·n_kblk``);
- the online softmax updates its running max once per K tile, and the
  exp-weights ``exp(s - m)`` are rounded to the compute dtype against that
  max before ·V, then the sum divides in fp32 at the end (the single-block
  kernel rounds normalised probabilities instead). Both kernel sets take
  each logical tile's max before any exponential; in fp32 the rounding is
  none, but the order of operations is kept too, since the fp32 training
  steps amplify a re-association of round-off (chip_smoke.py's gradient
  gates).

Out-of-range columns of a ragged last K tile carry ``HARD_MASK`` (their
exp-weight is exactly 0) and out-of-range rows contribute nothing to
dK/dV (JAX zeroes their q, g, lse and delta).

- ``flash_attention`` is the entry point, with the JAX signature; a
  ``torch.autograd.Function`` that saves q, k, v, the mask, the boundary,
  (w0, w1), the seed, the output and the per-row log-sum-exp. Its backward
  computes ``delta = rowsum(g · out)`` in fp32 (outside any kernel, as JAX
  does) and runs the dK/dV and the dQ kernels. A CUDA tensor launches the
  hand-written kernels, built at first use by ``kernels/build.py`` and
  picked by the dtype alone: bf16 takes the tensor-core kernels
  (``csrc/flash_attention_fwd_mma.cu``, ``csrc/flash_attention_bwd_mma.cu``),
  fp32 the CUDA-core ones, which take fp32 alone (``csrc/flash_attention_fwd.cu``,
  the tiled forward of ``csrc/attention_fp32_fwd.cuh``, and
  ``csrc/flash_attention_bwd.cu``, the tiled passes of
  ``csrc/attention_fp32_bwd.cuh``, each shared with the single-block fp32
  kernel of kernels/attention.py). A CPU tensor takes the plain versions.
  Nothing falls back from one to the other.
- ``flash_attention_reference`` and ``flash_attention_bwd_reference`` are
  the plain versions: they walk the logical tiles as the three kernel bodies
  do. The CPU tests hold them to the JAX kernels in interpret mode, and
  ``chip_smoke.py`` holds the CUDA kernels to them on the card.
  ``_tiled_fwd`` and ``_tiled_bwd`` are the fp32 kernels' walks in plain
  PyTorch (64-row tiles against the logical dropout tiles; the forward's
  staged key tiles and one lse a row, the backward's one dw partial per 64
  keys); the tests hold them to JAX, no route calls them.
- The kernels take every head_dim from 1 to 256, as the single-block ones
  do (kernels/attention.py): 64 (BERT-base, ViT-B) and 128 (ViLBERT's
  visual stream) from the libraries that export both instantiations, any
  other width from the library of its padded width (a multiple of 16 up to
  128, 192 or 256 above); the launchers pass the width of the call
  (``hd // num_heads``) and its scale, of the real width.
- ``causal`` (queries and keys at the same positions, Lq = Lk) takes no
  key after its query row: its score is ``HARD_MASK`` in the plain
  versions, -inf in the kernels, its weight exactly 0 in both. And v may be
  narrower than q and k (``d_v <= d``, latent attention's 128 under 192):
  the output, dv and every product with V or g are ``d_v`` wide. Either
  takes the bf16 kernels in the library of the call's padded width (the
  instances of 64 and 128 are left as they are: a call of 64 or 128 that
  is causal or narrower in v goes to the ``-DMKG_ATTN_DP`` library of its
  width), which skip the tiles wholly above the diagonal; the fp32 kernels
  take neither and raise.
- ``LAUNCHES_FLASH``, ``LAUNCHES_FLASH_DKV`` and ``LAUNCHES_FLASH_DQ``
  count kernel launches (a forward, dK/dV or dQ launch on either route);
  ``LAUNCHES_FLASH_FWD_MMA``, ``LAUNCHES_FLASH_DKV_MMA`` and
  ``LAUNCHES_FLASH_DQ_MMA`` count those of the tensor-core kernels alone;
  each has a ``_D128`` sibling that counts its head_dim-128 launches, and
  ``WIDTH_LAUNCHES_FLASH`` counts every launch by (count name without
  its ``LAUNCHES_FLASH`` prefix: "", "_DKV", "_DQ", "_FWD_MMA", "_DKV_MMA"
  or "_DQ_MMA"; head_dim).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import build
from .attention import (
    NEG_BIAS,
    ROWS_PER_BLOCK,
    _acc_dtype,
    _check_fp32,
    _check_inputs,
    _check_smem,
    _check_tensor,
    _geometry_args,
    _head_dim,
    _merge_heads,
    _raise_if,
    _resolve,
    _score,
    _seed_args,
    _span,
    _split_heads,
    dropout_cells,
    hash_keep,
    keep_bits,
    scale_of,
)

HARD_MASK = -1e30    # exact exclusion of out-of-range K columns (exp -> 0)
BLOCK_Q, BLOCK_K = 256, 512  # logical tile defaults (flash_attention.py:533-534)
# keys per dK/dV block, one (dw0, dw1) partial each, on both routes (the
# tensor-core kernel's kTile, the CUDA-core one's kRows)
KEYS_PER_BLOCK = 64
LAUNCHES_FLASH = 0      # forward kernel launches since import (or a caller's reset)
LAUNCHES_FLASH_DKV = 0  # dK/dV kernel launches, either route, likewise
LAUNCHES_FLASH_DQ = 0   # dQ kernel launches, either route, likewise
LAUNCHES_FLASH_FWD_MMA = 0  # of those, the tensor-core (bf16) kernels'
LAUNCHES_FLASH_DKV_MMA = 0
LAUNCHES_FLASH_DQ_MMA = 0
LAUNCHES_FLASH_D128 = 0      # the head_dim-128 launches among each count above
LAUNCHES_FLASH_DKV_D128 = 0
LAUNCHES_FLASH_DQ_D128 = 0
LAUNCHES_FLASH_FWD_MMA_D128 = 0
LAUNCHES_FLASH_DKV_MMA_D128 = 0
LAUNCHES_FLASH_DQ_MMA_D128 = 0
WIDTH_LAUNCHES_FLASH = collections.Counter()  # (count suffix, head_dim) -> launches


def _blocks(lq, lk, block_q, block_k):
    """(bq, bk, n_qblk, n_kblk) of flash_attention.py:_blocks."""
    bq, bk = min(block_q, lq), min(block_k, lk)
    return bq, bk, -(-lq // bq), -(-lk // bk)


def _tile_count(q, k, block_q, block_k):
    """The logical tiles of one (b, head): the seeds a dropout cell spans."""
    _, _, n_qblk, n_kblk = _blocks(q.shape[1], k.shape[1], block_q, block_k)
    return n_qblk * n_kblk


def _dropout_keep(batch, num_heads, bq, bk, rate, seed, qb, kb, n_qblk, n_kblk, device,
                  stride=None):
    """(B, heads, bq, bk) keep mask of the logical tile (qb, kb): the hash
    of attention.py:_dropout_keep with the seed of flash_attention.py:
    _tile_seed, the cells ``b * stride + head`` (``stride`` None: the call's
    own heads; a slice of a larger call's rows and heads folds the cell of
    its first row and head, times ``n_qblk * n_kblk``, into ``seed``)."""
    cell = dropout_cells(batch, num_heads, stride, device)
    return hash_keep(seed + (cell * n_qblk + qb) * n_kblk + kb, bq, bk, rate)


def _geometry_planes(boundary, w, rows, cols, geometry):
    """(mult, region0, region1), each (B, 1, len(rows), len(cols)), of the
    analogy geometry at the absolute row and column indices of a tile
    (attention.py:_geometry_planes with row0/col0)."""
    row_start, text_len, offset = geometry
    rows, cols = rows[:, None], cols[None, :]
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


class _Tiles:
    """The logical tiles of one call and what every kernel body computes on
    a (q-tile, k-tile): heads split, fp32 (fp64 for fp64 inputs), a ragged
    last K tile padded to ``bk`` keys with zeros and a ``HARD_MASK`` bias,
    and only the real rows of a ragged last Q tile (rows are independent,
    and JAX's zeroed out-of-range rows add exact zeros to dK/dV)."""

    def __init__(self, q, k, mask, num_heads, bnd, w, geometry, rate, seed,
                 block_q, block_k, stride=None, causal=False):
        b, lq, hd = q.shape
        self.lk = k.shape[1]
        self.causal = causal
        self.acc = _acc_dtype(q)
        self.scale = float(hd // num_heads) ** -0.5
        self.bq, self.bk, self.n_qblk, self.n_kblk = _blocks(lq, self.lk, block_q, block_k)
        self.num_heads, self.bnd, self.w, self.geometry = num_heads, bnd, w, geometry
        self.rate, self.seed, self.stride = rate, seed, stride
        self.bias = (1.0 - mask.to(self.acc)) * NEG_BIAS              # (B, Lk)

    def rows(self, qb, lq):
        r0 = qb * self.bq
        return r0, min(r0 + self.bq, lq)

    def keys(self, x, kb):
        """(B, heads, bk, d) slice of head-split keys or values, zero-padded."""
        c0 = kb * self.bk
        t = x[:, :, c0:c0 + self.bk]
        return F.pad(t, (0, 0, 0, self.bk - t.shape[2]))

    def scores(self, qt, kt, qb, kb, r0, r1):
        """(s_raw, planes or None, s) of the tile, (B, heads, r1 - r0, bk)."""
        c0 = kb * self.bk
        planes = None
        if self.geometry is not None:
            dev = qt.device
            planes = _geometry_planes(self.bnd, self.w, torch.arange(r0, r1, device=dev),
                                      torch.arange(c0, c0 + self.bk, device=dev),
                                      self.geometry)
        bias = self.bias[:, c0:c0 + self.bk]
        bias = F.pad(bias, (0, self.bk - bias.shape[1]), value=HARD_MASK)  # _col_bias
        s_raw, s = _score(torch.matmul(qt, kt.transpose(-1, -2)), self.scale,
                          None if planes is None else planes[0], bias[:, None, None, :])
        if self.causal:
            dev = qt.device
            later = (torch.arange(c0, c0 + self.bk, device=dev)[None, :]
                     > torch.arange(r0, r1, device=dev)[:, None])
            s = s.masked_fill(later, HARD_MASK)
        return s_raw, planes, s

    def keep(self, qb, kb, r0, r1, device):
        """The tile's keep mask on its real rows, or None without dropout."""
        if self.rate <= 0.0:
            return None
        keep = _dropout_keep(self.bnd.shape[0], self.num_heads, self.bq, self.bk,
                             self.rate, self.seed, qb, kb, self.n_qblk, self.n_kblk, device,
                             self.stride)
        return keep[:, :, :r1 - r0]


def _plain_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, compute_dtype,
               block_q, block_k, stride=None, causal=False):
    """(out (B, Lq, heads·d_v), lse (B, heads, Lq)): _flash_fwd_kernel :98-170
    tile by tile, its running max, sum and accumulator per row."""
    b, lq, _ = q.shape
    tiles = _Tiles(q, k, mask, num_heads, bnd, w, geometry, rate, seed, block_q, block_k,
                   stride, causal)
    acc = tiles.acc
    qh = _split_heads(q, num_heads, acc)
    kh = _split_heads(k, num_heads, acc)
    vh = _split_heads(v, num_heads, compute_dtype).to(acc)
    out = qh.new_empty(qh.shape[:3] + vh.shape[3:])
    lse = torch.empty(qh.shape[:3], dtype=acc, device=q.device)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    zero = torch.zeros((), dtype=acc, device=q.device)
    for qb in range(tiles.n_qblk):
        r0, r1 = tiles.rows(qb, lq)
        qt = qh[:, :, r0:r1]
        m = torch.full(qt.shape[:3] + (1,), HARD_MASK, dtype=acc, device=q.device)
        l = torch.zeros_like(m)
        o = qt.new_zeros(qt.shape[:3] + vh.shape[3:])
        for kb in range(tiles.n_kblk):
            _, _, s = tiles.scores(qt, tiles.keys(kh, kb), qb, kb, r0, r1)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            keep = tiles.keep(qb, kb, r0, r1, q.device)
            p_ctx = p if keep is None else torch.where(keep, p * inv, zero)
            pv = torch.matmul(p_ctx.to(compute_dtype).to(acc), tiles.keys(vh, kb))
            o = o * alpha + pv
            m = m_new
        out[:, :, r0:r1] = o / l
        lse[:, :, r0:r1] = (m + torch.log(l))[..., 0]
    return _merge_heads(out, q.dtype), lse


def _delta(g, out, num_heads):
    """(B, heads, Lq) rowsum(g · out) per head in fp32 (fp64 for fp64
    inputs), from the stored output (flash_attention.py:430-434)."""
    b, lq, hd = out.shape
    acc = _acc_dtype(out)
    prod = g.to(acc).reshape(b, lq, num_heads, -1) * out.to(acc).reshape(b, lq, num_heads, -1)
    return prod.sum(dim=-1).transpose(1, 2).contiguous()


def _plain_bwd(q, k, v, mask, g, lse, delta, num_heads, bnd, w, geometry, rate, seed,
               compute_dtype, block_q, block_k, stride=None, causal=False):
    """(dq, dk, dv, dw): the two backward kernel bodies, _flash_bwd_kv_kernel
    :183-268 and _flash_bwd_q_kernel :271-328, over the same tiles in one
    walk (their per-tile p and dS_raw are the same values), with their cast
    points: p_drop and dS_raw rounded to the compute dtype before the
    products, every sum in fp32."""
    b, lq, _ = q.shape
    tiles = _Tiles(q, k, mask, num_heads, bnd, w, geometry, rate, seed, block_q, block_k,
                   stride, causal)
    acc, lk, bk = tiles.acc, tiles.lk, tiles.bk
    qh, kh, vh, gh = (_split_heads(x, num_heads, acc) for x in (q, k, v, g))
    dq, dk, dv = torch.zeros_like(qh), torch.zeros_like(kh), torch.zeros_like(vh)
    dw = torch.zeros(2, dtype=acc, device=q.device)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    zero = torch.zeros((), dtype=acc, device=q.device)
    for qb in range(tiles.n_qblk):
        r0, r1 = tiles.rows(qb, lq)
        qt, gt = qh[:, :, r0:r1], gh[:, :, r0:r1]
        lse_t, delta_t = lse[:, :, r0:r1, None].to(acc), delta[:, :, r0:r1, None].to(acc)
        for kb in range(tiles.n_kblk):
            c0 = kb * bk
            n = min(bk, lk - c0)
            kt, vt = tiles.keys(kh, kb), tiles.keys(vh, kb)
            s_raw, planes, s = tiles.scores(qt, kt, qb, kb, r0, r1)
            p = torch.exp(s - lse_t)                                          # :180
            keep = tiles.keep(qb, kb, r0, r1, q.device)
            p_drop = p if keep is None else torch.where(keep, p * inv, zero)  # :230
            dv_t = torch.matmul(p_drop.to(compute_dtype).to(acc).transpose(-1, -2), gt)
            dv[:, :, c0:c0 + n] += dv_t[:, :, :n]                              # :233
            dp = torch.matmul(gt, vt.transpose(-1, -2))
            if keep is not None:
                dp = torch.where(keep, dp * inv, zero)                         # :242
            ds = p * (dp - delta_t)                                            # :243
            if planes is not None:
                mult, region0, region1 = planes
                dw += torch.stack([torch.sum(ds * s_raw * region0),             # :245-246
                                   torch.sum(ds * s_raw * region1)])
                ds = ds * mult
            ds_raw = (ds * tiles.scale).to(compute_dtype).to(acc)              # :250, :320
            dk[:, :, c0:c0 + n] += torch.matmul(ds_raw.transpose(-1, -2), qt)[:, :, :n]
            dq[:, :, r0:r1] += torch.matmul(ds_raw, kt)                        # :321
    return (_merge_heads(dq, q.dtype), _merge_heads(dk, k.dtype),
            _merge_heads(dv, v.dtype), dw.to(w.dtype))


def _tile_keep(b, lq, lk, num_heads, rate, seed, block_q, block_k, stride, device):
    """(B, heads, Lq, Lk) keep mask of the whole call, each element's bit
    from its logical (bq, bk) tile (the kernels' TileRow / TileCol,
    csrc/attention_fp32.cuh), whatever tile of 64 holds it."""
    bq, bk, n_qblk, n_kblk = _blocks(lq, lk, block_q, block_k)
    rows, cols = torch.arange(lq, device=device), torch.arange(lk, device=device)
    qb, kb = rows // bq, cols // bk
    cell = dropout_cells(b, num_heads, stride, device)[..., None, None]
    return keep_bits((rows - qb * bq)[:, None] * bk + (cols - kb * bk)[None, :],
                     seed + (cell * n_qblk + qb[:, None]) * n_kblk + kb[None, :], rate)


def _tiled_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, block_q, block_k,
               stride=None, keys=None):
    """(out, lse (B, heads, Lq)) of the fp32 forward kernel's walk in plain
    PyTorch (csrc/flash_attention_fwd.cu, the flash sweep of
    attention_fp32_fwd.cuh; the tests use it, no route does): blocks of
    ROWS_PER_BLOCK query rows (rows are independent: the kernel's 32-row
    blocks above a padded head width of 128 give the same numbers), each
    walking the logical K tiles of bk keys in staged tiles of ``keys`` (the
    kernel's: 64 up to a padded head width of 64, else 32). Of each logical
    tile first every staged tile's scores and the tile's max, before any
    exponential (as JAX's body), the running sum and accumulator rescaled
    once, then each staged tile's exp-weights, their sum, their dropout bit
    from the logical tile, a kept weight times 1 / (1 - rate), and P V added
    to the accumulator; out = acc / l and lse = m + log(l)."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    acc = _acc_dtype(q)
    dev = q.device
    d = hd // num_heads
    _, bk, _, _ = _blocks(lq, lk, block_q, block_k)
    keys = keys or (64 if build.padded_width(d) <= 64 else 32)
    qh, kh, vh = (_split_heads(x, num_heads, acc) for x in (q, k, v))
    rows, cols = torch.arange(lq, device=dev), torch.arange(lk, device=dev)
    mult = None
    if geometry is not None:
        mult = _geometry_planes(bnd, w, rows, cols, geometry)[0]
    bias = ((1.0 - mask.to(acc)) * NEG_BIAS)[:, None, None, :]
    kept = None
    if rate > 0.0:
        kept = _tile_keep(b, lq, lk, num_heads, rate, seed, block_q, block_k, stride, dev)
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    zero = torch.zeros((), dtype=acc, device=dev)
    out = torch.empty_like(qh)
    lse = torch.empty(qh.shape[:3], dtype=acc, device=dev)
    for i0 in range(0, lq, ROWS_PER_BLOCK):
        r = slice(i0, min(lq, i0 + ROWS_PER_BLOCK))
        m = torch.full(qh[:, :, r].shape[:3] + (1,), HARD_MASK, dtype=acc, device=dev)
        l = torch.zeros_like(m)
        o = torch.zeros_like(qh[:, :, r])
        for c0 in range(0, lk, bk):
            staged = [slice(j0, min(lk, c0 + bk, j0 + keys))
                      for j0 in range(c0, min(lk, c0 + bk), keys)]
            s = [_score(qh[:, :, r] @ kh[:, :, j].transpose(-1, -2), scale_of(d),
                        None if mult is None else mult[..., r, j], bias[..., j])[1]
                 for j in staged]
            m_new = torch.maximum(m, torch.cat([x.amax(dim=-1, keepdim=True) for x in s],
                                               dim=-1).amax(dim=-1, keepdim=True))
            corr = torch.exp(m - m_new)
            l, o = l * corr, o * corr
            for j, s_j in zip(staged, s):
                p = torch.exp(s_j - m_new)
                l = l + p.sum(dim=-1, keepdim=True)
                if kept is not None:
                    p = torch.where(kept[..., r, j], p * inv, zero)
                o = o + p @ vh[:, :, j]
            m = m_new
        out[:, :, r] = o / l
        lse[:, :, r] = (m + torch.log(l))[..., 0]
    return _merge_heads(out, q.dtype), lse


def _tiled_bwd(q, k, v, mask, g, lse, delta, num_heads, bnd, w, geometry, rate, seed,
               block_q, block_k, stride=None, block=64):
    """(dq, dk, dv, dw) of the fp32 backward kernels' walk in plain PyTorch
    (csrc/flash_attention_bwd.cu, the passes of attention_fp32_bwd.cuh; the
    tests use it, no route does): p = exp(s - lse) of each element, its
    dropout bit from its logical (bq, bk) tile whatever tile of ``block``
    holds it, delta the wrapper's; the dQ pass over key tiles of ``block``,
    the dK/dV pass over query tiles of ``block``, with one (dw0, dw1)
    partial per ``block`` keys, summed as the wrapper sums the kernel's."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    acc = _acc_dtype(q)
    dev = q.device
    qh, kh, vh, gh = (_split_heads(x, num_heads, acc) for x in (q, k, v, g))
    scale = float(hd // num_heads) ** -0.5
    rows, cols = torch.arange(lq, device=dev), torch.arange(lk, device=dev)
    planes = None if geometry is None else _geometry_planes(bnd, w, rows, cols, geometry)
    bias = ((1.0 - mask.to(acc)) * NEG_BIAS)[:, None, None, :]
    # every pass computes a score and a dP with the same instructions (the
    # kernels' row_dots), so here each product is formed once
    s_raw, s = _score(qh @ kh.transpose(-1, -2), scale,
                      None if planes is None else planes[0], bias)
    p = torch.exp(s - lse[..., None].to(acc))
    dp = gh @ vh.transpose(-1, -2)
    p_drop = p
    if rate > 0.0:
        kept = _tile_keep(b, lq, lk, num_heads, rate, seed, block_q, block_k, stride, dev)
        zero = torch.zeros((), dtype=acc, device=dev)
        inv = 1.0 / (1.0 - rate)
        p_drop = torch.where(kept, p * inv, zero)
        dp = torch.where(kept, dp * inv, zero)
    ds = p * (dp - delta[..., None].to(acc))
    ds_raw = (ds if planes is None else ds * planes[0]) * scale

    dq, dk, dv = torch.zeros_like(qh), torch.zeros_like(kh), torch.zeros_like(vh)
    for j0 in range(0, lk, block):  # the dQ pass
        j = slice(j0, min(lk, j0 + block))
        dq += ds_raw[..., j] @ kh[:, :, j]
    for i0 in range(0, lq, block):  # the dK/dV pass
        r = slice(i0, min(lq, i0 + block))
        dv += p_drop[:, :, r].transpose(-1, -2) @ gh[:, :, r]
        dk += ds_raw[:, :, r].transpose(-1, -2) @ qh[:, :, r]
    dw_part = torch.zeros(-(-lk // block), 2, dtype=acc, device=dev)
    if planes is not None:
        for j0 in range(0, lk, block):
            j = slice(j0, min(lk, j0 + block))
            terms = ds[..., j] * s_raw[..., j]
            dw_part[j0 // block] = torch.stack([torch.sum(terms * planes[1][..., j]),
                                                torch.sum(terms * planes[2][..., j])])
    return (_merge_heads(dq, q.dtype), _merge_heads(dk, k.dtype), _merge_heads(dv, v.dtype),
            dw_part.sum(dim=0).to(w.dtype))


def flash_attention_reference(
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
    block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
    causal: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention` (same arguments)."""
    bnd, w, geometry, rate, seed = _resolve(q, boundary, w0, w1, text_len, row_start,
                                            offset, dropout_rate, deterministic,
                                            dropout_seed, cell_offset,
                                            _tile_count(q, k, block_q, block_k))
    return _plain_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed,
                      compute_dtype, block_q, block_k, cell_stride, causal)[0]


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    g: torch.Tensor,              # (B, Lq, heads*d) cotangent of the output
    num_heads: int,
    *,
    out: Optional[torch.Tensor] = None,  # the forward's output and lse; the
    lse: Optional[torch.Tensor] = None,  # plain forward's when not given
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
    block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
    causal: bool = False,
):
    """Plain PyTorch version of the backward: (dq, dk, dv, dw), dw the (2,)
    gradient of the clamped (w0, w1) (zeros without a geometry). delta is
    rowsum(g · out) of the given (or recomputed) output."""
    bnd, w, geometry, rate, seed = _resolve(q, boundary, w0, w1, text_len, row_start,
                                            offset, dropout_rate, deterministic,
                                            dropout_seed, cell_offset,
                                            _tile_count(q, k, block_q, block_k))
    if out is None or lse is None:
        out, lse = _plain_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed,
                              compute_dtype, block_q, block_k, cell_stride, causal)
    g = g.to(q.dtype)
    return _plain_bwd(q, k, v, mask, g, lse, _delta(g, out, num_heads), num_heads, bnd,
                      w, geometry, rate, seed, compute_dtype, block_q, block_k, cell_stride,
                      causal)


# the tensor-core launchers' last two arguments: causal, head_dim_v
_SHAPE_ARGS = {"": [], "_mma": [ctypes.c_int, ctypes.c_int]}


def _bind_fwd(lib, suffix):
    """argtypes of a forward library's launcher, ``suffix`` "" or "_mma"."""
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    launcher = getattr(lib, f"mkg_flash_attention_fwd{suffix}")
    launcher.argtypes = [
        p, p, p, p, p, p, p, p,     # q k v mask boundary w out lse
        i, i, i, i, i, i,           # batch lq lk num_heads head_dim is_bf16
        f,                          # scale
        i, i, i, i,                 # has_geometry row_start text_len offset
        i, u, f, u,                 # dropout threshold inv_keep seed
        u,                          # cell_stride
        i, i, i, i,                 # bq bk n_qblk n_kblk
        p,                          # stream
    ] + _SHAPE_ARGS[suffix]
    launcher.restype = ctypes.c_int
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_fwd(width=None) -> ctypes.CDLL:
    """The CUDA-core forward kernel (csrc/flash_attention_fwd.cu), fp32, at
    a padded head ``width`` or in the library of 64 and 128; so the three
    below."""
    lib = _bind_fwd(build.load("flash_attention_fwd", width), "")
    lib.mkg_flash_attention_fwd_smem.argtypes = [ctypes.c_int] * 2  # bk head_dim
    lib.mkg_flash_attention_fwd_smem.restype = ctypes.c_size_t
    return lib


@functools.cache
def _lib_fwd_mma(width=None) -> ctypes.CDLL:
    """The tensor-core forward kernel (csrc/flash_attention_fwd_mma.cu)."""
    lib = _bind_fwd(build.load("flash_attention_fwd_mma", width), "_mma")
    lib.mkg_flash_attention_fwd_mma_smem.argtypes = [ctypes.c_int] * 3  # lk bk head_dim
    lib.mkg_flash_attention_fwd_mma_smem.restype = ctypes.c_size_t
    return lib


def _bind_bwd(lib, suffix):
    """argtypes of a backward library's two launchers, ``suffix`` "" or
    "_mma"."""
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    common = [
        i, i, i, i, i, i,           # batch lq lk num_heads head_dim is_bf16
        f,                          # scale
        i, i, i, i,                 # has_geometry row_start text_len offset
        i, u, f, u,                 # dropout threshold inv_keep seed
        u,                          # cell_stride
        i, i, i, i,                 # bq bk n_qblk n_kblk
        p,                          # stream
    ] + _SHAPE_ARGS[suffix]
    # q k v g mask boundary w lse delta, then dk dv dw_part / dq
    dkv, dq = (getattr(lib, f"mkg_flash_attention_bwd_{n}{suffix}") for n in ("dkv", "dq"))
    dkv.argtypes = [p] * 12 + common
    dq.argtypes = [p] * 10 + common
    dkv.restype = dq.restype = ctypes.c_int
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_bwd(width=None) -> ctypes.CDLL:
    """The CUDA-core backward kernels (csrc/flash_attention_bwd.cu), fp32."""
    lib = _bind_bwd(build.load("flash_attention_bwd", width), "")
    lib.mkg_flash_attention_bwd_smem.argtypes = [ctypes.c_int]  # head_dim
    lib.mkg_flash_attention_bwd_smem.restype = ctypes.c_size_t
    return lib


@functools.cache
def _lib_bwd_mma(width=None) -> ctypes.CDLL:
    """The tensor-core backward kernels (csrc/flash_attention_bwd_mma.cu)."""
    lib = _bind_bwd(build.load("flash_attention_bwd_mma", width), "_mma")
    lib.mkg_flash_attention_bwd_mma_smem.argtypes = [ctypes.c_int]  # head_dim
    lib.mkg_flash_attention_bwd_mma_smem.restype = ctypes.c_size_t
    return lib


def _call_args(q, k, num_heads, geometry, rate, seed, block_q, block_k, stride=None):
    """The scalar arguments every flash kernel takes, after its pointers:
    the head width of the call picks the instantiation and sets the scale."""
    b, lq, _ = q.shape
    lk = k.shape[1]
    d = _head_dim(q, num_heads)
    bq, bk, n_qblk, n_kblk = _blocks(lq, lk, block_q, block_k)
    return (b, lq, lk, num_heads, d, int(q.dtype == torch.bfloat16), scale_of(d),
            *_geometry_args(geometry, lq), int(rate > 0.0), int(rate * float(2 ** 32)),
            (1.0 / (1.0 - rate)) if rate > 0.0 else 1.0, *_seed_args(seed, stride, num_heads),
            bq, bk, n_qblk, n_kblk, torch.cuda.current_stream(q.device).cuda_stream)


def _shape_args(mma, q, v, num_heads, causal):
    """The library width of a call and its launcher's last arguments: the
    tensor-core kernels take (causal, d_v), and a causal call or one whose v
    is narrower than q goes to the library of its padded width (the
    instances of 64 and 128 take neither); the CUDA-core kernels raise at
    either."""
    d, dv = _head_dim(q, num_heads), _head_dim(v, num_heads)
    if not (causal or dv != d):
        return build.library_width(d), ((int(causal), dv) if mma else ())
    if not mma:
        raise ValueError("causal attention and a value width of its own take bf16 "
                         "(the tensor-core flash kernels)")
    return build.padded_width(d), (int(causal), dv)


def _fwd(mma, q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, block_q, block_k,
         stride=None, causal=False):
    """(out, lse) of one forward launch on a route: the tensor-core kernel
    (``mma``, bf16) or the CUDA-core one."""
    _, bk, _, _ = _blocks(q.shape[1], k.shape[1], block_q, block_k)
    d = _head_dim(q, num_heads)
    width, tail = _shape_args(mma, q, v, num_heads, causal)
    if mma:
        lib, launcher = _lib_fwd_mma(width), "mkg_flash_attention_fwd_mma"
        smem = lib.mkg_flash_attention_fwd_mma_smem(k.shape[1], bk, d)
    else:
        _check_fp32(q, "the CUDA-core flash forward")
        lib, launcher = _lib_fwd(width), "mkg_flash_attention_fwd"
        smem = lib.mkg_flash_attention_fwd_smem(bk, d)
    _check_smem(smem, q, f"{launcher[4:]} at block_k={bk}, head_dim {d}",
                hint="pass a smaller block_k")
    out = q.new_empty(q.shape[:2] + v.shape[2:])
    lse = torch.empty(q.shape[0], num_heads, q.shape[1], dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = getattr(lib, launcher)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), bnd.data_ptr(),
            w.data_ptr(), out.data_ptr(), lse.data_ptr(),
            *_call_args(q, k, num_heads, geometry, rate, seed, block_q, block_k, stride),
            *tail)
    _raise_if(err, lib, launcher[4:])
    return out, lse


def _count(kernel, mma, q, num_heads):
    """One launch of ``kernel`` ("FWD", "DKV" or "DQ") counted: in its
    count of either route, on the tensor cores (``mma``) in its ``_MMA``
    count too, at head_dim 128 in the ``_D128`` sibling of each, and by
    head width in ``WIDTH_LAUNCHES_FLASH``."""
    names = ["LAUNCHES_FLASH" + ("" if kernel == "FWD" else f"_{kernel}")]
    if mma:
        names.append(f"LAUNCHES_FLASH_{kernel}_MMA")
    d = _head_dim(q, num_heads)
    for name in names + [f"{n}_D128" for n in names if d == 128]:
        globals()[name] += 1
    for name in names:
        WIDTH_LAUNCHES_FLASH[name[len("LAUNCHES_FLASH"):], d] += 1


def _launch_fwd_cuda_cores(q, k, v, mask, num_heads, *args):
    """The CUDA-core forward (csrc/flash_attention_fwd.cu): the fp32 route
    (bf16 raises). Arguments as :func:`_launch_fwd`."""
    out = _fwd(False, q, k, v, mask, num_heads, *args)
    _count("FWD", False, q, num_heads)
    return out


def _launch_fwd_mma(q, k, v, mask, num_heads, *args):
    """The tensor-core forward (csrc/flash_attention_fwd_mma.cu), bf16."""
    out = _fwd(True, q, k, v, mask, num_heads, *args)
    _count("FWD", True, q, num_heads)
    return out


def _launch_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, block_q, block_k,
                stride=None, causal=False):
    """(out, lse) of one forward launch; the dtype alone picks the kernel."""
    launch = _launch_fwd_mma if q.dtype == torch.bfloat16 else _launch_fwd_cuda_cores
    return launch(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed, block_q, block_k,
                  stride, causal)


def _bwd_lib(q, v, g, lse, delta, num_heads, mma, causal=False):
    """The backward library of a route, its inputs checked, and its
    launchers' last arguments: the tensor-core kernels (``mma``, bf16) or
    the CUDA-core ones."""
    _check_tensor("g", g, q)
    if g.shape != q.shape[:2] + v.shape[2:]:
        raise ValueError(f"g {tuple(g.shape)} is not the output's shape "
                         f"{tuple(q.shape[:2] + v.shape[2:])}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (q.shape[0], num_heads, q.shape[1]) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 (B, heads, Lq) tensor")
    d = _head_dim(q, num_heads)
    width, tail = _shape_args(mma, q, v, num_heads, causal)
    if mma:
        lib = _lib_bwd_mma(width)
        smem, what = lib.mkg_flash_attention_bwd_mma_smem(d), "flash_attention_bwd_mma"
    else:
        _check_fp32(q, "the CUDA-core flash backward")
        lib = _lib_bwd(width)
        smem, what = lib.mkg_flash_attention_bwd_smem(d), "flash_attention_bwd"
    _check_smem(smem, q, f"{what} at head_dim {d}")
    return lib, tail


def _dkv(mma, q, k, v, mask, g, lse, delta, num_heads, bnd, w, geometry, rate, seed, block_q,
         block_k, stride=None, causal=False):
    """dk, dv and the (2,) dw of one dK/dV launch on a route: the kernel
    writes one (dw0, dw1) partial per (b, head, block of 64 keys) and this
    sums them, so no float atomics run and fp32 results repeat from run to
    run."""
    lib, tail = _bwd_lib(q, v, g, lse, delta, num_heads, mma, causal)
    launcher = "mkg_flash_attention_bwd_dkv" + ("_mma" if mma else "")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dw_part = torch.empty(q.shape[0], num_heads, -(-k.shape[1] // KEYS_PER_BLOCK), 2,
                          dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = getattr(lib, launcher)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), mask.data_ptr(),
            bnd.data_ptr(), w.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dw_part.data_ptr(),
            *_call_args(q, k, num_heads, geometry, rate, seed, block_q, block_k, stride),
            *tail)
    _raise_if(err, lib, launcher)
    return dk, dv, dw_part.sum(dim=(0, 1, 2)).to(w.dtype)


def _dq(mma, q, k, v, mask, g, lse, delta, num_heads, bnd, w, geometry, rate, seed, block_q,
        block_k, stride=None, causal=False):
    """dq of one dQ launch on a route."""
    lib, tail = _bwd_lib(q, v, g, lse, delta, num_heads, mma, causal)
    launcher = "mkg_flash_attention_bwd_dq" + ("_mma" if mma else "")
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = getattr(lib, launcher)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), mask.data_ptr(),
            bnd.data_ptr(), w.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_call_args(q, k, num_heads, geometry, rate, seed, block_q, block_k, stride),
            *tail)
    _raise_if(err, lib, launcher)
    return dq


def _launch_bwd_dkv_cuda_cores(q, k, v, mask, g, lse, delta, num_heads, *args):
    """The CUDA-core dK/dV kernel (csrc/flash_attention_bwd.cu): the fp32
    route (bf16 raises). Arguments as :func:`_launch_bwd_dkv`."""
    out = _dkv(False, q, k, v, mask, g, lse, delta, num_heads, *args)
    _count("DKV", False, q, num_heads)
    return out


def _launch_bwd_dq_cuda_cores(q, k, v, mask, g, lse, delta, num_heads, *args):
    """The CUDA-core dQ kernel (csrc/flash_attention_bwd.cu): the fp32
    route (bf16 raises)."""
    out = _dq(False, q, k, v, mask, g, lse, delta, num_heads, *args)
    _count("DQ", False, q, num_heads)
    return out


def _launch_bwd_dkv_mma(q, k, v, mask, g, lse, delta, num_heads, *args):
    """The tensor-core dK/dV kernel (csrc/flash_attention_bwd_mma.cu), bf16."""
    out = _dkv(True, q, k, v, mask, g, lse, delta, num_heads, *args)
    _count("DKV", True, q, num_heads)
    return out


def _launch_bwd_dq_mma(q, k, v, mask, g, lse, delta, num_heads, *args):
    """The tensor-core dQ kernel (csrc/flash_attention_bwd_mma.cu), bf16."""
    out = _dq(True, q, k, v, mask, g, lse, delta, num_heads, *args)
    _count("DQ", True, q, num_heads)
    return out


def _launch_bwd_dkv(q, k, v, mask, g, lse, delta, num_heads, bnd, w, geometry, rate, seed,
                    block_q, block_k, stride=None, causal=False):
    """dk, dv and the (2,) dw of one dK/dV launch; the dtype alone picks the
    kernel."""
    launch = _launch_bwd_dkv_mma if q.dtype == torch.bfloat16 else _launch_bwd_dkv_cuda_cores
    return launch(q, k, v, mask, g, lse, delta, num_heads, bnd, w, geometry, rate, seed,
                  block_q, block_k, stride, causal)


def _launch_bwd_dq(q, k, v, mask, g, lse, delta, num_heads, bnd, w, geometry, rate, seed,
                   block_q, block_k, stride=None, causal=False):
    """dq of one dQ launch; the dtype alone picks the kernel."""
    launch = _launch_bwd_dq_mma if q.dtype == torch.bfloat16 else _launch_bwd_dq_cuda_cores
    return launch(q, k, v, mask, g, lse, delta, num_heads, bnd, w, geometry, rate, seed,
                  block_q, block_k, stride, causal)


def _launch_bwd(*args):
    """(dq, dk, dv, dw) of one backward: the dK/dV kernel, then the dQ
    kernel, on the arguments of ``_launch_bwd_dkv``."""
    dk, dv, dw = _launch_bwd_dkv(*args)
    return _launch_bwd_dq(*args), dk, dv, dw


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of flash_attention.py:361-512: the forward saves its
    inputs, the seed, the output and the log-sum-exp; the backward computes
    delta from the output and recomputes the probabilities and the dropout
    masks tile by tile. Gradients flow to q, k, v and the stacked (w0, w1)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bnd, w, num_heads, geometry, rate, seed,
                compute_dtype, block_q, block_k, stride, causal):
        args = (num_heads, bnd, w, geometry, rate, seed)
        if q.device.type == "cpu":
            out, lse = _plain_fwd(q, k, v, mask, *args, compute_dtype, block_q, block_k,
                                  stride, causal)
        else:
            out, lse = _launch_fwd(q, k, v, mask, *args, block_q, block_k, stride, causal)
        ctx.save_for_backward(q, k, v, mask, bnd, w, out, lse)
        ctx.call = (num_heads, geometry, rate, seed, compute_dtype, block_q, block_k, stride,
                    causal)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, bnd, w, out, lse = ctx.saved_tensors
        (num_heads, geometry, rate, seed, compute_dtype, block_q, block_k, stride,
         causal) = ctx.call
        with _span("attention.bwd", q, k, num_heads, v, causal):
            g = g.to(q.dtype).contiguous()  # from the out-projection's backward
            delta = _delta(g, out, num_heads)
            args = (num_heads, bnd, w, geometry, rate, seed)
            if q.device.type == "cpu":
                dq, dk, dv, dw = _plain_bwd(q, k, v, mask, g, lse, delta, *args,
                                            compute_dtype, block_q, block_k, stride, causal)
            else:
                dq, dk, dv, dw = _launch_bwd(q, k, v, mask, g, lse, delta, *args,
                                             block_q, block_k, stride, causal)
        return (dq, dk, dv, None, None, dw, None, None, None, None, None, None, None, None,
                None)


def flash_attention(
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
    block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
    causal: bool = False,
) -> torch.Tensor:
    """Blocked fused attention: the contract of ``fused_attention`` at any
    sequence length, differentiable in q, k, v, w0 and w1. On CPU tensors the
    plain forward and backward (any head width); on CUDA tensors the kernels
    (bf16 or fp32, head_dim 1 to 256, compute dtype = the inputs' dtype) or
    an error. ``causal`` (Lq = Lk) leaves out every key after its query
    row; v (B, Lk, heads·d_v) may be narrower than q and k, d_v <= d, and
    the output is then (B, Lq, heads·d_v); either takes bf16 on CUDA."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block_q / block_k must be positive, got {block_q} / {block_k}")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal attention needs Lq = Lk, got {q.shape[1]} and {k.shape[1]}")
    with _span("attention.fwd", q, k, num_heads, v, causal):
        bnd, w, geometry, rate, seed = _resolve(q, boundary, w0, w1, text_len, row_start,
                                                offset, dropout_rate, deterministic,
                                                dropout_seed, cell_offset,
                                                _tile_count(q, k, block_q, block_k))
        maskf = mask.to(device=q.device, dtype=_acc_dtype(q)).contiguous()
        if q.device.type != "cpu":
            _check_inputs(q, k, v, maskf, num_heads, compute_dtype, kernel="flash_attention",
                          value_width=True)
        return _FlashAttention.apply(q, k, v, maskf, bnd.contiguous(), w.contiguous(),
                                     num_heads, geometry, rate, seed, compute_dtype,
                                     int(block_q), int(block_k), cell_stride, bool(causal))
