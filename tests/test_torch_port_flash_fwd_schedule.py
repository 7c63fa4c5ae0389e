"""The walk of the tensor-core flash forward, modelled in plain PyTorch.

On the card the bf16 flash forward (csrc/flash_attention_fwd_mma.cu) does
not walk the logical (bq, bk) tiles of the JAX kernel as the plain version
does: a block takes 64 query rows, whatever bq is, and a tile's keys arrive
in chunks of 64, counted from the tile's first key. What it must keep of the
tiles is this:

- a row's running max moves once per logical K tile: the tile's max is
  taken before any exponential (where all the keys are one tile of up to
  256, their scores stay in registers; otherwise each tile is swept twice,
  K alone for the max, then K and V), and the weights exp(s - m) are
  rounded to bf16 against it;
- the dropout index (r - qb·bq)·bk + (c - kb·bk) and the tile seed
  seed + ((b·heads + h)·n_qblk + qb)·n_kblk + kb, times 0x9E3779B9, are each
  built from a part of the row (its qb from its own index, so a 64-row
  block may straddle Q tiles) and a part of the key, in uint32.

``kernel_walk`` models that walk here, on the CPU, and is held to the JAX
Pallas flash forward in interpret mode and to the port's plain version
(``_plain_fwd``) at the flash edge cases (tests/test_torch_port_flash_edges
.py: Lq and Lk of 1 to 611, an all-masked row, 96 x 160 tiles), 2 heads of
64: the keep masks bit for bit, fp32 within 1e-5, bf16 within the bars below.
A negative control walks the same chunks with a running max per chunk (the
usual flash-attention design) and misses that bar: the bar sees a wrong
grouping."""

import math

import numpy as np
import pytest
import torch

from mkg_analogy_tpu_torch.kernels import attention as single
from mkg_analogy_tpu_torch.kernels import flash_attention as port
from test_torch_port_attention_edges import REL_MASKED_ROW, assert_close_by_batch_row
from test_torch_port_flash_edges import (FLASH_EDGE_CASES, FLASH_EDGE_IDS, flash_edge_inputs,
                                         flash_edge_kwargs)

torch.set_num_threads(1)

H, D = 2, 64
CHUNK = 64            # rows of a block, keys of a chunk
RESIDENT_KEYS = 256   # keys kept in registers where they are one logical tile
GOLDEN = 0x9E3779B9
M32 = 0xFFFFFFFF
ATOL = 1e-5           # fp32: the same math, summed in another order
# bf16 (the compute dtype; inputs on the bf16 grid, outputs compared in fp32
# before their rounding), the walk against the plain version: both round the
# same weights against the same maxima and differ only where an fp32 sum
# runs in another order. Measured over the edge cases, dropout 0 and 0.1:
# at most 4.2e-7; a running max per chunk (the negative control) moves the
# output by 2.6e-4 to 1.2e-3.
BF16_ATOL = 1e-5
# bf16, the walk against the JAX kernel: XLA sums the products in another
# order, a score one fp32 ulp apart now and then rounds a weight to the
# neighbouring bf16 value (2^-8 of itself). Measured: at most 9.1e-5 (the
# all-masked rows, held by REL_MASKED_ROW: 3.8e-4).
JAX_BF16_ATOL = 5e-4


def lowbias32(x):
    """The interpret-mode hash (attention.py:_dropout_keep) on uint32 numpy
    arrays."""
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def row_parts(rows, b, heads, bq, bk, n_qblk, n_kblk, seed):
    """(index base (R,), seed part (B, heads, R)) of the rows, uint32: the
    row's offset in its Q tile times bk, and (seed + (cell·n_qblk + qb)·
    n_kblk)·0x9E3779B9 with cell = b·heads + h."""
    qb = rows // bq
    base = ((rows - qb * bq) * bk).astype(np.uint32)
    cell = np.arange(b * heads, dtype=np.uint64).reshape(b, heads, 1)
    tile0 = (np.uint64(seed & M32) + (cell * np.uint64(n_qblk) + qb.astype(np.uint64))
             * np.uint64(n_kblk)) & np.uint64(M32)
    return base, ((tile0 * np.uint64(GOLDEN)) & np.uint64(M32)).astype(np.uint32)


def chunk_keep(base, row_mix, kb, col0, rate):
    """(B, heads, R, 64) keep mask of a chunk whose first key is key col0 of
    logical tile kb: index base + column in the tile, seed part + kb·
    0x9E3779B9, in uint32."""
    idx = base[:, None] + np.uint32(col0) + np.arange(CHUNK, dtype=np.uint32)[None, :]
    mix = row_mix + np.uint32((kb * GOLDEN) & M32)
    return lowbias32(idx[None, None] ^ mix[..., None]) >= np.uint32(int(rate * float(2 ** 32)))


def kernel_walk(q, k, v, mask, bnd, w, geometry, rate, seed, dtype, bq, bk, chunk_max=False):
    """(out (B, Lq, heads·d), lse (B, heads, Lq)) as the tensor-core kernel
    walks: 64-row blocks, logical K tiles in chunks of 64 keys from each
    tile's first key, keys beyond the tile a -inf bias. ``chunk_max``: the
    negative control, the running max (and the rescaling) per chunk."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    n_qblk, n_kblk = -(-lq // bq), -(-lk // bk)
    scale = float(hd // H) ** -0.5
    qh = port._split_heads(q, H, torch.float32)
    products = torch.matmul(qh, port._split_heads(k, H, torch.float32).transpose(-1, -2))
    vh = port._split_heads(v, H, dtype).float()
    bias = (1.0 - mask.float()) * single.NEG_BIAS                               # (B, Lk)
    out = torch.empty_like(qh)
    lse = torch.empty(qh.shape[:3])
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    for row0 in range(0, lq, CHUNK):
        rows = np.arange(row0, min(row0 + CHUNK, lq))
        base, row_mix = row_parts(rows, b, H, bq, bk, n_qblk, n_kblk, seed)
        m = torch.full((b, H, len(rows), 1), port.HARD_MASK)
        l = torch.zeros_like(m)
        o = torch.zeros(b, H, len(rows), qh.shape[-1])
        for kb in range(n_kblk):
            key0, tile_end = kb * bk, min(kb * bk + bk, lk)
            chunks = []
            for c0 in range(key0, tile_end, CHUNK):
                cols = torch.arange(c0, c0 + CHUNK)
                real = cols < tile_end
                cb = torch.where(real, bias[:, cols.clamp(max=lk - 1)], -math.inf)
                c = torch.full((b, 1, len(rows), CHUNK), scale)
                if geometry is not None:
                    mult = port._geometry_planes(bnd, w, torch.from_numpy(rows), cols, geometry)[0]
                    c = c * mult   # scale · w is exact (scale 2^-3)
                n = min(CHUNK, tile_end - c0)
                prod = torch.zeros(b, H, len(rows), CHUNK)
                prod[..., :n] = products[:, :, row0:row0 + len(rows), c0:c0 + n]
                # one FMA, acc * c + bias
                s = (prod.double() * c.double() + cb[:, None, None, :].double()).float()
                vc = torch.zeros(b, H, CHUNK, vh.shape[-1])
                vc[:, :, :n] = vh[:, :, c0:c0 + n]
                keep = None
                if rate > 0.0:
                    keep = torch.from_numpy(chunk_keep(base, row_mix, kb, c0 - key0, rate))
                chunks.append((s, vc, keep))
            groups = [[ch] for ch in chunks] if chunk_max else [chunks]
            for group in groups:
                tile_max = torch.stack([s.amax(dim=-1, keepdim=True) for s, _, _ in group]).amax(0)
                m_new = torch.maximum(m, tile_max)
                alpha = torch.exp(m - m_new)
                o = o * alpha
                total = torch.zeros_like(l)
                for s, vc, keep in group:
                    p = torch.exp(s - m_new)
                    total = total + p.sum(dim=-1, keepdim=True)
                    if keep is not None:
                        p = torch.where(keep, p * inv, 0.0)
                    o = o + torch.matmul(p.to(dtype).float(), vc)
                l = l * alpha + total
                m = m_new
        out[:, :, row0:row0 + len(rows)] = o / l
        lse[:, :, row0:row0 + len(rows)] = (m + torch.log(l))[..., 0]
    return port._merge_heads(out, q.dtype), lse


def case_call(case, rate, seed, dtype):
    """The case's fp32 tensors, on the bf16 grid for ``dtype`` bf16 (so
    that an output is compared before its rounding to bf16, which would
    hide the weights' rounding below one ulp of the output), and its
    resolved arguments."""
    q, k, v, _, mask = (torch.from_numpy(x) for x in flash_edge_inputs(case))
    q, k, v = (x.to(dtype).float() for x in (q, k, v))
    kw = flash_edge_kwargs(case, torch)
    bnd, w, geometry, rate, seed = single._resolve(
        q, kw.get("boundary"), kw.get("w0"), kw.get("w1"), kw.get("text_len"),
        kw.get("row_start", 0), kw.get("offset", 0), rate, rate == 0.0, seed)
    bq, bk = case[6]
    bq, bk = min(bq, q.shape[1]), min(bk, k.shape[1])
    return (q, k, v, mask), (bnd, w, geometry, rate, seed), (bq, bk)


def walk_and_plain(case, rate, seed, dtype, chunk_max=False):
    tensors, resolved, (bq, bk) = case_call(case, rate, seed, dtype)
    got = kernel_walk(*tensors, *resolved, dtype, bq, bk, chunk_max=chunk_max)
    want = port._plain_fwd(*tensors, H, *resolved, dtype, *case[6])
    return tensors, got, want


def jax_forward(case, q, k, v, mask, rate, seed, dtype):
    """out of the JAX flash forward in interpret mode, as fp32 numpy."""
    import jax.numpy as jnp
    from mkg_analogy_tpu.kernels.flash_attention import flash_attention as jax_fa

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    kw = flash_edge_kwargs(case, jnp)
    extra = dict(w0=jnp.asarray([0.3]), w1=jnp.asarray([0.7])) if case[4] is not None else {}
    out = jax_fa(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                 jnp.asarray(mask.numpy()), H, compute_dtype=jdt, interpret=True,
                 dropout_rate=rate, deterministic=rate == 0.0,
                 dropout_seed=jnp.asarray(seed, jnp.int32), **kw, **extra)
    return np.asarray(out, np.float32)


def assert_lse_close(got, want, mask, atol):
    """lse within ``atol``; on a batch row whose keys are all masked (lse
    ~ -1e4, where an fp32 ulp is 9.8e-4) within two ulps."""
    bars = torch.where(mask.bool().any(dim=1)[:, None, None], torch.full_like(want, atol),
                       (want.abs() * 2.0 ** -22).clamp(min=atol))
    assert ((got - want).abs() <= bars).all(), (got - want).abs().max()


@pytest.mark.parametrize("case", FLASH_EDGE_CASES, ids=FLASH_EDGE_IDS)
def test_keep_masks_from_row_and_key_parts_are_the_tiles(case):
    """The keep mask of every 64-key chunk of every 64-row block, built from
    the row part and the key part in uint32, is the logical tile's mask of
    the plain version (flash_attention.py:_dropout_keep with the seed of
    _tile_seed), bit for bit, with a seed that wraps past 2^32."""
    b, lq, lk, (bq, bk) = case[1], case[2], case[3], case[6]
    bq, bk, n_qblk, n_kblk = port._blocks(lq, lk, bq, bk)
    seed, rate = 2 ** 32 - 7, 0.3
    planes = {(qb, kb): port._dropout_keep(b, H, bq, bk, rate, seed, qb, kb, n_qblk, n_kblk,
                                           "cpu").numpy()
              for qb in range(n_qblk) for kb in range(n_kblk)}
    for row0 in range(0, lq, CHUNK):
        rows = np.arange(row0, min(row0 + CHUNK, lq))
        base, row_mix = row_parts(rows, b, H, bq, bk, n_qblk, n_kblk, seed)
        for kb in range(n_kblk):
            key0, tile_end = kb * bk, min(kb * bk + bk, lk)
            for c0 in range(key0, tile_end, CHUNK):
                got = chunk_keep(base, row_mix, kb, c0 - key0, rate)
                n = min(CHUNK, tile_end - c0)
                want = np.stack([planes[r // bq, kb][:, :, r % bq, c0 - key0:c0 - key0 + n]
                                 for r in rows], axis=2)
                np.testing.assert_array_equal(got[..., :n], want)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", FLASH_EDGE_CASES, ids=FLASH_EDGE_IDS)
def test_walk_matches_plain_and_jax_fp32(case, rate):
    """fp32: out and lse of the walk within 1e-5 of the plain version (lse
    of an all-masked row within two ulps of -1e4), out within 1e-5 of the
    JAX kernel (the all-masked row within REL_MASKED_ROW of its largest
    value: the products' summation order, tests/test_torch_port_attention_
    edges.py)."""
    tensors, (out, lse), (want_out, want_lse) = walk_and_plain(case, rate, 41, torch.float32)
    torch.testing.assert_close(out, want_out, atol=ATOL, rtol=0)
    assert_lse_close(lse, want_lse, tensors[3], ATOL)
    jax_out = jax_forward(case, *tensors, rate, 41, torch.float32)
    assert_close_by_batch_row(out.numpy(), jax_out, case, ATOL)


@pytest.mark.parametrize("case", FLASH_EDGE_CASES, ids=FLASH_EDGE_IDS)
def test_walk_matches_plain_and_jax_bf16(case):
    """bf16 compute dtype, dropout 0.1: out within BF16_ATOL of the plain
    version and lse within 1e-5 (two ulps on an all-masked row); out within
    JAX_BF16_ATOL of the JAX kernel, the all-masked row within
    REL_MASKED_ROW of its largest value."""
    tensors, (out, lse), (want_out, want_lse) = walk_and_plain(case, 0.1, 43, torch.bfloat16)
    torch.testing.assert_close(out, want_out, atol=BF16_ATOL, rtol=0)
    assert_lse_close(lse, want_lse, tensors[3], ATOL)
    jax_out = jax_forward(case, *tensors, 0.1, 43, torch.bfloat16)
    assert_close_by_batch_row(out.numpy(), jax_out, case, JAX_BF16_ATOL)


def test_a_running_max_per_chunk_misses_the_bar():
    """Negative control: the same walk with the running max moved per chunk
    of 64 keys, not per logical tile, is more than BF16_ATOL from the plain
    version in bf16 at every edge case whose tiles hold more than one chunk,
    while the tile-wise walk meets it; in fp32 both meet ATOL (the grouping
    changes only where the weights are rounded)."""
    multi = [c for c in FLASH_EDGE_CASES if min(c[3], c[6][1]) > CHUNK]
    assert len(multi) == 6
    for case in multi:
        _, (out, _), (want, _) = walk_and_plain(case, 0.0, 47, torch.bfloat16)
        _, (wrong, _), _ = walk_and_plain(case, 0.0, 47, torch.bfloat16, chunk_max=True)
        assert (out - want).abs().max() <= BF16_ATOL
        assert (wrong - want).abs().max() > 10 * BF16_ATOL, case[0]
    _, (wrong, _), (want, _) = walk_and_plain(multi[0], 0.0, 47, torch.float32, chunk_max=True)
    torch.testing.assert_close(wrong, want, atol=ATOL, rtol=0)


def test_schedule_reaches_both_designs_and_straddles():
    """The edge cases reach what the kernel's walk must get right: both of
    its designs (resident where all the keys are one tile of up to 256,
    streamed otherwise), several tiles, chunks cut short by a tile's end
    inside the keys (160-key tiles: 64 + 64 + 32), and 64-row blocks
    straddling Q tiles (bq = 96)."""
    tiles = {c[0]: port._blocks(c[2], c[3], *c[6]) for c in FLASH_EDGE_CASES}
    resident = {c[0] for c in FLASH_EDGE_CASES
                if tiles[c[0]][3] == 1 and c[3] <= RESIDENT_KEYS}
    assert resident == {"1x1", "257x255_rows_from_1", "611x1"}
    bq, bk, n_qblk, n_kblk = tiles["393x393_tiles_96x160"]
    assert n_kblk == 3 and bk % CHUNK and bq % CHUNK and n_qblk == 5
    assert tiles["511x513"][3] == 2 and tiles["1x611"][3] == 2
    assert REL_MASKED_ROW == 2e-3
