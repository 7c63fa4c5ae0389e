// The two passes of the tiled fp32 attention backward, shared by the
// single-block kernels (fused_attention_bwd.cu, rows 1-2: kFlash false) and
// the flash ones (flash_attention_bwd.cu, rows 4-5: kFlash true).
//
// Both compute, from q, k, v, the output cotangent g and the forward's
// row statistics,
//
//   dv = P~^T g             P~ = dropout(P)
//   dP = (g V^T) * keep / (1 - rate)
//   dS = P * (dP - delta)
//   dq = dS_raw K,  dk = dS_raw^T q,   dS_raw = dS * mult * scale
//   dw0 / dw1 = sum(dS * S_raw) over the two analogy regions
//
// in two passes, each one sweep over the other side with the register
// micro-tiles of attention_fp32.cuh for every product:
//   - the dq pass: one block per (query tile of 64 rows, head, batch row;
//     above D = 128 per 64 columns of dq). It stages its Q and g tiles and
//     sweeps the keys in tiles through cp.async: S and dP (two micro-tiles
//     a thread), P from the statistics, dS, dS_raw through shared memory to
//     its row's half-warp, dq += dS_raw K.
//   - the dK/dV pass: one block per (key tile of 64 keys, head, batch row;
//     above D = 128 per 64 columns of dk and dv). It stages its K and V
//     tiles and sweeps the query rows in tiles with their statistics and
//     delta: S^T and dP^T, P~ and dS_raw through shared memory, dv += P~^T
//     g and dk += dS_raw^T q.
// Neither uses float atomics: the dw sums are one (dw0, dw1) partial per
// block of one pass, which the wrapper sums, so fp32 results repeat from
// run to run.
//
// What the two kernel sets differ in (each is part of the function their
// TPU kernels compute):
//   - the statistics: the single-block forward writes each row's (max, log
//     of its sum), (B, heads, Lq, 2), and P = exp((s - max) - log l); the
//     flash forward one log-sum-exp a row, (B, heads, Lq), and P =
//     exp(s - lse), as flash_attention.py:_flash_bwd_kv_kernel computes it;
//   - delta: the single-block dq pass computes rowsum(g * out) (or, where
//     every key fits one tile, rowsum(dP * P) of that tile) and writes it
//     for the dK/dV pass; the flash wrapper hands both passes rowsum(g *
//     out) (kernels/flash_attention.py:_delta, as JAX computes it);
//   - the dropout mask: single-block one seed a (b, head) and idx = row *
//     Lk + col; flash one seed a logical (bq, bk) tile, seed + (cell *
//     n_qblk + qb) * n_kblk + kb, and idx = (row - qb bq) * bk + (col - kb
//     bk), the forward's (attention_fp32_fwd.cuh), whatever the 64-row
//     tiles here;
//   - the dw partials: single-block in the dq pass, one per query tile;
//     flash in the dK/dV pass, one per 64-key tile, as the Pallas kv kernel
//     sums them.
//
// The other side's tiles: up to D = 64, 64 rows in one buffer (4 x 4
// micro-tiles; 88 / 108 KB a block, two blocks an SM); above, 32 rows (16
// above D = 128) in two buffers, the next tile's copy in flight behind the
// current one's products (144 / 156 KB at 128, 203 / 211 KB at 256).
// Neither depends on a length. Nor does a ragged edge cost a whole tile:
// a tile's micro-tiles are as wide as its valid rows need (dq_tile_of,
// dkv_tile_of: a last tile of 35 rows runs 3 of a thread's 4 columns, one
// of 3 rows 1), and a block whose own valid rows fit in 16 R runs R of a
// thread's 4 rows (rows_a_thread: 96 rows take blocks of 4 and 2, 72 of 4
// and 1). 72, 96, 99 and FLAVA's 393 and 522 rows and keys all end so; the
// rows and columns left out are zero rows, whose terms add exact zeros, so
// the results are those of whole tiles bit for bit. Both passes compute a score with the
// forward's instructions in the same order (row_dots' column-order fmaf
// chain, then __fmul_rn and one fmaf, attention_fp32_fwd.cuh), so every
// pass sees the forward's probabilities bit for bit. Products are exact fp32 FMAs: no TF32.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fp32.cuh"

namespace attention_fp32 {

template <int D>
struct Bwd {
  // the other side's rows a tile, and the ring's buffers: up to D = 64, 64
  // rows in one buffer (4 x 4 micro-tiles, two blocks an SM); above, 32 (16
  // above D = 128) rows in two
  static constexpr int kSide = D <= 64 ? 64 : D <= 128 ? 32 : 16;
  static constexpr int kStages = D <= 64 ? 1 : 2;
  static constexpr int kTpt = kSide / kG;           // of them a thread
  static constexpr int kCols = cols_of<D>();        // result columns a block
  static constexpr int kNc = kCols / kG;            // result columns a thread
  static constexpr int kStride = D + kPad;
  static constexpr int kPStride = p_stride<kSide>();
  // the block's two tiles of 64 rows, kStages ring buffers of two side
  // tiles, one (dq) or two (dK/dV) 64 x kSide tiles through shared memory
  static constexpr size_t kDqFloats = 2 * size_t(kRows) * kStride +
                                      2 * kStages * size_t(kSide) * kStride +
                                      size_t(kRows) * kPStride + kRows;
  static constexpr size_t kDkvFloats = 2 * size_t(kRows) * kStride +
                                       2 * kStages * size_t(kSide) * kStride +
                                       2 * size_t(kRows) * kPStride;
  static constexpr size_t kDqBytes = kDqFloats * sizeof(float);
  static constexpr size_t kDkvBytes = kDkvFloats * sizeof(float);
  static constexpr size_t kBytes = kDqBytes > kDkvBytes ? kDqBytes : kDkvBytes;
};

// P of a score from the row's statistics: flash exp(s - lse), single-block
// exp((s - max) - log l).
template <bool kFlash>
__device__ __forceinline__ float prob(float sc, float m, float logl) {
  if constexpr (kFlash) {
    return expf(sc - m);
  } else {
    return expf((sc - m) - logl);
  }
}

// Sum a block's (dw0, dw1) partials in a fixed order and write them at
// out[0], out[1]. Every thread of the block calls it.
__device__ __forceinline__ void store_dw_partial(float dw0, float dw1, float* out) {
  __shared__ float dw_s[kThreads / 32][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  dw0 = warp_sum(dw0);
  dw1 = warp_sum(dw1);
  if (lane == 0) {
    dw_s[warp][0] = dw0;
    dw_s[warp][1] = dw1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t0 = 0.0f, t1 = 0.0f;
    for (int i = 0; i < kThreads / 32; ++i) {
      t0 += dw_s[i][0];
      t1 += dw_s[i][1];
    }
    out[0] = t0;
    out[1] = t1;
  }
}

// What a dq block carries across the key tiles: where its tiles are, its
// rows' geometry and statistics, their dq accumulators and (single-block)
// its share of the dw sums; R rows a thread (ty + 16 i, i < R).
template <int D, int R>
struct DqBlock {
  const float *qs, *gs;
  float *dss, *delta_s;  // the tile's dS_raw, the rows' delta
  Geometry geo;
  int ty, tx, row0, n_rows, col0;
  size_t stat0;
  bool one_tile;
  uint32_t seed_mix, cell;
  RowGeometry rg[R];
  float m[R], logl[R];
  float acc[R][Bwd<D>::kNc];
  float dw0, dw1;
};

// One key tile of the dq pass (K and V rows kt, vt from key j0), each
// thread's micro-tile R x T: T of its kTpt columns cover the tile's valid
// keys.
template <int T, int R, int D, bool kFlash>
__device__ __forceinline__ void dq_tile(DqBlock<D, R>& c, const Args& a, int b, const float* kt,
                                        const float* vt, int j0) {
  using S = Bwd<D>;
  const int lk = a.lk, ty = c.ty, tx = c.tx;
  float s[R][T], dp[R][T];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int u = 0; u < T; ++u) s[i][u] = dp[i][u] = 0.0f;
  }
  row_dots<D, T>(s, c.qs, kt, S::kStride, ty, tx);
  row_dots<D, T>(dp, c.gs, vt, S::kStride, ty, tx);

  // the flash dropout cells' row parts of this thread's rows
  TileRow trow[R];
  if (kFlash && a.dropout) {
#pragma unroll
    for (int i = 0; i < R; ++i) trow[i] = tile_row(a, c.cell, c.row0 + team_row(ty, i));
  }
  // P (into s), the dropped and rescaled dP (into dp), S_raw
  float s_raw[R][T];
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int j = j0 + tx + kG * u;
    const bool valid = j < lk;
    const float bias = valid ? (1.0f - a.mask[size_t(b) * lk + j]) * kNegBias : 0.0f;
    const bool answer = c.geo.col_is_answer(j);
    TileCol tcol{0u, 0u};
    if (kFlash && a.dropout) tcol = tile_col(a, j);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int il = team_row(ty, i);
      s_raw[i][u] = __fmul_rn(s[i][u], a.scale);
      const float sc = score(s[i][u], s_raw[i][u], a.scale, a.has_geometry,
                             c.rg[i].in_scope && answer, c.rg[i].w, bias);
      float p = 0.0f, dpv = 0.0f;
      if (valid && il < c.n_rows) {
        p = prob<kFlash>(sc, c.m[i], c.logl[i]);
        dpv = dp[i][u];
        if (a.dropout) {
          bool keep;
          if constexpr (kFlash) {
            keep = tile_keep(a, trow[i], tcol);
          } else {
            keep = dropout_keep(uint32_t(c.row0 + il) * uint32_t(lk) + uint32_t(j), c.seed_mix,
                                a.threshold);
          }
          dpv = keep ? __fmul_rn(dpv, a.keep) : 0.0f;
        }
      }
      s[i][u] = p;
      dp[i][u] = dpv;
    }
  }
  float delta[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (c.one_tile) {
      float x = 0.0f;
#pragma unroll
      for (int u = 0; u < T; ++u) x = fmaf(dp[i][u], s[i][u], x);
      delta[i] = group_sum(x);
      const int il = team_row(ty, i);
      if (c.col0 == 0 && tx == 0 && il < c.n_rows) a.delta[c.stat0 + il] = delta[i];
    } else {
      delta[i] = c.delta_s[team_row(ty, i)];
    }
  }
  // dS, the dw partials (single-block), dS_raw = dS * mult * scale
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const bool answer = c.geo.col_is_answer(j0 + tx + kG * u);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float ds = s[i][u] * (dp[i][u] - delta[i]);
      if (c.rg[i].in_scope && answer) {
        if constexpr (!kFlash) {
          if (c.rg[i].is_example) {
            c.dw0 = fmaf(ds, s_raw[i][u], c.dw0);
          } else {
            c.dw1 = fmaf(ds, s_raw[i][u], c.dw1);
          }
        }
        ds = ds * c.rg[i].w;
      }
      c.dss[team_row(ty, i) * S::kPStride + tx + kG * u] = ds * a.scale;
    }
  }
  __syncwarp();  // a row's dS_raw is read by the half-warp that wrote it
  p_times<kG * T, S::kCols>(c.acc, c.dss, S::kPStride, kt + c.col0, S::kStride, ty, tx);
}

// dq_tile at the narrowest micro-tile, of at most kTpt columns, whose kG *
// T keys cover the tile's n valid ones, in a block of four rows a thread;
// a narrower block (R < 4, one at the end of a (b, head)'s rows) keeps
// kTpt, which bounds the number of instances nvcc compiles.
template <int kTpt, int R, int D, bool kFlash>
__device__ __forceinline__ void dq_tile_of(int n, DqBlock<D, R>& c, const Args& a, int b,
                                           const float* kt, const float* vt, int j0) {
  if constexpr (kTpt > 1 && R == 4) {
    if (n <= kG * (kTpt - 1)) {
      dq_tile_of<kTpt - 1, R, D, kFlash>(n, c, a, b, kt, vt, j0);
      return;
    }
  }
  dq_tile<kTpt, R, D, kFlash>(c, a, b, kt, vt, j0);
}

// The dq pass of one block whose valid rows fit in 16 R.
template <int R, int D, bool kFlash>
__device__ __forceinline__ void dq_block(const Args& a) {
  using S = Bwd<D>;
  constexpr int kSide = S::kSide, kCols = S::kCols, kNc = S::kNc;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* gs = qs + kRows * S::kStride;
  float* ks = gs + kRows * S::kStride;                // two K tiles
  float* vs = ks + S::kStages * kSide * S::kStride;   // V tiles
  float* dss = vs + S::kStages * kSide * S::kStride;  // the tile's dS_raw
  float* delta_s = dss + kRows * S::kPStride;         // the rows' delta

  const int tile = blockIdx.x / groups_of<D>(), col0 = (blockIdx.x % groups_of<D>()) * kCols;
  const int h = blockIdx.y, b = blockIdx.z;
  const int d = kRagged ? a.head_dim : D;
  const int hd = a.num_heads * d, lq = a.lq, lk = a.lk;
  const int ty = team_ty(), tx = team_tx();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = tile * kRows, n_rows = min(kRows, lq - row0);
  const size_t tile_off = (size_t(b) * lq + row0) * hd + h * d;
  const float* kb = a.k + size_t(b) * lk * hd + h * d;
  const float* vb = a.v + size_t(b) * lk * hd + h * d;
  const bool q_aligned =
      head_aligned(a.q + tile_off, hd, d) && head_aligned(a.g + tile_off, hd, d);
  const bool kv_aligned = head_aligned(kb, hd, d) && head_aligned(vb, hd, d);
  const int n_tiles = (lk + kSide - 1) / kSide;

  stage<kRows, D>(qs, S::kStride, a.q + tile_off, hd, n_rows, d, q_aligned);
  stage<kRows, D>(gs, S::kStride, a.g + tile_off, hd, n_rows, d, q_aligned);
  stage<kSide, D>(ks, S::kStride, kb, hd, min(kSide, lk), d, kv_aligned);
  stage<kSide, D>(vs, S::kStride, vb, hd, min(kSide, lk), d, kv_aligned);
  cp_async_commit();

  DqBlock<D, R> c;
  c.qs = qs;
  c.gs = gs;
  c.dss = dss;
  c.delta_s = delta_s;
  c.ty = ty;
  c.tx = tx;
  c.row0 = row0;
  c.n_rows = n_rows;
  c.col0 = col0;
  // delta of the tile's rows (published by the first tile's barrier).
  // Flash: the wrapper's. Single-block, keys in more than one tile:
  // rowsum(g * out), a warp a row. Keys in one tile: rowsum(dP * P) of that
  // tile, in dq_tile, which is dP itself where P is one-hot (one key, or one
  // unmasked key), so dS is exactly 0 there, as in the plain version.
  c.one_tile = !kFlash && n_tiles == 1;
  c.stat0 = (size_t(b) * a.num_heads + h) * lq + row0;
  if constexpr (kFlash) {
    for (int il = threadIdx.x; il < kRows; il += kThreads) {
      delta_s[il] = il < n_rows ? a.delta[c.stat0 + il] : 0.0f;
    }
  } else {
    for (int il = warp; il < kRows && !c.one_tile; il += kThreads / 32) {
      float x = 0.0f;
      if (il < n_rows) {
        const float* gr = a.g + tile_off + size_t(il) * hd;
        const float* orow = a.out + tile_off + size_t(il) * hd;
        for (int col = lane; col < d; col += 32) x = fmaf(gr[col], orow[col], x);
      }
      x = warp_sum(x);
      if (lane == 0) {
        delta_s[il] = x;
        if (col0 == 0 && il < n_rows) a.delta[c.stat0 + il] = x;
      }
    }
  }

  c.geo = geometry_of(a, b);
  c.seed_mix = seed_mix_of(a, b, h);
  c.cell = uint32_t(b) * a.cell_stride + uint32_t(h);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int il = team_row(ty, i);
    c.rg[i] = c.geo.row(row0 + il);
    if constexpr (kFlash) {
      c.m[i] = il < n_rows ? a.lse[c.stat0 + il] : 0.0f;
      c.logl[i] = 0.0f;
    } else {
      c.m[i] = il < n_rows ? a.lse[(c.stat0 + il) * 2] : 0.0f;
      c.logl[i] = il < n_rows ? a.lse[(c.stat0 + il) * 2 + 1] : 0.0f;
    }
#pragma unroll
    for (int col = 0; col < kNc; ++col) c.acc[i][col] = 0.0f;
  }
  c.dw0 = c.dw1 = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kSide;
    if (S::kStages == 2 && t + 1 < n_tiles) {
      const int buf = (t + 1) & 1, jn = j0 + kSide, n = min(kSide, lk - jn);
      stage<kSide, D>(ks + buf * kSide * S::kStride, S::kStride, kb + size_t(jn) * hd, hd, n, d,
                      kv_aligned);
      stage<kSide, D>(vs + buf * kSide * S::kStride, S::kStride, vb + size_t(jn) * hd, hd, n, d,
                      kv_aligned);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (S::kStages == 1 && t > 0) {
        const int n = min(kSide, lk - j0);
        stage<kSide, D>(ks, S::kStride, kb + size_t(j0) * hd, hd, n, d, kv_aligned);
        stage<kSide, D>(vs, S::kStride, vb + size_t(j0) * hd, hd, n, d, kv_aligned);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cur = S::kStages == 2 ? (t & 1) : 0;
    dq_tile_of<S::kTpt, R, D, kFlash>(min(kSide, lk - j0), c, a, b,
                                      ks + cur * kSide * S::kStride,
                                      vs + cur * kSide * S::kStride, j0);
    __syncthreads();  // the tile buffers and dss are free
  }

  const bool o_aligned = head_aligned(a.dq + h * d, hd, d);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int il = team_row(ty, i);
    if (il < n_rows) {
      store_row<kCols>(a.dq + tile_off + size_t(il) * hd + col0, c.acc[i], tx, d - col0,
                       o_aligned);
    }
  }

  if (!kFlash && col0 == 0) {
    const int tiles = (lq + kRows - 1) / kRows;
    store_dw_partial(c.dw0, c.dw1,
                     a.dw_part + ((size_t(b) * a.num_heads + h) * tiles + tile) * 2);
  }
}

template <int D, bool kFlash>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1) dq_kernel(const Args a) {
  switch (rows_a_thread(min(kRows, a.lq - (blockIdx.x / groups_of<D>()) * kRows))) {
    case 4: dq_block<4, D, kFlash>(a); break;
    case 3: dq_block<3, D, kFlash>(a); break;
    case 2: dq_block<2, D, kFlash>(a); break;
    default: dq_block<1, D, kFlash>(a); break;
  }
}

// What a dK/dV block carries across the query tiles: where its tiles are,
// its keys' bias and geometry, their dk and dv accumulators and (flash) its
// share of the dw sums; R keys a thread (ty + 16 i, i < R).
template <int D, int R>
struct DkvBlock {
  const float *ks, *vs;
  float *pts, *dsts;  // the tile's P~ and dS_raw (keys x rows)
  Geometry geo;
  int ty, tx, key0, col0;
  size_t stat0;
  uint32_t seed_mix, cell;
  float bias[R];
  bool answer[R], key_valid[R];
  float dk[R][Bwd<D>::kNc], dv[R][Bwd<D>::kNc];
  float dw0, dw1;
};

// One query tile of the dK/dV pass (q and g rows qt, gt from row i0), each
// thread's micro-tile R x T, as dq_tile.
template <int T, int R, int D, bool kFlash>
__device__ __forceinline__ void dkv_tile(DkvBlock<D, R>& c, const Args& a, const float* qt,
                                         const float* gt, int i0) {
  using S = Bwd<D>;
  const int lq = a.lq, lk = a.lk, ty = c.ty, tx = c.tx;
  float s[R][T], dp[R][T];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int u = 0; u < T; ++u) s[i][u] = dp[i][u] = 0.0f;
  }
  row_dots<D, T>(s, c.ks, qt, S::kStride, ty, tx);
  row_dots<D, T>(dp, c.vs, gt, S::kStride, ty, tx);

  // the flash dropout cells' column parts of this thread's keys
  TileCol tcol[R];
  if (kFlash && a.dropout) {
#pragma unroll
    for (int i = 0; i < R; ++i) tcol[i] = tile_col(a, c.key0 + team_row(ty, i));
  }
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int r = i0 + tx + kG * u;  // this thread's query row
    const bool row_valid = r < lq;
    const RowGeometry rg = c.geo.row(r);
    float m = 0.0f, logl = 0.0f, delta = 0.0f;
    if (row_valid) {
      if constexpr (kFlash) {
        m = a.lse[c.stat0 + r];
      } else {
        m = a.lse[(c.stat0 + r) * 2];
        logl = a.lse[(c.stat0 + r) * 2 + 1];
      }
      delta = a.delta[c.stat0 + r];
    }
    TileRow trow{0u, 0u};
    if (kFlash && a.dropout) trow = tile_row(a, c.cell, r);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = c.key0 + team_row(ty, i);
      float pd = 0.0f, ds = 0.0f;
      if (row_valid && c.key_valid[i]) {
        const bool region = rg.in_scope && c.answer[i];
        const float s_raw = __fmul_rn(s[i][u], a.scale);
        const float sc =
            score(s[i][u], s_raw, a.scale, a.has_geometry, region, rg.w, c.bias[i]);
        const float p = prob<kFlash>(sc, m, logl);
        float dpv = dp[i][u];
        pd = p;
        if (a.dropout) {
          bool keep;
          if constexpr (kFlash) {
            keep = tile_keep(a, trow, tcol[i]);
          } else {
            keep = dropout_keep(uint32_t(r) * uint32_t(lk) + uint32_t(j), c.seed_mix,
                                a.threshold);
          }
          pd = keep ? __fmul_rn(p, a.keep) : 0.0f;
          dpv = keep ? __fmul_rn(dpv, a.keep) : 0.0f;
        }
        ds = p * (dpv - delta);
        if (region) {
          if constexpr (kFlash) {
            if (rg.is_example) {
              c.dw0 = fmaf(ds, s_raw, c.dw0);
            } else {
              c.dw1 = fmaf(ds, s_raw, c.dw1);
            }
          }
          ds = ds * rg.w;
        }
      }
      c.pts[team_row(ty, i) * S::kPStride + tx + kG * u] = pd;
      c.dsts[team_row(ty, i) * S::kPStride + tx + kG * u] = ds * a.scale;
    }
  }
  __syncwarp();  // a key's P~ and dS_raw are read by the half-warp that wrote them
  p_times<kG * T, S::kCols>(c.dv, c.pts, S::kPStride, gt + c.col0, S::kStride, ty, tx);
  p_times<kG * T, S::kCols>(c.dk, c.dsts, S::kPStride, qt + c.col0, S::kStride, ty, tx);
}

// dkv_tile at the narrowest micro-tile that covers the tile's n valid rows,
// as dq_tile_of.
template <int kTpt, int R, int D, bool kFlash>
__device__ __forceinline__ void dkv_tile_of(int n, DkvBlock<D, R>& c, const Args& a,
                                            const float* qt, const float* gt, int i0) {
  if constexpr (kTpt > 1 && R == 4) {
    if (n <= kG * (kTpt - 1)) {
      dkv_tile_of<kTpt - 1, R, D, kFlash>(n, c, a, qt, gt, i0);
      return;
    }
  }
  dkv_tile<kTpt, R, D, kFlash>(c, a, qt, gt, i0);
}

// The dK/dV pass of one block whose valid keys fit in 16 R.
template <int R, int D, bool kFlash>
__device__ __forceinline__ void dkv_block(const Args& a) {
  using S = Bwd<D>;
  constexpr int kSide = S::kSide, kCols = S::kCols, kNc = S::kNc;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kRows * S::kStride;
  float* qs = vs + kRows * S::kStride;                // two Q tiles
  float* gs = qs + S::kStages * kSide * S::kStride;   // g tiles
  float* pts = gs + S::kStages * kSide * S::kStride;  // the tile's P~ (keys x rows)
  float* dsts = pts + kRows * S::kPStride;            // its dS_raw (keys x rows)

  const int tile = blockIdx.x / groups_of<D>(), col0 = (blockIdx.x % groups_of<D>()) * kCols;
  const int h = blockIdx.y, b = blockIdx.z;
  const int d = kRagged ? a.head_dim : D;
  const int hd = a.num_heads * d, lq = a.lq, lk = a.lk;
  const int ty = team_ty(), tx = team_tx();
  const int key0 = tile * kRows, n_keys = min(kRows, lk - key0);
  const size_t tile_off = (size_t(b) * lk + key0) * hd + h * d;
  const float* qb = a.q + size_t(b) * lq * hd + h * d;
  const float* gb = a.g + size_t(b) * lq * hd + h * d;
  const bool kv_aligned =
      head_aligned(a.k + tile_off, hd, d) && head_aligned(a.v + tile_off, hd, d);
  const bool q_aligned = head_aligned(qb, hd, d) && head_aligned(gb, hd, d);
  const int n_tiles = (lq + kSide - 1) / kSide;

  stage<kRows, D>(ks, S::kStride, a.k + tile_off, hd, n_keys, d, kv_aligned);
  stage<kRows, D>(vs, S::kStride, a.v + tile_off, hd, n_keys, d, kv_aligned);
  stage<kSide, D>(qs, S::kStride, qb, hd, min(kSide, lq), d, q_aligned);
  stage<kSide, D>(gs, S::kStride, gb, hd, min(kSide, lq), d, q_aligned);
  cp_async_commit();

  DkvBlock<D, R> c;
  c.ks = ks;
  c.vs = vs;
  c.pts = pts;
  c.dsts = dsts;
  c.geo = geometry_of(a, b);
  c.ty = ty;
  c.tx = tx;
  c.key0 = key0;
  c.col0 = col0;
  c.stat0 = (size_t(b) * a.num_heads + h) * lq;
  c.seed_mix = seed_mix_of(a, b, h);
  c.cell = uint32_t(b) * a.cell_stride + uint32_t(h);
  // this thread's keys: ty + 16 i
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = key0 + team_row(ty, i);
    c.key_valid[i] = j < lk;
    c.bias[i] = c.key_valid[i] ? (1.0f - a.mask[size_t(b) * lk + j]) * kNegBias : 0.0f;
    c.answer[i] = c.geo.col_is_answer(j);
#pragma unroll
    for (int col = 0; col < kNc; ++col) c.dk[i][col] = c.dv[i][col] = 0.0f;
  }
  c.dw0 = c.dw1 = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = t * kSide;
    if (S::kStages == 2 && t + 1 < n_tiles) {
      const int buf = (t + 1) & 1, in = i0 + kSide, n = min(kSide, lq - in);
      stage<kSide, D>(qs + buf * kSide * S::kStride, S::kStride, qb + size_t(in) * hd, hd, n, d,
                      q_aligned);
      stage<kSide, D>(gs + buf * kSide * S::kStride, S::kStride, gb + size_t(in) * hd, hd, n, d,
                      q_aligned);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (S::kStages == 1 && t > 0) {
        const int n = min(kSide, lq - i0);
        stage<kSide, D>(qs, S::kStride, qb + size_t(i0) * hd, hd, n, d, q_aligned);
        stage<kSide, D>(gs, S::kStride, gb + size_t(i0) * hd, hd, n, d, q_aligned);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cur = S::kStages == 2 ? (t & 1) : 0;
    dkv_tile_of<S::kTpt, R, D, kFlash>(min(kSide, lq - i0), c, a,
                                       qs + cur * kSide * S::kStride,
                                       gs + cur * kSide * S::kStride, i0);
    __syncthreads();  // the tile buffers, pts and dsts are free
  }

  const bool o_aligned = head_aligned(a.dk + h * d, hd, d);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int jl = team_row(ty, i);
    if (jl < n_keys) {
      store_row<kCols>(a.dk + tile_off + size_t(jl) * hd + col0, c.dk[i], tx, d - col0,
                       o_aligned);
      store_row<kCols>(a.dv + tile_off + size_t(jl) * hd + col0, c.dv[i], tx, d - col0,
                       o_aligned);
    }
  }

  if (kFlash && col0 == 0) {
    const int tiles = (lk + kRows - 1) / kRows;
    store_dw_partial(c.dw0, c.dw1,
                     a.dw_part + ((size_t(b) * a.num_heads + h) * tiles + tile) * 2);
  }
}

template <int D, bool kFlash>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1) dkv_kernel(const Args a) {
  switch (rows_a_thread(min(kRows, a.lk - (blockIdx.x / groups_of<D>()) * kRows))) {
    case 4: dkv_block<4, D, kFlash>(a); break;
    case 3: dkv_block<3, D, kFlash>(a); break;
    case 2: dkv_block<2, D, kFlash>(a); break;
    default: dkv_block<1, D, kFlash>(a); break;
  }
}

}  // namespace attention_fp32
