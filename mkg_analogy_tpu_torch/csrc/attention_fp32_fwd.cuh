// The tiled fp32 attention forward, shared by the single-block kernel
// (fused_attention_fwd.cu, row 1: kFlash false) and the flash one
// (flash_attention_fwd.cu, row 3: kFlash true).
//
// Both compute, per (batch row, head), on the packed (B, L, heads * D)
// layout in and out,
//
//   out = softmax(scale * Q K^T (*) analogy multiplier + (1 - mask) * -1e4) V
//
// with attention dropout, every product on register micro-tiles
// (attention_fp32.cuh):
//   - one block of 256 threads per (query tile of 64 rows, head, batch row;
//     above D = 128 per 64 output columns, each such block recomputing the
//     scores): it stages its Q tile once, and the keys come in staged tiles
//     of 64 (D <= 64) or 32 through a double-buffered cp.async ring;
//   - each thread owns a 4 x (tile / 16) register micro-tile of the 64 x
//     tile score block: a depth step reads 4 + tile / 16 float4s of shared
//     memory (the four query rows broadcast within a half-warp) for
//     16 x tile / 16 FMAs; the exp-weights go through shared memory to the
//     half-warp that owns their row, and the same micro-tile scheme runs
//     P V into 4 x (D / 16) output accumulators a thread;
//   - a row's running max and sum (its 16 threads reduce with shuffles),
//     the sum and the accumulators rescaled when the max moves;
//   - a ragged edge costs no whole tile: a last key tile runs only the
//     micro-tile columns its valid keys need (T of a thread's kKpt), a
//     block only the rows its valid rows need (R of 4, rows_a_thread: 96
//     rows take blocks of 4 and 2 rows a thread, 99 of 4 and 3, 72 of 4
//     and 1). The rows and columns left out are zero rows and keys of
//     exp-weight 0, whose terms add exact zeros, so the results are those
//     of whole tiles bit for bit.
// The score of an element is row_dots' column-order fmaf chain, then
// __fmul_rn and one fmaf (attention_fp32.cuh, score): the backward passes
// (attention_fp32_bwd.cuh) form it with the same instructions, so they
// rebuild the forward's probabilities bit for bit. Products are exact fp32
// FMAs: no TF32 and no 3xTF32 (the fp32 bars are 2e-5).
//
// What the two kernels differ in (each part of the function of its TPU
// kernel):
//   - the sweep. Single-block: one online sweep over any Lk, the max moved
//     once a staged tile, K and V tiles staged together (105 KB of shared
//     memory at D = 64, 111 KB at 128: two blocks an SM; 159 KB at 256,
//     whatever the lengths). Flash: the logical K tiles of bk keys, each
//     swept twice as flash_attention.py:_flash_fwd_kernel (:122-151) walks
//     it: its K tiles' scores into shared memory and the tile's max first,
//     then its V tiles, the exp-weights against that max, P V chained over
//     the tile's keys in order, and the tile's sum in the order of a warp
//     whose lane j sums keys j, j + 32, ... and then halves (the order of
//     the plain version's row sum on the card). The fp32 training steps
//     amplify any re-association of round-off (a max moved once a staged
//     tile put chip_smoke.py's pre-train gradient gate at 7.4x its bar,
//     then a sum in another order at 9.2x), so the kernel keeps this order
//     of operations. Shared memory grows with bk (the Q tile,
//     a ring of two staged tiles, 64 rows of bk scores: 87.5 KB at D = 64
//     and bk <= 128, 111.5 KB at 224, two blocks an SM; 183.5 KB at 512);
//     above D = 128 a block takes 32 query rows (163.75 KB at 256 and bk =
//     512);
//   - the row statistics: single-block each row's (max, log of its sum),
//     (B, heads, Lq, 2): the two terms stay apart because an fp32 sum near
//     -1e4 (a row whose keys are all masked) would lose 2^-11 of it, 5e-4
//     of every probability of the row, to rounding; flash one log-sum-exp
//     a row, m + log(l), (B, heads, Lq), which its backward pair reads as p
//     = exp(s - lse), as JAX's body writes it;
//   - the dropout mask: single-block idx = row * Lk + col with one seed a
//     (b, head), a dropped weight 0 and the output divided by 1 - rate at
//     the end; flash one seed a logical (bq, bk) tile, seed + (cell *
//     n_qblk + qb) * n_kblk + kb, idx = (row - qb bq) * bk + (col - kb bk)
//     (bk the logical width even in a ragged last tile), a kept weight
//     times 1 / (1 - rate) before P V, as the Pallas body does. A row's
//     logical tile comes from one division (once a block, kept in shared
//     memory), so 64-row blocks may straddle the logical row tiles; the
//     staged key tiles start at each logical tile's first key;
//   - the running max starts at -inf (single-block) or -1e30 (flash,
//     flash_attention.py:113); keys past Lk are never read (JAX gives them
//     HARD_MASK, an exp-weight of exactly 0), so either start gives the
//     same numbers;
//   - the normalisation: single-block times 1 / sum (and / (1 - rate)),
//     flash acc / l, as their plain versions.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fp32.cuh"

namespace attention_fp32 {

constexpr float kHardMask = -1e30f;  // flash_attention.py:HARD_MASK, flash's first max

template <int D, bool kFlash>
struct Fwd {
  static constexpr int kKeys = D <= 64 ? 64 : 32;     // keys a staged tile
  static constexpr int kKpt = kKeys / kG;             // keys a thread
  static constexpr int kCols = cols_of<D>();          // output columns a block
  static constexpr int kNc = kCols / kG;              // output columns a thread
  static constexpr int kStride = D + kPad;            // Q and K rows
  static constexpr int kVStride = kCols + kPad;       // V rows (the block's columns)
  static constexpr int kPStride = p_stride<kKeys>();  // exp-weight rows (single-block)
  // query rows a block: 64, or 32 in the flash kernel above D = 128, where
  // 64 rows of a 512-key logical tile's scores beside a full-depth Q tile
  // and key ring would pass a block's shared memory
  static constexpr int kBlockRows = kFlash && D > 128 ? kRows / 2 : kRows;
  // flash: the row stride of the logical tile's scores (bk of them, rounded
  // up to 32; a step writes and reads no column past bk rounded up to kG):
  // kG more than a multiple of 32, as p_stride
  __host__ __device__ static constexpr int s_stride(int bk) { return (bk + 31) / 32 * 32 + kG; }
  // the dynamic shared memory of a block. Single-block: the Q tile, two K
  // and two V tiles, the tile's exp-weights. Flash: the Q tile, a ring of
  // two staged tiles (a logical tile's K tiles, then its V tiles), the
  // logical tile's scores (then exp-weights), the rows' dropout cells (a
  // tile seed and an index base a row).
  __host__ __device__ static constexpr size_t bytes(int bk) {
    return sizeof(float) *
           (kFlash ? size_t(kBlockRows) * kStride + 2 * size_t(kKeys) * kStride +
                         size_t(kBlockRows) * s_stride(bk) + 2 * kBlockRows
                   : size_t(kRows) * kStride + 2 * size_t(kKeys) * kStride +
                         2 * size_t(kKeys) * kVStride + size_t(kRows) * kPStride);
  }
};

// What a block carries across the key tiles: where its tiles are, its rows'
// geometry, running max and sum and output accumulators; R rows a thread
// (ty + 16 i, i < R).
template <int D, bool kFlash, int R>
struct FwdBlock {
  const float* qs;
  float* ps;              // single-block: the tile's exp-weights; flash: the logical tile's
  const uint32_t* cells;  // flash: the rows' tile seeds, then their index bases
  Geometry geo;
  int ty, tx, b, row0;
  uint32_t seed_mix;
  RowGeometry rg[R];
  // the rows' running max and sum (single-block: this thread's share of the
  // sum; flash: the row's, and this thread's shares of the logical tile's
  // exp-weights of keys tx and tx + kG mod 2 kG)
  float m[R], l[R], le[R], lo[R];
  float acc[R][Fwd<D, kFlash>::kNc];
};

// s[i][u]: the score of row ty + 16 i and key j0 + tx + kG u against the
// staged K rows kt; -inf from key j_end on (past Lk, or past the logical
// tile).
template <int T, int R, int D, bool kFlash>
__device__ __forceinline__ void tile_scores(const FwdBlock<D, kFlash, R>& c, const Args& a,
                                            const float* kt, int j0, int j_end,
                                            float (&s)[R][T]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int u = 0; u < T; ++u) s[i][u] = 0.0f;
  }
  row_dots<D, T>(s, c.qs, kt, Fwd<D, kFlash>::kStride, c.ty, c.tx);
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int j = j0 + c.tx + kG * u;
    const bool valid = j < j_end;
    const float bias = valid ? (1.0f - a.mask[size_t(c.b) * a.lk + j]) * kNegBias : 0.0f;
    const bool answer = c.geo.col_is_answer(j);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float x = s[i][u];
      s[i][u] = valid ? score(x, __fmul_rn(x, a.scale), a.scale, a.has_geometry,
                              c.rg[i].in_scope && answer, c.rg[i].w, bias)
                      : -INFINITY;
    }
  }
}

// The running max of row i moved to max(m, its group's mt), its sum and
// accumulators rescaled (by 0 the first time).
template <int D, bool kFlash, int R>
__device__ __forceinline__ void move_max(FwdBlock<D, kFlash, R>& c, int i, float mt) {
  const float m_new = fmaxf(c.m[i], group_max(mt));
  const float corr = expf(c.m[i] - m_new);
  c.m[i] = m_new;
  c.l[i] *= corr;
#pragma unroll
  for (int col = 0; col < Fwd<D, kFlash>::kNc; ++col) c.acc[i][col] *= corr;
}

// The exp-weights of a staged tile's scores s against the rows' running max
// (single-block: moved first by the tile's row max mt), their sum (before
// dropout) into l, dropped, written to P (the tile's first column, rows
// pstride apart), then acc += P V over the staged V rows vt. jl0: the
// tile's first key in its dropout cell (single-block: the key; flash: its
// column in the logical tile lt).
template <int T, int R, int D, bool kFlash>
__device__ __forceinline__ void tile_weights(FwdBlock<D, kFlash, R>& c, const Args& a,
                                             const float (&s)[R][T], const float (&mt)[R],
                                             float* P, int pstride, const float* vt, int jl0,
                                             int lt) {
  using S = Fwd<D, kFlash>;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!kFlash) move_max(c, i, mt[i]);
    const int il = team_row(c.ty, i);
    TileRow trow{0u, 0u};
    if (kFlash && a.dropout) trow = TileRow{c.cells[il], c.cells[S::kBlockRows + il]};
#pragma unroll
    for (int u = 0; u < T; ++u) {
      float p = expf(s[i][u] - c.m[i]);
      if constexpr (kFlash) {
        if (u & 1) {
          c.lo[i] += p;
        } else {
          c.le[i] += p;
        }
      } else {
        c.l[i] += p;
      }
      if (a.dropout) {
        const uint32_t jl = uint32_t(jl0 + c.tx + kG * u);
        if constexpr (kFlash) {
          p = dropout_keep(trow.idx + jl, (trow.seed + uint32_t(lt)) * 0x9E3779B9u,
                           a.threshold)
                  ? __fmul_rn(p, a.keep)
                  : 0.0f;
        } else if (!dropout_keep(uint32_t(c.row0 + il) * uint32_t(a.lk) + jl, c.seed_mix,
                                 a.threshold)) {
          p = 0.0f;
        }
      }
      P[il * pstride + c.tx + kG * u] = p;
    }
  }
  __syncwarp();  // a row's exp-weights are read by the half-warp that wrote them
  p_times<kG * T, S::kCols>(c.acc, P, pstride, vt, S::kVStride, c.ty, c.tx);
}

// Single-block: one staged tile (K and V rows kt, vt from key j0), the
// online softmax's max moved by the tile; micro-tiles R x T.
template <int T, int R, int D>
__device__ __forceinline__ void single_tile(FwdBlock<D, false, R>& c, const Args& a,
                                            const float* kt, const float* vt, int j0) {
  float s[R][T], mt[R];
  tile_scores<T>(c, a, kt, j0, a.lk, s);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    mt[i] = -INFINITY;
#pragma unroll
    for (int u = 0; u < T; ++u) mt[i] = fmaxf(mt[i], s[i][u]);
  }
  tile_weights<T>(c, a, s, mt, c.ps, Fwd<D, false>::kPStride, vt, j0, 0);
}

// Flash, a logical tile's first sweep: a staged K tile's scores into the
// scores' column jl0 on, their max into mt.
template <int T, int R, int D>
__device__ __forceinline__ void flash_scores(FwdBlock<D, true, R>& c, const Args& a,
                                             const float* kt, int j0, int j_end, int jl0,
                                             int sstride, float (&mt)[R]) {
  float s[R][T];
  tile_scores<T>(c, a, kt, j0, j_end, s);
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int u = 0; u < T; ++u) {
      mt[i] = fmaxf(mt[i], s[i][u]);
      c.ps[team_row(c.ty, i) * sstride + jl0 + c.tx + kG * u] = s[i][u];
    }
  }
}

// Flash, a logical tile's second sweep: the exp-weights of the scores at
// column jl0 on (written in their place), P V over the staged V rows vt.
template <int T, int R, int D>
__device__ __forceinline__ void flash_weights(FwdBlock<D, true, R>& c, const Args& a,
                                              const float* vt, int jl0, int lt, int sstride) {
  float s[R][T];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int u = 0; u < T; ++u) s[i][u] = c.ps[team_row(c.ty, i) * sstride + jl0 + c.tx + kG * u];
  }
  tile_weights<T>(c, a, s, c.m, c.ps + jl0, sstride, vt, jl0, lt);  // (mt unused)
}

// Each step at the narrowest micro-tile, of at most kKpt columns, whose kG *
// T keys cover the tile's n valid ones. Single-block: in a block of four
// rows a thread; a narrower block (R < 4, one at the end of a (b, head)'s
// rows) keeps kKpt, which bounds the number of instances nvcc compiles.
// Flash: in every block, so that no step writes or reads a score column
// past the logical tile's width rounded up to kG, which the scores' rows
// hold (s_stride).
template <int kKpt, int R, int D>
__device__ __forceinline__ void single_tile_of(int n, FwdBlock<D, false, R>& c, const Args& a,
                                               const float* kt, const float* vt, int j0) {
  if constexpr (kKpt > 1 && R == 4) {
    if (n <= kG * (kKpt - 1)) {
      single_tile_of<kKpt - 1, R, D>(n, c, a, kt, vt, j0);
      return;
    }
  }
  single_tile<kKpt, R, D>(c, a, kt, vt, j0);
}

template <int kKpt, int R, int D>
__device__ __forceinline__ void flash_scores_of(int n, FwdBlock<D, true, R>& c, const Args& a,
                                                const float* kt, int j0, int j_end, int jl0,
                                                int sstride, float (&mt)[R]) {
  if constexpr (kKpt > 1) {
    if (n <= kG * (kKpt - 1)) {
      flash_scores_of<kKpt - 1, R, D>(n, c, a, kt, j0, j_end, jl0, sstride, mt);
      return;
    }
  }
  flash_scores<kKpt, R, D>(c, a, kt, j0, j_end, jl0, sstride, mt);
}

template <int kKpt, int R, int D>
__device__ __forceinline__ void flash_weights_of(int n, FwdBlock<D, true, R>& c, const Args& a,
                                                 const float* vt, int jl0, int lt, int sstride) {
  if constexpr (kKpt > 1) {
    if (n <= kG * (kKpt - 1)) {
      flash_weights_of<kKpt - 1, R, D>(n, c, a, vt, jl0, lt, sstride);
      return;
    }
  }
  flash_weights<kKpt, R, D>(c, a, vt, jl0, lt, sstride);
}

// The forward of one block whose valid rows fit in 16 R.
template <int R, int D, bool kFlash>
__device__ __forceinline__ void fwd_block(const Args& a) {
  using S = Fwd<D, kFlash>;
  constexpr int kKeys = S::kKeys, kCols = S::kCols, kNc = S::kNc, kBlockRows = S::kBlockRows;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  // single-block: two K tiles, two V tiles, the exp-weights; flash: the ring
  // of two staged tiles, the logical tile's scores, the rows' cells
  float* ks = qs + kBlockRows * S::kStride;
  float* vs = ks + 2 * kKeys * S::kStride;
  float* ps = kFlash ? vs : vs + 2 * kKeys * S::kVStride;
  const int sstride = S::s_stride(a.bk);
  uint32_t* cells = reinterpret_cast<uint32_t*>(ps + kBlockRows * sstride);  // flash

  const int tile = blockIdx.x / groups_of<D>(), col0 = (blockIdx.x % groups_of<D>()) * kCols;
  const int h = blockIdx.y, b = blockIdx.z;
  const int d = kRagged ? a.head_dim : D;
  const int hd = a.num_heads * d, lq = a.lq, lk = a.lk;
  const int ty = team_ty(), tx = team_tx();
  const int row0 = tile * kBlockRows, n_rows = min(kBlockRows, lq - row0);
  const float* qb = a.q + (size_t(b) * lq + row0) * hd + h * d;
  const float* kb = a.k + size_t(b) * lk * hd + h * d;
  const float* vb = a.v + size_t(b) * lk * hd + h * d + col0;
  const bool q_aligned = head_aligned(qb, hd, d);
  const bool kv_aligned = head_aligned(kb, hd, d) && head_aligned(vb - col0, hd, d);
  const int v_cols = min(kCols, d - col0);
  // stage the K (V) tile of keys j .. up to j_end into buf
  auto stage_k = [&](float* buf, int j, int j_end) {
    stage<kKeys, D>(buf, S::kStride, kb + size_t(j) * hd, hd, min(kKeys, j_end - j), d,
                    kv_aligned);
  };
  auto stage_v = [&](float* buf, int j, int j_end) {
    stage<kKeys, kCols>(buf, S::kVStride, vb + size_t(j) * hd, hd, min(kKeys, j_end - j),
                        v_cols, kv_aligned);
  };

  stage<kBlockRows, D>(qs, S::kStride, qb, hd, n_rows, d, q_aligned);
  stage_k(ks, 0, kFlash ? min(lk, a.bk) : lk);
  if (!kFlash) stage_v(vs, 0, lk);
  cp_async_commit();

  FwdBlock<D, kFlash, R> c;
  c.qs = qs;
  c.ps = ps;
  c.cells = cells;
  c.geo = geometry_of(a, b);
  c.ty = ty;
  c.tx = tx;
  c.b = b;
  c.row0 = row0;
  c.seed_mix = seed_mix_of(a, b, h);
  if (kFlash && a.dropout) {
    // each row's logical tile (published by the first tile's barrier)
    const uint32_t cell = uint32_t(b) * a.cell_stride + uint32_t(h);
    for (int il = threadIdx.x; il < kBlockRows; il += kThreads) {
      const TileRow t = tile_row(a, cell, row0 + il);
      cells[il] = t.seed;
      cells[kBlockRows + il] = t.idx;
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    c.rg[i] = c.geo.row(row0 + team_row(ty, i));
    c.m[i] = kFlash ? kHardMask : -INFINITY;
    c.l[i] = 0.0f;
#pragma unroll
    for (int col = 0; col < kNc; ++col) c.acc[i][col] = 0.0f;
  }

  if constexpr (kFlash) {
    // Each logical tile twice: its K tiles' scores into the scores' rows and
    // its max, before any exponential; then its V tiles, the exp-weights
    // against that max and P V. The staged tiles run through the ring in
    // that order, the next one's copy in flight behind the current one.
    int slot = 0;
    for (int lt = 0; lt < a.n_kblk; ++lt) {
      const int c0 = lt * a.bk, c_end = min(lk, c0 + a.bk);
      const int n_tiles = (c_end - c0 + kKeys - 1) / kKeys;
      float mt[R];
#pragma unroll
      for (int i = 0; i < R; ++i) mt[i] = -INFINITY;
      for (int t = 0; t < n_tiles; ++t) {
        const int j0 = c0 + t * kKeys;
        float* next = ks + (slot ^ 1) * kKeys * S::kStride;
        if (t + 1 < n_tiles) {
          stage_k(next, j0 + kKeys, c_end);
        } else {
          stage_v(next, c0, c_end);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        flash_scores_of<S::kKpt, R, D>(c_end - j0, c, a, ks + slot * kKeys * S::kStride, j0,
                                       c_end, j0 - c0, sstride, mt);
        __syncthreads();  // the slot is free
        slot ^= 1;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        move_max(c, i, mt[i]);
        c.le[i] = c.lo[i] = 0.0f;
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int j0 = c0 + t * kKeys;
        float* next = ks + (slot ^ 1) * kKeys * S::kStride;
        if (t + 1 < n_tiles) {
          stage_v(next, j0 + kKeys, c_end);
        } else if (lt + 1 < a.n_kblk) {
          stage_k(next, c_end, min(lk, c_end + a.bk));
        }
        if (t + 1 < n_tiles || lt + 1 < a.n_kblk) {
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        flash_weights_of<S::kKpt, R, D>(c_end - j0, c, a, ks + slot * kKeys * S::kStride,
                                        j0 - c0, lt, sstride);
        __syncthreads();  // the slot and the exp-weights are free
        slot ^= 1;
      }
      // the logical tile's sum, in the order of a warp whose lane j sums
      // keys j, j + 32, ... and then reduces by halves (the plain version's
      // row sum on the card): keys tx + 32 k are this thread's le, keys tx +
      // kG + 32 k its lo
#pragma unroll
      for (int i = 0; i < R; ++i) c.l[i] += group_sum(c.le[i] + c.lo[i]);
    }
  } else {
    const int n_tiles = (lk + kKeys - 1) / kKeys;
    for (int t = 0; t < n_tiles; ++t) {
      const int j0 = t * kKeys;
      if (t + 1 < n_tiles) {
        const int buf = (t + 1) & 1;
        stage_k(ks + buf * kKeys * S::kStride, j0 + kKeys, lk);
        stage_v(vs + buf * kKeys * S::kVStride, j0 + kKeys, lk);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      single_tile_of<S::kKpt, R, D>(lk - j0, c, a, ks + (t & 1) * kKeys * S::kStride,
                                    vs + (t & 1) * kKeys * S::kVStride, j0);
      __syncthreads();  // the tile buffers and ps are free
    }
  }

  const bool o_aligned = head_aligned(a.o + h * d, hd, d);
  const size_t stat0 = (size_t(b) * a.num_heads + h) * lq + row0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int il = team_row(ty, i);
    const float sum = kFlash ? c.l[i] : group_sum(c.l[i]);
    if (il >= n_rows) continue;
    if constexpr (kFlash) {
#pragma unroll
      for (int col = 0; col < kNc; ++col) c.acc[i][col] = c.acc[i][col] / sum;
    } else {
      float norm = 1.0f / sum;
      if (a.dropout) norm = norm / a.keep;
#pragma unroll
      for (int col = 0; col < kNc; ++col) c.acc[i][col] *= norm;
    }
    store_row<kCols>(a.o + (size_t(b) * lq + row0 + il) * hd + h * d + col0, c.acc[i], tx,
                     d - col0, o_aligned);
    if (col0 == 0 && tx == 0) {
      if constexpr (kFlash) {
        a.lse[stat0 + il] = c.m[i] + logf(sum);
      } else {
        a.lse[(stat0 + il) * 2] = c.m[i];
        a.lse[(stat0 + il) * 2 + 1] = logf(sum);
      }
    }
  }
}

template <int D, bool kFlash>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1) fwd_kernel(const Args a) {
  constexpr int kBlockRows = Fwd<D, kFlash>::kBlockRows;
  const int r =
      rows_a_thread(min(kBlockRows, a.lq - (blockIdx.x / groups_of<D>()) * kBlockRows));
  if constexpr (kBlockRows == kRows) {
    switch (r) {
      case 4: fwd_block<4, D, kFlash>(a); break;
      case 3: fwd_block<3, D, kFlash>(a); break;
      case 2: fwd_block<2, D, kFlash>(a); break;
      default: fwd_block<1, D, kFlash>(a); break;
    }
  } else if (r == 2) {
    fwd_block<2, D, kFlash>(a);
  } else {
    fwd_block<1, D, kFlash>(a);
  }
}

// The grid of a forward launch: a block per (kBlockRows query rows, and
// above D = 128 per 64 output columns; head; batch row).
template <int D, bool kFlash>
dim3 fwd_grid(int batch, int lq, int num_heads) {
  constexpr int kBlockRows = Fwd<D, kFlash>::kBlockRows;
  return dim3(((lq + kBlockRows - 1) / kBlockRows) * groups_of<D>(), num_heads, batch);
}

}  // namespace attention_fp32
