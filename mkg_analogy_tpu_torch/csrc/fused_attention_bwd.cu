// Fused multi-head attention backward for the MarT towers, fp32, sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/attention.py:_bwd_kernel
// (:159, launched by _fused_attention_bwd, the pl.pallas_call at :350, under
// the jax.custom_vjp at :286-383) on the fp32 route; bf16 takes the
// tensor-core kernels (fused_attention_bwd_mma.cu). Given q, k, v, the
// output cotangent g, the forward's output and row statistics (each row's
// max m and log of its sum, fused_attention_fwd.cu) and its mask, boundary,
// (w0, w1) and seed, it rebuilds the probabilities and the dropout mask and
// writes
//
//   dv = P~^T g             P~ = dropout(P), P = exp(S - m - log l)
//   dP = (g V^T) * keep / (1 - rate)
//   dS = P * (dP - delta),  delta = rowsum(g * out) = rowsum(dP * P)
//   dq = dS_raw K,  dk = dS_raw^T q,   dS_raw = dS * mult * scale
//   dw0 / dw1 = sum(dS * S_raw) over the two analogy regions
//
// with the cast points of _bwd_kernel (:199, :208-217; each a no-op in fp32),
// on the packed (B, L, heads * D) layout in and out, D = 64 or 128, each its
// own instantiation, or any other width up to 256 through the instance of
// its padded width, in a library of its own (attention_width.cuh, as
// fused_attention_fwd.cu). delta = rowsum(g * out) is the identity rows 3-5
// use (kernels/flash_attention.py:_delta): out = P~ V, so g . out =
// sum_j P~_j (g . v_j) = rowsum(dP * P) with dropout too. The dropout mask
// is the counter hash of fused_attention_fwd.cu, so it is the forward's mask
// bit for bit. The plain PyTorch version is
// kernels/attention.py:fused_attention_bwd_reference.
//
// What bounds it: fp32 operations, 10 * Lq * Lk * d flops a (b, head) (S
// recomputed, dP, dv, dq, dk) on ~28 * L * d bytes, above the H100's fp32
// balance point of 20 flops a byte; the bound is the CUDA cores' 67
// TFLOP/s (no tensor-core format keeps the fp32 bar). Hopper blocks run in
// no order and carry nothing, so the work is split in two passes, each one
// sweep over the other side, with the register micro-tiles of
// attention_fp32.cuh for every product:
//   1. dq pass — one block per (query tile of 64 rows, head, batch row; and
//      above D = 128 per 64 columns of dq): it stages its Q and g tiles,
//      computes its rows' delta from g and out (and writes it for pass 2;
//      where every key fits one tile, rowsum(dP * P) of that tile instead,
//      which is exact where P is one-hot, as the plain version's dS = 0),
//      and sweeps the keys in tiles through cp.async: S and dP (two
//      micro-tiles a thread), P from the statistics, dS, the dw partials,
//      dS_raw through shared memory to its row's half-warp, dq += dS_raw K.
//      It writes one (dw0, dw1) partial per (b, head, query tile), which the
//      wrapper sums: no float atomics, so fp32 results repeat from run to
//      run.
//   2. dK/dV pass — one block per (key tile of 64 keys, head, batch row;
//      and above D = 128 per 64 columns of dk and dv): it stages its K and V
//      tiles and sweeps the query rows in tiles with their statistics and
//      delta: S^T and dP^T, P~ and dS_raw through shared memory, dv += P~^T
//      g and dk += dS_raw^T q.
// The other side's tiles: up to D = 64, 64 rows in one buffer (4 x 4
// micro-tiles, as the forward's; 88 / 108 KB a block, two blocks an SM: on
// an H100 faster at ViLT's 418 keys and MKGformer's shapes than 32 rows in
// two buffers, whose 4 x 2 micro-tiles read more shared memory an FMA, and
// a little slower at 1024 x 1024); above, 32 rows (16 above D = 128) in two
// buffers, the next tile's copy in flight behind the current one's
// products (144 / 156 KB at 128, 203 / 211 KB at 256). Neither depends on
// a length. Both passes compute a score with the forward's instructions in
// the same order (attention_fp32.cuh:row_dots, then __fmul_rn and one
// fmaf), so every pass sees the forward's probabilities bit for bit.
// Products are exact fp32 FMAs: no TF32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fp32.cuh"

using namespace attention_fp32;

namespace {

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
};

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1) dq_kernel(const Args a) {
  using S = Bwd<D>;
  constexpr int kSide = S::kSide, kTpt = S::kTpt, kCols = S::kCols, kNc = S::kNc;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* gs = qs + kRows * S::kStride;
  float* ks = gs + kRows * S::kStride;                // two K tiles
  float* vs = ks + S::kStages * kSide * S::kStride;   // V tiles
  float* dss = vs + S::kStages * kSide * S::kStride;  // the tile's dS_raw
  float* delta_s = dss + kRows * S::kPStride;         // the rows' delta
  __shared__ float dw_s[kThreads / 32][2];

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

  // delta of the tile's rows. Keys in more than one tile: rowsum(g * out),
  // a warp a row (published by the first tile's barrier). Keys in one tile:
  // rowsum(dP * P) of that tile, below, which is dP itself where P is
  // one-hot (one key, or one unmasked key), so dS is exactly 0 there, as
  // in the plain version.
  const bool one_tile = n_tiles == 1;
  const size_t stat0 = (size_t(b) * a.num_heads + h) * lq + row0;
  for (int il = warp; il < kRows && !one_tile; il += kThreads / 32) {
    float x = 0.0f;
    if (il < n_rows) {
      const float* gr = a.g + tile_off + size_t(il) * hd;
      const float* orow = a.out + tile_off + size_t(il) * hd;
      for (int c = lane; c < d; c += 32) x = fmaf(gr[c], orow[c], x);
    }
    x = warp_sum(x);
    if (lane == 0) {
      delta_s[il] = x;
      if (col0 == 0 && il < n_rows) a.delta[stat0 + il] = x;
    }
  }

  const Geometry geo = geometry_of(a, b);
  const uint32_t seed_mix = seed_mix_of(a, b, h);
  RowGeometry rg[4];
  float m[4], logl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int il = team_row(ty, i);
    rg[i] = geo.row(row0 + il);
    m[i] = il < n_rows ? a.lse[(stat0 + il) * 2] : 0.0f;
    logl[i] = il < n_rows ? a.lse[(stat0 + il) * 2 + 1] : 0.0f;
  }
  float acc[4][kNc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kNc; ++c) acc[i][c] = 0.0f;
  }
  float dw0 = 0.0f, dw1 = 0.0f;  // this thread's partials

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
    const float* kt = ks + cur * kSide * S::kStride;
    const float* vt = vs + cur * kSide * S::kStride;

    float s[4][kTpt], dp[4][kTpt];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int u = 0; u < kTpt; ++u) s[i][u] = dp[i][u] = 0.0f;
    }
    row_dots<D, kTpt>(s, qs, kt, S::kStride, ty, tx);
    row_dots<D, kTpt>(dp, gs, vt, S::kStride, ty, tx);

    // P (into s), the dropped and rescaled dP (into dp), S_raw
    float s_raw[4][kTpt];
#pragma unroll
    for (int u = 0; u < kTpt; ++u) {
      const int j = j0 + tx + kG * u;
      const bool valid = j < lk;
      const float bias = valid ? (1.0f - a.mask[size_t(b) * lk + j]) * kNegBias : 0.0f;
      const bool answer = geo.col_is_answer(j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int il = team_row(ty, i);
        s_raw[i][u] = __fmul_rn(s[i][u], a.scale);
        const float sc = score(s[i][u], s_raw[i][u], a.scale, a.has_geometry,
                               rg[i].in_scope && answer, rg[i].w, bias);
        float p = 0.0f, dpv = 0.0f;
        if (valid && il < n_rows) {
          p = expf((sc - m[i]) - logl[i]);
          dpv = dp[i][u];
          if (a.dropout) {
            dpv = dropout_keep(uint32_t(row0 + il) * uint32_t(lk) + uint32_t(j), seed_mix,
                               a.threshold)
                      ? __fmul_rn(dpv, a.keep)
                      : 0.0f;
          }
        }
        s[i][u] = p;
        dp[i][u] = dpv;
      }
    }
    float delta[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (one_tile) {
        float x = 0.0f;
#pragma unroll
        for (int u = 0; u < kTpt; ++u) x = fmaf(dp[i][u], s[i][u], x);
        delta[i] = group_sum(x);
        const int il = team_row(ty, i);
        if (col0 == 0 && tx == 0 && il < n_rows) a.delta[stat0 + il] = delta[i];
      } else {
        delta[i] = delta_s[team_row(ty, i)];
      }
    }
    // dS, the dw partials, dS_raw = dS * mult * scale
#pragma unroll
    for (int u = 0; u < kTpt; ++u) {
      const bool answer = geo.col_is_answer(j0 + tx + kG * u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ds = s[i][u] * (dp[i][u] - delta[i]);
        if (rg[i].in_scope && answer) {
          if (rg[i].is_example) {
            dw0 = fmaf(ds, s_raw[i][u], dw0);
          } else {
            dw1 = fmaf(ds, s_raw[i][u], dw1);
          }
          ds = ds * rg[i].w;
        }
        dss[team_row(ty, i) * S::kPStride + tx + kG * u] = ds * a.scale;
      }
    }
    __syncwarp();  // a row's dS_raw is read by the half-warp that wrote it
    p_times<kSide, kCols>(acc, dss, S::kPStride, kt + col0, S::kStride, ty, tx);
    __syncthreads();  // the tile buffers and dss are free
  }

  const bool o_aligned = head_aligned(a.dq + h * d, hd, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int il = team_row(ty, i);
    if (il < n_rows) {
      store_row<kCols>(a.dq + tile_off + size_t(il) * hd + col0, acc[i], tx, d - col0,
                       o_aligned);
    }
  }

  if (col0 == 0) {
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
      const int tiles = (lq + kRows - 1) / kRows;
      float* o = a.dw_part + ((size_t(b) * a.num_heads + h) * tiles + tile) * 2;
      o[0] = t0;
      o[1] = t1;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1) dkv_kernel(const Args a) {
  using S = Bwd<D>;
  constexpr int kSide = S::kSide, kTpt = S::kTpt, kCols = S::kCols, kNc = S::kNc;
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

  const Geometry geo = geometry_of(a, b);
  const uint32_t seed_mix = seed_mix_of(a, b, h);
  const size_t stat0 = (size_t(b) * a.num_heads + h) * lq;
  // this thread's keys: ty + 16 i
  float bias[4];
  bool answer[4], key_valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = key0 + team_row(ty, i);
    key_valid[i] = j < lk;
    bias[i] = key_valid[i] ? (1.0f - a.mask[size_t(b) * lk + j]) * kNegBias : 0.0f;
    answer[i] = geo.col_is_answer(j);
  }
  float dk[4][kNc], dv[4][kNc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kNc; ++c) dk[i][c] = dv[i][c] = 0.0f;
  }

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
    const float* qt = qs + cur * kSide * S::kStride;
    const float* gt = gs + cur * kSide * S::kStride;

    float s[4][kTpt], dp[4][kTpt];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int u = 0; u < kTpt; ++u) s[i][u] = dp[i][u] = 0.0f;
    }
    row_dots<D, kTpt>(s, ks, qt, S::kStride, ty, tx);
    row_dots<D, kTpt>(dp, vs, gt, S::kStride, ty, tx);

#pragma unroll
    for (int u = 0; u < kTpt; ++u) {
      const int r = i0 + tx + kG * u;  // this thread's query row
      const bool row_valid = r < lq;
      const RowGeometry rg = geo.row(r);
      float m = 0.0f, logl = 0.0f, delta = 0.0f;
      if (row_valid) {
        m = a.lse[(stat0 + r) * 2];
        logl = a.lse[(stat0 + r) * 2 + 1];
        delta = a.delta[stat0 + r];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = key0 + team_row(ty, i);
        float pd = 0.0f, ds = 0.0f;
        if (row_valid && key_valid[i]) {
          const bool region = rg.in_scope && answer[i];
          const float sc = score(s[i][u], __fmul_rn(s[i][u], a.scale), a.scale,
                                 a.has_geometry, region, rg.w, bias[i]);
          const float p = expf((sc - m) - logl);
          float dpv = dp[i][u];
          pd = p;
          if (a.dropout) {
            const bool keep =
                dropout_keep(uint32_t(r) * uint32_t(lk) + uint32_t(j), seed_mix, a.threshold);
            pd = keep ? __fmul_rn(p, a.keep) : 0.0f;
            dpv = keep ? __fmul_rn(dpv, a.keep) : 0.0f;
          }
          ds = p * (dpv - delta);
          if (region) ds = ds * rg.w;
        }
        pts[team_row(ty, i) * S::kPStride + tx + kG * u] = pd;
        dsts[team_row(ty, i) * S::kPStride + tx + kG * u] = ds * a.scale;
      }
    }
    __syncwarp();  // a key's P~ and dS_raw are read by the half-warp that wrote them
    p_times<kSide, kCols>(dv, pts, S::kPStride, gt + col0, S::kStride, ty, tx);
    p_times<kSide, kCols>(dk, dsts, S::kPStride, qt + col0, S::kStride, ty, tx);
    __syncthreads();  // the tile buffers, pts and dsts are free
  }

  const bool o_aligned = head_aligned(a.dk + h * d, hd, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int jl = team_row(ty, i);
    if (jl < n_keys) {
      store_row<kCols>(a.dk + tile_off + size_t(jl) * hd + col0, dk[i], tx, d - col0, o_aligned);
      store_row<kCols>(a.dv + tile_off + size_t(jl) * hd + col0, dv[i], tx, d - col0, o_aligned);
    }
  }
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the larger of the two passes' blocks at this
// head width, whatever the lengths (the wrapper holds it against the
// device's opt-in limit before launching); 0 for a width the library does
// not take.
size_t mkg_fused_attention_bwd_smem(int head_dim) {
  return with_width(head_dim, size_t(0), [&](auto width) {
    using S = Bwd<decltype(width)::value>;
    return S::kDqBytes > S::kDkvBytes ? S::kDqBytes : S::kDkvBytes;
  });
}

// Launches both passes on `stream` without synchronising (the dq pass
// first: it writes delta, which the dK/dV pass reads); returns
// cudaGetLastError(). fp32 throughout: out is the forward's output, lse its
// (B, heads, Lq, 2) row statistics, delta (B, heads, Lq) scratch, dw_part
// (B, heads, ceil(Lq / 64), 2) the partials of (dw0, dw1). head_dim is 64
// or 128 (or, in a library of one padded width, any width that rounds up
// to it); inv_keep is 1 / (1 - rate).
int mkg_fused_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                            const void* mask, const void* boundary, const void* w,
                            const void* out, const void* lse, void* dq, void* dk, void* dv,
                            void* delta, void* dw_part, int batch, int lq, int lk,
                            int num_heads, int head_dim, float scale, int has_geometry,
                            int row_start, int text_len, int offset, int dropout,
                            unsigned int threshold, float inv_keep, unsigned int seed,
                            unsigned int cell_stride, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.g = static_cast<const float*>(g);
  a.mask = static_cast<const float*>(mask);
  a.boundary = static_cast<const int*>(boundary);
  a.w = static_cast<const float*>(w);
  a.out = static_cast<const float*>(out);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.delta = static_cast<float*>(delta);
  a.dw_part = static_cast<float*>(dw_part);
  a.lq = lq;
  a.lk = lk;
  a.num_heads = num_heads;
  a.head_dim = head_dim;
  a.scale = scale;
  a.has_geometry = has_geometry;
  a.row_start = row_start;
  a.text_len = text_len;
  a.offset = offset;
  a.dropout = dropout;
  a.threshold = threshold;
  a.keep = inv_keep;
  a.seed = seed;
  a.cell_stride = cell_stride;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    constexpr int D = decltype(width)::value;
    const dim3 grid_dq(((lq + kRows - 1) / kRows) * groups_of<D>(), num_heads, batch);
    const dim3 grid_dkv(((lk + kRows - 1) / kRows) * groups_of<D>(), num_heads, batch);
    int err = launch_kernel(dq_kernel<D>, grid_dq, Bwd<D>::kDqBytes, a, s);
    if (err != 0) return err;
    return launch_kernel(dkv_kernel<D>, grid_dkv, Bwd<D>::kDkvBytes, a, s);
  });
}

}  // extern "C"
