// Fused multi-head attention backward for the MarT towers, sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/attention.py:_bwd_kernel
// (launched by _fused_attention_bwd, the pl.pallas_call at :350, under the
// jax.custom_vjp at :286-383). Given q, k, v, the output cotangent g and the
// forward's mask, boundary, (w0, w1) and seed, it recomputes the scores and
// probabilities, regenerates the dropout mask, and writes
//
//   dv = P_cast^T g          P_cast = dropout(P) rounded to the compute dtype
//   dP = (g V^T) * keep / (1 - rate)
//   dS = P * (dP - rowsum(dP * P))
//   dq = dS_raw K,  dk = dS_raw^T q,   dS_raw = (dS * mult * scale) rounded
//   dw0 / dw1 = sum(dS * S_raw) over the two analogy regions
//
// with the cast points of _bwd_kernel (:199, :208-217), on the packed
// (B, L, heads * D) layout in and out, D = 64 or 128 (ViLBERT's visual
// stream), each width its own instantiation, or any other width up to 256
// through the instance of its padded width, in a library of its own
// (attention_width.cuh, as fused_attention_fwd.cu). Scores, softmax and every sum are in
// fp32; q, k, v, g and the results are bf16 or fp32. The dropout mask is
// the counter hash of fused_attention_fwd.cu (the JAX interpret-mode
// _dropout_keep with the per-(b, head) seed of _cell_seed, seed + b *
// cell_stride + head: b * heads + head on one device), so it is the
// forward's mask bit for bit. The plain PyTorch version is
// kernels/attention.py:fused_attention_bwd_reference.
//
// What bounds it: bytes, by the same count as the forward. At the main-path
// shapes (L <= 227, head_dim 64) a (b, head) does ~10 * Lq * Lk * 64 flops on
// ~7 * L * 64 * 2 bytes, far below the H100's ~295 flop/byte balance point.
// The design reads q, k, v and g and writes dq, dk and dv without ever
// storing a score, probability or mask in device memory. A Pallas grid
// carries dk/dv sums from one query block to the next; Hopper blocks run in
// no order and carry nothing, so the work is split in two passes, as the
// flash backward splits it (flash_attention.py:183/:271):
//   1. dq pass — one block per (query tile of 64 rows, head, batch row),
//      the forward's layout: the block stages its head's K and V slices in
//      shared memory; each warp takes one query row at a time (lane j takes
//      keys j, j+32, ...), recomputes the score row, its max m and sum l,
//      dP and delta = rowsum(dP * P), dS, the dw partials and dS_raw, then
//      lane l accumulates dq columns 2l and 2l+1 over all keys. It writes
//      (m, l, delta) per row, 12 bytes, and one (dw0, dw1) partial per
//      block, which the wrapper sums: no float atomics, so fp32 results
//      repeat from run to run.
//   2. dk/dv pass — one block per (key tile of 64 keys, head, batch row):
//      the block stages its head's Q and g slices and the rows' (m, l,
//      delta); each warp takes one key at a time (lane i takes query rows
//      i, i+32, ...), recomputes P and dS for that column from (m, l,
//      delta), and lane l accumulates dk and dv columns 2l and 2l+1 over
//      all query rows.
// Both passes compute a score with the same operations in the same order
// (explicit __fmul_rn, then one fmaf, so the compiler contracts nothing
// differently), so pass 2's probabilities are pass 1's bit for bit. The
// products run on the CUDA cores (no mma.sync, wgmma or TMA yet): a simple
// kernel that is right first.
//
// Shared memory: pass 1 holds K and V for Lk keys plus three fp32 rows per
// warp (146 KB at Lk = 227 in fp32, under the H100's 227 KB); pass 2 holds Q
// and g for Lq rows plus two fp32 rows per warp (80 KB at Lq = 128 in fp32).
// At D = 128 the rows double (201 keys and 205 query rows fit in fp32), and
// a lane accumulates four result columns, 2l, 2l + 1 of each 64-column
// half.
//
// Each pass whose rows do not fit a block, and both passes above D = 128
// (where a row of D floats would pass a thread's 255 registers), take a
// streaming form beside it, whose shared memory depends on neither length:
// the JAX kernel stages a head's whole K/V of any length (attention.py:
// _specs), so the port takes every Lq and Lk too. Blocks of 16 warps take
// the same 64 query rows (dq) or keys (dk/dv), 4 a warp, and stage those
// rows once; the other side comes in chunks of 32, one a lane, staged by
// the whole block:
//   1. dq pass: four sweeps over the keys, each recomputing the scores with
//      the same instructions: the row max; the sum of exp(s - max); P, dP
//      and delta = rowsum(dP * P); then dS, the dw partials and dS_raw, and
//      dq over the chunk;
//   2. dk/dv pass: one sweep over the query rows with their (m, l, delta).
// A lane takes keys (query rows) lane, lane + 32, ... in order and each
// result runs over the other side in order, as in the resident forms, so
// the two give the same dq, dk, dv and row statistics bit for bit; only the
// dw partials are summed in another order. Either form fits any length in
// 227 KB (203 KB and 211 KB a block at D = 256 in fp32).
// mkg_fused_attention_bwd_smem reports the larger of the forms the two
// passes take; the wrapper holds it against the device's limit all the
// same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cfloat>

#include "attention_width.cuh"

namespace {

using attention_width::kRagged;
using attention_width::stage_block;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;  // query rows per dq block
constexpr int kKeysPerBlock = 64;  // keys per dk/dv block
constexpr float kNegBias = -10000.0f;  // reference padding bias

__device__ __forceinline__ void load_chunk(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// value after a round trip through T (the casts to the compute dtype)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool dropout_keep(uint32_t idx, uint32_t seed_mix,
                                             uint32_t threshold) {
  uint32_t x = idx ^ seed_mix;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return x >= threshold;
}

// fp32 dot product of a row held in registers with a D-wide row of T
template <int D, typename T>
__device__ __forceinline__ float dot_row(const float* a, const T* b) {
  constexpr int kChunk = 16 / sizeof(T);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < D; c += kChunk) {
    float bf[kChunk];
    load_chunk(b + c, bf);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) acc = fmaf(a[c + i], bf[i], acc);
  }
  return acc;
}

template <int D, typename T>
__device__ __forceinline__ void load_row(const T* p, float* f, int d) {
  constexpr int kChunk = 16 / sizeof(T);
  if constexpr (kRagged) {
    attention_width::load_row<D>(p, f, d);
  } else {
#pragma unroll
    for (int c = 0; c < D; c += kChunk) load_chunk(p + c, f + c);
  }
}

// A result pair at columns col, col + 1 of a row (those below d).
template <typename T>
__device__ __forceinline__ void store_cols(T* row, int col, int d, float a, float b) {
  if constexpr (kRagged) {
    attention_width::store_pair(row, col, d, a, b);
  } else {
    store_pair(row + col, a, b);
  }
}

// The analogy geometry of attention.py:_geometry_planes, per row: whether
// row r is in scope, whether it is an example row (region 0) or not
// (region 1), and its multiplier w0 or w1.
struct RowGeometry {
  bool in_scope;
  bool is_example;
  float w;
};

struct Geometry {
  int has, row_start, text_len, bnd;
  float w0, w1;

  __device__ __forceinline__ RowGeometry row(int r) const {
    RowGeometry g{false, false, 1.0f};
    if (has) {
      const bool is_example = r >= row_start && r < bnd;
      g.in_scope = (is_example || r >= bnd) && r < text_len;
      g.is_example = is_example;
      g.w = is_example ? w0 : w1;
    }
    return g;
  }
  __device__ __forceinline__ bool col_is_answer(int j) const {
    return has && j >= bnd && j < text_len;
  }
};

// The score as the plain version rounds it (kernels/attention.py:_score,
// XLA's contraction inside the JAX kernels): one FMA, fmaf(acc, scale,
// bias) without a geometry, fmaf(s_raw, w or 1, bias) with one, s_raw =
// acc * scale rounded first. At head_dim 64 (scale 2^-3) s_raw is exact and
// the two agree; at 128 (2^-3.5) they do not.
__device__ __forceinline__ float score(float acc, float s_raw, float scale, int has_geometry,
                                       bool region, float w, float bias) {
  return has_geometry ? fmaf(s_raw, region ? w : 1.0f, bias) : fmaf(acc, scale, bias);
}

template <typename T, int D>
struct Layout {
  static constexpr int kChunk = 16 / sizeof(T);              // elements per 16 B
  static constexpr int kStride = D + kChunk;                 // padded smem row
  static size_t round4(int n) { return size_t((n + 3) & ~3); }
  // pass 1: K, V (lk rows), the bias row, three fp32 rows per warp
  static size_t dq_bytes(int lk) {
    return 2 * size_t(lk) * kStride * sizeof(T) + round4(lk) * sizeof(float) * (1 + 3 * kWarps);
  }
  // pass 2: Q, g (lq rows), (m, l, delta) per row, two fp32 rows per warp
  static size_t dkv_bytes(int lq) {
    return 2 * size_t(lq) * kStride * sizeof(T) + round4(lq) * sizeof(float) * (3 + 2 * kWarps);
  }
};

// Stage the (rows x d) slice of head h of batch row b from the packed
// (B, rows, hd) tensor x into padded shared-memory rows of D (zero from d
// on).
template <int D, typename T>
__device__ __forceinline__ void stage(T* dst, const T* x, int b, int rows, int hd, int h,
                                      int d) {
  constexpr int kChunk = Layout<T, D>::kChunk;
  constexpr int kStride = Layout<T, D>::kStride;
  constexpr int kChunksPerRow = D / kChunk;
  const T* src = x + size_t(b) * rows * hd + h * d;
  if constexpr (kRagged) {
    attention_width::stage_rows<D>(dst, kStride, src, rows, hd, d);
    return;
  }
  for (int i = threadIdx.x; i < rows * kChunksPerRow; i += kThreads) {
    const int j = i / kChunksPerRow, c = (i % kChunksPerRow) * kChunk;
    *reinterpret_cast<uint4*>(dst + j * kStride + c) =
        *reinterpret_cast<const uint4*>(src + size_t(j) * hd + c);
  }
}

// Whether a pass takes its resident form: its rows of the other side (Lk
// keys for dq, Lq query rows for dk/dv) fit a block, and a row of D floats
// fits a thread's registers.
template <typename T, int D>
bool dq_resident(int lk) {
  return D <= 128 && Layout<T, D>::dq_bytes(lk) <= size_t(attention_width::smem_optin());
}
template <typename T, int D>
bool dkv_resident(int lq) {
  return D <= 128 && Layout<T, D>::dkv_bytes(lq) <= size_t(attention_width::smem_optin());
}

// The streaming forms: 16 warps of 4 rows (query rows or keys), the other
// side in chunks of 32.
constexpr int kStreamWarps = 16;
constexpr int kStreamThreads = kStreamWarps * 32;
constexpr int kStreamRows = kRowsPerBlock / kStreamWarps;
constexpr int kSideChunk = 32;
static_assert(kKeysPerBlock == kRowsPerBlock, "both streaming passes take 64 rows a block");

template <typename T, int D>
struct StreamLayout {
  static constexpr int kStride = Layout<T, D>::kStride;
  // dq: Q and g of the block's rows, K and V of a key chunk, its biases,
  // a row of dS_raw for each (warp, query row)
  static constexpr size_t dq_bytes =
      size_t(2 * kRowsPerBlock + 2 * kSideChunk) * kStride * sizeof(T) +
      size_t(kSideChunk) * sizeof(float) * (1 + kStreamWarps * kStreamRows);
  // dk/dv: K and V of the block's keys, Q and g of a row chunk, its (m, l,
  // delta), rows of dS_raw and P_cast for each (warp, key)
  static constexpr size_t dkv_bytes =
      size_t(2 * kKeysPerBlock + 2 * kSideChunk) * kStride * sizeof(T) +
      size_t(kSideChunk) * sizeof(float) * (3 + 2 * kStreamWarps * kStreamRows);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ mask, const int* __restrict__ boundary,
                        const float* __restrict__ w, T* __restrict__ dq,
                        float* __restrict__ stats, float* __restrict__ dw_part,
                        int lq, int lk, int num_heads, float scale, int has_geometry,
                        int row_start, int text_len, int offset, int dropout,
                        uint32_t threshold, float inv_keep, uint32_t seed,
                        uint32_t cell_stride, int head_dim) {
  constexpr int kStride = Layout<T, D>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float dw_s[kWarps][2];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + size_t(lk) * kStride;
  float* bias_s = reinterpret_cast<float*>(vs + size_t(lk) * kStride);
  const int lk4 = (lk + 3) & ~3;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int d = kRagged ? head_dim : D;
  const int hd = num_heads * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sraw_row = bias_s + lk4 * (1 + 3 * warp);  // s_raw
  float* p_row = sraw_row + lk4;                    // s, then exp, then p
  float* d_row = p_row + lk4;                       // dP, then dS_raw

  stage<D>(ks, k, b, lk, hd, h, d);
  stage<D>(vs, v, b, lk, hd, h, d);
  for (int j = threadIdx.x; j < lk; j += kThreads) {
    bias_s[j] = (1.0f - mask[size_t(b) * lk + j]) * kNegBias;
  }
  __syncthreads();

  const Geometry geo{has_geometry, row_start, text_len,
                     has_geometry ? boundary[b] + offset : 0,
                     has_geometry ? w[0] : 1.0f, has_geometry ? w[1] : 1.0f};
  const uint32_t seed_mix =
      (seed + uint32_t(b) * cell_stride + uint32_t(h)) * 0x9E3779B9u;
  const int r_end = min(lq, (tile + 1) * kRowsPerBlock);
  float dw0 = 0.0f, dw1 = 0.0f;  // this lane's partials

  for (int r = tile * kRowsPerBlock + warp; r < r_end; r += kWarps) {
    const size_t row_off = (size_t(b) * lq + r) * hd + h * d;
    const RowGeometry rg = geo.row(r);

    // Scores and their max, the query row in registers.
    float mx = -FLT_MAX;
    {
      float qf[D];
      load_row<D>(q + row_off, qf, d);
      for (int j = lane; j < lk; j += 32) {
        const float acc = dot_row<D>(qf, ks + j * kStride);
        const float s_raw = __fmul_rn(acc, scale);
        const float s = score(acc, s_raw, scale, has_geometry,
                              rg.in_scope && geo.col_is_answer(j), rg.w, bias_s[j]);
        sraw_row[j] = s_raw;
        p_row[j] = s;
        mx = fmaxf(mx, s);
      }
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < lk; j += 32) {
      const float e = expf(p_row[j] - mx);
      p_row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);

    // P, dP (masked and scaled by the forward's keep mask) and
    // delta = rowsum(dP * P), the cotangent row in registers.
    float delta = 0.0f;
    {
      float gf[D];
      load_row<D>(g + row_off, gf, d);
      for (int j = lane; j < lk; j += 32) {
        const float p = p_row[j] / sum;
        float dp = dot_row<D>(gf, vs + j * kStride);
        if (dropout) {
          dp = dropout_keep(uint32_t(r) * uint32_t(lk) + uint32_t(j), seed_mix, threshold)
                   ? __fmul_rn(dp, inv_keep)
                   : 0.0f;
        }
        p_row[j] = p;
        d_row[j] = dp;
        delta = fmaf(dp, p, delta);
      }
    }
    delta = warp_sum(delta);

    // dS, the dw partials and dS_raw = round(dS * mult * scale).
    for (int j = lane; j < lk; j += 32) {
      float ds = p_row[j] * (d_row[j] - delta);
      if (rg.in_scope && geo.col_is_answer(j)) {
        if (rg.is_example) {
          dw0 = fmaf(ds, sraw_row[j], dw0);
        } else {
          dw1 = fmaf(ds, sraw_row[j], dw1);
        }
        ds = ds * rg.w;
      }
      d_row[j] = round_to(ds * scale, q);
    }
    __syncwarp();

    // dq row: lane l owns columns 2l and 2l+1 of each 64-column half.
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += 64) {
      const int col = c0 + 2 * lane;
      if (kRagged && col >= d) continue;  // beyond the head's columns
      float a0 = 0.0f, a1 = 0.0f;
      const T* kcol = ks + col;
#pragma unroll 4
      for (int j = 0; j < lk; ++j) {
        const float dsr = d_row[j];
        const float2 kk = load_pair(kcol + j * kStride);
        a0 = fmaf(dsr, kk.x, a0);
        a1 = fmaf(dsr, kk.y, a1);
      }
      store_cols(dq + row_off, col, d, a0, a1);
    }
    if (lane == 0) {
      float* st = stats + ((size_t(b) * num_heads + h) * lq + r) * 3;
      st[0] = mx;
      st[1] = sum;
      st[2] = delta;
    }
    __syncwarp();  // the rows are rewritten by this warp's next query row
  }

  dw0 = warp_sum(dw0);
  dw1 = warp_sum(dw1);
  if (lane == 0) {
    dw_s[warp][0] = dw0;
    dw_s[warp][1] = dw1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t0 = 0.0f, t1 = 0.0f;
    for (int i = 0; i < kWarps; ++i) {
      t0 += dw_s[i][0];
      t1 += dw_s[i][1];
    }
    float* out = dw_part + ((size_t(b) * num_heads + h) * gridDim.x + tile) * 2;
    out[0] = t0;
    out[1] = t1;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ mask, const int* __restrict__ boundary,
                         const float* __restrict__ w, const float* __restrict__ stats,
                         T* __restrict__ dk, T* __restrict__ dv, int lq, int lk,
                         int num_heads, float scale, int has_geometry, int row_start,
                         int text_len, int offset, int dropout, uint32_t threshold,
                         float inv_keep, uint32_t seed, uint32_t cell_stride, int head_dim) {
  constexpr int kStride = Layout<T, D>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* gs = qs + size_t(lq) * kStride;
  float* m_s = reinterpret_cast<float*>(gs + size_t(lq) * kStride);
  const int lq4 = (lq + 3) & ~3;
  float* l_s = m_s + lq4;
  float* delta_s = l_s + lq4;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int d = kRagged ? head_dim : D;
  const int hd = num_heads * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pc_row = delta_s + lq4 * (1 + 2 * warp);  // P, then P_cast
  float* ds_row = pc_row + lq4;                    // dS_raw

  stage<D>(qs, q, b, lq, hd, h, d);
  stage<D>(gs, g, b, lq, hd, h, d);
  const float* st = stats + (size_t(b) * num_heads + h) * lq * 3;
  for (int i = threadIdx.x; i < lq; i += kThreads) {
    m_s[i] = st[3 * i];
    l_s[i] = st[3 * i + 1];
    delta_s[i] = st[3 * i + 2];
  }
  __syncthreads();

  const Geometry geo{has_geometry, row_start, text_len,
                     has_geometry ? boundary[b] + offset : 0,
                     has_geometry ? w[0] : 1.0f, has_geometry ? w[1] : 1.0f};
  const uint32_t seed_mix =
      (seed + uint32_t(b) * cell_stride + uint32_t(h)) * 0x9E3779B9u;
  const int j_end = min(lk, (tile + 1) * kKeysPerBlock);

  for (int j = tile * kKeysPerBlock + warp; j < j_end; j += kWarps) {
    const size_t col_off = (size_t(b) * lk + j) * hd + h * d;
    const float bias = (1.0f - mask[size_t(b) * lk + j]) * kNegBias;
    const bool col_answer = geo.col_is_answer(j);

    // P for this key column, the key row in registers; P_cast for dv.
    {
      float kf[D];
      load_row<D>(k + col_off, kf, d);
      for (int i = lane; i < lq; i += 32) {
        const RowGeometry rg = geo.row(i);
        const float acc = dot_row<D>(kf, qs + i * kStride);
        const float s = score(acc, __fmul_rn(acc, scale), scale, has_geometry,
                              rg.in_scope && col_answer, rg.w, bias);
        const float p = expf(s - m_s[i]) / l_s[i];
        float p_drop = p;
        if (dropout) {
          p_drop = dropout_keep(uint32_t(i) * uint32_t(lk) + uint32_t(j), seed_mix, threshold)
                       ? __fmul_rn(p, inv_keep)
                       : 0.0f;
        }
        pc_row[i] = p_drop;
        ds_row[i] = p;
      }
    }
    // dP and dS_raw for this column, the value row in registers.
    {
      float vf[D];
      load_row<D>(v + col_off, vf, d);
      for (int i = lane; i < lq; i += 32) {
        const RowGeometry rg = geo.row(i);
        float dp = dot_row<D>(vf, gs + i * kStride);
        if (dropout) {
          dp = dropout_keep(uint32_t(i) * uint32_t(lk) + uint32_t(j), seed_mix, threshold)
                   ? __fmul_rn(dp, inv_keep)
                   : 0.0f;
        }
        float ds = ds_row[i] * (dp - delta_s[i]);
        if (rg.in_scope && col_answer) ds = ds * rg.w;
        ds_row[i] = round_to(ds * scale, q);
        pc_row[i] = round_to(pc_row[i], q);
      }
    }
    __syncwarp();

    // dk and dv rows: lane l owns columns 2l and 2l+1 of each 64-column half.
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += 64) {
      const int col = c0 + 2 * lane;
      if (kRagged && col >= d) continue;  // beyond the head's columns
      float k0 = 0.0f, k1 = 0.0f, v0 = 0.0f, v1 = 0.0f;
      const T* qcol = qs + col;
      const T* gcol = gs + col;
#pragma unroll 4
      for (int i = 0; i < lq; ++i) {
        const float dsr = ds_row[i], pc = pc_row[i];
        const float2 qq = load_pair(qcol + i * kStride);
        const float2 gg = load_pair(gcol + i * kStride);
        k0 = fmaf(dsr, qq.x, k0);
        k1 = fmaf(dsr, qq.y, k1);
        v0 = fmaf(pc, gg.x, v0);
        v1 = fmaf(pc, gg.y, v1);
      }
      store_cols(dk + col_off, col, d, k0, k1);
      store_cols(dv + col_off, col, d, v0, v1);
    }
    __syncwarp();  // the rows are rewritten by this warp's next key
  }
}

// dq pass at any Lk and any D up to 256: four sweeps over the keys in
// chunks of 32.
template <typename T, int D>
__global__ void __launch_bounds__(kStreamThreads)
attention_bwd_dq_streaming_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const T* __restrict__ g,
                                  const float* __restrict__ mask,
                                  const int* __restrict__ boundary,
                                  const float* __restrict__ w, T* __restrict__ dq,
                                  float* __restrict__ stats, float* __restrict__ dw_part,
                                  int lq, int lk, int num_heads, float scale,
                                  int has_geometry, int row_start, int text_len, int offset,
                                  int dropout, uint32_t threshold, float inv_keep,
                                  uint32_t seed, uint32_t cell_stride, int head_dim) {
  constexpr int kStride = Layout<T, D>::kStride;
  constexpr int kPairs = (D + 63) / 64;  // column pairs 2 lane + 64 c a lane owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float dw_s[kStreamWarps][2];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* gs = qs + kRowsPerBlock * kStride;
  T* ks = gs + kRowsPerBlock * kStride;
  T* vs = ks + kSideChunk * kStride;
  float* bias_s = reinterpret_cast<float*>(vs + kSideChunk * kStride);

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int d = kRagged ? head_dim : D;
  const int hd = num_heads * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ds_s = bias_s + kSideChunk * (1 + kStreamRows * warp);  // kStreamRows rows of 32
  const int row0 = tile * kRowsPerBlock;
  const int n_rows = min(kRowsPerBlock, lq - row0);
  const size_t tile_off = (size_t(b) * lq + row0) * hd + h * d;
  stage_block<D, kStride>(qs, q + tile_off, n_rows, hd, d);
  stage_block<D, kStride>(gs, g + tile_off, n_rows, hd, d);
  // (the first chunk's barrier publishes qs and gs)

  const Geometry geo{has_geometry, row_start, text_len,
                     has_geometry ? boundary[b] + offset : 0,
                     has_geometry ? w[0] : 1.0f, has_geometry ? w[1] : 1.0f};
  const uint32_t seed_mix =
      (seed + uint32_t(b) * cell_stride + uint32_t(h)) * 0x9E3779B9u;
  const T* kb = k + size_t(b) * lk * hd + h * d;
  const T* vb = v + size_t(b) * lk * hd + h * d;

  // this warp's rows: local row il = warp + kStreamWarps * t
  float mx[kStreamRows], sum[kStreamRows], delta[kStreamRows];
  float2 acc[kStreamRows][kPairs];
#pragma unroll
  for (int t = 0; t < kStreamRows; ++t) {
    mx[t] = -FLT_MAX;
    sum[t] = 0.0f;
    delta[t] = 0.0f;
#pragma unroll
    for (int c = 0; c < kPairs; ++c) acc[t][c] = make_float2(0.0f, 0.0f);
  }
  float dw0 = 0.0f, dw1 = 0.0f;  // this lane's partials

  // sweep 0: max; 1: sum of exp(s - max); 2: delta; 3: dS_raw and dq
  for (int sweep = 0; sweep < 4; ++sweep) {
    for (int j0 = 0; j0 < lk; j0 += kSideChunk) {
      const int n = min(kSideChunk, lk - j0);
      __syncthreads();  // the chunk buffers are free
      stage_block<D, kStride>(ks, kb + size_t(j0) * hd, n, hd, d);
      if (sweep >= 2) stage_block<D, kStride>(vs, vb + size_t(j0) * hd, n, hd, d);
      if (threadIdx.x < n) {
        bias_s[threadIdx.x] = (1.0f - mask[size_t(b) * lk + j0 + threadIdx.x]) * kNegBias;
      }
      __syncthreads();
      const int j = j0 + lane;  // this lane's key
#pragma unroll
      for (int t = 0; t < kStreamRows; ++t) {
        const int il = warp + kStreamWarps * t;
        if (il >= n_rows) continue;
        const int r = row0 + il;
        const RowGeometry rg = geo.row(r);
        const bool region = rg.in_scope && geo.col_is_answer(j);
        float dsr = 0.0f;
        if (lane < n) {
          const attention_width::HeadRow<D, T, false> qrow(qs + il * kStride);
          const float acc_s = qrow.dot(ks + lane * kStride);
          const float s_raw = __fmul_rn(acc_s, scale);
          const float s = score(acc_s, s_raw, scale, has_geometry, region, rg.w, bias_s[lane]);
          if (sweep == 0) {
            mx[t] = fmaxf(mx[t], s);
          } else if (sweep == 1) {
            sum[t] += expf(s - mx[t]);
          } else {
            const float p = expf(s - mx[t]) / sum[t];
            const attention_width::HeadRow<D, T, false> grow(gs + il * kStride);
            float dp = grow.dot(vs + lane * kStride);
            if (dropout) {
              dp = dropout_keep(uint32_t(r) * uint32_t(lk) + uint32_t(j), seed_mix, threshold)
                       ? __fmul_rn(dp, inv_keep)
                       : 0.0f;
            }
            if (sweep == 2) {
              delta[t] = fmaf(dp, p, delta[t]);
            } else {
              float ds = p * (dp - delta[t]);
              if (region) {
                if (rg.is_example) {
                  dw0 = fmaf(ds, s_raw, dw0);
                } else {
                  dw1 = fmaf(ds, s_raw, dw1);
                }
                ds = ds * rg.w;
              }
              dsr = round_to(ds * scale, q);
            }
          }
        }
        if (sweep == 3) {
          float* drow = ds_s + kSideChunk * t;
          drow[lane] = dsr;
          __syncwarp();
#pragma unroll
          for (int c = 0; c < kPairs; ++c) {
            const int col = 64 * c + 2 * lane;
            if (kRagged && col >= d) continue;  // beyond the head's columns
            float2 x = acc[t][c];
            const T* kcol = ks + col;
#pragma unroll 4
            for (int jj = 0; jj < n; ++jj) {
              const float dj = drow[jj];
              const float2 kk = load_pair(kcol + jj * kStride);
              x.x = fmaf(dj, kk.x, x.x);
              x.y = fmaf(dj, kk.y, x.y);
            }
            acc[t][c] = x;
          }
          __syncwarp();  // drow is rewritten for the next chunk
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kStreamRows; ++t) {
      if (sweep == 0) mx[t] = warp_max(mx[t]);
      if (sweep == 1) sum[t] = warp_sum(sum[t]);
      if (sweep == 2) delta[t] = warp_sum(delta[t]);
    }
  }

#pragma unroll
  for (int t = 0; t < kStreamRows; ++t) {
    const int il = warp + kStreamWarps * t;
    if (il >= n_rows) continue;
    const int r = row0 + il;
    const size_t row_off = (size_t(b) * lq + r) * hd + h * d;
#pragma unroll
    for (int c = 0; c < kPairs; ++c) store_cols(dq + row_off, 64 * c + 2 * lane, d, acc[t][c].x,
                                                acc[t][c].y);
    if (lane == 0) {
      float* st = stats + ((size_t(b) * num_heads + h) * lq + r) * 3;
      st[0] = mx[t];
      st[1] = sum[t];
      st[2] = delta[t];
    }
  }
  dw0 = warp_sum(dw0);
  dw1 = warp_sum(dw1);
  if (lane == 0) {
    dw_s[warp][0] = dw0;
    dw_s[warp][1] = dw1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t0 = 0.0f, t1 = 0.0f;
    for (int i = 0; i < kStreamWarps; ++i) {
      t0 += dw_s[i][0];
      t1 += dw_s[i][1];
    }
    float* out = dw_part + ((size_t(b) * num_heads + h) * gridDim.x + tile) * 2;
    out[0] = t0;
    out[1] = t1;
  }
}

// dk/dv pass at any Lq and any D up to 256: one sweep over the query rows
// in chunks of 32.
template <typename T, int D>
__global__ void __launch_bounds__(kStreamThreads)
attention_bwd_dkv_streaming_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const T* __restrict__ g,
                                   const float* __restrict__ mask,
                                   const int* __restrict__ boundary,
                                   const float* __restrict__ w,
                                   const float* __restrict__ stats, T* __restrict__ dk,
                                   T* __restrict__ dv, int lq, int lk, int num_heads,
                                   float scale, int has_geometry, int row_start,
                                   int text_len, int offset, int dropout, uint32_t threshold,
                                   float inv_keep, uint32_t seed, uint32_t cell_stride,
                                   int head_dim) {
  constexpr int kStride = Layout<T, D>::kStride;
  constexpr int kPairs = (D + 63) / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kKeysPerBlock * kStride;
  T* qs = vs + kKeysPerBlock * kStride;
  T* gs = qs + kSideChunk * kStride;
  float* m_s = reinterpret_cast<float*>(gs + kSideChunk * kStride);
  float* l_s = m_s + kSideChunk;
  float* delta_s = l_s + kSideChunk;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int d = kRagged ? head_dim : D;
  const int hd = num_heads * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ds_s = delta_s + kSideChunk * (1 + 2 * kStreamRows * warp);  // dS_raw rows
  float* pc_s = ds_s + kSideChunk * kStreamRows;                         // P_cast rows
  const int key0 = tile * kKeysPerBlock;
  const int n_keys = min(kKeysPerBlock, lk - key0);
  const size_t tile_off = (size_t(b) * lk + key0) * hd + h * d;
  stage_block<D, kStride>(ks, k + tile_off, n_keys, hd, d);
  stage_block<D, kStride>(vs, v + tile_off, n_keys, hd, d);

  const Geometry geo{has_geometry, row_start, text_len,
                     has_geometry ? boundary[b] + offset : 0,
                     has_geometry ? w[0] : 1.0f, has_geometry ? w[1] : 1.0f};
  const uint32_t seed_mix =
      (seed + uint32_t(b) * cell_stride + uint32_t(h)) * 0x9E3779B9u;
  const T* qb = q + size_t(b) * lq * hd + h * d;
  const T* gb = g + size_t(b) * lq * hd + h * d;
  const float* st = stats + (size_t(b) * num_heads + h) * lq * 3;

  // this warp's keys: local key jl = warp + kStreamWarps * t
  float2 kacc[kStreamRows][kPairs], vacc[kStreamRows][kPairs];
#pragma unroll
  for (int t = 0; t < kStreamRows; ++t) {
#pragma unroll
    for (int c = 0; c < kPairs; ++c) kacc[t][c] = vacc[t][c] = make_float2(0.0f, 0.0f);
  }

  for (int i0 = 0; i0 < lq; i0 += kSideChunk) {
    const int n = min(kSideChunk, lq - i0);
    __syncthreads();  // the chunk buffers are free (and ks / vs published)
    stage_block<D, kStride>(qs, qb + size_t(i0) * hd, n, hd, d);
    stage_block<D, kStride>(gs, gb + size_t(i0) * hd, n, hd, d);
    if (threadIdx.x < n) {
      m_s[threadIdx.x] = st[3 * (i0 + threadIdx.x)];
      l_s[threadIdx.x] = st[3 * (i0 + threadIdx.x) + 1];
      delta_s[threadIdx.x] = st[3 * (i0 + threadIdx.x) + 2];
    }
    __syncthreads();
    const int i = i0 + lane;  // this lane's query row
    const RowGeometry rg = geo.row(i);
#pragma unroll
    for (int t = 0; t < kStreamRows; ++t) {
      const int jl = warp + kStreamWarps * t;
      if (jl >= n_keys) continue;
      const int j = key0 + jl;
      float dsr = 0.0f, pc = 0.0f;
      if (lane < n) {
        const float bias = (1.0f - mask[size_t(b) * lk + j]) * kNegBias;
        const bool region = rg.in_scope && geo.col_is_answer(j);
        const attention_width::HeadRow<D, T, false> krow(ks + jl * kStride);
        const float acc_s = krow.dot(qs + lane * kStride);
        const float s = score(acc_s, __fmul_rn(acc_s, scale), scale, has_geometry, region, rg.w,
                              bias);
        const float p = expf(s - m_s[lane]) / l_s[lane];
        float p_drop = p;
        const bool keep =
            !dropout ||
            dropout_keep(uint32_t(i) * uint32_t(lk) + uint32_t(j), seed_mix, threshold);
        if (dropout) p_drop = keep ? __fmul_rn(p, inv_keep) : 0.0f;
        const attention_width::HeadRow<D, T, false> vrow(vs + jl * kStride);
        float dp = vrow.dot(gs + lane * kStride);
        if (dropout) dp = keep ? __fmul_rn(dp, inv_keep) : 0.0f;
        float ds = p * (dp - delta_s[lane]);
        if (region) ds = ds * rg.w;
        dsr = round_to(ds * scale, q);
        pc = round_to(p_drop, q);
      }
      float* drow = ds_s + kSideChunk * t;
      float* prow = pc_s + kSideChunk * t;
      drow[lane] = dsr;
      prow[lane] = pc;
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kPairs; ++c) {
        const int col = 64 * c + 2 * lane;
        if (kRagged && col >= d) continue;  // beyond the head's columns
        float2 x = kacc[t][c], y = vacc[t][c];
        const T* qcol = qs + col;
        const T* gcol = gs + col;
#pragma unroll 4
        for (int ii = 0; ii < n; ++ii) {
          const float di = drow[ii], pi = prow[ii];
          const float2 qq = load_pair(qcol + ii * kStride);
          const float2 gg = load_pair(gcol + ii * kStride);
          x.x = fmaf(di, qq.x, x.x);
          x.y = fmaf(di, qq.y, x.y);
          y.x = fmaf(pi, gg.x, y.x);
          y.y = fmaf(pi, gg.y, y.y);
        }
        kacc[t][c] = x;
        vacc[t][c] = y;
      }
      __syncwarp();  // the rows are rewritten for the next key
    }
  }

#pragma unroll
  for (int t = 0; t < kStreamRows; ++t) {
    const int jl = warp + kStreamWarps * t;
    if (jl >= n_keys) continue;
    const size_t col_off = tile_off + size_t(jl) * hd;
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      store_cols(dk + col_off, 64 * c + 2 * lane, d, kacc[t][c].x, kacc[t][c].y);
      store_cols(dv + col_off, 64 * c + 2 * lane, d, vacc[t][c].x, vacc[t][c].y);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* g, const void* mask,
           const void* boundary, const void* w, void* dq, void* dk, void* dv,
           void* stats, void* dw_part, int batch, int lq, int lk, int num_heads,
           float scale, int has_geometry, int row_start, int text_len, int offset,
           int dropout, uint32_t threshold, float inv_keep, uint32_t seed,
           uint32_t cell_stride, int head_dim, cudaStream_t stream) {
  const bool dq_whole = dq_resident<T, D>(lk), dkv_whole = dkv_resident<T, D>(lq);
  const size_t smem_dq = dq_whole ? Layout<T, D>::dq_bytes(lk) : StreamLayout<T, D>::dq_bytes;
  const size_t smem_dkv =
      dkv_whole ? Layout<T, D>::dkv_bytes(lq) : StreamLayout<T, D>::dkv_bytes;
  auto dq_kernel = attention_bwd_dq_streaming_kernel<T, D>;
  auto dkv_kernel = attention_bwd_dkv_streaming_kernel<T, D>;
  if constexpr (D <= 128) {
    if (dq_whole) dq_kernel = attention_bwd_dq_kernel<T, D>;
    if (dkv_whole) dkv_kernel = attention_bwd_dkv_kernel<T, D>;
  }
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem_dq));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_dkv));
  if (err != cudaSuccess) return int(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const float* maskf = static_cast<const float*>(mask);
  const int* bnd = static_cast<const int*>(boundary);
  const float* wf = static_cast<const float*>(w);
  const dim3 grid_dq((lq + kRowsPerBlock - 1) / kRowsPerBlock, num_heads, batch);
  dq_kernel<<<grid_dq, dq_whole ? kThreads : kStreamThreads, smem_dq, stream>>>(
      qt, kt, vt, gt, maskf, bnd, wf, static_cast<T*>(dq), static_cast<float*>(stats),
      static_cast<float*>(dw_part), lq, lk, num_heads, scale, has_geometry, row_start,
      text_len, offset, dropout, threshold, inv_keep, seed,
      cell_stride, head_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 grid_dkv((lk + kKeysPerBlock - 1) / kKeysPerBlock, num_heads, batch);
  dkv_kernel<<<grid_dkv, dkv_whole ? kThreads : kStreamThreads, smem_dkv, stream>>>(
      qt, kt, vt, gt, maskf, bnd, wf, static_cast<const float*>(stats),
      static_cast<T*>(dk), static_cast<T*>(dv), lq, lk, num_heads, scale, has_geometry,
      row_start, text_len, offset, dropout, threshold, inv_keep, seed,
      cell_stride, head_dim);
  return int(cudaGetLastError());
}

template <typename T, int D>
size_t smem_bytes(int lq, int lk) {
  const size_t a = dq_resident<T, D>(lk) ? Layout<T, D>::dq_bytes(lk)
                                         : StreamLayout<T, D>::dq_bytes;
  const size_t b = dkv_resident<T, D>(lq) ? Layout<T, D>::dkv_bytes(lq)
                                          : StreamLayout<T, D>::dkv_bytes;
  return a > b ? a : b;
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the larger of the two passes' blocks, in the
// forms a call of Lq query rows and Lk keys takes (the wrapper holds it
// against the device's opt-in limit before launching); 0 for a head width
// the library does not take.
size_t mkg_fused_attention_bwd_smem(int lq, int lk, int is_bf16, int head_dim) {
  return attention_width::with_width(head_dim, size_t(0), [&](auto width) {
    constexpr int D = decltype(width)::value;
    return attention_width::with_type(
        is_bf16, size_t(0), [&](auto t) { return smem_bytes<decltype(t), D>(lq, lk); });
  });
}

// Launches both passes on `stream` without synchronising; returns
// cudaGetLastError(). head_dim is 64 or 128 (or, in a library of one padded
// width, any width that rounds up to it); stats is (B, heads, Lq, 3)
// fp32 scratch, dw_part (B, heads, ceil(Lq / 64), 2) fp32 partials of (dw0,
// dw1).
int mkg_fused_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                            const void* mask, const void* boundary, const void* w,
                            void* dq, void* dk, void* dv, void* stats, void* dw_part,
                            int batch, int lq, int lk, int num_heads, int head_dim,
                            int is_bf16, float scale, int has_geometry, int row_start,
                            int text_len, int offset, int dropout, unsigned int threshold,
                            float inv_keep, unsigned int seed, unsigned int cell_stride,
                            void* stream) {
  return attention_width::with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    constexpr int D = decltype(width)::value;
    return attention_width::with_type(is_bf16, int(cudaErrorInvalidValue), [&](auto t) {
      return launch<decltype(t), D>(q, k, v, g, mask, boundary, w, dq, dk, dv, stats, dw_part,
                                    batch, lq, lk, num_heads, scale, has_geometry, row_start,
                                    text_len, offset, dropout, threshold, inv_keep, seed,
                                    cell_stride, head_dim, static_cast<cudaStream_t>(stream));
    });
  });
}

}  // extern "C"
