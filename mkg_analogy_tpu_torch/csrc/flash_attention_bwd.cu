// K-blocked (flash) fused attention backward for the MarT towers, sm_90a:
// two kernels, two launches.
//
// Replaces the TPU kernels mkg_analogy_tpu/kernels/flash_attention.py:
// _flash_bwd_kv_kernel (the pl.pallas_call at :453) and _flash_bwd_q_kernel
// (:491), under the jax.custom_vjp at :361-512. Given q, k, v, the output
// cotangent g, the forward's mask, boundary, (w0, w1) and seed, its per-row
// log-sum-exp lse and delta = rowsum(g * out) (both (B, heads, Lq) fp32), they
// recompute the normalised probabilities p = exp(s - lse) element by element
// and write
//
//   dv = P_drop_cast^T g       P_drop = dropout(P), rounded to the compute dtype
//   dP = (g V^T) * keep / (1 - rate)
//   dS = P * (dP - delta)
//   dq = dS_raw K,  dk = dS_raw^T q,   dS_raw = (dS * mult * scale) rounded
//   dw0 / dw1 = sum(dS * S_raw) over the two analogy regions
//
// with the cast points of the Pallas bodies (:233-254, :320), on the packed
// (B, L, heads * D) layout in and out, D = 64 or 128 (ViLBERT's visual
// stream), each width its own instantiation, or any other width up to 256
// through the instance of its padded width, in a library of its own
// (attention_width.cuh, as flash_attention_fwd.cu). Every sum is fp32; q, k, v, g and the
// results are bf16 or fp32. The dropout masks are the forward's
// (flash_attention_fwd.cu): the interpret-mode hash keyed to the logical
// (bq, bk) tiles, idx = row_in_tile * bk + col_in_tile, tile seed
// seed + (cell * n_qblk + qb) * n_kblk + kb, cell = b * cell_stride +
// head (b * heads + head on one device; a rank of a mesh passes the
// global head count and folds its first cell into the seed). Nothing here
// depends on the online softmax's grouping, so the kernels stage keys and
// rows in chunks of any size and compute each (row, key) on its own. The
// plain version is kernels/flash_attention.py:flash_attention_bwd_reference.
//
// What bounds it: at the main-path shapes (L <= 611) bytes; at L = 2048 the
// products (4 * Lq * Lk * D flops per (b, head) for dK/dV
// with its recomputed scores, 3 for dQ) pass the H100's balance point. A
// Pallas grid carries sums from one step to the next; Hopper blocks carry
// nothing, so the two kernels split the work by what they sum over, as the
// Pallas pair does, and neither uses float atomics:
//   - dK/dV: one block per (32 keys, head, batch row). The block stages its
//     keys' K and V rows once, then walks the query rows in chunks of 128,
//     staging their q, g, lse and delta. Each warp owns 4 keys with their dk
//     and dv columns in registers (lane l owns columns 2l and 2l+1); for each
//     key, lane i computes rows i, i + 32, ...: s_raw, p, P_drop, dP, dS, the
//     dw partials and dS_raw into per-warp shared rows, then every lane
//     accumulates its columns over the chunk (columns 2l and 2l+1 of each
//     64: two at D = 64, four at 128). Rows past Lq are never read
//     (JAX zeroes them to the same effect, :215-220). It writes one
//     (dw0, dw1) partial per (b, head, key block), which the wrapper sums.
//   - dQ: one block per (32 query rows, head, batch row). The block stages
//     its rows' q and g once, then walks the keys in chunks of 128, staging K,
//     V and the padding bias. Each warp owns 4 rows with their dq columns in
//     registers; for each row, lane j computes keys j, j + 32, ...: p, dP,
//     dS_raw, then every lane accumulates its dq columns.
// Both kernels form a score with the forward's operations in the forward's
// order (the fmaf dot product, then score()), so all three see the same
// scores bit for bit. The products run on the CUDA cores (no mma.sync,
// wgmma or TMA yet): a simple kernel that is right first. At D = 128 a
// lane's key or query row takes 128 registers and the staged rows 178 KB
// (dK/dV) and 174 KB (dQ) of shared memory, one block an SM. Above 128
// (192, 256) the row is read from shared memory at every product
// (attention_width.cuh, HeadRow) and chunks are of 64 rows or keys: 201 KB
// (dK/dV) and 199 KB (dQ) at 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_width.cuh"

namespace {

using attention_width::kRagged;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerBlock = 32;          // keys per dK/dV block, rows per dQ block
constexpr int kPerWarp = kPerBlock / kWarps;
// Rows (dK/dV) or keys (dQ) staged at a time: 128, or 64 above D = 128,
// where two chunks of 128 rows of 192 or 256 fp32 columns would pass a
// block's shared memory.
template <int D>
__host__ __device__ constexpr int chunk_of() { return D <= 128 ? 128 : 64; }
constexpr float kNegBias = -10000.0f;  // reference padding bias

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

// The score of the fp32 product sum acc, as the plain version rounds it
// (kernels/attention.py:_score): without a geometry fmaf(acc, scale, bias),
// with one fmaf(s_raw, w in the region or 1, bias), s_raw = acc * scale
// rounded first (flash_attention_fwd.cu says why both forms matter at 128).
__device__ __forceinline__ float score(float acc, float scale, int has_geometry, bool region,
                                       float w, float bias) {
  if (!has_geometry) return fmaf(acc, scale, bias);
  return fmaf(__fmul_rn(acc, scale), region ? w : 1.0f, bias);
}

// The logical tiles of the call, for the dropout masks.
struct Tiles {
  int bq, bk, n_qblk, n_kblk;
  uint32_t seed, cell, threshold;

  // keep bit of (row r, key j) in the forward's mask
  __device__ __forceinline__ bool keep(int r, int j) const {
    const int qb = r / bq, kb = j / bk;
    const uint32_t mix =
        (seed + (cell * uint32_t(n_qblk) + uint32_t(qb)) * uint32_t(n_kblk) + uint32_t(kb)) *
        0x9E3779B9u;
    return dropout_keep(uint32_t(r - qb * bq) * uint32_t(bk) + uint32_t(j - kb * bk), mix,
                        threshold);
  }
};

template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);                // elements per 16 B
  static constexpr int kStride = D + kVec;                   // padded smem row
  // dK/dV: K and V of the block's keys, q and g of a row chunk, its lse
  // and delta, three fp32 rows per warp
  static constexpr size_t dkv_bytes =
      2 * size_t(kPerBlock + chunk_of<D>()) * kStride * sizeof(T) +
      size_t(chunk_of<D>()) * sizeof(float) * (2 + 3 * kWarps);
  // dQ: q and g of the block's rows, K and V of a key chunk, its bias row,
  // two fp32 rows per warp
  static constexpr size_t dq_bytes =
      2 * size_t(kPerBlock + chunk_of<D>()) * kStride * sizeof(T) +
      size_t(chunk_of<D>()) * sizeof(float) * (1 + 2 * kWarps);
};

// Stage `rows` rows of d elements from global memory (row stride hd) into
// padded shared-memory rows of D (zero from d on).
template <int D, typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int rows, int hd, int d) {
  constexpr int kVec = Layout<T, D>::kVec;
  constexpr int kStride = Layout<T, D>::kStride;
  constexpr int kVecsPerRow = D / kVec;
  if constexpr (kRagged) {
    attention_width::stage_rows<D>(dst, kStride, src, rows, hd, d);
    return;
  }
  for (int i = threadIdx.x; i < rows * kVecsPerRow; i += kThreads) {
    const int j = i / kVecsPerRow, c = (i % kVecsPerRow) * kVec;
    *reinterpret_cast<uint4*>(dst + j * kStride + c) =
        *reinterpret_cast<const uint4*>(src + size_t(j) * hd + c);
  }
}

struct Args {
  int lq, lk, num_heads;
  float scale;
  int has_geometry, row_start, text_len, offset, dropout;
  float inv_keep;
  uint32_t cell_stride;  // dropout cell of (b, h): b * cell_stride + h
  Tiles tiles;
  int head_dim;  // the call's (the tile's in a library of 64 and 128)
};

// A result pair at columns col, col + 1 of a row (those below d).
template <typename T>
__device__ __forceinline__ void store_cols(T* row, int col, int d, float x, float y) {
  if constexpr (kRagged) {
    attention_width::store_pair(row, col, d, x, y);
  } else {
    store_pair(row + col, x, y);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ g,
                               const float* __restrict__ mask,
                               const int* __restrict__ boundary,
                               const float* __restrict__ w, const float* __restrict__ lse,
                               const float* __restrict__ delta, T* __restrict__ dk,
                               T* __restrict__ dv, float* __restrict__ dw_part, Args a) {
  constexpr int kStride = Layout<T, D>::kStride;
  constexpr int kChunk = chunk_of<D>();
  // column pairs a lane owns: 2 lane + 64 c, c < kPairs (those below d)
  constexpr int kPairs = (D + 63) / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float dw_s[kWarps][2];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kPerBlock * kStride;
  T* qs = vs + kPerBlock * kStride;
  T* gs = qs + kChunk * kStride;
  float* lse_s = reinterpret_cast<float*>(gs + kChunk * kStride);
  float* delta_s = lse_s + kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sraw_row = delta_s + kChunk + 3 * kChunk * warp;  // s_raw
  float* d_row = sraw_row + kChunk;                        // P, then dS_raw
  float* pc_row = d_row + kChunk;                          // P_drop rounded

  const int h = blockIdx.y, b = blockIdx.z;
  const int lq = a.lq, lk = a.lk;
  const int d = kRagged ? a.head_dim : D;
  const int hd = a.num_heads * d;
  const size_t head_off = size_t(h) * d;
  const int j_begin = blockIdx.x * kPerBlock;
  const int n_keys = min(kPerBlock, lk - j_begin);
  stage<D>(ks, k + (size_t(b) * lk + j_begin) * hd + head_off, n_keys, hd, d);
  stage<D>(vs, v + (size_t(b) * lk + j_begin) * hd + head_off, n_keys, hd, d);

  const Geometry geo{a.has_geometry, a.row_start, a.text_len,
                     a.has_geometry ? boundary[b] + a.offset : 0,
                     a.has_geometry ? w[0] : 1.0f, a.has_geometry ? w[1] : 1.0f};
  Tiles tiles = a.tiles;
  tiles.cell = uint32_t(b) * a.cell_stride + uint32_t(h);
  const float* lse_bh = lse + (size_t(b) * a.num_heads + h) * lq;
  const float* delta_bh = delta + (size_t(b) * a.num_heads + h) * lq;

  float2 kacc[kPerWarp][kPairs], vacc[kPerWarp][kPairs];
#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) {
#pragma unroll
    for (int c = 0; c < kPairs; ++c) kacc[t][c] = vacc[t][c] = make_float2(0.0f, 0.0f);
  }
  float dw0 = 0.0f, dw1 = 0.0f;  // this lane's partials

  for (int r0 = 0; r0 < lq; r0 += kChunk) {
    const int n = min(kChunk, lq - r0);
    __syncthreads();  // the row chunk is free (and ks / vs published)
    stage<D>(qs, q + (size_t(b) * lq + r0) * hd + head_off, n, hd, d);
    stage<D>(gs, g + (size_t(b) * lq + r0) * hd + head_off, n, hd, d);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      lse_s[i] = lse_bh[r0 + i];
      delta_s[i] = delta_bh[r0 + i];
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < kPerWarp; ++t) {
      const int jl = warp + kWarps * t;
      if (jl >= n_keys) continue;
      const int j = j_begin + jl;
      const float bias = (1.0f - mask[size_t(b) * lk + j]) * kNegBias;
      const bool col_answer = geo.col_is_answer(j);
      // s_raw, P and P_drop for this key column, the key row in registers.
      {
        const attention_width::HeadRow<D, T> kf(ks + jl * kStride);
        for (int i = lane; i < n; i += 32) {
          const int r = r0 + i;
          const RowGeometry rg = geo.row(r);
          const float acc = kf.dot(qs + i * kStride);
          const float p = expf(score(acc, a.scale, a.has_geometry, rg.in_scope && col_answer,
                                     rg.w, bias) -
                               lse_s[i]);
          float p_drop = p;
          if (a.dropout) p_drop = tiles.keep(r, j) ? __fmul_rn(p, a.inv_keep) : 0.0f;
          sraw_row[i] = __fmul_rn(acc, a.scale);
          d_row[i] = p;
          pc_row[i] = round_to(p_drop, q);
        }
      }
      // dP, dS, the dw partials and dS_raw, the value row in registers.
      {
        const attention_width::HeadRow<D, T> vf(vs + jl * kStride);
        for (int i = lane; i < n; i += 32) {
          const int r = r0 + i;
          const RowGeometry rg = geo.row(r);
          float dp = vf.dot(gs + i * kStride);
          if (a.dropout) dp = tiles.keep(r, j) ? __fmul_rn(dp, a.inv_keep) : 0.0f;
          float ds = d_row[i] * (dp - delta_s[i]);
          if (rg.in_scope && col_answer) {
            if (rg.is_example) {
              dw0 = fmaf(ds, sraw_row[i], dw0);
            } else {
              dw1 = fmaf(ds, sraw_row[i], dw1);
            }
            ds = ds * rg.w;
          }
          d_row[i] = round_to(ds * a.scale, q);
        }
      }
      __syncwarp();
      // dk and dv rows of this key: lane l owns columns 2l + 64 c and
      // 2l + 1 + 64 c.
      float2 x[kPairs], y[kPairs];
#pragma unroll
      for (int c = 0; c < kPairs; ++c) {
        x[c] = kacc[t][c];
        y[c] = vacc[t][c];
      }
      const T* qcol = qs + 2 * lane;
      const T* gcol = gs + 2 * lane;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float dsr = d_row[i], pc = pc_row[i];
#pragma unroll
        for (int c = 0; c < kPairs; ++c) {
          if (kRagged && 2 * lane + 64 * c >= d) continue;  // beyond the head
          const float2 qq = load_pair(qcol + i * kStride + 64 * c);
          const float2 gg = load_pair(gcol + i * kStride + 64 * c);
          x[c].x = fmaf(dsr, qq.x, x[c].x);
          x[c].y = fmaf(dsr, qq.y, x[c].y);
          y[c].x = fmaf(pc, gg.x, y[c].x);
          y[c].y = fmaf(pc, gg.y, y[c].y);
        }
      }
#pragma unroll
      for (int c = 0; c < kPairs; ++c) {
        kacc[t][c] = x[c];
        vacc[t][c] = y[c];
      }
      __syncwarp();  // the rows are rewritten for this warp's next key
    }
  }

#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) {
    const int jl = warp + kWarps * t;
    if (jl < n_keys) {
      const size_t off = (size_t(b) * lk + j_begin + jl) * hd + head_off;
#pragma unroll
      for (int c = 0; c < kPairs; ++c) {
        store_cols(dk + off, 2 * lane + 64 * c, d, kacc[t][c].x, kacc[t][c].y);
        store_cols(dv + off, 2 * lane + 64 * c, d, vacc[t][c].x, vacc[t][c].y);
      }
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
    for (int i = 0; i < kWarps; ++i) {
      t0 += dw_s[i][0];
      t1 += dw_s[i][1];
    }
    float* out = dw_part + ((size_t(b) * a.num_heads + h) * gridDim.x + blockIdx.x) * 2;
    out[0] = t0;
    out[1] = t1;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              const float* __restrict__ mask,
                              const int* __restrict__ boundary,
                              const float* __restrict__ w, const float* __restrict__ lse,
                              const float* __restrict__ delta, T* __restrict__ dq, Args a) {
  constexpr int kStride = Layout<T, D>::kStride;
  constexpr int kChunk = chunk_of<D>();
  constexpr int kPairs = (D + 63) / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* gs = qs + kPerBlock * kStride;
  T* ks = gs + kPerBlock * kStride;
  T* vs = ks + kChunk * kStride;
  float* bias_s = reinterpret_cast<float*>(vs + kChunk * kStride);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* p_row = bias_s + kChunk + 2 * kChunk * warp;  // P
  float* d_row = p_row + kChunk;                       // dS_raw

  const int h = blockIdx.y, b = blockIdx.z;
  const int lq = a.lq, lk = a.lk;
  const int d = kRagged ? a.head_dim : D;
  const int hd = a.num_heads * d;
  const size_t head_off = size_t(h) * d;
  const int r_begin = blockIdx.x * kPerBlock;
  const int n_rows = min(kPerBlock, lq - r_begin);
  stage<D>(qs, q + (size_t(b) * lq + r_begin) * hd + head_off, n_rows, hd, d);
  stage<D>(gs, g + (size_t(b) * lq + r_begin) * hd + head_off, n_rows, hd, d);

  const Geometry geo{a.has_geometry, a.row_start, a.text_len,
                     a.has_geometry ? boundary[b] + a.offset : 0,
                     a.has_geometry ? w[0] : 1.0f, a.has_geometry ? w[1] : 1.0f};
  Tiles tiles = a.tiles;
  tiles.cell = uint32_t(b) * a.cell_stride + uint32_t(h);
  const size_t stat_off = (size_t(b) * a.num_heads + h) * lq + r_begin;

  float2 dacc[kPerWarp][kPairs];
  float lse_r[kPerWarp], delta_r[kPerWarp];
#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) {
    const int il = warp + kWarps * t;
#pragma unroll
    for (int c = 0; c < kPairs; ++c) dacc[t][c] = make_float2(0.0f, 0.0f);
    lse_r[t] = il < n_rows ? lse[stat_off + il] : 0.0f;
    delta_r[t] = il < n_rows ? delta[stat_off + il] : 0.0f;
  }

  for (int c0 = 0; c0 < lk; c0 += kChunk) {
    const int n = min(kChunk, lk - c0);
    __syncthreads();  // the key chunk is free (and qs / gs published)
    stage<D>(ks, k + (size_t(b) * lk + c0) * hd + head_off, n, hd, d);
    stage<D>(vs, v + (size_t(b) * lk + c0) * hd + head_off, n, hd, d);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      bias_s[j] = (1.0f - mask[size_t(b) * lk + c0 + j]) * kNegBias;
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < kPerWarp; ++t) {
      const int il = warp + kWarps * t;
      if (il >= n_rows) continue;
      const int r = r_begin + il;
      const RowGeometry rg = geo.row(r);
      // P for this row over the chunk, the query row in registers.
      {
        const attention_width::HeadRow<D, T> qf(qs + il * kStride);
        for (int j = lane; j < n; j += 32) {
          p_row[j] = expf(score(qf.dot(ks + j * kStride), a.scale, a.has_geometry,
                                rg.in_scope && geo.col_is_answer(c0 + j), rg.w, bias_s[j]) -
                          lse_r[t]);
        }
      }
      // dP, dS and dS_raw, the cotangent row in registers.
      {
        const attention_width::HeadRow<D, T> gf(gs + il * kStride);
        for (int j = lane; j < n; j += 32) {
          float dp = gf.dot(vs + j * kStride);
          if (a.dropout) dp = tiles.keep(r, c0 + j) ? __fmul_rn(dp, a.inv_keep) : 0.0f;
          float ds = p_row[j] * (dp - delta_r[t]);
          if (rg.in_scope && geo.col_is_answer(c0 + j)) ds = ds * rg.w;
          d_row[j] = round_to(ds * a.scale, q);
        }
      }
      __syncwarp();
      // dq row: lane l owns columns 2l + 64 c and 2l + 1 + 64 c.
      float2 x[kPairs];
#pragma unroll
      for (int c = 0; c < kPairs; ++c) x[c] = dacc[t][c];
      const T* kcol = ks + 2 * lane;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float dsr = d_row[j];
#pragma unroll
        for (int c = 0; c < kPairs; ++c) {
          if (kRagged && 2 * lane + 64 * c >= d) continue;  // beyond the head
          const float2 kk = load_pair(kcol + j * kStride + 64 * c);
          x[c].x = fmaf(dsr, kk.x, x[c].x);
          x[c].y = fmaf(dsr, kk.y, x[c].y);
        }
      }
#pragma unroll
      for (int c = 0; c < kPairs; ++c) dacc[t][c] = x[c];
      __syncwarp();  // the rows are rewritten for this warp's next row
    }
  }

#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) {
    const int il = warp + kWarps * t;
    if (il < n_rows) {
      T* drow = dq + (size_t(b) * lq + r_begin + il) * hd + head_off;
#pragma unroll
      for (int c = 0; c < kPairs; ++c) {
        store_cols(drow, 2 * lane + 64 * c, d, dacc[t][c].x, dacc[t][c].y);
      }
    }
  }
}

Args make_args(int lq, int lk, int num_heads, float scale, int has_geometry, int row_start,
               int text_len, int offset, int dropout, uint32_t threshold, float inv_keep,
               uint32_t seed, uint32_t cell_stride, int bq, int bk,
               int n_qblk, int n_kblk, int head_dim) {
  Args a;
  a.lq = lq;
  a.lk = lk;
  a.num_heads = num_heads;
  a.scale = scale;
  a.has_geometry = has_geometry;
  a.row_start = row_start;
  a.text_len = text_len;
  a.offset = offset;
  a.dropout = dropout;
  a.inv_keep = inv_keep;
  a.cell_stride = cell_stride;
  a.tiles = Tiles{bq, bk, n_qblk, n_kblk, seed, 0u, threshold};
  a.head_dim = head_dim;
  return a;
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* mask,
               const void* boundary, const void* w, const void* lse, const void* delta,
               void* dk, void* dv, void* dw_part, int batch, const Args& a,
               cudaStream_t stream) {
  const size_t smem = Layout<T, D>::dkv_bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.lk + kPerBlock - 1) / kPerBlock, a.num_heads, batch);
  flash_attention_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(mask),
      static_cast<const int*>(boundary), static_cast<const float*>(w),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(dw_part), a);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const void* mask,
              const void* boundary, const void* w, const void* lse, const void* delta,
              void* dq, int batch, const Args& a, cudaStream_t stream) {
  const size_t smem = Layout<T, D>::dq_bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.lq + kPerBlock - 1) / kPerBlock, a.num_heads, batch);
  flash_attention_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(mask),
      static_cast<const int*>(boundary), static_cast<const float*>(w),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq),
      a);
  return int(cudaGetLastError());
}

template <typename T, int D>
size_t smem_of() {
  const size_t a = Layout<T, D>::dkv_bytes, b = Layout<T, D>::dq_bytes;
  return a > b ? a : b;
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the larger of the two kernels' blocks at
// head_dim 64 or 128 (or a width of this library's padded one; the wrapper
// holds it against the device's opt-in limit before launching); 0 for
// another width.
size_t mkg_flash_attention_bwd_smem(int is_bf16, int head_dim) {
  return attention_width::with_width(head_dim, size_t(0), [&](auto width) {
    constexpr int D = decltype(width)::value;
    return attention_width::with_type(is_bf16, size_t(0),
                                      [&](auto t) { return smem_of<decltype(t), D>(); });
  });
}

// dK/dV and the dw partials: launches on `stream` without synchronising and
// returns cudaGetLastError() (cudaErrorInvalidValue for a head_dim this
// library does not take). lse and delta are (B, heads, Lq) fp32, dw_part
// (B, heads, ceil(Lk / 32), 2) fp32 partials of (dw0, dw1).
int mkg_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                const void* mask, const void* boundary, const void* w,
                                const void* lse, const void* delta, void* dk, void* dv,
                                void* dw_part, int batch, int lq, int lk, int num_heads,
                                int head_dim, int is_bf16, float scale, int has_geometry,
                                int row_start, int text_len, int offset, int dropout,
                                unsigned int threshold, float inv_keep, unsigned int seed,
                                unsigned int cell_stride, int bq,
                                int bk, int n_qblk, int n_kblk, void* stream) {
  const Args a = make_args(lq, lk, num_heads, scale, has_geometry, row_start, text_len,
                           offset, dropout, threshold, inv_keep, seed, cell_stride,
                           bq, bk, n_qblk, n_kblk, head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return attention_width::with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    constexpr int D = decltype(width)::value;
    return attention_width::with_type(is_bf16, int(cudaErrorInvalidValue), [&](auto t) {
      return launch_dkv<decltype(t), D>(q, k, v, g, mask, boundary, w, lse, delta, dk, dv,
                                        dw_part, batch, a, s);
    });
  });
}

// dQ: launches on `stream` without synchronising and returns
// cudaGetLastError(), as above.
int mkg_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                               const void* mask, const void* boundary, const void* w,
                               const void* lse, const void* delta, void* dq, int batch,
                               int lq, int lk, int num_heads, int head_dim, int is_bf16,
                               float scale, int has_geometry, int row_start, int text_len,
                               int offset, int dropout, unsigned int threshold,
                               float inv_keep, unsigned int seed, unsigned int cell_stride, int bq,
                               int bk, int n_qblk, int n_kblk, void* stream) {
  const Args a = make_args(lq, lk, num_heads, scale, has_geometry, row_start, text_len,
                           offset, dropout, threshold, inv_keep, seed, cell_stride,
                           bq, bk, n_qblk, n_kblk, head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return attention_width::with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    constexpr int D = decltype(width)::value;
    return attention_width::with_type(is_bf16, int(cudaErrorInvalidValue), [&](auto t) {
      return launch_dq<decltype(t), D>(q, k, v, g, mask, boundary, w, lse, delta, dq, batch,
                                       a, s);
    });
  });
}

}  // extern "C"
