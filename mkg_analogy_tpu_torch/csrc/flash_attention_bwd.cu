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
// (B, L, heads * 64) layout in and out. Every sum is fp32; q, k, v, g and the
// results are bf16 or fp32. The dropout masks are the forward's
// (flash_attention_fwd.cu): the interpret-mode hash keyed to the logical
// (bq, bk) tiles, idx = row_in_tile * bk + col_in_tile, tile seed
// seed + ((b * heads + head) * n_qblk + qb) * n_kblk + kb. Nothing here
// depends on the online softmax's grouping, so the kernels stage keys and
// rows in chunks of any size and compute each (row, key) on its own. The
// plain version is kernels/flash_attention.py:flash_attention_bwd_reference.
//
// What bounds it: at the main-path shapes (L <= 611, head_dim 64) bytes; at
// L = 2048 the products (4 * Lq * Lk * 64 flops per (b, head) for dK/dV
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
//     accumulates its columns over the chunk. Rows past Lq are never read
//     (JAX zeroes them to the same effect, :215-220). It writes one
//     (dw0, dw1) partial per (b, head, key block), which the wrapper sums.
//   - dQ: one block per (32 query rows, head, batch row). The block stages
//     its rows' q and g once, then walks the keys in chunks of 128, staging K,
//     V and the padding bias. Each warp owns 4 rows with their dq columns in
//     registers; for each row, lane j computes keys j, j + 32, ...: p, dP,
//     dS_raw, then every lane accumulates its dq columns.
// Both kernels form a score with the forward's operations in the forward's
// order (the fmaf dot product, then __fmul_rn / __fadd_rn), so all three see
// the same scores bit for bit. The products run on the CUDA cores (no
// mma.sync, wgmma or TMA yet): a simple kernel that is right first.
// head_dim is fixed at 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerBlock = 32;          // keys per dK/dV block, rows per dQ block
constexpr int kPerWarp = kPerBlock / kWarps;
constexpr int kChunk = 128;            // rows (dK/dV) or keys (dQ) staged at a time
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

// fp32 dot product of a row held in registers with a 64-wide row of T
template <typename T>
__device__ __forceinline__ float dot_row(const float* a, const T* b) {
  constexpr int kVec = 16 / sizeof(T);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kHeadDim; c += kVec) {
    float bf[kVec];
    load_chunk(b + c, bf);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc = fmaf(a[c + i], bf[i], acc);
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ void load_row(const T* p, float* f) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < kHeadDim; c += kVec) load_chunk(p + c, f + c);
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

// s = (acc * scale) (* w in the region) + bias, rounded step by step
__device__ __forceinline__ float score(float s_raw, bool region, float w, float bias) {
  return __fadd_rn(region ? __fmul_rn(s_raw, w) : s_raw, bias);
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

template <typename T>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);                // elements per 16 B
  static constexpr int kStride = kHeadDim + kVec;            // padded smem row
  // dK/dV: K and V of the block's keys, q and g of a row chunk, its lse
  // and delta, three fp32 rows per warp
  static constexpr size_t dkv_bytes =
      2 * size_t(kPerBlock + kChunk) * kStride * sizeof(T) +
      size_t(kChunk) * sizeof(float) * (2 + 3 * kWarps);
  // dQ: q and g of the block's rows, K and V of a key chunk, its bias row,
  // two fp32 rows per warp
  static constexpr size_t dq_bytes =
      2 * size_t(kPerBlock + kChunk) * kStride * sizeof(T) +
      size_t(kChunk) * sizeof(float) * (1 + 2 * kWarps);
};

// Stage `rows` rows of 64 elements from global memory (row stride hd) into
// padded shared-memory rows.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int rows, int hd) {
  constexpr int kVec = Layout<T>::kVec;
  constexpr int kStride = Layout<T>::kStride;
  constexpr int kVecsPerRow = kHeadDim / kVec;
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
  Tiles tiles;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ g,
                               const float* __restrict__ mask,
                               const int* __restrict__ boundary,
                               const float* __restrict__ w, const float* __restrict__ lse,
                               const float* __restrict__ delta, T* __restrict__ dk,
                               T* __restrict__ dv, float* __restrict__ dw_part, Args a) {
  constexpr int kStride = Layout<T>::kStride;
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
  const int hd = a.num_heads * kHeadDim;
  const size_t head_off = size_t(h) * kHeadDim;
  const int j_begin = blockIdx.x * kPerBlock;
  const int n_keys = min(kPerBlock, lk - j_begin);
  stage(ks, k + (size_t(b) * lk + j_begin) * hd + head_off, n_keys, hd);
  stage(vs, v + (size_t(b) * lk + j_begin) * hd + head_off, n_keys, hd);

  const Geometry geo{a.has_geometry, a.row_start, a.text_len,
                     a.has_geometry ? boundary[b] + a.offset : 0,
                     a.has_geometry ? w[0] : 1.0f, a.has_geometry ? w[1] : 1.0f};
  Tiles tiles = a.tiles;
  tiles.cell = uint32_t(b * a.num_heads + h);
  const float* lse_bh = lse + (size_t(b) * a.num_heads + h) * lq;
  const float* delta_bh = delta + (size_t(b) * a.num_heads + h) * lq;

  float k0[kPerWarp], k1[kPerWarp], v0[kPerWarp], v1[kPerWarp];
#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) k0[t] = k1[t] = v0[t] = v1[t] = 0.0f;
  float dw0 = 0.0f, dw1 = 0.0f;  // this lane's partials

  for (int r0 = 0; r0 < lq; r0 += kChunk) {
    const int n = min(kChunk, lq - r0);
    __syncthreads();  // the row chunk is free (and ks / vs published)
    stage(qs, q + (size_t(b) * lq + r0) * hd + head_off, n, hd);
    stage(gs, g + (size_t(b) * lq + r0) * hd + head_off, n, hd);
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
        float kf[kHeadDim];
        load_row(ks + jl * kStride, kf);
        for (int i = lane; i < n; i += 32) {
          const int r = r0 + i;
          const RowGeometry rg = geo.row(r);
          const float s_raw = __fmul_rn(dot_row(kf, qs + i * kStride), a.scale);
          const float p =
              expf(score(s_raw, rg.in_scope && col_answer, rg.w, bias) - lse_s[i]);
          float p_drop = p;
          if (a.dropout) p_drop = tiles.keep(r, j) ? __fmul_rn(p, a.inv_keep) : 0.0f;
          sraw_row[i] = s_raw;
          d_row[i] = p;
          pc_row[i] = round_to(p_drop, q);
        }
      }
      // dP, dS, the dw partials and dS_raw, the value row in registers.
      {
        float vf[kHeadDim];
        load_row(vs + jl * kStride, vf);
        for (int i = lane; i < n; i += 32) {
          const int r = r0 + i;
          const RowGeometry rg = geo.row(r);
          float dp = dot_row(vf, gs + i * kStride);
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
      // dk and dv rows of this key: lane l owns columns 2l and 2l+1.
      float x0 = k0[t], x1 = k1[t], y0 = v0[t], y1 = v1[t];
      const T* qcol = qs + 2 * lane;
      const T* gcol = gs + 2 * lane;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float d = d_row[i], pc = pc_row[i];
        const float2 qq = load_pair(qcol + i * kStride);
        const float2 gg = load_pair(gcol + i * kStride);
        x0 = fmaf(d, qq.x, x0);
        x1 = fmaf(d, qq.y, x1);
        y0 = fmaf(pc, gg.x, y0);
        y1 = fmaf(pc, gg.y, y1);
      }
      k0[t] = x0;
      k1[t] = x1;
      v0[t] = y0;
      v1[t] = y1;
      __syncwarp();  // the rows are rewritten for this warp's next key
    }
  }

#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) {
    const int jl = warp + kWarps * t;
    if (jl < n_keys) {
      const size_t off = (size_t(b) * lk + j_begin + jl) * hd + head_off + 2 * lane;
      store_pair(dk + off, k0[t], k1[t]);
      store_pair(dv + off, v0[t], v1[t]);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              const float* __restrict__ mask,
                              const int* __restrict__ boundary,
                              const float* __restrict__ w, const float* __restrict__ lse,
                              const float* __restrict__ delta, T* __restrict__ dq, Args a) {
  constexpr int kStride = Layout<T>::kStride;
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
  const int hd = a.num_heads * kHeadDim;
  const size_t head_off = size_t(h) * kHeadDim;
  const int r_begin = blockIdx.x * kPerBlock;
  const int n_rows = min(kPerBlock, lq - r_begin);
  stage(qs, q + (size_t(b) * lq + r_begin) * hd + head_off, n_rows, hd);
  stage(gs, g + (size_t(b) * lq + r_begin) * hd + head_off, n_rows, hd);

  const Geometry geo{a.has_geometry, a.row_start, a.text_len,
                     a.has_geometry ? boundary[b] + a.offset : 0,
                     a.has_geometry ? w[0] : 1.0f, a.has_geometry ? w[1] : 1.0f};
  Tiles tiles = a.tiles;
  tiles.cell = uint32_t(b * a.num_heads + h);
  const size_t stat_off = (size_t(b) * a.num_heads + h) * lq + r_begin;

  float d0[kPerWarp], d1[kPerWarp], lse_r[kPerWarp], delta_r[kPerWarp];
#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) {
    const int il = warp + kWarps * t;
    d0[t] = d1[t] = 0.0f;
    lse_r[t] = il < n_rows ? lse[stat_off + il] : 0.0f;
    delta_r[t] = il < n_rows ? delta[stat_off + il] : 0.0f;
  }

  for (int c0 = 0; c0 < lk; c0 += kChunk) {
    const int n = min(kChunk, lk - c0);
    __syncthreads();  // the key chunk is free (and qs / gs published)
    stage(ks, k + (size_t(b) * lk + c0) * hd + head_off, n, hd);
    stage(vs, v + (size_t(b) * lk + c0) * hd + head_off, n, hd);
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
        float qf[kHeadDim];
        load_row(qs + il * kStride, qf);
        for (int j = lane; j < n; j += 32) {
          const float s_raw = __fmul_rn(dot_row(qf, ks + j * kStride), a.scale);
          p_row[j] = expf(score(s_raw, rg.in_scope && geo.col_is_answer(c0 + j), rg.w,
                                bias_s[j]) -
                          lse_r[t]);
        }
      }
      // dP, dS and dS_raw, the cotangent row in registers.
      {
        float gf[kHeadDim];
        load_row(gs + il * kStride, gf);
        for (int j = lane; j < n; j += 32) {
          float dp = dot_row(gf, vs + j * kStride);
          if (a.dropout) dp = tiles.keep(r, c0 + j) ? __fmul_rn(dp, a.inv_keep) : 0.0f;
          float ds = p_row[j] * (dp - delta_r[t]);
          if (rg.in_scope && geo.col_is_answer(c0 + j)) ds = ds * rg.w;
          d_row[j] = round_to(ds * a.scale, q);
        }
      }
      __syncwarp();
      // dq row: lane l owns columns 2l and 2l+1.
      float x0 = d0[t], x1 = d1[t];
      const T* kcol = ks + 2 * lane;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float d = d_row[j];
        const float2 kk = load_pair(kcol + j * kStride);
        x0 = fmaf(d, kk.x, x0);
        x1 = fmaf(d, kk.y, x1);
      }
      d0[t] = x0;
      d1[t] = x1;
      __syncwarp();  // the rows are rewritten for this warp's next row
    }
  }

#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) {
    const int il = warp + kWarps * t;
    if (il < n_rows) {
      store_pair(dq + (size_t(b) * lq + r_begin + il) * hd + head_off + 2 * lane, d0[t],
                 d1[t]);
    }
  }
}

Args make_args(int lq, int lk, int num_heads, float scale, int has_geometry, int row_start,
               int text_len, int offset, int dropout, uint32_t threshold, float inv_keep,
               uint32_t seed, int bq, int bk, int n_qblk, int n_kblk) {
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
  a.tiles = Tiles{bq, bk, n_qblk, n_kblk, seed, 0u, threshold};
  return a;
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* mask,
               const void* boundary, const void* w, const void* lse, const void* delta,
               void* dk, void* dv, void* dw_part, int batch, const Args& a,
               cudaStream_t stream) {
  const size_t smem = Layout<T>::dkv_bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dkv_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.lk + kPerBlock - 1) / kPerBlock, a.num_heads, batch);
  flash_attention_bwd_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(mask),
      static_cast<const int*>(boundary), static_cast<const float*>(w),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(dw_part), a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* g, const void* mask,
              const void* boundary, const void* w, const void* lse, const void* delta,
              void* dq, int batch, const Args& a, cudaStream_t stream) {
  const size_t smem = Layout<T>::dq_bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.lq + kPerBlock - 1) / kPerBlock, a.num_heads, batch);
  flash_attention_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(mask),
      static_cast<const int*>(boundary), static_cast<const float*>(w),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq),
      a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the larger of the two kernels' blocks (the
// wrapper holds it against the device's opt-in limit before launching).
size_t mkg_flash_attention_bwd_smem(int is_bf16) {
  if (is_bf16) {
    const size_t a = Layout<__nv_bfloat16>::dkv_bytes, b = Layout<__nv_bfloat16>::dq_bytes;
    return a > b ? a : b;
  }
  const size_t a = Layout<float>::dkv_bytes, b = Layout<float>::dq_bytes;
  return a > b ? a : b;
}

// dK/dV and the dw partials: launches on `stream` without synchronising and
// returns cudaGetLastError(). lse and delta are (B, heads, Lq) fp32, dw_part
// (B, heads, ceil(Lk / 32), 2) fp32 partials of (dw0, dw1).
int mkg_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                const void* mask, const void* boundary, const void* w,
                                const void* lse, const void* delta, void* dk, void* dv,
                                void* dw_part, int batch, int lq, int lk, int num_heads,
                                int is_bf16, float scale, int has_geometry, int row_start,
                                int text_len, int offset, int dropout,
                                unsigned int threshold, float inv_keep, unsigned int seed,
                                int bq, int bk, int n_qblk, int n_kblk, void* stream) {
  const Args a = make_args(lq, lk, num_heads, scale, has_geometry, row_start, text_len,
                           offset, dropout, threshold, inv_keep, seed, bq, bk, n_qblk,
                           n_kblk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_dkv<__nv_bfloat16>(q, k, v, g, mask, boundary, w, lse, delta, dk, dv,
                                     dw_part, batch, a, s);
  }
  return launch_dkv<float>(q, k, v, g, mask, boundary, w, lse, delta, dk, dv, dw_part,
                           batch, a, s);
}

// dQ: launches on `stream` without synchronising and returns
// cudaGetLastError().
int mkg_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                               const void* mask, const void* boundary, const void* w,
                               const void* lse, const void* delta, void* dq, int batch,
                               int lq, int lk, int num_heads, int is_bf16, float scale,
                               int has_geometry, int row_start, int text_len, int offset,
                               int dropout, unsigned int threshold, float inv_keep,
                               unsigned int seed, int bq, int bk, int n_qblk, int n_kblk,
                               void* stream) {
  const Args a = make_args(lq, lk, num_heads, scale, has_geometry, row_start, text_len,
                           offset, dropout, threshold, inv_keep, seed, bq, bk, n_qblk,
                           n_kblk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_dq<__nv_bfloat16>(q, k, v, g, mask, boundary, w, lse, delta, dq, batch, a,
                                    s);
  }
  return launch_dq<float>(q, k, v, g, mask, boundary, w, lse, delta, dq, batch, a, s);
}

}  // extern "C"
