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
// (B, L, heads * 64) layout in and out. Scores, softmax and every sum are in
// fp32; q, k, v, g and the results are bf16 or fp32. The dropout mask is
// the counter hash of fused_attention_fwd.cu (the JAX interpret-mode
// _dropout_keep with the per-(b, head) seed of _cell_seed), so it is the
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
// (explicit __fmul_rn/__fadd_rn, so the compiler contracts nothing
// differently), so pass 2's probabilities are pass 1's bit for bit. The
// products run on the CUDA cores (no mma.sync, wgmma or TMA yet): a simple
// kernel that is right first.
//
// Shared memory: pass 1 holds K and V for Lk keys plus three fp32 rows per
// warp (146 KB at Lk = 227 in fp32, under the H100's 227 KB); pass 2 holds Q
// and g for Lq rows plus two fp32 rows per warp (80 KB at Lq = 128 in fp32).
// The wrapper checks mkg_fused_attention_bwd_smem against the device and
// raises above it. head_dim is fixed at 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cfloat>

namespace {

constexpr int kHeadDim = 64;
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

// fp32 dot product of a row held in registers with a 64-wide row of T
template <typename T>
__device__ __forceinline__ float dot_row(const float* a, const T* b) {
  constexpr int kChunk = 16 / sizeof(T);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kHeadDim; c += kChunk) {
    float bf[kChunk];
    load_chunk(b + c, bf);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) acc = fmaf(a[c + i], bf[i], acc);
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ void load_row(const T* p, float* f) {
  constexpr int kChunk = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < kHeadDim; c += kChunk) load_chunk(p + c, f + c);
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

template <typename T>
struct Layout {
  static constexpr int kChunk = 16 / sizeof(T);              // elements per 16 B
  static constexpr int kStride = kHeadDim + kChunk;          // padded smem row
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

// Stage the (rows x 64) slice of head h of batch row b from the packed
// (B, rows, hd) tensor x into padded shared-memory rows.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* x, int b, int rows, int hd, int h) {
  constexpr int kChunk = Layout<T>::kChunk;
  constexpr int kStride = Layout<T>::kStride;
  constexpr int kChunksPerRow = kHeadDim / kChunk;
  const T* src = x + size_t(b) * rows * hd + h * kHeadDim;
  for (int i = threadIdx.x; i < rows * kChunksPerRow; i += kThreads) {
    const int j = i / kChunksPerRow, c = (i % kChunksPerRow) * kChunk;
    *reinterpret_cast<uint4*>(dst + j * kStride + c) =
        *reinterpret_cast<const uint4*>(src + size_t(j) * hd + c);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ mask, const int* __restrict__ boundary,
                        const float* __restrict__ w, T* __restrict__ dq,
                        float* __restrict__ stats, float* __restrict__ dw_part,
                        int lq, int lk, int num_heads, float scale, int has_geometry,
                        int row_start, int text_len, int offset, int dropout,
                        uint32_t threshold, float inv_keep, uint32_t seed) {
  constexpr int kStride = Layout<T>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float dw_s[kWarps][2];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + size_t(lk) * kStride;
  float* bias_s = reinterpret_cast<float*>(vs + size_t(lk) * kStride);
  const int lk4 = (lk + 3) & ~3;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = num_heads * kHeadDim;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sraw_row = bias_s + lk4 * (1 + 3 * warp);  // s_raw
  float* p_row = sraw_row + lk4;                    // s, then exp, then p
  float* d_row = p_row + lk4;                       // dP, then dS_raw

  stage(ks, k, b, lk, hd, h);
  stage(vs, v, b, lk, hd, h);
  for (int j = threadIdx.x; j < lk; j += kThreads) {
    bias_s[j] = (1.0f - mask[size_t(b) * lk + j]) * kNegBias;
  }
  __syncthreads();

  const Geometry geo{has_geometry, row_start, text_len,
                     has_geometry ? boundary[b] + offset : 0,
                     has_geometry ? w[0] : 1.0f, has_geometry ? w[1] : 1.0f};
  const uint32_t seed_mix = (seed + uint32_t(b * num_heads + h)) * 0x9E3779B9u;
  const int r_end = min(lq, (tile + 1) * kRowsPerBlock);
  float dw0 = 0.0f, dw1 = 0.0f;  // this lane's partials

  for (int r = tile * kRowsPerBlock + warp; r < r_end; r += kWarps) {
    const size_t row_off = (size_t(b) * lq + r) * hd + h * kHeadDim;
    const RowGeometry rg = geo.row(r);

    // Scores and their max, the query row in registers.
    float mx = -FLT_MAX;
    {
      float qf[kHeadDim];
      load_row(q + row_off, qf);
      for (int j = lane; j < lk; j += 32) {
        const float s_raw = __fmul_rn(dot_row(qf, ks + j * kStride), scale);
        const float s = score(s_raw, rg.in_scope && geo.col_is_answer(j), rg.w, bias_s[j]);
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
      float gf[kHeadDim];
      load_row(g + row_off, gf);
      for (int j = lane; j < lk; j += 32) {
        const float p = p_row[j] / sum;
        float dp = dot_row(gf, vs + j * kStride);
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

    // dq row: lane l owns columns 2l and 2l+1.
    float a0 = 0.0f, a1 = 0.0f;
    const T* kcol = ks + 2 * lane;
#pragma unroll 4
    for (int j = 0; j < lk; ++j) {
      const float d = d_row[j];
      const float2 kk = load_pair(kcol + j * kStride);
      a0 = fmaf(d, kk.x, a0);
      a1 = fmaf(d, kk.y, a1);
    }
    store_pair(dq + row_off + 2 * lane, a0, a1);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ mask, const int* __restrict__ boundary,
                         const float* __restrict__ w, const float* __restrict__ stats,
                         T* __restrict__ dk, T* __restrict__ dv, int lq, int lk,
                         int num_heads, float scale, int has_geometry, int row_start,
                         int text_len, int offset, int dropout, uint32_t threshold,
                         float inv_keep, uint32_t seed) {
  constexpr int kStride = Layout<T>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* gs = qs + size_t(lq) * kStride;
  float* m_s = reinterpret_cast<float*>(gs + size_t(lq) * kStride);
  const int lq4 = (lq + 3) & ~3;
  float* l_s = m_s + lq4;
  float* delta_s = l_s + lq4;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = num_heads * kHeadDim;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pc_row = delta_s + lq4 * (1 + 2 * warp);  // P, then P_cast
  float* ds_row = pc_row + lq4;                    // dS_raw

  stage(qs, q, b, lq, hd, h);
  stage(gs, g, b, lq, hd, h);
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
  const uint32_t seed_mix = (seed + uint32_t(b * num_heads + h)) * 0x9E3779B9u;
  const int j_end = min(lk, (tile + 1) * kKeysPerBlock);

  for (int j = tile * kKeysPerBlock + warp; j < j_end; j += kWarps) {
    const size_t col_off = (size_t(b) * lk + j) * hd + h * kHeadDim;
    const float bias = (1.0f - mask[size_t(b) * lk + j]) * kNegBias;
    const bool col_answer = geo.col_is_answer(j);

    // P for this key column, the key row in registers; P_cast for dv.
    {
      float kf[kHeadDim];
      load_row(k + col_off, kf);
      for (int i = lane; i < lq; i += 32) {
        const RowGeometry rg = geo.row(i);
        const float s_raw = __fmul_rn(dot_row(kf, qs + i * kStride), scale);
        const float s = score(s_raw, rg.in_scope && col_answer, rg.w, bias);
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
      float vf[kHeadDim];
      load_row(v + col_off, vf);
      for (int i = lane; i < lq; i += 32) {
        const RowGeometry rg = geo.row(i);
        float dp = dot_row(vf, gs + i * kStride);
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

    // dk and dv rows: lane l owns columns 2l and 2l+1.
    float k0 = 0.0f, k1 = 0.0f, v0 = 0.0f, v1 = 0.0f;
    const T* qcol = qs + 2 * lane;
    const T* gcol = gs + 2 * lane;
#pragma unroll 4
    for (int i = 0; i < lq; ++i) {
      const float d = ds_row[i], pc = pc_row[i];
      const float2 qq = load_pair(qcol + i * kStride);
      const float2 gg = load_pair(gcol + i * kStride);
      k0 = fmaf(d, qq.x, k0);
      k1 = fmaf(d, qq.y, k1);
      v0 = fmaf(pc, gg.x, v0);
      v1 = fmaf(pc, gg.y, v1);
    }
    store_pair(dk + col_off + 2 * lane, k0, k1);
    store_pair(dv + col_off + 2 * lane, v0, v1);
    __syncwarp();  // the rows are rewritten by this warp's next key
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, const void* mask,
           const void* boundary, const void* w, void* dq, void* dk, void* dv,
           void* stats, void* dw_part, int batch, int lq, int lk, int num_heads,
           float scale, int has_geometry, int row_start, int text_len, int offset,
           int dropout, uint32_t threshold, float inv_keep, uint32_t seed,
           cudaStream_t stream) {
  const size_t smem_dq = Layout<T>::dq_bytes(lk);
  const size_t smem_dkv = Layout<T>::dkv_bytes(lq);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem_dq));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_dkv));
  if (err != cudaSuccess) return int(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const float* maskf = static_cast<const float*>(mask);
  const int* bnd = static_cast<const int*>(boundary);
  const float* wf = static_cast<const float*>(w);
  const dim3 grid_dq((lq + kRowsPerBlock - 1) / kRowsPerBlock, num_heads, batch);
  attention_bwd_dq_kernel<T><<<grid_dq, kThreads, smem_dq, stream>>>(
      qt, kt, vt, gt, maskf, bnd, wf, static_cast<T*>(dq), static_cast<float*>(stats),
      static_cast<float*>(dw_part), lq, lk, num_heads, scale, has_geometry, row_start,
      text_len, offset, dropout, threshold, inv_keep, seed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 grid_dkv((lk + kKeysPerBlock - 1) / kKeysPerBlock, num_heads, batch);
  attention_bwd_dkv_kernel<T><<<grid_dkv, kThreads, smem_dkv, stream>>>(
      qt, kt, vt, gt, maskf, bnd, wf, static_cast<const float*>(stats),
      static_cast<T*>(dk), static_cast<T*>(dv), lq, lk, num_heads, scale, has_geometry,
      row_start, text_len, offset, dropout, threshold, inv_keep, seed);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the larger of the two passes' blocks (the
// wrapper holds it against the device's opt-in limit before launching).
size_t mkg_fused_attention_bwd_smem(int lq, int lk, int is_bf16) {
  if (is_bf16) {
    const size_t a = Layout<__nv_bfloat16>::dq_bytes(lk);
    const size_t b = Layout<__nv_bfloat16>::dkv_bytes(lq);
    return a > b ? a : b;
  }
  const size_t a = Layout<float>::dq_bytes(lk), b = Layout<float>::dkv_bytes(lq);
  return a > b ? a : b;
}

// Launches both passes on `stream` without synchronising; returns
// cudaGetLastError(). stats is (B, heads, Lq, 3) fp32 scratch, dw_part
// (B, heads, ceil(Lq / 64), 2) fp32 partials of (dw0, dw1).
int mkg_fused_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                            const void* mask, const void* boundary, const void* w,
                            void* dq, void* dk, void* dv, void* stats, void* dw_part,
                            int batch, int lq, int lk, int num_heads, int is_bf16,
                            float scale, int has_geometry, int row_start, int text_len,
                            int offset, int dropout, unsigned int threshold,
                            float inv_keep, unsigned int seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, g, mask, boundary, w, dq, dk, dv, stats,
                                 dw_part, batch, lq, lk, num_heads, scale, has_geometry,
                                 row_start, text_len, offset, dropout, threshold,
                                 inv_keep, seed, s);
  }
  return launch<float>(q, k, v, g, mask, boundary, w, dq, dk, dv, stats, dw_part, batch,
                       lq, lk, num_heads, scale, has_geometry, row_start, text_len, offset,
                       dropout, threshold, inv_keep, seed, s);
}

}  // extern "C"
