// K-blocked (flash) fused attention forward for the MarT towers, sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/flash_attention.py:
// _flash_fwd_kernel (launched by _flash_attention_fwd, the pl.pallas_call at
// :393). Contract, per (batch row, head), on the packed (B, L, heads * 64)
// layout in and out:
//
//   out = softmax(scale * Q K^T (*) analogy multiplier + (1 - mask) * -1e4) V
//   lse = the per-row log-sum-exp of those scores, (B, heads, Lq) fp32
//
// computed as an online softmax over the *logical* K tiles of bk keys
// (bk = min(block_k, Lk), 512 by default): after each tile the running max
// becomes max(m, tile max), the exp-weights p = exp(s - m) are rounded to
// the compute dtype (the dtype of q/k/v) before the product with V, the
// running sum and accumulator are rescaled by exp(m_old - m), and the sum
// divides in fp32 at the end. In bf16 that grouping is part of the result,
// so the kernel keeps one logical tile's scores of every row (in shared
// memory) and takes the tile max before any exponential, as the Pallas body
// does (:133-151). Scores and softmax are fp32.
//
// Dropout: the counter hash of the JAX kernel's interpret mode
// (attention.py:_dropout_keep), keyed to the logical (bq, bk) tiles:
// idx = row_in_tile * bk + col_in_tile (bk even in a ragged last tile),
// seed = seed + ((b * heads + head) * n_qblk + qb) * n_kblk + kb
// (flash_attention.py:_tile_seed), applied to the unnormalised p after the
// sum. The plain version (kernels/flash_attention.py:flash_attention_reference)
// and the two backward kernels draw the same masks.
//
// A ragged last K tile: the kernel never reads keys past Lk. JAX gives those
// columns a -1e30 bias (_col_bias), so their exp-weights are exactly 0 and
// they change neither the tile max nor the sums: leaving them out gives the
// same numbers. The running max starts at -1e30 (:113), not -inf.
//
// What bounds it: at the main-path shapes (L <= 611, head_dim 64) bytes;
// at L = 2048 the 4 * Lq * Lk * 64 flops per (b, head) pass the H100's
// balance point. The design reads q, k, v once per block from device memory
// (K/V again from L2 for every 32-row block) and writes out and lse once;
// scores and probabilities stay in shared memory and registers:
//   - one block per (32 query rows, head, batch row); the block stages its
//     rows of q once, then for each logical K tile stages K in chunks of 128
//     keys (16-byte loads into padded shared-memory rows), computes the
//     tile's scores of its 32 rows into shared memory (32 x bk fp32), takes
//     each row's tile max, running max, exp-weights and sum, then stages V
//     in chunks of 128 keys and accumulates p V;
//   - each warp owns 4 rows for the whole kernel, with their running max,
//     sum and accumulator in registers (lane l owns output columns 2l and
//     2l+1); lane j scores keys j, j + 32, ... of a chunk.
// Chunked staging keeps fp32 at bk = 512 within one block's shared memory
// (108.5 KB; a whole 512-key K + V tile would be 256 KB). The products run on
// the CUDA cores (no mma.sync, wgmma or TMA yet): a simple kernel that is
// right first. head_dim is fixed at 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 32;
constexpr int kRowsPerWarp = kRowsPerBlock / kWarps;
constexpr int kChunk = 128;            // keys staged at a time
constexpr float kNegBias = -10000.0f;  // reference padding bias
constexpr float kHardMask = -1e30f;    // flash_attention.py:HARD_MASK

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

// value after a round trip through T (the cast of the exp-weights)
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

// The analogy geometry of attention.py:_geometry_planes for row r.
struct RowGeometry {
  bool in_scope;
  float w;
};

struct Geometry {
  int has, row_start, text_len, bnd;
  float w0, w1;

  __device__ __forceinline__ RowGeometry row(int r) const {
    RowGeometry g{false, 1.0f};
    if (has) {
      const bool is_example = r >= row_start && r < bnd;
      g.in_scope = (is_example || r >= bnd) && r < text_len;
      g.w = is_example ? w0 : w1;
    }
    return g;
  }
  __device__ __forceinline__ bool col_is_answer(int j) const {
    return has && j >= bnd && j < text_len;
  }
};

// s = (acc * scale) (* w in the region) + bias, rounded step by step (the
// backward kernels form the same score with the same operations)
__device__ __forceinline__ float score(float s_raw, bool region, float w, float bias) {
  return __fadd_rn(region ? __fmul_rn(s_raw, w) : s_raw, bias);
}

template <typename T>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);                // elements per 16 B
  static constexpr int kStride = kHeadDim + kVec;            // padded smem row
  // the block's q rows, one K or V chunk, the tile's bias row and the
  // tile's scores of every row
  static size_t smem_bytes(int bk) {
    return size_t(kRowsPerBlock + kChunk) * kStride * sizeof(T) +
           size_t(bk) * sizeof(float) * (1 + kRowsPerBlock);
  }
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ mask,
                           const int* __restrict__ boundary,
                           const float* __restrict__ w, T* __restrict__ out,
                           float* __restrict__ lse, int lq, int lk, int num_heads,
                           float scale, int has_geometry, int row_start, int text_len,
                           int offset, int dropout, uint32_t threshold, float inv_keep,
                           uint32_t seed, int bq, int bk, int n_qblk, int n_kblk) {
  constexpr int kStride = Layout<T>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* cs = qs + kRowsPerBlock * kStride;                      // K or V chunk
  float* bias_s = reinterpret_cast<float*>(cs + kChunk * kStride);
  float* s_tile = bias_s + bk;                               // kRowsPerBlock x bk

  const int h = blockIdx.y, b = blockIdx.z;
  const int hd = num_heads * kHeadDim;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r_begin = blockIdx.x * kRowsPerBlock;
  const int n_rows = min(kRowsPerBlock, lq - r_begin);
  const size_t head_off = size_t(h) * kHeadDim;

  stage(qs, q + (size_t(b) * lq + r_begin) * hd + head_off, n_rows, hd);
  // (the first chunk's barrier publishes qs)

  const Geometry geo{has_geometry, row_start, text_len,
                     has_geometry ? boundary[b] + offset : 0,
                     has_geometry ? w[0] : 1.0f, has_geometry ? w[1] : 1.0f};
  const uint32_t cell = uint32_t(b * num_heads + h);

  // this warp's rows: local row il = warp + kWarps * t
  float m[kRowsPerWarp], l[kRowsPerWarp], a0[kRowsPerWarp], a1[kRowsPerWarp];
  float alpha[kRowsPerWarp], pv0[kRowsPerWarp], pv1[kRowsPerWarp];
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    m[t] = kHardMask;
    l[t] = a0[t] = a1[t] = 0.0f;
  }

  for (int kb = 0; kb < n_kblk; ++kb) {
    const int c_begin = kb * bk;
    const int width = min(bk, lk - c_begin);  // real keys of this tile

    // 1. The tile's scores of every row, K staged chunk by chunk.
    for (int c0 = 0; c0 < width; c0 += kChunk) {
      const int n = min(kChunk, width - c0);
      __syncthreads();  // the chunk buffer is free
      stage(cs, k + (size_t(b) * lk + c_begin + c0) * hd + head_off, n, hd);
      for (int j = threadIdx.x; j < n; j += kThreads) {
        bias_s[c0 + j] = (1.0f - mask[size_t(b) * lk + c_begin + c0 + j]) * kNegBias;
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t) {
        const int il = warp + kWarps * t;
        if (il < n_rows) {
          const RowGeometry rg = geo.row(r_begin + il);
          float qf[kHeadDim];
          load_row(qs + il * kStride, qf);
          float* srow = s_tile + il * bk;
          for (int j = lane; j < n; j += 32) {
            const float s_raw = __fmul_rn(dot_row(qf, cs + j * kStride), scale);
            srow[c0 + j] = score(s_raw, rg.in_scope && geo.col_is_answer(c_begin + c0 + j),
                                 rg.w, bias_s[c0 + j]);
          }
        }
      }
    }
    __syncwarp();

    // 2. Per row: the tile max, the new running max, the exp-weights (their
    //    sum before dropout), dropped and rounded to T in place.
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
      const int il = warp + kWarps * t;
      alpha[t] = 1.0f;
      if (il < n_rows) {
        const int r = r_begin + il;
        float* srow = s_tile + il * bk;
        float mx = kHardMask;
        for (int j = lane; j < width; j += 32) mx = fmaxf(mx, srow[j]);
        const float m_new = fmaxf(m[t], warp_max(mx));
        const int qb = r / bq;
        const uint32_t row_idx = uint32_t(r - qb * bq) * uint32_t(bk);
        const uint32_t mix =
            (seed + (cell * uint32_t(n_qblk) + uint32_t(qb)) * uint32_t(n_kblk) + uint32_t(kb)) *
            0x9E3779B9u;
        float sum = 0.0f;
        for (int j = lane; j < width; j += 32) {
          float p = expf(srow[j] - m_new);
          sum += p;
          if (dropout) {
            p = dropout_keep(row_idx + uint32_t(j), mix, threshold) ? __fmul_rn(p, inv_keep)
                                                                    : 0.0f;
          }
          srow[j] = round_to(p, q);
        }
        alpha[t] = expf(m[t] - m_new);
        l[t] = l[t] * alpha[t] + warp_sum(sum);
        m[t] = m_new;
      }
      pv0[t] = pv1[t] = 0.0f;
    }

    // 3. p V over the tile, V staged chunk by chunk.
    for (int c0 = 0; c0 < width; c0 += kChunk) {
      const int n = min(kChunk, width - c0);
      __syncthreads();  // the chunk buffer is free; step 2 is done
      stage(cs, v + (size_t(b) * lk + c_begin + c0) * hd + head_off, n, hd);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t) {
        const int il = warp + kWarps * t;
        if (il < n_rows) {
          const float* prow = s_tile + il * bk + c0;
          const T* vcol = cs + 2 * lane;
          float x0 = pv0[t], x1 = pv1[t];
#pragma unroll 4
          for (int j = 0; j < n; ++j) {
            const float p = prow[j];
            const float2 vv = load_pair(vcol + j * kStride);
            x0 = fmaf(p, vv.x, x0);
            x1 = fmaf(p, vv.y, x1);
          }
          pv0[t] = x0;
          pv1[t] = x1;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
      a0[t] = a0[t] * alpha[t] + pv0[t];
      a1[t] = a1[t] * alpha[t] + pv1[t];
    }
  }

  // out = acc / l, lse = m + log(l)
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int il = warp + kWarps * t;
    if (il < n_rows) {
      const int r = r_begin + il;
      store_pair(out + (size_t(b) * lq + r) * hd + head_off + 2 * lane, a0[t] / l[t],
                 a1[t] / l[t]);
      if (lane == 0) lse[(size_t(b) * num_heads + h) * lq + r] = m[t] + logf(l[t]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* boundary, const void* w, void* out, void* lse, int batch, int lq,
           int lk, int num_heads, float scale, int has_geometry, int row_start,
           int text_len, int offset, int dropout, uint32_t threshold, float inv_keep,
           uint32_t seed, int bq, int bk, int n_qblk, int n_kblk, cudaStream_t stream) {
  const size_t smem = Layout<T>::smem_bytes(bk);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((lq + kRowsPerBlock - 1) / kRowsPerBlock, num_heads, batch);
  flash_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const int*>(boundary),
      static_cast<const float*>(w), static_cast<T*>(out), static_cast<float*>(lse), lq, lk,
      num_heads, scale, has_geometry, row_start, text_len, offset, dropout, threshold,
      inv_keep, seed, bq, bk, n_qblk, n_kblk);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block for logical K tiles of bk keys (the
// wrapper holds it against the device's opt-in limit before launching).
size_t mkg_flash_attention_fwd_smem(int bk, int is_bf16) {
  return is_bf16 ? Layout<__nv_bfloat16>::smem_bytes(bk) : Layout<float>::smem_bytes(bk);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// out is (B, Lq, heads * 64) in the inputs' dtype, lse (B, heads, Lq) fp32.
int mkg_flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                            const void* boundary, const void* w, void* out, void* lse,
                            int batch, int lq, int lk, int num_heads, int is_bf16,
                            float scale, int has_geometry, int row_start, int text_len,
                            int offset, int dropout, unsigned int threshold, float inv_keep,
                            unsigned int seed, int bq, int bk, int n_qblk, int n_kblk,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, mask, boundary, w, out, lse, batch, lq, lk,
                                 num_heads, scale, has_geometry, row_start, text_len,
                                 offset, dropout, threshold, inv_keep, seed, bq, bk, n_qblk,
                                 n_kblk, s);
  }
  return launch<float>(q, k, v, mask, boundary, w, out, lse, batch, lq, lk, num_heads,
                       scale, has_geometry, row_start, text_len, offset, dropout, threshold,
                       inv_keep, seed, bq, bk, n_qblk, n_kblk, s);
}

}  // extern "C"
