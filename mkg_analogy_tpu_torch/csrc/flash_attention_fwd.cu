// K-blocked (flash) fused attention forward for the MarT towers, sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/flash_attention.py:
// _flash_fwd_kernel (launched by _flash_attention_fwd, the pl.pallas_call at
// :393) for fp32 inputs (bf16 takes the tensor-core kernel of
// flash_attention_fwd_mma.cu). Contract, per (batch row, head), on the
// packed (B, L, heads * D) layout in and out, D = 64 (BERT-base, ViT-B) or
// 128 (ViLBERT's visual stream: 1024 wide, 8 heads), each width its own
// instantiation, or any other width up to 256 through the instance of its
// padded width, in a library of its own (attention_width.cuh: rows staged
// element by element, zero beyond the real width; a lane's column pairs
// past it are neither summed nor stored):
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
// seed = seed + (cell * n_qblk + qb) * n_kblk + kb, cell = b * cell_stride
// + head (b * heads + head on one device; a rank of a mesh folds its first
// cell into the seed)
// (flash_attention.py:_tile_seed), applied to the unnormalised p after the
// sum. The plain version (kernels/flash_attention.py:flash_attention_reference)
// and the two backward kernels draw the same masks.
//
// A ragged last K tile: the kernel never reads keys past Lk. JAX gives those
// columns a -1e30 bias (_col_bias), so their exp-weights are exactly 0 and
// they change neither the tile max nor the sums: leaving them out gives the
// same numbers. The running max starts at -1e30 (:113), not -inf.
//
// What bounds it: at the main-path shapes (L <= 611) bytes; at L = 2048
// the 4 * Lq * Lk * D flops per (b, head) pass the H100's
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
//     2l+1 of each 64 columns: two at D = 64, four at 128); lane j scores
//     keys j, j + 32, ... of a chunk, its query row in D registers (read
//     from shared memory at every product above D = 128, where D registers
//     would pass a thread's 255: attention_width.cuh, HeadRow).
// Chunked staging keeps fp32 at bk = 512 within one block's shared memory
// (108.5 KB at D = 64, 148.5 KB at 128, 163.5 KB at 256 with chunks of 64
// keys; a whole 512-key K + V tile would be 256 KB or 512 KB). The
// products run on the CUDA cores (no mma.sync, wgmma or TMA yet): a simple
// kernel that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_width.cuh"

namespace {

using attention_width::kRagged;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 32;
constexpr int kRowsPerWarp = kRowsPerBlock / kWarps;
// Keys staged at a time: 128, or 64 above D = 128, where 128 rows of 192
// or 256 fp32 columns beside a 512-key tile's scores would pass a block's
// shared memory.
template <int D>
__host__ __device__ constexpr int chunk_of() { return D <= 128 ? 128 : 64; }
constexpr float kNegBias = -10000.0f;  // reference padding bias
constexpr float kHardMask = -1e30f;    // flash_attention.py:HARD_MASK

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

// The score of the fp32 product sum acc, as the plain version rounds it
// (kernels/attention.py:_score, XLA's contraction inside the JAX kernels):
// without a geometry one FMA, fmaf(acc, scale, bias); with one, s_raw =
// acc * scale rounded first, then fmaf(s_raw, w in the region or 1, bias).
// At head_dim 64 (scale 2^-3) s_raw is exact and the two forms agree; at
// 128 (2^-3.5) they do not, and where every key of a row is masked (scores
// at -1e4, an fp32 ulp 9.8e-4) the other form would move a probability by
// 1e-3 of itself. The backward kernels form the same score with the same
// operations.
__device__ __forceinline__ float score(float acc, float scale, int has_geometry, bool region,
                                       float w, float bias) {
  if (!has_geometry) return fmaf(acc, scale, bias);
  return fmaf(__fmul_rn(acc, scale), region ? w : 1.0f, bias);
}

template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);                // elements per 16 B
  static constexpr int kStride = D + kVec;                   // padded smem row
  // the block's q rows, one K or V chunk, the tile's bias row and the
  // tile's scores of every row
  static size_t smem_bytes(int bk) {
    return size_t(kRowsPerBlock + chunk_of<D>()) * kStride * sizeof(T) +
           size_t(bk) * sizeof(float) * (1 + kRowsPerBlock);
  }
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ mask,
                           const int* __restrict__ boundary,
                           const float* __restrict__ w, T* __restrict__ out,
                           float* __restrict__ lse, int lq, int lk, int num_heads,
                           float scale, int has_geometry, int row_start, int text_len,
                           int offset, int dropout, uint32_t threshold, float inv_keep,
                           uint32_t seed, uint32_t cell_stride, int bq,
                           int bk, int n_qblk, int n_kblk, int head_dim) {
  constexpr int kStride = Layout<T, D>::kStride;
  constexpr int kChunk = chunk_of<D>();
  // column pairs a lane owns: 2 lane + 64 c, c < kPairs (those below d)
  constexpr int kPairs = (D + 63) / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* cs = qs + kRowsPerBlock * kStride;                      // K or V chunk
  float* bias_s = reinterpret_cast<float*>(cs + kChunk * kStride);
  float* s_tile = bias_s + bk;                               // kRowsPerBlock x bk

  const int h = blockIdx.y, b = blockIdx.z;
  const int d = kRagged ? head_dim : D;
  const int hd = num_heads * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r_begin = blockIdx.x * kRowsPerBlock;
  const int n_rows = min(kRowsPerBlock, lq - r_begin);
  const size_t head_off = size_t(h) * d;

  stage<D>(qs, q + (size_t(b) * lq + r_begin) * hd + head_off, n_rows, hd, d);
  // (the first chunk's barrier publishes qs)

  const Geometry geo{has_geometry, row_start, text_len,
                     has_geometry ? boundary[b] + offset : 0,
                     has_geometry ? w[0] : 1.0f, has_geometry ? w[1] : 1.0f};
  const uint32_t cell = uint32_t(b) * cell_stride + uint32_t(h);

  // this warp's rows: local row il = warp + kWarps * t
  float m[kRowsPerWarp], l[kRowsPerWarp], alpha[kRowsPerWarp];
  float2 acc[kRowsPerWarp][kPairs], pv[kRowsPerWarp][kPairs];
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    m[t] = kHardMask;
    l[t] = 0.0f;
#pragma unroll
    for (int c = 0; c < kPairs; ++c) acc[t][c] = make_float2(0.0f, 0.0f);
  }

  for (int kb = 0; kb < n_kblk; ++kb) {
    const int c_begin = kb * bk;
    const int width = min(bk, lk - c_begin);  // real keys of this tile

    // 1. The tile's scores of every row, K staged chunk by chunk.
    for (int c0 = 0; c0 < width; c0 += kChunk) {
      const int n = min(kChunk, width - c0);
      __syncthreads();  // the chunk buffer is free
      stage<D>(cs, k + (size_t(b) * lk + c_begin + c0) * hd + head_off, n, hd, d);
      for (int j = threadIdx.x; j < n; j += kThreads) {
        bias_s[c0 + j] = (1.0f - mask[size_t(b) * lk + c_begin + c0 + j]) * kNegBias;
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t) {
        const int il = warp + kWarps * t;
        if (il < n_rows) {
          const RowGeometry rg = geo.row(r_begin + il);
          const attention_width::HeadRow<D, T> qrow(qs + il * kStride);
          float* srow = s_tile + il * bk;
          for (int j = lane; j < n; j += 32) {
            srow[c0 + j] = score(qrow.dot(cs + j * kStride), scale, has_geometry,
                                 rg.in_scope && geo.col_is_answer(c_begin + c0 + j), rg.w,
                                 bias_s[c0 + j]);
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
#pragma unroll
      for (int c = 0; c < kPairs; ++c) pv[t][c] = make_float2(0.0f, 0.0f);
    }

    // 3. p V over the tile, V staged chunk by chunk.
    for (int c0 = 0; c0 < width; c0 += kChunk) {
      const int n = min(kChunk, width - c0);
      __syncthreads();  // the chunk buffer is free; step 2 is done
      stage<D>(cs, v + (size_t(b) * lk + c_begin + c0) * hd + head_off, n, hd, d);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t) {
        const int il = warp + kWarps * t;
        if (il < n_rows) {
          const float* prow = s_tile + il * bk + c0;
          const T* vcol = cs + 2 * lane;
          float2 x[kPairs];
#pragma unroll
          for (int c = 0; c < kPairs; ++c) x[c] = pv[t][c];
#pragma unroll 4
          for (int j = 0; j < n; ++j) {
            const float p = prow[j];
#pragma unroll
            for (int c = 0; c < kPairs; ++c) {
              if (kRagged && 2 * lane + 64 * c >= d) continue;  // beyond the head
              const float2 vv = load_pair(vcol + j * kStride + 64 * c);
              x[c].x = fmaf(p, vv.x, x[c].x);
              x[c].y = fmaf(p, vv.y, x[c].y);
            }
          }
#pragma unroll
          for (int c = 0; c < kPairs; ++c) pv[t][c] = x[c];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
#pragma unroll
      for (int c = 0; c < kPairs; ++c) {
        acc[t][c].x = acc[t][c].x * alpha[t] + pv[t][c].x;
        acc[t][c].y = acc[t][c].y * alpha[t] + pv[t][c].y;
      }
    }
  }

  // out = acc / l, lse = m + log(l)
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int il = warp + kWarps * t;
    if (il < n_rows) {
      const int r = r_begin + il;
      T* orow = out + (size_t(b) * lq + r) * hd + head_off;
#pragma unroll
      for (int c = 0; c < kPairs; ++c) {
        const int col = 2 * lane + 64 * c;
        if constexpr (kRagged) {
          attention_width::store_pair(orow, col, d, acc[t][c].x / l[t], acc[t][c].y / l[t]);
        } else {
          store_pair(orow + col, acc[t][c].x / l[t], acc[t][c].y / l[t]);
        }
      }
      if (lane == 0) lse[(size_t(b) * num_heads + h) * lq + r] = m[t] + logf(l[t]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* boundary, const void* w, void* out, void* lse, int batch, int lq,
           int lk, int num_heads, float scale, int has_geometry, int row_start,
           int text_len, int offset, int dropout, uint32_t threshold, float inv_keep,
           uint32_t seed, uint32_t cell_stride, int bq, int bk,
           int n_qblk, int n_kblk, int head_dim, cudaStream_t stream) {
  const size_t smem = Layout<T, D>::smem_bytes(bk);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((lq + kRowsPerBlock - 1) / kRowsPerBlock, num_heads, batch);
  flash_attention_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const int*>(boundary),
      static_cast<const float*>(w), static_cast<T*>(out), static_cast<float*>(lse), lq, lk,
      num_heads, scale, has_geometry, row_start, text_len, offset, dropout, threshold,
      inv_keep, seed, cell_stride, bq, bk, n_qblk, n_kblk, head_dim);
  return int(cudaGetLastError());
}

template <int D>
size_t smem_of(int bk, int is_bf16) {
  return attention_width::with_type(
      is_bf16, size_t(0), [&](auto t) { return Layout<decltype(t), D>::smem_bytes(bk); });
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block for logical K tiles of bk keys at
// head_dim 64 or 128 (or a width of this library's padded one; the wrapper
// holds it against the device's opt-in limit before launching); 0 for
// another width.
size_t mkg_flash_attention_fwd_smem(int bk, int is_bf16, int head_dim) {
  return attention_width::with_width(head_dim, size_t(0), [&](auto width) {
    return smem_of<decltype(width)::value>(bk, is_bf16);
  });
}

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (cudaErrorInvalidValue for a head_dim this library does not take). out is
// (B, Lq, heads * head_dim) in the inputs' dtype, lse (B, heads, Lq) fp32.
int mkg_flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                            const void* boundary, const void* w, void* out, void* lse,
                            int batch, int lq, int lk, int num_heads, int head_dim,
                            int is_bf16, float scale, int has_geometry, int row_start,
                            int text_len, int offset, int dropout, unsigned int threshold,
                            float inv_keep, unsigned int seed, unsigned int cell_stride, int bq,
                            int bk, int n_qblk, int n_kblk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return attention_width::with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    constexpr int D = decltype(width)::value;
    return attention_width::with_type(is_bf16, int(cudaErrorInvalidValue), [&](auto t) {
      return launch<decltype(t), D>(q, k, v, mask, boundary, w, out, lse, batch, lq, lk,
                                    num_heads, scale, has_geometry, row_start, text_len, offset,
                                    dropout, threshold, inv_keep, seed, cell_stride, bq, bk,
                                    n_qblk, n_kblk, head_dim, s);
    });
  });
}

}  // extern "C"
