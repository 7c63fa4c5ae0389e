// Fused multi-head attention forward for the MarT towers, sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/attention.py:_fwd_kernel
// (launched by _fused_attention_fwd, the pl.pallas_call at :313). Contract:
//
//   out = softmax(scale * Q K^T (*) analogy multiplier + (1 - mask) * -1e4) V
//
// per (batch row, head), on the packed (B, L, heads * D) layout that the
// projection GEMMs produce, for input and output; D, the head width, is 64
// (BERT-base, ViT-B) or 128 (ViLBERT's visual stream), each its own
// instantiation, or any other width up to 256 through the instance of its
// padded width, in a library of its own (attention_width.cuh: rows staged
// and loaded element by element, zero beyond the real width, and a lane's
// columns stored where they are below it). Scores and softmax are in
// fp32; the probabilities are rounded to the compute dtype (the dtype of
// q/k/v) before the product with V, which accumulates in fp32. The analogy
// multiplier is computed inline from (row, col, boundary[b]) with the
// geometry of attention.py:_geometry_planes (row_start, text_len, offset);
// it is never stored as a plane. w = (w0, w1) arrives already clamped.
//
// Dropout uses the counter hash of the JAX kernel's interpret mode
// (attention.py:_dropout_keep): idx = row * Lk + col, x = idx ^ (seed *
// 0x9E3779B9), two lowbias32 rounds, keep where x >= uint32(rate * 2^32),
// with the per-(b, head) seed of attention.py:_cell_seed, seed + b *
// cell_stride + head (b * heads + head on one device; a rank of a mesh
// passes the global head count as the stride and folds the global cell of
// its first row and head into the seed). The plain PyTorch
// version (kernels/attention.py:fused_attention_reference) uses the same
// hash, so the two agree mask for mask. The TPU's hardware random bits are
// not reproduced.
//
// What bounds it: bytes. At the main-path shapes (L <= 227, head_dim 64)
// each (b, head) does ~4 * Lq * Lk * 64 flops on 4 * L * 64 * 2 bytes, far
// below the H100's ~295 flop/byte balance point. So the design reads each
// of q, k, v once from device memory and writes the context once, and keeps
// everything in between (scores, probabilities, the dropout mask) in shared
// memory and registers:
//   - one block per (query tile of 64 rows, head, batch row); the block
//     stages that head's K and V slices (Lk x 64, strided out of the packed
//     layout, 16-byte loads) in shared memory, rows padded by 16 bytes so
//     that lanes reading different rows hit different banks;
//   - each warp takes one query row at a time: the row lives in registers,
//     lane j scores keys j, j+32, ...; the fp32 score row is kept in shared
//     memory for the max / exp / sum / normalise / dropout passes; then lane
//     l accumulates output columns 2l and 2l+1 over all keys.
// The products run on the CUDA cores, not the tensor cores (no mma.sync,
// wgmma or TMA yet): a simple kernel that is right first.
//
// Whole K/V slices in shared memory bound Lk: with the H100's 227 KB per
// block, up to 717 keys in bf16 and 400 in fp32 at D = 64, 400 and 212 at
// D = 128. At D = 128 a lane accumulates four output columns, 2l, 2l + 1
// of each 64-column half.
//
// Longer keys, and every call above D = 128 (where a query row of D floats
// would pass a thread's 255 registers), take the streaming form beside it
// (fused_attention_fwd_streaming_kernel), whose shared memory does not
// depend on Lk: the JAX kernel stages a head's whole K/V of any length
// (attention.py:_specs), so the port takes every Lk too (ViLT's 418 keys in
// fp32 at L = 128). A block of 16 warps takes the same 64 query rows, 4 a
// warp, and stages its Q tile once; the keys come in chunks of 32, one a
// lane, staged by the whole block, in three sweeps that recompute each
// score with the same instructions: the rows' max over every key, then
// their sums of exp(s - max), then p = exp(s - max) / sum, dropped and
// rounded, and P V. A lane sums keys lane, lane + 32, ... in order and a
// row's P V runs over the keys in order, as the resident form does, so the
// two give the same numbers bit for bit (138 KB a block at D = 256 in
// fp32). mkg_fused_attention_fwd_smem reports the form a call takes; the
// wrapper holds it against the device's limit all the same.
//
// The score is rounded as the plain version rounds it
// (kernels/attention.py:_score): fmaf(acc, scale, bias) without a geometry,
// fmaf(acc * scale, w or 1, bias) with one, acc * scale rounded first. At
// D = 64 (scale 2^-3) the two agree; at D = 128 (2^-3.5) they do not.

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
constexpr int kRowsPerBlock = 64;
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

// value after a round trip through T (the cast of the probabilities)
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

// The score of an fp32 product sum, as the plain version rounds it.
__device__ __forceinline__ float score(float acc, float scale, int has_geometry, bool region,
                                       float w, float bias) {
  return has_geometry ? fmaf(__fmul_rn(acc, scale), region ? w : 1.0f, bias)
                      : fmaf(acc, scale, bias);
}

template <typename T, int D>
struct Layout {
  static constexpr int kChunk = 16 / sizeof(T);              // elements per 16 B
  static constexpr int kStride = D + kChunk;                 // padded smem row
  static size_t smem_bytes(int lk) {
    const size_t lk4 = (lk + 3) & ~3;
    return 2 * size_t(lk) * kStride * sizeof(T) + lk4 * sizeof(float) * (1 + kWarps);
  }
};

// Whether a call of Lk keys takes the resident form: the head's whole K
// and V fit a block, and its query row fits a thread's registers.
template <typename T, int D>
bool resident(int lk) {
  return D <= 128 && Layout<T, D>::smem_bytes(lk) <= size_t(attention_width::smem_optin());
}

// The streaming form: 16 warps of 4 query rows, keys in chunks of 32.
constexpr int kStreamWarps = 16;
constexpr int kStreamThreads = kStreamWarps * 32;
constexpr int kStreamRows = kRowsPerBlock / kStreamWarps;  // query rows a warp
constexpr int kKeyChunk = 32;                              // keys a chunk, one a lane

template <typename T, int D>
struct StreamLayout {
  static constexpr int kStride = Layout<T, D>::kStride;
  // the Q tile, one chunk of K and of V, the chunk's biases, and a row of a
  // chunk's probabilities for each (warp, query row)
  static constexpr size_t bytes =
      size_t(kRowsPerBlock + 2 * kKeyChunk) * kStride * sizeof(T) +
      size_t(kKeyChunk) * sizeof(float) * (1 + kStreamWarps * kStreamRows);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fused_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ mask,
                           const int* __restrict__ boundary,
                           const float* __restrict__ w, T* __restrict__ out,
                           int lq, int lk, int num_heads, float scale,
                           int has_geometry, int row_start, int text_len, int offset,
                           int dropout, uint32_t threshold, float keep_div,
                           uint32_t seed, uint32_t cell_stride, int head_dim) {
  constexpr int kChunk = Layout<T, D>::kChunk;
  constexpr int kStride = Layout<T, D>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + size_t(lk) * kStride;
  float* bias_s = reinterpret_cast<float*>(vs + size_t(lk) * kStride);
  const int lk4 = (lk + 3) & ~3;

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int d = kRagged ? head_dim : D;
  const int hd = num_heads * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* srow = bias_s + lk4 * (1 + warp);

  // Stage this head's K and V slices and the padding bias row.
  const T* kb = k + size_t(b) * lk * hd + h * d;
  const T* vb = v + size_t(b) * lk * hd + h * d;
  if constexpr (kRagged) {
    attention_width::stage_rows<D>(ks, kStride, kb, lk, hd, d);
    attention_width::stage_rows<D>(vs, kStride, vb, lk, hd, d);
  } else {
    constexpr int kChunksPerRow = D / kChunk;
    for (int i = threadIdx.x; i < lk * kChunksPerRow; i += kThreads) {
      const int j = i / kChunksPerRow, c = (i % kChunksPerRow) * kChunk;
      *reinterpret_cast<uint4*>(ks + j * kStride + c) =
          *reinterpret_cast<const uint4*>(kb + size_t(j) * hd + c);
      *reinterpret_cast<uint4*>(vs + j * kStride + c) =
          *reinterpret_cast<const uint4*>(vb + size_t(j) * hd + c);
    }
  }
  for (int j = threadIdx.x; j < lk; j += kThreads) {
    bias_s[j] = (1.0f - mask[size_t(b) * lk + j]) * kNegBias;
  }
  __syncthreads();

  const int bnd = has_geometry ? boundary[b] + offset : 0;
  const float w0 = has_geometry ? w[0] : 1.0f;
  const float w1 = has_geometry ? w[1] : 1.0f;
  const uint32_t seed_mix =
      (seed + uint32_t(b) * cell_stride + uint32_t(h)) * 0x9E3779B9u;
  const int r_end = min(lq, (tile + 1) * kRowsPerBlock);

  for (int r = tile * kRowsPerBlock + warp; r < r_end; r += kWarps) {
    // The query row, in registers, in every lane.
    const T* qr = q + (size_t(b) * lq + r) * hd + h * d;
    float qf[D];
    if constexpr (kRagged) {
      attention_width::load_row<D>(qr, qf, d);
    } else {
#pragma unroll
      for (int c = 0; c < D; c += kChunk) load_chunk(qr + c, qf + c);
    }

    // Row half of the analogy geometry (attention.py:_geometry_planes).
    bool row_in_scope = false;
    float row_w = 1.0f;
    if (has_geometry) {
      const bool row_is_example = r >= row_start && r < bnd;
      const bool row_is_answer = r >= bnd;
      row_in_scope = (row_is_example || row_is_answer) && r < text_len;
      row_w = row_is_example ? w0 : w1;
    }

    float mx = -FLT_MAX;
    for (int j = lane; j < lk; j += 32) {
      const T* kr = ks + j * kStride;
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < D; c += kChunk) {
        float kf[kChunk];
        load_chunk(kr + c, kf);
#pragma unroll
        for (int i = 0; i < kChunk; ++i) acc = fmaf(qf[c + i], kf[i], acc);
      }
      const bool region = row_in_scope && j >= bnd && j < text_len;
      const float s = score(acc, scale, has_geometry, region, row_w, bias_s[j]);
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < lk; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < lk; j += 32) {
      float p = srow[j] / sum;
      if (dropout) {
        p = dropout_keep(uint32_t(r) * uint32_t(lk) + uint32_t(j), seed_mix, threshold)
                ? p / keep_div
                : 0.0f;
      }
      srow[j] = round_to(p, q);
    }
    __syncwarp();

#pragma unroll
    for (int c0 = 0; c0 < D; c0 += 64) {
      const int col = c0 + 2 * lane;
      if (kRagged && col >= d) continue;  // beyond the head's columns
      float a0 = 0.0f, a1 = 0.0f;
      const T* vcol = vs + col;
#pragma unroll 4
      for (int j = 0; j < lk; ++j) {
        const float p = srow[j];
        const float2 vv = load_pair(vcol + j * kStride);
        a0 = fmaf(p, vv.x, a0);
        a1 = fmaf(p, vv.y, a1);
      }
      T* orow = out + (size_t(b) * lq + r) * hd + h * d;
      if constexpr (kRagged) {
        attention_width::store_pair(orow, col, d, a0, a1);
      } else {
        store_pair(orow + col, a0, a1);
      }
    }
    __syncwarp();  // srow is rewritten by this warp's next row
  }
}

// Any Lk and any D up to 256: three sweeps over the keys in chunks of 32.
template <typename T, int D>
__global__ void __launch_bounds__(kStreamThreads)
fused_attention_fwd_streaming_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, const float* __restrict__ mask,
                                     const int* __restrict__ boundary,
                                     const float* __restrict__ w, T* __restrict__ out,
                                     int lq, int lk, int num_heads, float scale,
                                     int has_geometry, int row_start, int text_len,
                                     int offset, int dropout, uint32_t threshold,
                                     float keep_div, uint32_t seed, uint32_t cell_stride,
                                     int head_dim) {
  constexpr int kStride = Layout<T, D>::kStride;
  constexpr int kPairs = (D + 63) / 64;  // column pairs 2 lane + 64 c a lane owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kRowsPerBlock * kStride;
  T* vs = ks + kKeyChunk * kStride;
  float* bias_s = reinterpret_cast<float*>(vs + kKeyChunk * kStride);

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int d = kRagged ? head_dim : D;
  const int hd = num_heads * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* p_s = bias_s + kKeyChunk * (1 + kStreamRows * warp);  // kStreamRows rows of 32
  const int row0 = tile * kRowsPerBlock;
  const int n_rows = min(kRowsPerBlock, lq - row0);
  stage_block<D, kStride>(qs, q + (size_t(b) * lq + row0) * hd + h * d, n_rows, hd, d);
  // (the first chunk's barrier publishes qs)

  const int bnd = has_geometry ? boundary[b] + offset : 0;
  const float w0 = has_geometry ? w[0] : 1.0f;
  const float w1 = has_geometry ? w[1] : 1.0f;
  const uint32_t seed_mix =
      (seed + uint32_t(b) * cell_stride + uint32_t(h)) * 0x9E3779B9u;
  const T* kb = k + size_t(b) * lk * hd + h * d;
  const T* vb = v + size_t(b) * lk * hd + h * d;

  // this warp's rows: local row il = warp + kStreamWarps * t
  float mx[kStreamRows], sum[kStreamRows];
  float2 acc[kStreamRows][kPairs];
#pragma unroll
  for (int t = 0; t < kStreamRows; ++t) {
    mx[t] = -FLT_MAX;
    sum[t] = 0.0f;
#pragma unroll
    for (int c = 0; c < kPairs; ++c) acc[t][c] = make_float2(0.0f, 0.0f);
  }

  // sweep 0: each row's max; 1: its sum of exp(s - max); 2: p, P V
  for (int sweep = 0; sweep < 3; ++sweep) {
    for (int j0 = 0; j0 < lk; j0 += kKeyChunk) {
      const int n = min(kKeyChunk, lk - j0);
      __syncthreads();  // the chunk buffers are free
      stage_block<D, kStride>(ks, kb + size_t(j0) * hd, n, hd, d);
      if (sweep == 2) stage_block<D, kStride>(vs, vb + size_t(j0) * hd, n, hd, d);
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
        float s = 0.0f;
        if (lane < n) {
          // the row half of the analogy geometry, as the resident form has it
          bool row_in_scope = false;
          float row_w = 1.0f;
          if (has_geometry) {
            const bool row_is_example = r >= row_start && r < bnd;
            const bool row_is_answer = r >= bnd;
            row_in_scope = (row_is_example || row_is_answer) && r < text_len;
            row_w = row_is_example ? w0 : w1;
          }
          const attention_width::HeadRow<D, T, false> qrow(qs + il * kStride);
          const bool region = row_in_scope && j >= bnd && j < text_len;
          s = score(qrow.dot(ks + lane * kStride), scale, has_geometry, region, row_w,
                    bias_s[lane]);
        }
        if (sweep == 0) {
          if (lane < n) mx[t] = fmaxf(mx[t], s);
        } else if (sweep == 1) {
          if (lane < n) sum[t] += expf(s - mx[t]);
        } else {
          float p = 0.0f;
          if (lane < n) {
            p = expf(s - mx[t]) / sum[t];
            if (dropout) {
              p = dropout_keep(uint32_t(r) * uint32_t(lk) + uint32_t(j), seed_mix, threshold)
                      ? p / keep_div
                      : 0.0f;
            }
            p = round_to(p, q);
          }
          float* prow = p_s + kKeyChunk * t;
          prow[lane] = p;
          __syncwarp();
#pragma unroll
          for (int c = 0; c < kPairs; ++c) {
            const int col = 64 * c + 2 * lane;
            if (kRagged && col >= d) continue;  // beyond the head's columns
            float2 x = acc[t][c];
            const T* vcol = vs + col;
#pragma unroll 4
            for (int jj = 0; jj < n; ++jj) {
              const float pj = prow[jj];
              const float2 vv = load_pair(vcol + jj * kStride);
              x.x = fmaf(pj, vv.x, x.x);
              x.y = fmaf(pj, vv.y, x.y);
            }
            acc[t][c] = x;
          }
          __syncwarp();  // prow is rewritten for the next chunk
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kStreamRows; ++t) {
      if (sweep == 0) mx[t] = warp_max(mx[t]);
      if (sweep == 1) sum[t] = warp_sum(sum[t]);
    }
  }

#pragma unroll
  for (int t = 0; t < kStreamRows; ++t) {
    const int il = warp + kStreamWarps * t;
    if (il >= n_rows) continue;
    T* orow = out + (size_t(b) * lq + row0 + il) * hd + h * d;
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      const int col = 64 * c + 2 * lane;
      if constexpr (kRagged) {
        attention_width::store_pair(orow, col, d, acc[t][c].x, acc[t][c].y);
      } else {
        store_pair(orow + col, acc[t][c].x, acc[t][c].y);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* boundary, const void* w, void* out, int batch, int lq,
           int lk, int num_heads, float scale, int has_geometry, int row_start,
           int text_len, int offset, int dropout, uint32_t threshold,
           float keep_div, uint32_t seed, uint32_t cell_stride, int head_dim,
           cudaStream_t stream) {
  const bool whole = resident<T, D>(lk);
  const size_t smem = whole ? Layout<T, D>::smem_bytes(lk) : StreamLayout<T, D>::bytes;
  auto kernel = fused_attention_fwd_streaming_kernel<T, D>;
  if constexpr (D <= 128) {
    if (whole) kernel = fused_attention_fwd_kernel<T, D>;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((lq + kRowsPerBlock - 1) / kRowsPerBlock, num_heads, batch);
  kernel<<<grid, whole ? kThreads : kStreamThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const int*>(boundary),
      static_cast<const float*>(w), static_cast<T*>(out), lq, lk, num_heads, scale,
      has_geometry, row_start, text_len, offset, dropout, threshold, keep_div, seed,
      cell_stride, head_dim);
  return int(cudaGetLastError());
}

template <typename T, int D>
size_t smem_bytes(int lk) {
  return resident<T, D>(lk) ? Layout<T, D>::smem_bytes(lk) : StreamLayout<T, D>::bytes;
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one block of the form a call of Lk keys takes
// needs (the wrapper holds it against the device's opt-in limit before
// launching); 0 for a head width the library does not take.
size_t mkg_fused_attention_fwd_smem(int lk, int is_bf16, int head_dim) {
  return attention_width::with_width(head_dim, size_t(0), [&](auto width) {
    constexpr int D = decltype(width)::value;
    return attention_width::with_type(is_bf16, size_t(0),
                                      [&](auto t) { return smem_bytes<decltype(t), D>(lk); });
  });
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// head_dim is 64 or 128 (or, in a library of one padded width, any width
// that rounds up to it).
int mkg_fused_attention_fwd(const void* q, const void* k, const void* v,
                            const void* mask, const void* boundary, const void* w,
                            void* out, int batch, int lq, int lk, int num_heads,
                            int head_dim, int is_bf16, float scale, int has_geometry,
                            int row_start, int text_len, int offset, int dropout,
                            unsigned int threshold, float keep_div, unsigned int seed,
                            unsigned int cell_stride, void* stream) {
  return attention_width::with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    constexpr int D = decltype(width)::value;
    return attention_width::with_type(is_bf16, int(cudaErrorInvalidValue), [&](auto t) {
      return launch<decltype(t), D>(q, k, v, mask, boundary, w, out, batch, lq, lk, num_heads,
                                    scale, has_geometry, row_start, text_len, offset, dropout,
                                    threshold, keep_div, seed, cell_stride, head_dim,
                                    static_cast<cudaStream_t>(stream));
    });
  });
}

}  // extern "C"
