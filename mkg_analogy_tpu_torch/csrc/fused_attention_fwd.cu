// Fused multi-head attention forward for the MarT towers, fp32, sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/attention.py:_fwd_kernel
// (:124, launched by _fused_attention_fwd, the pl.pallas_call at :313) on
// the fp32 route; bf16 takes the tensor-core kernel
// (fused_attention_fwd_mma.cu). Contract:
//
//   out = softmax(scale * Q K^T (*) analogy multiplier + (1 - mask) * -1e4) V
//
// per (batch row, head), on the packed (B, L, heads * D) layout that the
// projection GEMMs produce, in and out; D, the head width, is 64 or 128,
// each its own instantiation, or any other width up to 256 through the
// instance of its padded width, in a library of its own
// (attention_width.cuh: zero beyond the real width; rows staged element by
// element where a head's rows are not 16-byte aligned). The analogy
// multiplier is computed inline from (row, col, boundary[b]) with the
// geometry of attention.py:_geometry_planes (row_start, text_len, offset);
// it is never stored as a plane. w = (w0, w1) arrives already clamped. The
// score is rounded as the plain version rounds it (kernels/attention.py:
// _score): fmaf(acc, scale, bias) without a geometry, fmaf(acc * scale, w
// or 1, bias) with one, acc * scale rounded first.
//
// Dropout uses the counter hash of the JAX kernel's interpret mode
// (attention.py:_dropout_keep): idx = row * Lk + col, with the per-(b, head)
// seed of attention.py:_cell_seed, seed + b * cell_stride + head (a rank of
// a mesh passes the global head count as the stride and folds the global
// cell of its first row and head into the seed). The plain PyTorch version
// (kernels/attention.py:fused_attention_reference) uses the same hash, so
// the two agree mask for mask. The TPU's hardware random bits are not
// reproduced.
//
// What bounds it: fp32 operations. A (b, head) does 4 * Lq * Lk * d flops
// (Q K^T and P V) on 16 * L * d bytes: ~64 flops a byte at L = 128, d = 64,
// above the H100's fp32 balance point (67 TFLOP/s over 3.35 TB/s: 20). The
// CUDA cores' 67 TFLOP/s is the bound; no tensor-core format keeps the fp32
// bar of 2e-5 (TF32 keeps three digits). So the design keeps the FMA pipe
// fed (attention_fp32.cuh):
//   - one block of 256 threads per (query tile of 64 rows, head, batch row;
//     and above D = 128 per 64 output columns, each such block recomputing
//     the scores): it stages its Q tile once, and the keys come in tiles of
//     64 (D <= 64) or 32 through a double-buffered cp.async ring of K and V
//     tiles, so its shared memory does not depend on Lk (105 KB at D = 64,
//     111 KB at 128: two blocks an SM; 159 KB at 256);
//   - each thread owns a 4 x (tile / 16) register micro-tile of the 64 x
//     tile score block: a depth step reads 4 + tile / 16 float4s of shared
//     memory (the four query rows broadcast within a half-warp) for
//     16 x tile / 16 FMAs;
//   - online softmax, one sweep over the keys for every Lk: a row's running
//     max and sum (its 16 threads reduce with shuffles), the accumulators
//     rescaled when the max moves; the tile's probabilities go through
//     shared memory to the half-warp that owns their row, and the same
//     micro-tile scheme runs P V into 4 x (D / 16) output accumulators a
//     thread;
//   - it writes each row's (max, log of the sum), whose sum is the row's
//     log-sum-exp: the backward (fused_attention_bwd.cu) rebuilds P from it
//     in one sweep. The two terms stay apart because an fp32 lse near -1e4
//     (a row whose keys are all masked) would lose 2^-11 of it, 5e-4 of
//     every probability of the row, to rounding.
// Products are exact fp32 FMAs: no TF32 and no 3xTF32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fp32.cuh"

using namespace attention_fp32;

namespace {

template <int D>
struct Fwd {
  static constexpr int kKeys = D <= 64 ? 64 : 32;     // keys a tile
  static constexpr int kKpt = kKeys / kG;             // keys a thread
  static constexpr int kCols = cols_of<D>();          // output columns a block
  static constexpr int kNc = kCols / kG;              // output columns a thread
  static constexpr int kStride = D + kPad;            // Q and K rows
  static constexpr int kVStride = kCols + kPad;       // V rows (the block's columns)
  static constexpr int kPStride = p_stride<kKeys>();  // probability rows
  static constexpr size_t kFloats = size_t(kRows) * kStride + 2 * size_t(kKeys) * kStride +
                                    2 * size_t(kKeys) * kVStride + size_t(kRows) * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1) fwd_kernel(const Args a) {
  using S = Fwd<D>;
  constexpr int kKeys = S::kKeys, kKpt = S::kKpt, kCols = S::kCols, kNc = S::kNc;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kRows * S::kStride;              // two K tiles
  float* vs = ks + 2 * kKeys * S::kStride;           // two V tiles
  float* ps = vs + 2 * kKeys * S::kVStride;          // the tile's probabilities

  const int tile = blockIdx.x / groups_of<D>(), col0 = (blockIdx.x % groups_of<D>()) * kCols;
  const int h = blockIdx.y, b = blockIdx.z;
  const int d = kRagged ? a.head_dim : D;
  const int hd = a.num_heads * d, lq = a.lq, lk = a.lk;
  const int ty = team_ty(), tx = team_tx();
  const int row0 = tile * kRows;
  const float* qb = a.q + (size_t(b) * lq + row0) * hd + h * d;
  const float* kb = a.k + size_t(b) * lk * hd + h * d;
  const float* vb = a.v + size_t(b) * lk * hd + h * d + col0;
  const bool q_aligned = head_aligned(qb, hd, d);
  const bool kv_aligned = head_aligned(kb, hd, d) && head_aligned(vb - col0, hd, d);
  const int v_cols = min(kCols, d - col0);
  const int n_tiles = (lk + kKeys - 1) / kKeys;

  stage<kRows, D>(qs, S::kStride, qb, hd, min(kRows, lq - row0), d, q_aligned);
  stage<kKeys, D>(ks, S::kStride, kb, hd, min(kKeys, lk), d, kv_aligned);
  stage<kKeys, kCols>(vs, S::kVStride, vb, hd, min(kKeys, lk), v_cols, kv_aligned);
  cp_async_commit();

  const Geometry geo = geometry_of(a, b);
  const uint32_t seed_mix = seed_mix_of(a, b, h);
  RowGeometry rg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rg[i] = geo.row(row0 + team_row(ty, i));

  float m[4], l[4], acc[4][kNc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kNc; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kKeys;
    if (t + 1 < n_tiles) {
      const int buf = (t + 1) & 1, jn = j0 + kKeys, n = min(kKeys, lk - jn);
      stage<kKeys, D>(ks + buf * kKeys * S::kStride, S::kStride, kb + size_t(jn) * hd, hd,
                          n, d, kv_aligned);
      stage<kKeys, kCols>(vs + buf * kKeys * S::kVStride, S::kVStride,
                              vb + size_t(jn) * hd, hd, n, v_cols, kv_aligned);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + (t & 1) * kKeys * S::kStride;
    const float* vt = vs + (t & 1) * kKeys * S::kVStride;

    float s[4][kKpt];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int u = 0; u < kKpt; ++u) s[i][u] = 0.0f;
    }
    row_dots<D, kKpt>(s, qs, kt, S::kStride, ty, tx);

    // scores, the tile's row max, the running max and sum
    float mt[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int u = 0; u < kKpt; ++u) {
      const int j = j0 + tx + kG * u;
      const bool valid = j < lk;
      const float bias = valid ? (1.0f - a.mask[size_t(b) * lk + j]) * kNegBias : 0.0f;
      const bool answer = geo.col_is_answer(j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[i][u];
        s[i][u] = valid ? score(x, __fmul_rn(x, a.scale), a.scale, a.has_geometry,
                                rg[i].in_scope && answer, rg[i].w, bias)
                        : -INFINITY;
        mt[i] = fmaxf(mt[i], s[i][u]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], group_max(mt[i]));
      const float corr = expf(m[i] - m_new);  // 0 at the first tile
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < kNc; ++c) acc[i][c] *= corr;
      const int il = team_row(ty, i);
#pragma unroll
      for (int u = 0; u < kKpt; ++u) {
        float p = expf(s[i][u] - m_new);
        l[i] += p;
        if (a.dropout) {
          const uint32_t j = uint32_t(j0 + tx + kG * u);
          if (!dropout_keep(uint32_t(row0 + il) * uint32_t(lk) + j, seed_mix, a.threshold)) {
            p = 0.0f;
          }
        }
        ps[il * S::kPStride + tx + kG * u] = p;
      }
    }
    __syncwarp();  // a row's probabilities are read by the threads that wrote them
    p_times<kKeys, kCols>(acc, ps, S::kPStride, vt, S::kVStride, ty, tx);
    __syncthreads();  // the tile buffers and ps are free
  }

  const bool o_aligned = head_aligned(a.o + h * d, hd, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + team_row(ty, i);
    const float sum = group_sum(l[i]);
    if (r >= lq) continue;
    float norm = 1.0f / sum;
    if (a.dropout) norm = norm / a.keep;
#pragma unroll
    for (int c = 0; c < kNc; ++c) acc[i][c] *= norm;
    store_row<kCols>(a.o + (size_t(b) * lq + r) * hd + h * d + col0, acc[i], tx, d - col0,
                        o_aligned);
    if (col0 == 0 && tx == 0) {
      float* st = a.lse + ((size_t(b) * a.num_heads + h) * lq + r) * 2;
      st[0] = m[i];
      st[1] = logf(sum);
    }
  }
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory a block takes at this head width, whatever the
// lengths (the wrapper holds it against the device's opt-in limit before
// launching); 0 for a width the library does not take.
size_t mkg_fused_attention_fwd_smem(int head_dim) {
  return with_width(head_dim, size_t(0),
                    [&](auto width) { return Fwd<decltype(width)::value>::kBytes; });
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// fp32 q, k, v (B, Lq or Lk, heads * head_dim) and out likewise; lse
// (B, heads, Lq, 2) fp32, each row's max and log of its sum. head_dim is 64
// or 128 (or, in a library of one padded width, any width that rounds up
// to it); keep_div is 1 - rate.
int mkg_fused_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                            const void* boundary, const void* w, void* out, void* lse,
                            int batch, int lq, int lk, int num_heads, int head_dim,
                            float scale, int has_geometry, int row_start, int text_len,
                            int offset, int dropout, unsigned int threshold, float keep_div,
                            unsigned int seed, unsigned int cell_stride, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.mask = static_cast<const float*>(mask);
  a.boundary = static_cast<const int*>(boundary);
  a.w = static_cast<const float*>(w);
  a.o = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
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
  a.keep = keep_div;
  a.seed = seed;
  a.cell_stride = cell_stride;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    constexpr int D = decltype(width)::value;
    const dim3 grid(((lq + kRows - 1) / kRows) * groups_of<D>(), num_heads, batch);
    return launch_kernel(fwd_kernel<D>, grid, Fwd<D>::kBytes, a, s);
  });
}

}  // extern "C"
