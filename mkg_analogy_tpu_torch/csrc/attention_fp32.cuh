// The tiled fp32 attention kernels (fused_attention_fwd.cu, and the two
// backward passes of attention_fp32_bwd.cuh, which fused_attention_bwd.cu
// and flash_attention_bwd.cu instantiate): what they share.
//
// Every block takes a tile of 64 rows (query rows, or keys in the dK/dV
// pass) against the other side, which comes in tiles of kN rows through a
// cp.async ring of one or two buffers. Its 256 threads own a register
// micro-tile of each 64 x kN product: thread (ty, tx) = (threadIdx.x / 16,
// threadIdx.x % 16) owns rows ty, ty + 16, ty + 32, ty + 48 against the
// other side's rows tx, tx + 16, ... (kN / 16 of them). A depth step reads
// a float4 of each of its four rows (two distinct addresses in a warp: a
// broadcast) and of each of its kN / 16 other rows, and feeds them into
// 4 x 4 x kN / 16 FMAs. Staged rows are padded by 4 floats, so the 16 rows
// a warp reads in one instruction fall on distinct banks in two
// wavefronts.
//
// The second product of each pass (P V, dS K, P~^T g, dS^T q) takes the
// 64 x kN tile of probabilities (or dS) back from shared memory, where each
// half-warp wrote the rows it alone reads (a __syncwarp, no barrier), and
// multiplies it into a per-thread accumulator of 4 rows x kCols / 16
// result columns of the block's kCols: float4 pieces 64 apart where kCols
// is a multiple of 64, single columns 16 apart otherwise, conflict-free
// either way.
//
// Every product is an exact fp32 FMA chain on the CUDA cores (no TF32: the
// fp32 bars are 2e-5 and TF32 keeps three digits). A score's dot product
// runs over the depth in column order, one fmaf a column, in every pass and
// in the forward, so the dq and dK/dV passes recompute the forward's scores
// bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_width.cuh"

namespace attention_fp32 {

using attention_width::kRagged;

constexpr int kRows = 64;              // rows a block owns (query rows or keys)
constexpr int kPad = 4;                // floats padding each staged row of a head
constexpr float kNegBias = -10000.0f;  // reference padding bias

// The 256 threads of a block: 16 row groups of 4 rows (thread row group ty
// owns rows ty, ty + 16, ty + 32, ty + 48 of the 64) times kG = 16 threads
// a row group (tx), a row group's threads in one half-warp, so its
// reductions are shuffles. (8 threads a row group, 128 threads and a
// micro-tile twice as large, read half the shared-memory wavefronts a
// product and ran slower on an H100 at every shape tried: 8 warps an SM
// hide less latency than 16.)
constexpr int kG = 16;
constexpr int kThreads = 16 * kG;
__device__ __forceinline__ int team_tx() { return threadIdx.x % kG; }
__device__ __forceinline__ int team_ty() { return threadIdx.x / kG; }
__device__ __forceinline__ int team_row(int ty, int i) { return ty + 16 * i; }
// The row stride of a 64 x kN tile that each row group writes its rows of:
// the warp's two consecutive rows, kN + kG floats apart, write their kG
// columns and read their float4s on distinct banks.
template <int kN>
__host__ __device__ constexpr int p_stride() { return kN + kG; }

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Columns of the result a block owns: all of them up to 128, 64 above (a
// head of 192 or 256 columns takes 3 or 4 blocks, each recomputing the
// scores over the full depth, as groups_of does for the tensor-core
// kernels), so a thread's accumulators stay at 4 x 16 or fewer.
template <int D>
__host__ __device__ constexpr int cols_of() { return D <= 128 ? D : 64; }
template <int D>
__host__ __device__ constexpr int groups_of() { return D / cols_of<D>(); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zero where !valid
// (src is then not read).
__device__ __forceinline__ void cp_async_16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage kR rows of kC columns of one head (rows `ld` floats apart in global
// memory, src at the tile's first row) into shared-memory rows `stride`
// floats apart, with every thread of the block: rows from rows_valid and
// columns from cols_valid on are zero (past the sequence; past the real
// width in a library of one padded width). 16-byte cp.async pieces where
// every row of the head is 16-byte aligned (always in the libraries of 64
// and 128), the caller commits; else element by element, synchronously,
// visible after the same barrier.
template <int kR, int kC>
__device__ __forceinline__ void stage(float* dst, int stride, const float* src, int ld,
                                      int rows_valid, int cols_valid, bool aligned) {
  if (aligned) {
    constexpr unsigned kPieces = kC / 4;
    for (unsigned i = threadIdx.x; i < kR * kPieces; i += kThreads) {
      const int r = int(i / kPieces), c = int(i % kPieces) * 4;
      const bool valid = r < rows_valid && c < cols_valid;
      cp_async_16(dst + r * stride + c, valid ? src + size_t(r) * ld + c : src, valid);
    }
  } else {
    for (unsigned i = threadIdx.x; i < kR * kC; i += kThreads) {
      const int r = int(i / kC), c = int(i % kC);
      dst[r * stride + c] = r < rows_valid && c < cols_valid ? src[size_t(r) * ld + c] : 0.0f;
    }
  }
}

// s[i][t] += A[ty + 16 i] . B[tx + kG t] over D columns of two staged tiles
// (rows `stride` floats apart), one fmaf a column, in column order; R of a
// thread's rows (4, or fewer where a block's valid rows fit in 16 R).
template <int D, int T, int R>
__device__ __forceinline__ void row_dots(float (&s)[R][T], const float* A, const float* B,
                                         int stride, int ty, int tx) {
  const float* a = A + ty * stride;
  const float* b = B + tx * stride;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 av[R], bv[T];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = *reinterpret_cast<const float4*>(a + 16 * i * stride + c);
#pragma unroll
    for (int t = 0; t < T; ++t) bv[t] = *reinterpret_cast<const float4*>(b + kG * t * stride + c);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        s[i][t] = fmaf(av[i].x, bv[t].x, s[i][t]);
        s[i][t] = fmaf(av[i].y, bv[t].y, s[i][t]);
        s[i][t] = fmaf(av[i].z, bv[t].z, s[i][t]);
        s[i][t] = fmaf(av[i].w, bv[t].w, s[i][t]);
      }
    }
  }
}

// The result columns of thread tx, m < kCols / kG: float4 pieces 64
// apart (4 tx + 64 (m / 4) + m % 4) where kCols is a multiple of 64, else
// single columns kG apart (tx + kG m).
template <int kCols>
__host__ __device__ constexpr bool vec_cols() { return kCols % (4 * kG) == 0; }
template <int kCols>
__device__ __forceinline__ int col_of(int tx, int m) {
  if constexpr (vec_cols<kCols>()) {
    return (m / 4) * 4 * kG + 4 * tx + (m % 4);
  } else {
    return tx + kG * m;
  }
}

template <int kCols>
__device__ __forceinline__ void load_cols(const float* row, int tx, float (&x)[kCols / kG]) {
  constexpr int NC = kCols / kG;
  if constexpr (vec_cols<kCols>()) {
#pragma unroll
    for (int g = 0; g < NC / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(row + 4 * kG * g + 4 * tx);
      x[4 * g] = v.x;
      x[4 * g + 1] = v.y;
      x[4 * g + 2] = v.z;
      x[4 * g + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < NC; ++m) x[m] = row[tx + kG * m];
  }
}

__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// acc[i][m] += sum over j < kN of P[ty + 16 i][j] * X[j][col_of(m)]: the
// 64 x kN tile P (rows `pstride` apart) into the thread's R x kCols / kG
// accumulators, X's rows `xstride` apart, j in order.
template <int kN, int kCols, int R>
__device__ __forceinline__ void p_times(float (&acc)[R][kCols / kG], const float* P,
                                        int pstride, const float* X, int xstride, int ty,
                                        int tx) {
  constexpr int NC = kCols / kG;
  const float* p = P + ty * pstride;
#pragma unroll 2
  for (int j = 0; j < kN; j += 4) {
    float4 pv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      pv[i] = *reinterpret_cast<const float4*>(p + 16 * i * pstride + j);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float x[NC];
      load_cols<kCols>(X + (j + u) * xstride, tx, x);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pij = part(pv[i], u);
#pragma unroll
        for (int m = 0; m < NC; ++m) acc[i][m] = fmaf(pij, x[m], acc[i][m]);
      }
    }
  }
}

// Store a thread's kCols / kG results of one row (`row` points at its
// column col0 of the head): columns below cols_valid only; float4 pieces
// where aligned.
template <int kCols>
__device__ __forceinline__ void store_row(float* row, const float (&a)[kCols / kG], int tx,
                                          int cols_valid, bool aligned) {
  constexpr int NC = kCols / kG;
  if constexpr (vec_cols<kCols>()) {
    if (aligned) {
#pragma unroll
      for (int g = 0; g < NC / 4; ++g) {
        if (4 * kG * g + 4 * tx < cols_valid) {
          *reinterpret_cast<float4*>(row + 4 * kG * g + 4 * tx) =
              make_float4(a[4 * g], a[4 * g + 1], a[4 * g + 2], a[4 * g + 3]);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int m = 0; m < NC; ++m) {
    const int c = col_of<kCols>(tx, m);
    if (c < cols_valid) row[c] = a[m];
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The counter hash of the JAX interpret-mode _dropout_keep
// (kernels/attention.py:hash_keep): idx = row * Lk + col, seed_mix = (seed +
// b * cell_stride + head) * 0x9E3779B9, two lowbias32 rounds.
__device__ __forceinline__ bool dropout_keep(uint32_t idx, uint32_t seed_mix,
                                             uint32_t threshold) {
  uint32_t x = idx ^ seed_mix;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return x >= threshold;
}

// The analogy geometry of attention.py:_geometry_planes: whether row r is
// in scope (and below Lq), whether it is an example row (region 0) or not
// (region 1), and its multiplier w0 or w1; whether key j is an answer
// column.
struct RowGeometry {
  bool in_scope;
  bool is_example;
  float w;
};

struct Geometry {
  int has, row_start, text_len, bnd, lq;
  float w0, w1;

  __device__ __forceinline__ RowGeometry row(int r) const {
    RowGeometry g{false, false, 1.0f};
    if (has) {
      const bool is_example = r >= row_start && r < bnd;
      g.in_scope = (is_example || r >= bnd) && r < text_len && r < lq;
      g.is_example = is_example;
      g.w = is_example ? w0 : w1;
    }
    return g;
  }
  __device__ __forceinline__ bool col_is_answer(int j) const {
    return has && j >= bnd && j < text_len;
  }
};

// (s_raw, s) of an fp32 dot product, as the plain version rounds them
// (kernels/attention.py:_score, XLA's contraction inside the JAX kernels):
// s_raw = acc * scale rounded; s one FMA, fmaf(acc, scale, bias) without a
// geometry, fmaf(s_raw, w or 1, bias) with one.
__device__ __forceinline__ float score(float acc, float s_raw, float scale, int has_geometry,
                                       bool region, float w, float bias) {
  return has_geometry ? fmaf(s_raw, region ? w : 1.0f, bias) : fmaf(acc, scale, bias);
}

// The arguments of every launch.
struct Args {
  const float *q, *k, *v, *g, *mask, *w;
  const int* boundary;
  const float* out;  // the backward's: the forward's output, for delta
  float* lse;        // (B, heads, Lq, 2): the forward writes it, the backward reads it;
                     // flash: (B, heads, Lq), row 3's log-sum-exp
  float *o, *dq, *dk, *dv;
  float* delta;    // (B, heads, Lq): the dq pass writes rowsum(g * out), the dK/dV pass
                   // reads it; flash: the wrapper's, both passes read it
  float* dw_part;  // the (dw0, dw1) partials: (B, heads, ceil(Lq / 64), 2) of the
                   // single-block dq pass, (B, heads, ceil(Lk / 64), 2) of the flash dK/dV pass
  int lq, lk, num_heads, head_dim, has_geometry, row_start, text_len, offset, dropout;
  uint32_t threshold, seed, cell_stride;
  float scale, keep;  // keep: the forward's divisor 1 - rate, the backward's 1 / (1 - rate)
  int bq, bk, n_qblk, n_kblk;  // the flash call's logical tiles (its dropout cells)
};

// Whether every row of one head (x at its first row, rows ld floats apart,
// d columns) can move in 16-byte pieces.
__device__ __forceinline__ bool head_aligned(const float* x, int ld, int d) {
  return !kRagged || attention_width::rows_aligned(x, ld, d, 4);
}

__device__ __forceinline__ Geometry geometry_of(const Args& a, int b) {
  return Geometry{a.has_geometry, a.row_start, a.text_len,
                  a.has_geometry ? a.boundary[b] + a.offset : 0, a.lq,
                  a.has_geometry ? a.w[0] : 1.0f, a.has_geometry ? a.w[1] : 1.0f};
}

__device__ __forceinline__ uint32_t seed_mix_of(const Args& a, int b, int h) {
  return (a.seed + uint32_t(b) * a.cell_stride + uint32_t(h)) * 0x9E3779B9u;
}

// f(std::integral_constant<int, D>{}) for this library's instance of a call
// of head width d, or `none`.
template <class R, class F>
R with_width(int d, R none, F&& f) {
  return attention_width::with_width(d, none, static_cast<F&&>(f));
}

template <class K>
int launch_kernel(K kernel, dim3 grid, size_t smem, const Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace attention_fp32
