// Tensor-core building blocks of the attention kernels, sm_90a, bf16.
//
// Shared by fused_attention_fwd_mma.cu and fused_attention_bwd_mma.cu, the
// bf16 kernels that replace the TPU kernels
// mkg_analogy_tpu/kernels/attention.py:_fwd_kernel and :_bwd_kernel, and
// written so that the flash kernels can include it too: nothing here knows
// how a kernel walks its keys.
//
// What bounds the kernels built from it: bytes. A (batch row, head) of the
// main path does 4-10 * Lq * Lk * 64 flops on 4-7 * L * 64 * 2 bytes, far
// below the H100's ~295 flop/byte balance point, so the products must cost
// almost nothing beside the loads. On the CUDA cores they did not: one warp
// per query row re-read the head's whole K and V from shared memory for
// every row. Here every product is
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (bf16 operands, fp32
// accumulators: the contract of the TPU kernel's dot_general with
// preferred_element_type=float32), a warp owns 16 rows, and one ldmatrix of
// an operand tile serves all 16.
//
// Fragment layout relied on (PTX ISA, mma.m16n8k16 with .bf16), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major)  reg0 (g, 2t..2t+1)      reg1 (g + 8, 2t..2t+1)
//                           reg2 (g, 2t+8..2t+9)    reg3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, "col")       reg0 (k = 2t..2t+1, n = g)   reg1 (k = 2t+8.., n = g)
//   C (16 x 8, fp32)        c0, c1 (g, 2t..2t+1)    c2, c3 (g + 8, 2t..2t+1)
// So two neighbouring 16 x 8 accumulator tiles, rounded to bf16 and packed
// in pairs, are the A fragment of the next product (pack_a): probabilities
// and dS never pass through shared memory. A tile is 64 rows of D bf16 in
// shared memory (D the tile width: 64, 128 for ViLBERT's visual stream, or
// another multiple of 16 up to 128, or 192 or 256, attention_width.cuh),
// rows padded to D + 8 (144 or 272 bytes at 64 or 128, 528 at 256, an odd
// count of 16-byte units at every D), so the eight 16-byte rows one
// ldmatrix phase reads fall in eight different 16-byte bank groups. The
// same tile feeds a product as "rows x depth" (ldmatrix, product_nt: Q K^T,
// g V^T, K Q^T, V g^T; the depth is the tile width) and as "depth x
// columns" (ldmatrix.trans,
// product_nn: P V, dS K, P^T g, dS^T Q; the block's cols_of<D>() result
// columns: all D below 128, 64 from 128 up, so at D = 128 a block computes
// one half of its head's result columns, at 256 one quarter). Every helper
// that addresses a tile takes D as its first template argument, 64 by
// default.
//
// Tile widths other than 64 and 128 (registers by ptxas -v, PERF.md): a
// block owns all its D result columns at every D up to 112, so its result
// accumulators grow to 14 tiles of 16 x 8 at 112 (56 registers a thread)
// where 128's halves keep 8; the halves' split would pay the score row
// twice for a remainder of 16-48 columns. At 192 and 256 (the padded
// widths above 128) a block owns 64 columns, as at 128, and no A fragments
// are held for a sweep: each product over the depth loads them 64 columns
// at a time (product_a), the score and dP tiles being recomputed by each of
// the 3 or 4 blocks of a head.
//
// Cast points live in the kernels, not here. fp32 inputs do not come this
// way: TF32 keeps ~3 decimal digits and the fp32 kernels are held to 2e-5,
// so they stay on the CUDA cores (fused_attention_fwd.cu, _bwd.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cfloat>
#include <cmath>

#include "attention_width.cuh"

namespace attention_mma {

using bf16 = __nv_bfloat16;
using attention_width::kRagged;

constexpr int kHeadDim = 64;          // the default head width
constexpr int kTile = 64;            // rows of a block's tile and of a streamed chunk
constexpr int kWarps = 4;            // 16 rows of the tile each
constexpr int kThreads = kWarps * 32;
constexpr float kNegBias = -10000.0f;            // reference padding bias

// The padded shared-memory row of a tile of head width D, in bf16; a tile's
// elements and bytes.
template <int D>
__host__ __device__ constexpr int stride_of() { return D + 8; }
template <int D>
__host__ __device__ constexpr int tile_elems() { return kTile * stride_of<D>(); }
template <int D>
__host__ __device__ constexpr int tile_bytes() { return tile_elems<D>() * int(sizeof(bf16)); }

constexpr int kStride = stride_of<kHeadDim>();
constexpr int kTileElems = tile_elems<kHeadDim>();
constexpr int kTileBytes = tile_bytes<kHeadDim>();

// The blocks that share a head's result columns (its column groups): from
// D = 128 up, D / 64 blocks of 64 columns each (two halves at 128, three at
// 192, four at 256), one block below 128; and the result columns a block
// owns. Every block of a group computes the whole score row (its depth is
// D), so a thread's result accumulators stay those of D = 64 however wide
// the head.
template <int D>
__host__ __device__ constexpr int groups_of() {
  static_assert((D % 16 == 0 && D >= 16 && D <= 128) || D == 192 || D == 256,
                "tile width: a multiple of 16 to 128, or 192 or 256");
  return D < 128 ? 1 : D / 64;
}
template <int D>
__host__ __device__ constexpr int cols_of() { return D / groups_of<D>(); }

// The call's head width: D itself, or (in a library of one padded width)
// the width the call passed in its arguments' `d`. The forwards keep the
// constant D where the library is of 64 and 128, without this call: read
// through it, the streaming forward at 128 took 148 registers, not 130,
// and the forwards ran 1.4-1.9% slower (PERF.md).
template <int D, class A>
__device__ __forceinline__ int head_width(const A& a) {
  if constexpr (kRagged) {
    return a.d;
  } else {
    return D;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing registers; zeros when !valid
// (src must still be a mapped address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The same for a count known only after a loop is unrolled (0..7; the
// instruction takes an immediate).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 7: cp_async_wait<7>(); break;
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage up to 64 rows of D columns of one head (`ld` elements apart in
// global memory) into a padded tile with 16-byte cp.async; rows from
// `rows_valid` on are zero-filled, and so are the columns from `cols_valid`
// on (a library of one padded width: the head's real width ends there).
// src points at the tile's first row, which is always valid. The caller
// commits. Rows whose start is not 16-byte aligned (a width that is not a
// multiple of 8) are copied element by element, synchronously: visible
// after the same barrier as a cp.async, and the commit groups stay empty.
// The index is unsigned: a signed one costs the division and the modulo
// their sign fix-ups (3% of the forward's time at 64, measured).
template <int D = kHeadDim>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int rows_valid, int ld,
                                           int cols_valid = D) {
  constexpr unsigned kPieces = D / 8;  // 16-byte pieces a row
  if constexpr (!kRagged) {
    for (unsigned i = threadIdx.x; i < kTile * kPieces; i += kThreads) {
      const int r = int(i / kPieces), c = int(i % kPieces) * 8;
      const bool valid = r < rows_valid;
      cp_async_16(dst + r * stride_of<D>() + c, src + size_t(valid ? r : 0) * ld + c, valid);
    }
  } else if (attention_width::rows_aligned(src, ld, min(cols_valid, D), 2)) {
    for (unsigned i = threadIdx.x; i < kTile * kPieces; i += kThreads) {
      const int r = int(i / kPieces), c = int(i % kPieces) * 8;
      const bool valid = r < rows_valid && c < cols_valid;
      cp_async_16(dst + r * stride_of<D>() + c, src + (valid ? size_t(r) * ld + c : 0), valid);
    }
  } else {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
    uint16_t* t = reinterpret_cast<uint16_t*>(dst);
    for (unsigned i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = int(i / D), c = int(i % D);
      t[r * stride_of<D>() + c] = r < rows_valid && c < cols_valid ? s[size_t(r) * ld + c] : 0;
    }
  }
}

// The A fragments (KD depth steps of 16: the head width D / 16) of a warp's
// 16 rows of a tile.
template <int D = kHeadDim, int KD>
__device__ __forceinline__ void load_a(uint32_t (&a)[KD][4], const bf16* rows) {
  const int lane = threadIdx.x & 31;
  const bf16* p = rows + (lane & 15) * stride_of<D>() + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < KD; ++ks) ldmatrix_x4(a[ks], p + ks * 16);
}

// Both products walk the depth in steps of 16 and, within a step, first
// load the B fragments and then run the mma.sync, one for each accumulator
// tile: up to eight independent accumulations stand between two uses of the
// same accumulator, which hides the tensor pipe's latency (the asm
// statements are volatile, so this order is the order executed).

// c[nt] (16 x 8 each, 8 NT columns in all: 64, or 32 for half a tile) +=
// A * tile^T: column n of the result is row n of the tile, the depth is the
// head dimension (16 KD of the tile's columns).
template <int D = kHeadDim, int NT, int KD>
__device__ __forceinline__ void product_nt(float (&c)[NT][4], const uint32_t (&a)[KD][4],
                                           const bf16* tile) {
  constexpr int kS = stride_of<D>();
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + ((lane & 7) + 8 * (lane >> 4)) * kS + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int ks = 0; ks < KD; ++ks) {
    uint32_t b[NT / 2][4];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) ldmatrix_x4(b[np], p + np * 16 * kS + ks * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      mma_bf16(c[2 * np], a[ks], b[np][0], b[np][1]);
      mma_bf16(c[2 * np + 1], a[ks], b[np][2], b[np][3]);
    }
  }
}

// The A fragments of a warp's 16 rows that a product over the whole depth
// D holds for its sweep: all D / 16 of them up to D = 128 (load_a); none
// above, where 64 or more registers of them beside the score, dP and result
// tiles would spill, and product_a reads them again 64 columns at a time.
template <int D, int KD>
__device__ __forceinline__ void load_a_held(uint32_t (&a)[KD][4], const bf16* rows) {
  if constexpr (D <= 128) load_a<D>(a, rows);
}

// c += A * tile^T over the whole depth D (product_nt), A a warp's 16 rows
// of a tile in shared memory (`rows`): from the held fragments `a` up to
// D = 128, from depth slices of 64 columns loaded in turn above. The
// slices walk the depth in the order product_nt walks it, so each
// accumulator sees the same mma.sync in the same order either way.
template <int D, int NT, int KD>
__device__ __forceinline__ void product_a(float (&c)[NT][4], const uint32_t (&a)[KD][4],
                                          const bf16* rows, const bf16* tile) {
  if constexpr (D <= 128) {
    product_nt<D>(c, a, tile);
  } else {
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 64) {
      uint32_t slice[4][4];
      load_a<D>(slice, rows + d0);
      product_nt<D>(c, slice, tile + d0);
    }
  }
}

// c[nt] (16 x 8 each, 8 NT head columns from `tile`, which may point at a
// tile's second half: 64 by default, a block's cols_of<D>() in general;
// NT even) += A * tile: the depth is the tile's first 16 KS rows (64, or 32
// for half a tile), a[ks] covering rows 16 ks .. 16 ks + 15.
template <int D = kHeadDim, int KS, int NT>
__device__ __forceinline__ void product_nn(float (&c)[NT][4], const uint32_t (&a)[KS][4],
                                           const bf16* tile) {
  static_assert(NT % 2 == 0, "column tiles in pairs of 16 columns");
  constexpr int kS = stride_of<D>();
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (lane & 15) * kS + 8 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t b[NT / 2][4];
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) ldmatrix_x4_trans(b[dp], p + ks * 16 * kS + dp * 16);
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      mma_bf16(c[2 * dp], a[ks], b[dp][0], b[dp][1]);
      mma_bf16(c[2 * dp + 1], a[ks], b[dp][2], b[dp][3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2 KS 16 x 8 fp32 tiles (16 x 64, or 16 x 32), rounded to bf16 (nearest
// even: the cast to the compute dtype), as the KS A fragments of the next
// product.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4], const float (&c)[2 * KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    a[ks][0] = pack_bf16(c[2 * ks][0], c[2 * ks][1]);
    a[ks][1] = pack_bf16(c[2 * ks][2], c[2 * ks][3]);
    a[ks][2] = pack_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1]);
    a[ks][3] = pack_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3]);
  }
}

// A row's values lie in the four lanes of a quad (t = 0..3).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A warp's 16 x 8 NT fp32 result (64 columns by default), rounded to bf16,
// through its own 16 rows of a tile of width D in shared memory (which no
// other warp touches; its first 8 NT columns) to global memory in 16-byte
// pieces; rows from `rows_valid` on and columns from `cols_valid` on are
// not stored (element by element where the rows are not 16-byte aligned,
// as stage_tile loads them).
template <int D = kHeadDim, int NT>
__device__ __forceinline__ void store_rows(bf16* dst, int ld, int rows_valid, bf16* rows,
                                           const float (&c)[NT][4], int cols_valid = 8 * NT) {
  constexpr int kS = stride_of<D>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<uint32_t*>(rows + g * kS + nt * 8 + 2 * t) =
        pack_bf16(c[nt][0], c[nt][1]);
    *reinterpret_cast<uint32_t*>(rows + (g + 8) * kS + nt * 8 + 2 * t) =
        pack_bf16(c[nt][2], c[nt][3]);
  }
  __syncwarp();
  if (!kRagged || attention_width::rows_aligned(dst, ld, min(cols_valid, 8 * NT), 2)) {
#pragma unroll
    for (int i = lane; i < 16 * NT; i += 32) {
      // (at NT = 8 the shifts of the 64-column form, whose registers the
      // instances of 64 and 128 were tuned with)
      const int r = NT == 8 ? i >> 3 : i / NT, col = (NT == 8 ? i & 7 : i % NT) * 8;
      if (r < rows_valid && (!kRagged || col < cols_valid)) {
        *reinterpret_cast<uint4*>(dst + size_t(r) * ld + col) =
            *reinterpret_cast<const uint4*>(rows + r * kS + col);
      }
    }
  } else {
    for (int i = lane; i < 16 * 8 * NT; i += 32) {
      const int r = i / (8 * NT), col = i % (8 * NT);
      if (r < rows_valid && col < cols_valid) dst[size_t(r) * ld + col] = rows[r * kS + col];
    }
  }
}

// The counter hash of the JAX kernel's interpret mode
// (attention.py:_dropout_keep): idx = row * Lk + col, seed_mix = (seed +
// b * heads + h) * 0x9E3779B9, two lowbias32 rounds, keep where
// x >= uint32(rate * 2^32).
__device__ __forceinline__ bool dropout_keep(uint32_t idx, uint32_t seed_mix,
                                             uint32_t threshold) {
  uint32_t x = idx ^ seed_mix;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return x >= threshold;
}

// The analogy geometry of attention.py:_geometry_planes from (row, col,
// boundary[b] + offset): the score of an in-scope row at an answer column
// is multiplied by w0 (example rows: region 0 of the dw sums) or w1 (the
// other in-scope rows: region 1).
struct RowGeometry {
  bool in_scope;
  bool is_example;
  float w;  // the row's multiplier at an answer column (1 out of scope)
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
      g.w = g.in_scope ? (is_example ? w0 : w1) : 1.0f;
    }
    return g;
  }
  __device__ __forceinline__ bool col_is_answer(int j) const {
    return has && j >= bnd && j < text_len;
  }
  // Bit 2 nt + j: whether column col0 + 8 nt + j is an answer column; a
  // lane's 16 columns of a 64-column chunk, col0 = chunk start + 2t.
  __device__ __forceinline__ uint32_t answer_bits(int col0) const {
    uint32_t bits = 0u;
    if (has) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          bits |= uint32_t(col_is_answer(col0 + 8 * nt + j)) << (2 * nt + j);
        }
      }
    }
    return bits;
  }
};

__device__ __forceinline__ Geometry load_geometry(int has, int row_start, int text_len,
                                                  int offset, const int* boundary,
                                                  const float* w, int b) {
  return Geometry{has, row_start, text_len, has ? boundary[b] + offset : 0,
                  has ? w[0] : 1.0f, has ? w[1] : 1.0f};
}

// A score is one FMA from the product's accumulator, s = acc * c + bias,
// with c = scale (* the row's multiplier at an answer column) and bias =
// (1 - mask) * -1e4, or -inf for the padding of a chunk beyond Lk, whose
// probability is thereby exactly 0 and which no max sees. The plain version
// (kernels/attention.py:_score) rounds as XLA does inside the JAX kernels,
// acc * scale + bias in one FMA, or s_raw * w + bias with s_raw = acc *
// scale; at head_dim 64 the scale is 2^-3, so s_raw and scale * w are exact
// and this FMA is the plain version's, given the same acc. That matters
// where every key of a row is masked: its scores sit at -1e4, where an fp32
// ulp is 9.8e-4, and only scores quantised on the plain version's grid give
// its probabilities (base-2 scores, log2(e) folded into c and bias, land on
// another grid, and a fifth of such a row's probabilities then round to the
// neighbouring bf16). exp(s - m) is ex2.approx of (s - m) * log2(e): the difference
// first, so that the row's largest score gives exactly 1.
//
// At head_dim 128 the scale is 2^-3.5 and that fold leaves the plain
// version's grid where a multiplier applies, so ScoreRule<128> keeps the
// plain version's two roundings there: without a geometry s = fmaf(acc,
// scale, bias), as at 64; with one s_raw = acc * scale is rounded first
// (pre = scale) and s = fmaf(s_raw, w or 1, bias) (c = w or 1).
//
// A library of one padded width (attention_width.cuh) keeps the two
// roundings at every width, 64 included: its scale is d^-1/2 of the real
// width, a power of two only at d = 1, 4, 16 and 64, where the two forms
// agree anyway.
template <int D>
__device__ __forceinline__ float score_of(float acc, float pre, float c, float bias) {
  if constexpr (D == 64 && !kRagged) {
    return fmaf(acc, c, bias);
  } else {
    return fmaf(__fmul_rn(acc, pre), c, bias);
  }
}

template <int D>
struct ScoreRule {
  float pre;      // the factor rounded into acc first (D = 128 with a geometry)
  float c_plain;  // c outside the answer region

  __device__ __forceinline__ ScoreRule(float scale, int has_geometry) {
    const bool two_step = (D != 64 || kRagged) && has_geometry;
    pre = two_step ? scale : 1.0f;
    c_plain = two_step ? 1.0f : scale;
  }
  // c at an answer column of a row whose multiplier is w (exact at 64)
  __device__ __forceinline__ float c_answer(float w) const { return c_plain * w; }
  __device__ __forceinline__ float score(float acc, float c, float bias) const {
    return score_of<D>(acc, pre, c, bias);
  }
};

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float exp_minus_max(float s, float m) {
  return ex2((s - m) * kLog2e);
}

// The bias of one chunk's 64 columns (threads 0..63 write; visible after
// the block's next barrier).
__device__ __forceinline__ void stage_bias(float* bias_chunk, const float* mask_b, int key0,
                                           int lk) {
  if (threadIdx.x < kTile) {
    const int col = key0 + threadIdx.x;
    bias_chunk[threadIdx.x] = col < lk ? (1.0f - mask_b[col]) * kNegBias : -INFINITY;
  }
}

// s = acc * c + bias on a 16 x 64 fragment, in place (by ScoreRule<D> with
// `pre` at D = 128); c is c_row[r] at the lane's answer columns (abits) and
// c_plain elsewhere. Folds the max of each of the lane's two rows over its
// columns into cmax. A causal call (row_g >= 0, a library of one padded
// width only) gives a key after the row (col > row) the score -inf before
// any max sees it, as the padding beyond Lk has: its probability is
// exactly 0. row_g is the lane's first row (its second row_g + 8), col0 the
// chunk's first key plus 2t.
template <int D = kHeadDim>
__device__ __forceinline__ void scores(float (&s)[8][4], uint32_t abits, float c_plain,
                                       const float (&c_row)[2], const float* bias_chunk,
                                       float (&cmax)[2], float pre = 1.0f, int row_g = -1,
                                       int col0 = 0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 bias = *reinterpret_cast<const float2*>(bias_chunk + nt * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, j = e & 1;
      const float c = (abits >> (2 * nt + j)) & 1u ? c_row[r] : c_plain;
      s[nt][e] = score_of<D>(s[nt][e], pre, c, j ? bias.y : bias.x);
      if constexpr (kRagged) {
        if (row_g >= 0 && col0 + nt * 8 + j > row_g + 8 * r) s[nt][e] = -INFINITY;
      }
      cmax[r] = fmaxf(cmax[r], s[nt][e]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.0f;
}

}  // namespace attention_mma
