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
// and dS never pass through shared memory. A tile is 64 rows of 64 bf16 in
// shared memory, rows padded to 72 (144 bytes), so the eight 16-byte rows
// one ldmatrix phase reads fall in eight different 16-byte bank groups.
// The same tile feeds a product as "rows x depth" (ldmatrix, product_nt:
// Q K^T, g V^T, K Q^T, V g^T) and as "depth x columns" (ldmatrix.trans,
// product_nn: P V, dS K, P^T g, dS^T Q).
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

namespace attention_mma {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;
constexpr int kTile = 64;            // rows of a block's tile and of a streamed chunk
constexpr int kWarps = 4;            // 16 rows of the tile each
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kHeadDim + 8;            // padded shared-memory row, bf16
constexpr int kTileElems = kTile * kStride;
constexpr int kTileBytes = kTileElems * int(sizeof(bf16));
constexpr float kNegBias = -10000.0f;            // reference padding bias

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

// Stage up to 64 rows of one head (64 bf16 each, `ld` elements apart in
// global memory) into a padded tile with 16-byte cp.async; rows from
// `rows_valid` on are zero-filled. src points at the tile's first row, which
// is always valid. The caller commits.
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int rows_valid, int ld) {
  for (int i = threadIdx.x; i < kTile * (kHeadDim / 8); i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool valid = r < rows_valid;
    cp_async_16(dst + r * kStride + c, src + size_t(valid ? r : 0) * ld + c, valid);
  }
}

// The A fragments (four depth steps of 16) of a warp's 16 rows of a tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* rows) {
  const int lane = threadIdx.x & 31;
  const bf16* p = rows + (lane & 15) * kStride + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(a[ks], p + ks * 16);
}

// Both products walk the depth in steps of 16 and, within a step, first
// load the B fragments and then run the mma.sync, one for each accumulator
// tile: up to eight independent accumulations stand between two uses of the
// same accumulator, which hides the tensor pipe's latency (the asm
// statements are volatile, so this order is the order executed).

// c[nt] (16 x 8 each, 8 NT columns in all: 64, or 32 for half a tile) +=
// A * tile^T: column n of the result is row n of the tile, the depth is the
// head dimension.
template <int NT>
__device__ __forceinline__ void product_nt(float (&c)[NT][4], const uint32_t (&a)[4][4],
                                           const bf16* tile) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + ((lane & 7) + 8 * (lane >> 4)) * kStride + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t b[NT / 2][4];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) ldmatrix_x4(b[np], p + np * 16 * kStride + ks * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      mma_bf16(c[2 * np], a[ks], b[np][0], b[np][1]);
      mma_bf16(c[2 * np + 1], a[ks], b[np][2], b[np][3]);
    }
  }
}

// c[nt] (16 x 8 each, the 64 head columns) += A * tile: the depth is the
// tile's first 16 KS rows (64, or 32 for half a tile), a[ks] covering rows
// 16 ks .. 16 ks + 15.
template <int KS>
__device__ __forceinline__ void product_nn(float (&c)[8][4], const uint32_t (&a)[KS][4],
                                           const bf16* tile) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (lane & 15) * kStride + 8 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t b[4][4];
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) ldmatrix_x4_trans(b[dp], p + ks * 16 * kStride + dp * 16);
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
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

// A warp's 16 x 64 fp32 result, rounded to bf16, through its own 16 rows of
// a tile in shared memory (which no other warp touches) to global memory in
// 16-byte pieces; rows from `rows_valid` on are not stored.
__device__ __forceinline__ void store_rows(bf16* dst, int ld, int rows_valid, bf16* rows,
                                           const float (&c)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<uint32_t*>(rows + g * kStride + nt * 8 + 2 * t) =
        pack_bf16(c[nt][0], c[nt][1]);
    *reinterpret_cast<uint32_t*>(rows + (g + 8) * kStride + nt * 8 + 2 * t) =
        pack_bf16(c[nt][2], c[nt][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * 8; i += 32) {
    const int r = i >> 3, col = (i & 7) * 8;
    if (r < rows_valid) {
      *reinterpret_cast<uint4*>(dst + size_t(r) * ld + col) =
          *reinterpret_cast<const uint4*>(rows + r * kStride + col);
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

// s = acc * c + bias on a 16 x 64 fragment, in place; c is c_row[r] at the
// lane's answer columns (abits) and c_plain elsewhere. Folds the max of
// each of the lane's two rows over its columns into cmax.
__device__ __forceinline__ void scores(float (&s)[8][4], uint32_t abits, float c_plain,
                                       const float (&c_row)[2], const float* bias_chunk,
                                       float (&cmax)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 bias = *reinterpret_cast<const float2*>(bias_chunk + nt * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, j = e & 1;
      const float c = (abits >> (2 * nt + j)) & 1u ? c_row[r] : c_plain;
      s[nt][e] = fmaf(s[nt][e], c, j ? bias.y : bias.x);
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
