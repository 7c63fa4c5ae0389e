// Fused multi-head attention forward on the tensor cores, bf16, sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/attention.py:_fwd_kernel
// (launched by _fused_attention_fwd) for bf16 inputs, which every main path
// runs. Contract, per (batch row, head), on the packed (B, L, heads * 64)
// layout in and out:
//
//   out = softmax(scale * Q K^T (*) analogy multiplier + (1 - mask) * -1e4) V
//
// What bounds it: bytes (attention_mma.cuh has the count). The CUDA-core
// kernel it takes over from (fused_attention_fwd.cu, which keeps fp32: TF32
// cannot meet the fp32 bar of 2e-5) was paced by shared-memory bandwidth and
// FMA throughput instead: one warp per query row re-read the head's whole K and V
// for every row, and at 418 keys its 120 KB of staged K and V left one block
// an SM. The design here:
//   - a block takes one (query tile of 64 rows, head, batch row); four
//     warps of 16 rows each; both products are mma.sync m16n8k16 with
//     fragments from ldmatrix (.trans for V), so a K or V fragment read
//     once from shared memory serves 16 rows;
//   - K and V come in chunks of 64 keys by 16-byte cp.async, one commit
//     group a chunk, so every load of a block is in flight before its first
//     product;
//   - the contract's cast points want the probabilities normalised before
//     they are rounded to bf16, so a row's max and sum must be known before
//     its first P V step. Up to 256 keys (the three MKGformer shapes, the
//     image tool's ViT) the whole score row stays in accumulator registers
//     (16 x Lk fp32 a warp, 32 registers a thread a chunk) and every chunk
//     of K and V in shared memory (fwd_resident_kernel<2>: 45.5 KB a block,
//     <4>: 82.5 KB): one Q K^T, one exponential an element. Above that
//     (ViLT's 418) the keys are swept twice through two buffers
//     (fwd_streaming_kernel, 45.5 KB a block whatever Lk, so several blocks
//     stay resident an SM): sweep 0 streams K alone and keeps each row's
//     running max and sum, rescaled when the max moves; sweep 1 streams K
//     and V and recomputes the same score tiles with the same instructions,
//     bit for bit. The second Q K^T costs tensor-core time a byte-bound
//     kernel has to spare;
//   - either way p = exp(s - m) / l is dropped (p / (1 - rate) by the
//     counter hash of attention_mma.cuh, index row * Lk + col), rounded to
//     bf16, and two 16 x 8 accumulator tiles are repacked as the A fragment
//     of P V: no probability passes through shared memory;
//   - bias, multiplier, max, exp, sum, dropout and rounding work on the
//     accumulator fragment: a lane holds rows g and g + 8 (g = lane / 4),
//     columns 2t and 2t + 1 (t = lane % 4) of each 16 x 8 tile, and computes
//     the geometry and the dropout index from those coordinates. A score
//     is one FMA from the accumulator, on the plain version's fp32 grid
//     (attention_mma.cuh: scores).
// Ragged edges: rows beyond Lq are zero-filled and not stored; keys beyond
// Lk are padding of the chunk, not masked keys: they are zero-filled, their
// bias is -inf, so they take no part in max or sum and their probability is
// exactly 0. exp is ex2.approx, within 2 ulp of fp32: far inside the bf16
// bar.

#include "attention_mma.cuh"

using namespace attention_mma;

namespace {

constexpr int kMaxResidentKeys = 4 * kTile;

constexpr int resident_smem(int nc) {
  return (1 + 2 * nc) * kTileBytes + nc * kTile * int(sizeof(float));
}

struct Args {
  const bf16 *q, *k, *v;
  const float* mask;
  const int* boundary;
  const float* w;
  bf16* out;
  int lq, lk, num_heads;
  float scale;
  int has_geometry, row_start, text_len, offset, dropout;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
};

// What a lane knows of its two rows (row_g and row_g + 8 of the tile).
struct Lane {
  Geometry geo;
  uint32_t seed_mix;
  int row_g;
  float c_plain;   // scale
  float c_row[2];  // scale times the row's multiplier at answer columns

  __device__ __forceinline__ Lane(const Args& a, int b, int h, int row0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    geo = load_geometry(a.has_geometry, a.row_start, a.text_len, a.offset, a.boundary, a.w, b);
    seed_mix = (a.seed + uint32_t(b * a.num_heads + h)) * 0x9E3779B9u;
    row_g = row0 + warp * 16 + (lane >> 2);
    c_plain = a.scale;
    c_row[0] = c_plain * geo.row(row_g).w;
    c_row[1] = c_plain * geo.row(row_g + 8).w;
  }
};

// One chunk's scores -> probabilities: normalised, dropped, in place, ready
// for the rounding of pack_a.
__device__ __forceinline__ void probabilities(float (&s)[8][4], const float (&m)[2],
                                              const float (&inv_l)[2], const Args& a,
                                              const Lane& ln, int key0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp_minus_max(s[nt][e], m[r]) * inv_l[r];
      if (a.dropout) {
        const uint32_t idx = uint32_t(ln.row_g + 8 * r) * uint32_t(a.lk) +
                             uint32_t(key0 + nt * 8 + 2 * t + (e & 1));
        p = dropout_keep(idx, ln.seed_mix, a.threshold) ? p * a.inv_keep : 0.0f;
      }
      s[nt][e] = p;
    }
  }
}

__device__ __forceinline__ float row_exp_sum(const float (&s)[8][4], int r, float m) {
  float sum = 0.0f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    sum += exp_minus_max(s[nt][2 * r], m) + exp_minus_max(s[nt][2 * r + 1], m);
  }
  return sum;
}

// Up to 64 NC keys: the score row in registers, every chunk in shared
// memory, one sweep.
template <int NC>
__global__ void __launch_bounds__(kThreads) fwd_resident_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTileElems;       // NC chunks
  bf16* v_s = k_s + NC * kTileElems;  // NC chunks
  float* bias_s = reinterpret_cast<float*>(v_s + NC * kTileElems);  // NC rows of 64

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = a.num_heads * kHeadDim;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int row0 = tile * kTile;
  const int n_chunks = (a.lk + kTile - 1) / kTile;  // <= NC

  // every load of the block, one commit group a chunk: Q with K's first
  const bf16* kb = a.k + size_t(b) * a.lk * hd + h * kHeadDim;
  const bf16* vb = a.v + size_t(b) * a.lk * hd + h * kHeadDim;
  stage_tile(q_s, a.q + (size_t(b) * a.lq + row0) * hd + h * kHeadDim, a.lq - row0, hd);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c < n_chunks) {
      stage_tile(k_s + c * kTileElems, kb + size_t(c) * kTile * hd, a.lk - c * kTile, hd);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c < n_chunks) {
      stage_tile(v_s + c * kTileElems, vb + size_t(c) * kTile * hd, a.lk - c * kTile, hd);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    stage_bias(bias_s + c * kTile, a.mask + size_t(b) * a.lk, c * kTile, a.lk);
  }
  const Lane ln(a, b, h, row0);

  uint32_t qa[4][4];
  float s[NC][8][4];
  float m[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    cp_async_wait_pending(2 * NC - 1 - c);
    __syncthreads();
    if (c == 0) load_a(qa, q_s + warp * 16 * kStride);
    if (c < n_chunks) {
      zero(s[c]);
      product_nt(s[c], qa, k_s + c * kTileElems);
      scores(s[c], ln.geo.answer_bits(c * kTile + 2 * t), ln.c_plain, ln.c_row,
                  bias_s + c * kTile, m);
    }
  }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = quad_max(m[r]);
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < n_chunks) sum += row_exp_sum(s[c], r, m[r]);
    }
    inv_l[r] = 1.0f / quad_sum(sum);
  }

  float o[8][4];
  zero(o);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    cp_async_wait_pending(NC - 1 - c);
    __syncthreads();
    if (c < n_chunks) {
      probabilities(s[c], m, inv_l, a, ln, c * kTile);
      uint32_t pa[4][4];
      pack_a(pa, s[c]);
      product_nn(o, pa, v_s + c * kTileElems);
    }
  }
  store_rows(a.out + (size_t(b) * a.lq + row0 + warp * 16) * hd + h * kHeadDim, hd,
             a.lq - row0 - warp * 16, q_s + warp * 16 * kStride, o);
}

// Any Lk: two sweeps over the keys through two buffers.
__global__ void __launch_bounds__(kThreads) fwd_streaming_kernel(const Args a) {
  __shared__ __align__(16) bf16 q_s[kTileElems];
  __shared__ __align__(16) bf16 k_s[2][kTileElems];
  __shared__ __align__(16) bf16 v_s[2][kTileElems];
  __shared__ __align__(8) float bias_s[2][kTile];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = a.num_heads * kHeadDim;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int row0 = tile * kTile;

  const bf16* kb = a.k + size_t(b) * a.lk * hd + h * kHeadDim;
  const bf16* vb = a.v + size_t(b) * a.lk * hd + h * kHeadDim;
  const float* mask_b = a.mask + size_t(b) * a.lk;
  const int n_chunks = (a.lk + kTile - 1) / kTile;
  const int n_items = 2 * n_chunks;  // sweep 0 then sweep 1

  auto load_item = [&](int it) {
    const int buf = it & 1;
    const int key0 = (it >= n_chunks ? it - n_chunks : it) * kTile;
    stage_tile(k_s[buf], kb + size_t(key0) * hd, a.lk - key0, hd);
    if (it >= n_chunks) stage_tile(v_s[buf], vb + size_t(key0) * hd, a.lk - key0, hd);
    stage_bias(bias_s[buf], mask_b, key0, a.lk);
    cp_async_commit();
  };

  stage_tile(q_s, a.q + (size_t(b) * a.lq + row0) * hd + h * kHeadDim, a.lq - row0, hd);
  load_item(0);  // one group with the Q tile
  const Lane ln(a, b, h, row0);

  uint32_t qa[4][4];
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.0f, 0.0f}, inv_l[2] = {0.0f, 0.0f};
  float o[8][4];
  zero(o);

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) {
      load_item(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) load_a(qa, q_s + warp * 16 * kStride);
    const int buf = it & 1;
    const bool second = it >= n_chunks;
    const int key0 = (second ? it - n_chunks : it) * kTile;

    float s[8][4];
    float cmax[2] = {-FLT_MAX, -FLT_MAX};
    zero(s);
    product_nt(s, qa, k_s[buf]);
    scores(s, ln.geo.answer_bits(key0 + 2 * t), ln.c_plain, ln.c_row, bias_s[buf], cmax);

    if (!second) {
      // sweep 0: running max and sum of each row (a lane's share of the sum)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(cmax[r]));
        l[r] = l[r] * exp_minus_max(m[r], m_new) + row_exp_sum(s, r, m_new);
        m[r] = m_new;
      }
      if (it == n_chunks - 1) {
        inv_l[0] = 1.0f / quad_sum(l[0]);
        inv_l[1] = 1.0f / quad_sum(l[1]);
      }
    } else {
      // sweep 1: probabilities, normalised, dropped, then rounded; P V
      probabilities(s, m, inv_l, a, ln, key0);
      uint32_t pa[4][4];
      pack_a(pa, s);
      product_nn(o, pa, v_s[buf]);
    }
    __syncthreads();  // the buffer is refilled by the load after next
  }
  store_rows(a.out + (size_t(b) * a.lq + row0 + warp * 16) * hd + h * kHeadDim, hd,
             a.lq - row0 - warp * 16, q_s + warp * 16 * kStride, o);
}

template <int NC>
int launch_resident(const Args& a, dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fwd_resident_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         resident_smem(NC));
  if (err != cudaSuccess) return int(err);
  fwd_resident_kernel<NC><<<grid, kThreads, resident_smem(NC), stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// q, k, v and out are bf16, packed (B, L, heads * 64); inv_keep is
// 1 / (1 - rate).
int mkg_fused_attention_fwd_mma(const void* q, const void* k, const void* v, const void* mask,
                                const void* boundary, const void* w, void* out, int batch,
                                int lq, int lk, int num_heads, float scale, int has_geometry,
                                int row_start, int text_len, int offset, int dropout,
                                unsigned int threshold, float inv_keep, unsigned int seed,
                                void* stream) {
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const float*>(mask),
               static_cast<const int*>(boundary), static_cast<const float*>(w),
               static_cast<bf16*>(out), lq, lk, num_heads, scale, has_geometry, row_start,
               text_len, offset, dropout, threshold, inv_keep, seed};
  const dim3 grid((lq + kTile - 1) / kTile, num_heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lk <= 2 * kTile) return launch_resident<2>(a, grid, s);
  if (lk <= kMaxResidentKeys) return launch_resident<4>(a, grid, s);
  fwd_streaming_kernel<<<grid, kThreads, 0, s>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
