// Fused multi-head attention forward on the tensor cores, bf16, sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/attention.py:_fwd_kernel
// (launched by _fused_attention_fwd) for bf16 inputs, which every main path
// runs. Contract, per (batch row, head), on the packed (B, L, heads * D)
// layout in and out, D = 64 (BERT-base, ViT-B) or 128 (ViLBERT's visual
// stream: 1024 wide, 8 heads), each width its own instantiation, or any
// other width up to 256 through the instance of its padded width, in a
// library of its own (attention_width.cuh; MiniLM's 32, the small recipes'
// 16):
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
//     of K and V in shared memory (fwd_resident_kernel<64, 2>: 45.5 KB a
//     block, <64, 4>: 82.5 KB, <128, 2>: 69.5 KB): one Q K^T, one
//     exponential an element. Above that
//     (ViLT's 418) the keys are swept twice through two buffers
//     (fwd_streaming_kernel<64>, 45.5 KB a block whatever Lk, so several blocks
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
//   - at D = 128 a block owns 64 of its head's 128 output columns (a half,
//     from blockIdx.x): it computes the whole score row (the depth is 128)
//     and stages only its half of V, so the accumulators a thread holds are
//     those of D = 64 and the score row's cost is paid twice. Up to 128
//     keys are resident (fwd_resident_kernel<128, 2>), longer rows stream.
//     The score keeps the plain version's two roundings where a multiplier
//     applies (attention_mma.cuh: ScoreRule).
//   - at the other tile widths (16 to 112) a block owns all D columns
//     (cols_of<D>), with D / 8 accumulator tiles; up to 256 keys stay
//     resident at D <= 64, up to 128 above. At 192 and 256 (heads of 129
//     to 256 columns) three or four blocks own 64 output columns each, as
//     the halves at 128 do, and the score takes its Q fragments 64 columns
//     at a time from shared memory (attention_mma.cuh: product_a).
// Ragged edges: rows beyond Lq are zero-filled and not stored; keys beyond
// Lk are padding of the chunk, not masked keys: they are zero-filled, their
// bias is -inf, so they take no part in max or sum and their probability is
// exactly 0. exp is ex2.approx, within 2 ulp of fp32: far inside the bf16
// bar.

#include "attention_mma.cuh"

using namespace attention_mma;

namespace {

constexpr int kMaxResidentKeys = 4 * kTile;

// Q, NC chunks of K (D columns) and of the block's columns of V, and NC
// rows of 64 biases.
template <int D>
constexpr int resident_smem(int nc) {
  return (1 + nc) * tile_bytes<D>() + nc * tile_bytes<cols_of<D>()>() +
         nc * kTile * int(sizeof(float));
}

// Q, two buffers of K and of V's block columns, two rows of biases.
template <int D>
constexpr int streaming_smem() {
  return 3 * tile_bytes<D>() + 2 * tile_bytes<cols_of<D>()>() + 2 * kTile * int(sizeof(float));
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
  uint32_t cell_stride;  // dropout cell of (b, h): b * cell_stride + h
#ifdef MKG_ATTN_DP
  int d;  // the call's head width (the tile's is MKG_ATTN_DP)
#endif
};

// What a lane knows of its two rows (row_g and row_g + 8 of the tile).
template <int D>
struct Lane {
  Geometry geo;
  uint32_t seed_mix;
  int row_g;
  ScoreRule<D> rule;
  float c_row[2];  // c at the rows' answer columns

  __device__ __forceinline__ Lane(const Args& a, int b, int h, int row0)
      : rule(a.scale, a.has_geometry) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    geo = load_geometry(a.has_geometry, a.row_start, a.text_len, a.offset, a.boundary, a.w, b);
    seed_mix = (a.seed + uint32_t(b) * a.cell_stride + uint32_t(h)) * 0x9E3779B9u;
    row_g = row0 + warp * 16 + (lane >> 2);
    c_row[0] = rule.c_answer(geo.row(row_g).w);
    c_row[1] = rule.c_answer(geo.row(row_g + 8).w);
  }
};

// One chunk's scores -> probabilities: normalised, dropped, in place, ready
// for the rounding of pack_a.
template <int D>
__device__ __forceinline__ void probabilities(float (&s)[8][4], const float (&m)[2],
                                              const float (&inv_l)[2], const Args& a,
                                              const Lane<D>& ln, int key0) {
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

// The block's coordinates: its tile of 64 query rows, its group of the
// head's columns (always 0 below D = 128), head and batch row.
template <int D>
struct Block {
  int tile, group, h, b;
  __device__ __forceinline__ Block()
      : tile(blockIdx.x / groups_of<D>()), group(blockIdx.x % groups_of<D>()), h(blockIdx.y),
        b(blockIdx.z) {}
};

// Up to 64 NC keys: the score row in registers, every chunk in shared
// memory, one sweep.
template <int D, int NC>
__global__ void __launch_bounds__(kThreads) fwd_resident_kernel(const Args a) {
  constexpr int W = cols_of<D>(), NT = W / 8;  // the block's result columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + tile_elems<D>();       // NC chunks
  bf16* v_s = k_s + NC * tile_elems<D>();  // NC chunks of the block's W columns
  float* bias_s = reinterpret_cast<float*>(v_s + NC * tile_elems<W>());  // NC rows of 64

  const Block<D> blk;
  const int h = blk.h, b = blk.b;
  int d = D;  // the head width: a constant in a library of 64 and 128 (PERF.md)
  if constexpr (kRagged) d = head_width<D>(a);
  const int v_cols = d - blk.group * W;
  const int hd = a.num_heads * d;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int row0 = blk.tile * kTile;
  const int n_chunks = (a.lk + kTile - 1) / kTile;  // <= NC

  // every load of the block, one commit group a chunk: Q with K's first
  const bf16* kb = a.k + size_t(b) * a.lk * hd + h * d;
  const bf16* vb = a.v + size_t(b) * a.lk * hd + h * d + blk.group * W;
  stage_tile<D>(q_s, a.q + (size_t(b) * a.lq + row0) * hd + h * d, a.lq - row0, hd, d);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c < n_chunks) {
      stage_tile<D>(k_s + c * tile_elems<D>(), kb + size_t(c) * kTile * hd, a.lk - c * kTile,
                    hd, d);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c < n_chunks) {
      stage_tile<W>(v_s + c * tile_elems<W>(), vb + size_t(c) * kTile * hd, a.lk - c * kTile,
                    hd, v_cols);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    stage_bias(bias_s + c * kTile, a.mask + size_t(b) * a.lk, c * kTile, a.lk);
  }
  const Lane<D> ln(a, b, h, row0);

  uint32_t qa[D / 16][4];
  float s[NC][8][4];
  float m[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    cp_async_wait_pending(2 * NC - 1 - c);
    __syncthreads();
    if (c == 0) load_a_held<D>(qa, q_s + warp * 16 * stride_of<D>());
    if (c < n_chunks) {
      zero(s[c]);
      product_a<D>(s[c], qa, q_s + warp * 16 * stride_of<D>(), k_s + c * tile_elems<D>());
      scores<D>(s[c], ln.geo.answer_bits(c * kTile + 2 * t), ln.rule.c_plain, ln.c_row,
                bias_s + c * kTile, m, ln.rule.pre);
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

  float o[NT][4];
  zero(o);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    cp_async_wait_pending(NC - 1 - c);
    __syncthreads();
    if (c < n_chunks) {
      probabilities(s[c], m, inv_l, a, ln, c * kTile);
      uint32_t pa[4][4];
      pack_a(pa, s[c]);
      product_nn<W>(o, pa, v_s + c * tile_elems<W>());
    }
  }
  store_rows<D>(a.out + (size_t(b) * a.lq + row0 + warp * 16) * hd + h * d + blk.group * W, hd,
                a.lq - row0 - warp * 16, q_s + warp * 16 * stride_of<D>(), o, v_cols);
}

// Any Lk: two sweeps over the keys through two buffers.
template <int D>
__global__ void __launch_bounds__(kThreads) fwd_streaming_kernel(const Args a) {
  constexpr int W = cols_of<D>(), NT = W / 8;  // the block's result columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + tile_elems<D>();       // two buffers
  bf16* v_s = k_s + 2 * tile_elems<D>();   // two buffers of the block's W columns
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * tile_elems<W>());  // two rows of 64

  const Block<D> blk;
  const int h = blk.h, b = blk.b;
  int d = D;  // the head width: a constant in a library of 64 and 128 (PERF.md)
  if constexpr (kRagged) d = head_width<D>(a);
  const int v_cols = d - blk.group * W;
  const int hd = a.num_heads * d;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int row0 = blk.tile * kTile;

  const bf16* kb = a.k + size_t(b) * a.lk * hd + h * d;
  const bf16* vb = a.v + size_t(b) * a.lk * hd + h * d + blk.group * W;
  const float* mask_b = a.mask + size_t(b) * a.lk;
  const int n_chunks = (a.lk + kTile - 1) / kTile;
  const int n_items = 2 * n_chunks;  // sweep 0 then sweep 1

  auto load_item = [&](int it) {
    const int buf = it & 1;
    const int key0 = (it >= n_chunks ? it - n_chunks : it) * kTile;
    stage_tile<D>(k_s + buf * tile_elems<D>(), kb + size_t(key0) * hd, a.lk - key0, hd, d);
    if (it >= n_chunks) {
      stage_tile<W>(v_s + buf * tile_elems<W>(), vb + size_t(key0) * hd, a.lk - key0, hd,
                    v_cols);
    }
    stage_bias(bias_s + buf * kTile, mask_b, key0, a.lk);
    cp_async_commit();
  };

  stage_tile<D>(q_s, a.q + (size_t(b) * a.lq + row0) * hd + h * d, a.lq - row0, hd, d);
  load_item(0);  // one group with the Q tile
  const Lane<D> ln(a, b, h, row0);

  uint32_t qa[D / 16][4];
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.0f, 0.0f}, inv_l[2] = {0.0f, 0.0f};
  float o[NT][4];
  zero(o);

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) {
      load_item(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) load_a_held<D>(qa, q_s + warp * 16 * stride_of<D>());
    const int buf = it & 1;
    const bool second = it >= n_chunks;
    const int key0 = (second ? it - n_chunks : it) * kTile;

    float s[8][4];
    float cmax[2] = {-FLT_MAX, -FLT_MAX};
    zero(s);
    product_a<D>(s, qa, q_s + warp * 16 * stride_of<D>(), k_s + buf * tile_elems<D>());
    scores<D>(s, ln.geo.answer_bits(key0 + 2 * t), ln.rule.c_plain, ln.c_row,
              bias_s + buf * kTile, cmax, ln.rule.pre);

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
      product_nn<W>(o, pa, v_s + buf * tile_elems<W>());
    }
    __syncthreads();  // the buffer is refilled by the load after next
  }
  store_rows<D>(a.out + (size_t(b) * a.lq + row0 + warp * 16) * hd + h * d + blk.group * W, hd,
                a.lq - row0 - warp * 16, q_s + warp * 16 * stride_of<D>(), o, v_cols);
}

int launch_kernel(void (*kernel)(const Args), dim3 grid, int smem, const Args& a,
                  cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <int D>
int launch(const Args& a, int batch, cudaStream_t s) {
  const dim3 grid((a.lq + kTile - 1) / kTile * groups_of<D>(), a.num_heads, batch);
  if (a.lk <= 2 * kTile) {
    return launch_kernel(fwd_resident_kernel<D, 2>, grid, resident_smem<D>(2), a, s);
  }
  if constexpr (D <= 64) {
    // a 16 x 256 score row and 128 head columns of Q fragments would spill
    if (a.lk <= kMaxResidentKeys) {
      return launch_kernel(fwd_resident_kernel<D, 4>, grid, resident_smem<D>(4), a, s);
    }
  }
  return launch_kernel(fwd_streaming_kernel<D>, grid, streaming_smem<D>(), a, s);
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// q, k, v and out are bf16, packed (B, L, heads * head_dim), head_dim 64 or
// 128 (or, in a library of one padded width, any width that rounds up to
// it); inv_keep is 1 / (1 - rate).
int mkg_fused_attention_fwd_mma(const void* q, const void* k, const void* v, const void* mask,
                                const void* boundary, const void* w, void* out, int batch,
                                int lq, int lk, int num_heads, int head_dim, float scale,
                                int has_geometry, int row_start, int text_len, int offset,
                                int dropout, unsigned int threshold, float inv_keep,
                                unsigned int seed, unsigned int cell_stride, void* stream) {
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<const float*>(mask),
         static_cast<const int*>(boundary), static_cast<const float*>(w),
         static_cast<bf16*>(out), lq, lk, num_heads, scale, has_geometry, row_start,
         text_len, offset, dropout, threshold, inv_keep, seed, cell_stride};
#ifdef MKG_ATTN_DP
  a.d = head_dim;
#endif
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return attention_width::with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    return launch<decltype(width)::value>(a, batch, s);
  });
}

}  // extern "C"
