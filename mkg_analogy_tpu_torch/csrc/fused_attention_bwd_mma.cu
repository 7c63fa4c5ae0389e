// Fused multi-head attention backward on the tensor cores, bf16, sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/attention.py:_bwd_kernel
// (launched by _fused_attention_bwd under the jax.custom_vjp) for bf16
// inputs. Given q, k, v, the output cotangent g and the forward's mask,
// boundary, (w0, w1) and seed, it recomputes scores and probabilities,
// regenerates the dropout mask (the counter hash of attention_mma.cuh: the
// forward's mask bit for bit) and writes
//
//   dv = P_cast^T g          P_cast = dropout(P) rounded to bf16      (:199)
//   dP = (g V^T) * keep / (1 - rate)                                  (:208-209)
//   dS = P * (dP - rowsum(dP * P))                                    (:210)
//   dq = dS_raw K,  dk = dS_raw^T q,   dS_raw = (dS * mult * scale) rounded (:217)
//   dw0 / dw1 = sum(dS * S_raw) over the two analogy regions          (:212-213)
//
// with those cast points of _bwd_kernel, fp32 scores, softmax and sums, on
// the packed (B, L, heads * D) layout, D = 64 or 128 (ViLBERT's visual
// stream), each width its own instantiation, or any other width up to 256
// through the instance of its padded width, in a library of its own
// (attention_width.cuh).
//
// What bounds it: bytes (attention_mma.cuh has the count). The CUDA-core
// kernels it takes over from (fused_attention_bwd.cu, which keeps fp32) ran
// the one-warp-per-row pattern five times over with up to three fp32 score
// rows a warp in shared memory. Here all five products are mma.sync
// m16n8k16 on ldmatrix fragments, a warp owns 16 rows, and operands come in
// chunks of 64 rows by 16-byte cp.async (55 KB a block whatever the
// lengths at D = 64, 103 KB at 128). Blocks carry nothing between them and no float atomics run, so
// the two passes stay:
//   1. dq pass, per (64 query rows, head, batch row): S = Q K^T and
//      dP = g V^T as accumulator tiles; each row's max m, sum l and
//      delta = sum(dP * exp(s - m)) / l; then p, dS, the dw partials from
//      the fragment's coordinates, dS_raw rounded and repacked as the A
//      fragment of dS K (K through ldmatrix.trans). delta needs the whole
//      row before the first dS. Up to 128 keys (the text and vision
//      towers) both tiles of the row stay in registers and every load is in
//      flight from the start (dq_resident_kernel); above that the keys are
//      swept twice through two buffers (dq_streaming_kernel): sweep 0 keeps
//      running m, l and sum(dP * e), rescaled when the max moves, sweep 1
//      recomputes the same tiles with the same instructions, bit for bit.
//      Writes dq, the rows' (m, 1 / l, delta, multiplier) and one (dw0,
//      dw1) partial a block, which the wrapper sums: fp32 results repeat
//      from run to run.
//   2. dk/dv pass, per (64 keys, head, batch row), one sweep over the Q and
//      g chunks: S^T = K Q^T and dP^T = V g^T computed transposed, so that
//      P_cast^T and dS_raw^T are A fragments of P^T g and dS^T Q (g and Q
//      through ldmatrix.trans). K Q^T need not round as Q K^T did: pass 2
//      takes nothing of pass 1 but those row statistics, a probability that
//      comes out a last bit above 1 does no harm (nothing takes its
//      logarithm or root), and the bars (2^-7 of each result's largest
//      value) hold the passes together.
// At D = 128 each block of either pass owns 64 of its head's 128 result
// columns (a half, from blockIdx.x): the score and dP tiles take the whole
// depth of 128 and are computed by both halves' blocks, while a thread's
// result accumulators stay those of D = 64. The dq pass then always streams
// (its resident form would hold 64 more registers of Q and g fragments), and
// only the first half's block writes a row's statistics and the dw
// partials. The score keeps the plain version's two roundings where a
// multiplier applies (attention_mma.cuh: ScoreRule), and dS_raw is rounded
// as (dS * multiplier) * scale, in the plain version's order. At the other
// tile widths (16 to 112) a block of either pass owns all D result columns
// (cols_of<D>), and the dq pass keeps its resident form up to D = 64. At
// 192 and 256 three or four blocks own 64 result columns each, as the
// halves at 128 do, and every product over the depth takes its A
// fragments 64 columns at a time from shared memory (attention_mma.cuh:
// product_a): 198 KB of shared memory a block at 256, one block an SM.
// A lane holds rows g and g + 8 (g = lane / 4) and columns 2t, 2t + 1
// (t = lane % 4) of each 16 x 8 tile; geometry and dropout index come from
// those coordinates (in pass 2 the tile's rows are keys, its columns query
// rows). A score is one FMA from the accumulator, on the plain version's
// fp32 grid (attention_mma.cuh: scores); the dw sums take s_raw = acc *
// scale from the accumulator itself. Ragged edges: rows and keys beyond Lq
// and Lk are zero-filled padding of a tile: a padded key's bias is -inf and
// a padded row's 1 / l is 0, so their p and dS are exactly 0; they enter no
// max, sum, dw or product, and are not stored.

#include "attention_mma.cuh"

using namespace attention_mma;

namespace {

constexpr int kDqResidentChunks = 2;

// Q, g, two chunks (or buffers) of K and of V, two rows of biases.
template <int D>
constexpr int dq_smem() {
  return 6 * tile_bytes<D>() + 2 * kTile * int(sizeof(float));
}

// K, V, two buffers of Q and of g, two blocks of 64 row statistics.
template <int D>
constexpr int dkv_smem() {
  return 6 * tile_bytes<D>() + 2 * 4 * kTile * int(sizeof(float));
}

struct Args {
  const bf16 *q, *k, *v, *go;
  const float* mask;
  const int* boundary;
  const float* w;
  bf16 *dq, *dk, *dv;
  float* stats;    // (B, heads, Lq, 4): m, 1 / l, delta, the row's multiplier
  float* dw_part;  // (B, heads, ceil(Lq / 64), 2)
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

// The block's coordinates: its tile of 64 rows (query rows in the dq pass,
// keys in the dk/dv pass), its group of the head's columns (always 0 below
// D = 128), head and batch row.
template <int D>
struct Block {
  int tile, group, h, b;
  __device__ __forceinline__ Block()
      : tile(blockIdx.x / groups_of<D>()), group(blockIdx.x % groups_of<D>()), h(blockIdx.y),
        b(blockIdx.z) {}
};

// What a lane of the dq pass knows of its two rows (row_g, row_g + 8).
template <int D>
struct Lane {
  Geometry geo;
  uint32_t seed_mix;
  int row_g;
  ScoreRule<D> rule;
  float c_row[2];           // c at the rows' answer columns
  float w_row[2];           // the row's multiplier at answer columns
  bool in_region[2];        // a valid row in scope: its answer columns enter dw
  bool is_example[2];       // ... dw0 (example rows) or dw1

  __device__ __forceinline__ Lane(const Args& a, int b, int h, int row0)
      : rule(a.scale, a.has_geometry) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    geo = load_geometry(a.has_geometry, a.row_start, a.text_len, a.offset, a.boundary, a.w, b);
    seed_mix = (a.seed + uint32_t(b) * a.cell_stride + uint32_t(h)) * 0x9E3779B9u;
    row_g = row0 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const RowGeometry rg = geo.row(row_g + 8 * r);
      w_row[r] = rg.w;
      c_row[r] = rule.c_answer(rg.w);
      is_example[r] = rg.is_example;
      in_region[r] = rg.in_scope && row_g + 8 * r < a.lq;
    }
  }
};

// One chunk of a lane's rows: s the accumulator of Q K^T (kept raw: the dw
// sums need acc * scale), dp the accumulator of g V^T.
struct Chunk {
  uint32_t abits;     // the lane's answer columns
  const float* bias;  // the chunk's 64 biases
  int key0;

  template <int D>
  __device__ __forceinline__ float score(const Lane<D>& ln, float acc, int nt, int e) const {
    const float2 b2 = *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * (threadIdx.x & 3));
    const float c = (abits >> (2 * nt + (e & 1))) & 1u ? ln.c_row[e >> 1] : ln.rule.c_plain;
    return ln.rule.score(acc, c, e & 1 ? b2.y : b2.x);
  }

  // dP under the forward's keep mask, in place; the rows' max score.
  template <int D>
  __device__ __forceinline__ void mask_and_max(const float (&s)[8][4], float (&dp)[8][4],
                                               float (&cmax)[2], const Args& a,
                                               const Lane<D>& ln) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        if (a.dropout) {
          const uint32_t idx = uint32_t(ln.row_g + 8 * r) * uint32_t(a.lk) +
                               uint32_t(key0 + nt * 8 + 2 * t + (e & 1));
          dp[nt][e] = dropout_keep(idx, ln.seed_mix, a.threshold) ? dp[nt][e] * a.inv_keep
                                                                   : 0.0f;
        }
        cmax[r] = fmaxf(cmax[r], score(ln, s[nt][e], nt, e));
      }
    }
  }

  // sum(e) and sum(dP * e) of row r with e = exp(s - m): a lane's share
  template <int D>
  __device__ __forceinline__ void sums(const float (&s)[8][4], const float (&dp)[8][4], int r,
                                       float m, float& sum, float& dsum,
                                       const Lane<D>& ln) const {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float ex = exp_minus_max(score(ln, s[nt][e], nt, e), m);
        sum += ex;
        dsum = fmaf(dp[nt][e], ex, dsum);
      }
    }
  }

  // s <- dS_raw = p * (dP - delta) * mult * scale (rounded by pack_a); the dw
  // partials of the lane's valid rows.
  template <int D>
  __device__ __forceinline__ void ds_raw(float (&s)[8][4], const float (&dp)[8][4],
                                         const float (&m)[2], const float (&inv_l)[2],
                                         const float (&delta)[2], float& dw0, float& dw1,
                                         const Args& a, const Lane<D>& ln) const {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float acc = s[nt][e];
        const float p = exp_minus_max(score(ln, acc, nt, e), m[r]) * inv_l[r];
        float ds = p * (dp[nt][e] - delta[r]);
        if ((abits >> (2 * nt + (e & 1))) & 1u) {
          // an answer column: in a region of the dw sums if the row is in
          // scope (w_row is 1 otherwise)
          const float term = ds * __fmul_rn(acc, a.scale);
          if (ln.in_region[r] && ln.is_example[r]) dw0 += term;
          if (ln.in_region[r] && !ln.is_example[r]) dw1 += term;
          ds *= ln.w_row[r];
        }
        s[nt][e] = ds * a.scale;
      }
    }
  }
};

template <int D>
__device__ __forceinline__ void finish_dq(const Args& a, const Lane<D>& ln, const Block<D>& blk,
                                          bf16* q_rows, const float (&acc)[cols_of<D>() / 8][4],
                                          const float (&m)[2], const float (&inv_l)[2],
                                          const float (&delta)[2], float dw0, float dw1) {
  __shared__ float dw_s[kWarps][2];
  constexpr int W = cols_of<D>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blk.h, b = blk.b;
  const int d = head_width<D>(a);
  const int hd = a.num_heads * d;
  const int row_w = blk.tile * kTile + warp * 16;
  store_rows<D>(a.dq + (size_t(b) * a.lq + row_w) * hd + h * d + blk.group * W, hd,
                a.lq - row_w, q_rows, acc, d - blk.group * W);
  if (blk.group != 0) return;  // the statistics and dw are the first group's to write
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (ln.row_g + 8 * r < a.lq) {
        float4* st = reinterpret_cast<float4*>(a.stats) +
                     (size_t(b) * a.num_heads + h) * a.lq + ln.row_g + 8 * r;
        *st = make_float4(m[r], inv_l[r], delta[r], ln.w_row[r]);
      }
    }
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
    const int tiles = gridDim.x / groups_of<D>();
    float* dst = a.dw_part + ((size_t(b) * a.num_heads + h) * tiles + blk.tile) * 2;
    dst[0] = t0;
    dst[1] = t1;
  }
}

// dq pass up to 128 keys at D <= 64: both accumulator tiles of the whole
// row in registers, every chunk in shared memory, one sweep.
template <int D>
__global__ void __launch_bounds__(kThreads) dq_resident_kernel(const Args a) {
  constexpr int NC = kDqResidentChunks;
  constexpr int NT = D / 8;  // the block's D result columns
  static_assert(D <= 64, "the resident dq pass holds 2 x 64 keys of two tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + tile_elems<D>();
  bf16* k_s = g_s + tile_elems<D>();       // NC chunks
  bf16* v_s = k_s + NC * tile_elems<D>();  // NC chunks
  float* bias_s = reinterpret_cast<float*>(v_s + NC * tile_elems<D>());  // NC rows of 64

  const Block<D> blk;
  const int h = blk.h, b = blk.b;
  const int d = head_width<D>(a);
  const int hd = a.num_heads * d;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int row0 = blk.tile * kTile;
  const int n_chunks = (a.lk + kTile - 1) / kTile;  // <= NC

  const size_t tile_off = (size_t(b) * a.lq + row0) * hd + h * d;
  const bf16* kb = a.k + size_t(b) * a.lk * hd + h * d;
  const bf16* vb = a.v + size_t(b) * a.lk * hd + h * d;
  stage_tile<D>(q_s, a.q + tile_off, a.lq - row0, hd, d);
  stage_tile<D>(g_s, a.go + tile_off, a.lq - row0, hd, d);
#pragma unroll
  for (int c = 0; c < NC; ++c) {  // one commit group a chunk; Q and g with the first
    if (c < n_chunks) {
      stage_tile<D>(k_s + c * tile_elems<D>(), kb + size_t(c) * kTile * hd, a.lk - c * kTile,
                    hd, d);
      stage_tile<D>(v_s + c * tile_elems<D>(), vb + size_t(c) * kTile * hd, a.lk - c * kTile,
                    hd, d);
    }
    cp_async_commit();
    stage_bias(bias_s + c * kTile, a.mask + size_t(b) * a.lk, c * kTile, a.lk);
  }
  const Lane<D> ln(a, b, h, row0);

  uint32_t qa[D / 16][4], ga[D / 16][4];
  float s[NC][8][4], dp[NC][8][4];
  Chunk ch[NC];
  float m[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    cp_async_wait_pending(NC - 1 - c);
    __syncthreads();
    if (c == 0) {
      load_a<D>(qa, q_s + warp * 16 * stride_of<D>());
      load_a<D>(ga, g_s + warp * 16 * stride_of<D>());
    }
    ch[c] = Chunk{ln.geo.answer_bits(c * kTile + 2 * t), bias_s + c * kTile, c * kTile};
    if (c < n_chunks) {
      zero(s[c]);
      zero(dp[c]);
      product_nt<D>(s[c], qa, k_s + c * tile_elems<D>());
      product_nt<D>(dp[c], ga, v_s + c * tile_elems<D>());
      ch[c].mask_and_max(s[c], dp[c], m, a, ln);
    }
  }
  float inv_l[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = quad_max(m[r]);
    float sum = 0.0f, dsum = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < n_chunks) ch[c].sums(s[c], dp[c], r, m[r], sum, dsum, ln);
    }
    inv_l[r] = 1.0f / quad_sum(sum);
    delta[r] = quad_sum(dsum) * inv_l[r];
  }
  float dw0 = 0.0f, dw1 = 0.0f;
  float acc[NT][4];
  zero(acc);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c < n_chunks) {
      ch[c].ds_raw(s[c], dp[c], m, inv_l, delta, dw0, dw1, a, ln);
      uint32_t da[4][4];
      pack_a(da, s[c]);
      product_nn<D>(acc, da, k_s + c * tile_elems<D>());
    }
  }
  finish_dq(a, ln, blk, q_s + warp * 16 * stride_of<D>(), acc, m, inv_l, delta, dw0, dw1);
}

// dq pass at any Lk: two sweeps over the keys through two buffers.
template <int D>
__global__ void __launch_bounds__(kThreads) dq_streaming_kernel(const Args a) {
  constexpr int W = cols_of<D>(), NT = W / 8;  // the block's result columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + tile_elems<D>();
  bf16* k_s = g_s + tile_elems<D>();       // two buffers
  bf16* v_s = k_s + 2 * tile_elems<D>();   // two buffers
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * tile_elems<D>());  // two rows of 64

  const Block<D> blk;
  const int h = blk.h, b = blk.b;
  const int d = head_width<D>(a);
  const int hd = a.num_heads * d;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int row0 = blk.tile * kTile;

  const bf16* kb = a.k + size_t(b) * a.lk * hd + h * d;
  const bf16* vb = a.v + size_t(b) * a.lk * hd + h * d;
  const float* mask_b = a.mask + size_t(b) * a.lk;
  const int n_chunks = (a.lk + kTile - 1) / kTile;
  const int n_items = 2 * n_chunks;  // sweep 0 then sweep 1

  auto load_item = [&](int it) {
    const int buf = it & 1;
    const int key0 = (it >= n_chunks ? it - n_chunks : it) * kTile;
    stage_tile<D>(k_s + buf * tile_elems<D>(), kb + size_t(key0) * hd, a.lk - key0, hd, d);
    stage_tile<D>(v_s + buf * tile_elems<D>(), vb + size_t(key0) * hd, a.lk - key0, hd, d);
    stage_bias(bias_s + buf * kTile, mask_b, key0, a.lk);
    cp_async_commit();
  };

  const size_t tile_off = (size_t(b) * a.lq + row0) * hd + h * d;
  stage_tile<D>(q_s, a.q + tile_off, a.lq - row0, hd, d);
  stage_tile<D>(g_s, a.go + tile_off, a.lq - row0, hd, d);
  load_item(0);  // one group with the Q and g tiles
  const Lane<D> ln(a, b, h, row0);

  uint32_t qa[D / 16][4], ga[D / 16][4];
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.0f, 0.0f}, dsum[2] = {0.0f, 0.0f};
  float inv_l[2] = {0.0f, 0.0f}, delta[2] = {0.0f, 0.0f};
  float dw0 = 0.0f, dw1 = 0.0f;
  float acc[NT][4];
  zero(acc);

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) {
      load_item(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      load_a_held<D>(qa, q_s + warp * 16 * stride_of<D>());
      load_a_held<D>(ga, g_s + warp * 16 * stride_of<D>());
    }
    const int buf = it & 1;
    const bool second = it >= n_chunks;
    const int key0 = (second ? it - n_chunks : it) * kTile;
    const bf16* kc = k_s + buf * tile_elems<D>();
    const Chunk ch{ln.geo.answer_bits(key0 + 2 * t), bias_s + buf * kTile, key0};

    float s[8][4], dp[8][4];
    float cmax[2] = {-FLT_MAX, -FLT_MAX};
    zero(s);
    zero(dp);
    product_a<D>(s, qa, q_s + warp * 16 * stride_of<D>(), kc);
    product_a<D>(dp, ga, g_s + warp * 16 * stride_of<D>(), v_s + buf * tile_elems<D>());
    ch.mask_and_max(s, dp, cmax, a, ln);

    if (!second) {
      // sweep 0: running max, sum and sum(dP * e) of each row (a lane's share)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(cmax[r]));
        const float resc = exp_minus_max(m[r], m_new);
        float sum = 0.0f, dsm = 0.0f;
        ch.sums(s, dp, r, m_new, sum, dsm, ln);
        l[r] = l[r] * resc + sum;
        dsum[r] = dsum[r] * resc + dsm;
        m[r] = m_new;
      }
      if (it == n_chunks - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          inv_l[r] = 1.0f / quad_sum(l[r]);
          delta[r] = quad_sum(dsum[r]) * inv_l[r];
        }
      }
    } else {
      // sweep 1: p, dS, the dw partials, dS_raw rounded; dq += dS_raw K
      ch.ds_raw(s, dp, m, inv_l, delta, dw0, dw1, a, ln);
      uint32_t da[4][4];
      pack_a(da, s);
      product_nn<D>(acc, da, kc + blk.group * W);
    }
    __syncthreads();  // the buffer is refilled by the load after next
  }
  finish_dq(a, ln, blk, q_s + warp * 16 * stride_of<D>(), acc, m, inv_l, delta, dw0, dw1);
}

// dk/dv pass, per 64 keys: one sweep over the Q and g chunks and the rows'
// statistics through two buffers.
template <int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Args a) {
  constexpr int W = cols_of<D>(), NT = W / 8;  // the block's result columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + tile_elems<D>();
  bf16* q_s = v_s + tile_elems<D>();       // two buffers
  bf16* g_s = q_s + 2 * tile_elems<D>();   // two buffers
  float4* st_s = reinterpret_cast<float4*>(g_s + 2 * tile_elems<D>());  // two blocks of 64 rows

  const Block<D> blk;
  const int h = blk.h, b = blk.b;
  const int d = head_width<D>(a);
  const int hd = a.num_heads * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = blk.tile * kTile;

  const bf16* qb = a.q + size_t(b) * a.lq * hd + h * d;
  const bf16* gb = a.go + size_t(b) * a.lq * hd + h * d;
  const float4* st_b = reinterpret_cast<const float4*>(a.stats) +
                       (size_t(b) * a.num_heads + h) * a.lq;
  const int n_chunks = (a.lq + kTile - 1) / kTile;

  auto load_item = [&](int it) {
    const int buf = it & 1, r0 = it * kTile;
    stage_tile<D>(q_s + buf * tile_elems<D>(), qb + size_t(r0) * hd, a.lq - r0, hd, d);
    stage_tile<D>(g_s + buf * tile_elems<D>(), gb + size_t(r0) * hd, a.lq - r0, hd, d);
    if (threadIdx.x < kTile) {  // zeros beyond Lq: 1 / l = 0, so p = 0 there
      const bool valid = r0 + threadIdx.x < a.lq;
      cp_async_16(st_s + buf * kTile + threadIdx.x, st_b + (valid ? r0 + threadIdx.x : 0),
                  valid);
    }
    cp_async_commit();
  };

  const size_t tile_off = (size_t(b) * a.lk + key0) * hd + h * d;
  stage_tile<D>(k_s, a.k + tile_off, a.lk - key0, hd, d);
  stage_tile<D>(v_s, a.v + tile_off, a.lk - key0, hd, d);
  load_item(0);  // one group with the K and V tiles

  const Geometry geo =
      load_geometry(a.has_geometry, a.row_start, a.text_len, a.offset, a.boundary, a.w, b);
  const uint32_t seed_mix =
      (a.seed + uint32_t(b) * a.cell_stride + uint32_t(h)) * 0x9E3779B9u;
  const ScoreRule<D> rule(a.scale, a.has_geometry);
  const int key_g = key0 + warp * 16 + g;  // this lane's keys: key_g and key_g + 8
  bool key_answer[2];
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_g + 8 * r;
    key_answer[r] = geo.col_is_answer(key);
    bias[r] = key < a.lk ? (1.0f - a.mask[size_t(b) * a.lk + key]) * kNegBias : -INFINITY;
  }

  float dk_acc[NT][4], dv_acc[NT][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int it = 0; it < n_chunks; ++it) {
    if (it + 1 < n_chunks) {
      load_item(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = it & 1, r0 = it * kTile;
    const bf16* qc = q_s + buf * tile_elems<D>();
    const bf16* gc = g_s + buf * tile_elems<D>();
    const float4* st = st_s + buf * kTile;

    // S^T = K Q^T: P (kept in pt) and P_cast^T; dv += P_cast^T g. keep_bits
    // holds the chunk's 32 keep flags of this lane for the dP^T half.
    float pt[8][4];
    uint32_t keep_bits = 0u;
    {
      uint32_t ka[D / 16][4], pa[4][4];  // K's fragments are reloaded a chunk: registers
      float pc[8][4];
      load_a_held<D>(ka, k_s + warp * 16 * stride_of<D>());
      zero(pt);
      product_a<D>(pt, ka, k_s + warp * 16 * stride_of<D>(), qc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, il = nt * 8 + 2 * t + (e & 1);
          // m, 1 / l, delta, multiplier of query row r0 + il
          const float4 row = st[il];
          const float c = key_answer[r] ? rule.c_answer(row.w) : rule.c_plain;
          const float p = exp_minus_max(rule.score(pt[nt][e], c, bias[r]), row.x) * row.y;
          float p_drop = p;
          if (a.dropout) {
            const uint32_t idx =
                uint32_t(r0 + il) * uint32_t(a.lk) + uint32_t(key_g + 8 * r);
            const bool keep = dropout_keep(idx, seed_mix, a.threshold);
            keep_bits |= uint32_t(keep) << (nt * 4 + e);
            p_drop = keep ? p * a.inv_keep : 0.0f;
          }
          pt[nt][e] = p;
          pc[nt][e] = p_drop;
        }
      }
      pack_a(pa, pc);
      product_nn<D>(dv_acc, pa, gc + blk.group * W);
    }

    // dP^T = V g^T: dS_raw^T; dk += dS_raw^T Q
    {
      uint32_t va[D / 16][4];
      float dpt[8][4];
      load_a_held<D>(va, v_s + warp * 16 * stride_of<D>());
      zero(dpt);
      product_a<D>(dpt, va, v_s + warp * 16 * stride_of<D>(), gc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, il = nt * 8 + 2 * t + (e & 1);
          const float4 row = st[il];
          float dp = dpt[nt][e];
          if (a.dropout) dp = (keep_bits >> (nt * 4 + e)) & 1u ? dp * a.inv_keep : 0.0f;
          const float ds = pt[nt][e] * (dp - row.z);
          dpt[nt][e] = (ds * (key_answer[r] ? row.w : 1.0f)) * a.scale;
        }
      }
      uint32_t da[4][4];
      pack_a(da, dpt);
      product_nn<D>(dk_acc, da, qc + blk.group * W);
    }
    __syncthreads();  // the buffer is refilled by the load after next
  }

  const int keys_valid = a.lk - key0 - warp * 16, cols_valid = d - blk.group * W;
  const size_t out_off = tile_off + size_t(warp) * 16 * hd + blk.group * W;
  store_rows<D>(a.dk + out_off, hd, keys_valid, k_s + warp * 16 * stride_of<D>(), dk_acc,
                cols_valid);
  store_rows<D>(a.dv + out_off, hd, keys_valid, v_s + warp * 16 * stride_of<D>(), dv_acc,
                cols_valid);
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
  const dim3 grid_dq((a.lq + kTile - 1) / kTile * groups_of<D>(), a.num_heads, batch);
  void (*dq_kernel)(const Args) = dq_streaming_kernel<D>;
  if constexpr (D <= 64) {
    if (a.lk <= kDqResidentChunks * kTile) dq_kernel = dq_resident_kernel<D>;
  }
  const int err = launch_kernel(dq_kernel, grid_dq, dq_smem<D>(), a, s);
  if (err != 0) return err;
  const dim3 grid_dkv((a.lk + kTile - 1) / kTile * groups_of<D>(), a.num_heads, batch);
  return launch_kernel(dkv_kernel<D>, grid_dkv, dkv_smem<D>(), a, s);
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches both passes on `stream` without synchronising; returns
// cudaGetLastError(). q, k, v, g, dq, dk and dv are bf16, packed (B, L,
// heads * head_dim), head_dim 64 or 128 (or, in a library of one padded
// width, any width that rounds up to it); stats is (B, heads, Lq, 4) fp32
// scratch, 16-byte aligned; dw_part (B, heads, ceil(Lq / 64), 2) fp32
// partials of (dw0, dw1); inv_keep is 1 / (1 - rate).
int mkg_fused_attention_bwd_mma(const void* q, const void* k, const void* v, const void* g,
                                const void* mask, const void* boundary, const void* w,
                                void* dq, void* dk, void* dv, void* stats, void* dw_part,
                                int batch, int lq, int lk, int num_heads, int head_dim,
                                float scale, int has_geometry, int row_start, int text_len,
                                int offset, int dropout, unsigned int threshold,
                                float inv_keep, unsigned int seed, unsigned int cell_stride,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<const bf16*>(g),
         static_cast<const float*>(mask), static_cast<const int*>(boundary),
         static_cast<const float*>(w), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
         static_cast<bf16*>(dv), static_cast<float*>(stats),
         static_cast<float*>(dw_part), lq, lk, num_heads, scale, has_geometry,
         row_start, text_len, offset, dropout, threshold, inv_keep, seed, cell_stride};
#ifdef MKG_ATTN_DP
  a.d = head_dim;
#endif
  return attention_width::with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    return launch<decltype(width)::value>(a, batch, s);
  });
}

}  // extern "C"
