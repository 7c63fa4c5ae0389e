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
// the packed (B, L, heads * 64) layout.
//
// What bounds it: bytes (attention_mma.cuh has the count). The CUDA-core
// kernels it takes over from (fused_attention_bwd.cu, which keeps fp32) ran
// the one-warp-per-row pattern five times over with up to three fp32 score
// rows a warp in shared memory. Here all five products are mma.sync
// m16n8k16 on ldmatrix fragments, a warp owns 16 rows, and operands come in
// chunks of 64 rows by 16-byte cp.async (55 KB a block whatever the
// lengths). Blocks carry nothing between them and no float atomics run, so
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
constexpr int kDqSmem = 6 * kTileBytes + 2 * kTile * int(sizeof(float));
constexpr int kDkvSmem = 6 * kTileBytes + 2 * 4 * kTile * int(sizeof(float));

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
};

// What a lane of the dq pass knows of its two rows (row_g, row_g + 8).
struct Lane {
  Geometry geo;
  uint32_t seed_mix;
  int row_g;
  float c_plain, c_row[2];  // scale (* the row's multiplier)
  float w_row[2];           // the row's multiplier at answer columns
  bool in_region[2];        // a valid row in scope: its answer columns enter dw
  bool is_example[2];       // ... dw0 (example rows) or dw1

  __device__ __forceinline__ Lane(const Args& a, int b, int h, int row0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    geo = load_geometry(a.has_geometry, a.row_start, a.text_len, a.offset, a.boundary, a.w, b);
    seed_mix = (a.seed + uint32_t(b * a.num_heads + h)) * 0x9E3779B9u;
    row_g = row0 + warp * 16 + (lane >> 2);
    c_plain = a.scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const RowGeometry rg = geo.row(row_g + 8 * r);
      w_row[r] = rg.w;
      c_row[r] = c_plain * rg.w;
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

  __device__ __forceinline__ float c(const Lane& ln, int nt, int e) const {
    return (abits >> (2 * nt + (e & 1))) & 1u ? ln.c_row[e >> 1] : ln.c_plain;
  }

  // dP under the forward's keep mask, in place; the rows' max score.
  __device__ __forceinline__ void mask_and_max(const float (&s)[8][4], float (&dp)[8][4],
                                               float (&cmax)[2], const Args& a,
                                               const Lane& ln) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 b2 = *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        if (a.dropout) {
          const uint32_t idx = uint32_t(ln.row_g + 8 * r) * uint32_t(a.lk) +
                               uint32_t(key0 + nt * 8 + 2 * t + (e & 1));
          dp[nt][e] = dropout_keep(idx, ln.seed_mix, a.threshold) ? dp[nt][e] * a.inv_keep
                                                                   : 0.0f;
        }
        cmax[r] = fmaxf(cmax[r], fmaf(s[nt][e], c(ln, nt, e), e & 1 ? b2.y : b2.x));
      }
    }
  }

  // sum(e) and sum(dP * e) of row r with e = exp(s - m): a lane's share
  __device__ __forceinline__ void sums(const float (&s)[8][4], const float (&dp)[8][4], int r,
                                       float m, float& sum, float& dsum,
                                       const Lane& ln) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 b2 = *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float ex =
            exp_minus_max(fmaf(s[nt][e], c(ln, nt, e), e & 1 ? b2.y : b2.x), m);
        sum += ex;
        dsum = fmaf(dp[nt][e], ex, dsum);
      }
    }
  }

  // s <- dS_raw = p * (dP - delta) * mult * scale (rounded by pack_a); the dw
  // partials of the lane's valid rows.
  __device__ __forceinline__ void ds_raw(float (&s)[8][4], const float (&dp)[8][4],
                                         const float (&m)[2], const float (&inv_l)[2],
                                         const float (&delta)[2], float& dw0, float& dw1,
                                         const Args& a, const Lane& ln) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 b2 = *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float acc = s[nt][e];
        const float p =
            exp_minus_max(fmaf(acc, c(ln, nt, e), e & 1 ? b2.y : b2.x), m[r]) * inv_l[r];
        float ds = p * (dp[nt][e] - delta[r]);
        if ((abits >> (2 * nt + (e & 1))) & 1u) {
          // an answer column: in a region of the dw sums if the row is in
          // scope (w_row is 1 otherwise)
          const float term = ds * (acc * a.scale);
          if (ln.in_region[r] && ln.is_example[r]) dw0 += term;
          if (ln.in_region[r] && !ln.is_example[r]) dw1 += term;
          ds *= ln.w_row[r];
        }
        s[nt][e] = ds * a.scale;
      }
    }
  }
};

__device__ __forceinline__ void finish_dq(const Args& a, const Lane& ln, int b, int h,
                                          int tile, bf16* q_rows, const float (&acc)[8][4],
                                          const float (&m)[2], const float (&inv_l)[2],
                                          const float (&delta)[2], float dw0, float dw1) {
  __shared__ float dw_s[kWarps][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hd = a.num_heads * kHeadDim;
  const int row_w = tile * kTile + warp * 16;
  store_rows(a.dq + (size_t(b) * a.lq + row_w) * hd + h * kHeadDim, hd, a.lq - row_w, q_rows,
             acc);
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
    float* dst = a.dw_part + ((size_t(b) * a.num_heads + h) * gridDim.x + tile) * 2;
    dst[0] = t0;
    dst[1] = t1;
  }
}

// dq pass up to 128 keys: both accumulator tiles of the whole row in
// registers, every chunk in shared memory, one sweep.
__global__ void __launch_bounds__(kThreads) dq_resident_kernel(const Args a) {
  constexpr int NC = kDqResidentChunks;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + kTileElems;
  bf16* k_s = g_s + kTileElems;       // NC chunks
  bf16* v_s = k_s + NC * kTileElems;  // NC chunks
  float* bias_s = reinterpret_cast<float*>(v_s + NC * kTileElems);  // NC rows of 64

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = a.num_heads * kHeadDim;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int row0 = tile * kTile;
  const int n_chunks = (a.lk + kTile - 1) / kTile;  // <= NC

  const size_t tile_off = (size_t(b) * a.lq + row0) * hd + h * kHeadDim;
  const bf16* kb = a.k + size_t(b) * a.lk * hd + h * kHeadDim;
  const bf16* vb = a.v + size_t(b) * a.lk * hd + h * kHeadDim;
  stage_tile(q_s, a.q + tile_off, a.lq - row0, hd);
  stage_tile(g_s, a.go + tile_off, a.lq - row0, hd);
#pragma unroll
  for (int c = 0; c < NC; ++c) {  // one commit group a chunk; Q and g with the first
    if (c < n_chunks) {
      stage_tile(k_s + c * kTileElems, kb + size_t(c) * kTile * hd, a.lk - c * kTile, hd);
      stage_tile(v_s + c * kTileElems, vb + size_t(c) * kTile * hd, a.lk - c * kTile, hd);
    }
    cp_async_commit();
    stage_bias(bias_s + c * kTile, a.mask + size_t(b) * a.lk, c * kTile, a.lk);
  }
  const Lane ln(a, b, h, row0);

  uint32_t qa[4][4], ga[4][4];
  float s[NC][8][4], dp[NC][8][4];
  Chunk ch[NC];
  float m[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    cp_async_wait_pending(NC - 1 - c);
    __syncthreads();
    if (c == 0) {
      load_a(qa, q_s + warp * 16 * kStride);
      load_a(ga, g_s + warp * 16 * kStride);
    }
    ch[c] = Chunk{ln.geo.answer_bits(c * kTile + 2 * t), bias_s + c * kTile, c * kTile};
    if (c < n_chunks) {
      zero(s[c]);
      zero(dp[c]);
      product_nt(s[c], qa, k_s + c * kTileElems);
      product_nt(dp[c], ga, v_s + c * kTileElems);
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
  float acc[8][4];
  zero(acc);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c < n_chunks) {
      ch[c].ds_raw(s[c], dp[c], m, inv_l, delta, dw0, dw1, a, ln);
      uint32_t da[4][4];
      pack_a(da, s[c]);
      product_nn(acc, da, k_s + c * kTileElems);
    }
  }
  finish_dq(a, ln, b, h, tile, q_s + warp * 16 * kStride, acc, m, inv_l, delta, dw0, dw1);
}

// dq pass at any Lk: two sweeps over the keys through two buffers.
__global__ void __launch_bounds__(kThreads) dq_streaming_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + kTileElems;
  bf16* k_s = g_s + kTileElems;       // two buffers
  bf16* v_s = k_s + 2 * kTileElems;   // two buffers
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * kTileElems);  // two rows of 64

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
    stage_tile(k_s + buf * kTileElems, kb + size_t(key0) * hd, a.lk - key0, hd);
    stage_tile(v_s + buf * kTileElems, vb + size_t(key0) * hd, a.lk - key0, hd);
    stage_bias(bias_s + buf * kTile, mask_b, key0, a.lk);
    cp_async_commit();
  };

  const size_t tile_off = (size_t(b) * a.lq + row0) * hd + h * kHeadDim;
  stage_tile(q_s, a.q + tile_off, a.lq - row0, hd);
  stage_tile(g_s, a.go + tile_off, a.lq - row0, hd);
  load_item(0);  // one group with the Q and g tiles
  const Lane ln(a, b, h, row0);

  uint32_t qa[4][4], ga[4][4];
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.0f, 0.0f}, dsum[2] = {0.0f, 0.0f};
  float inv_l[2] = {0.0f, 0.0f}, delta[2] = {0.0f, 0.0f};
  float dw0 = 0.0f, dw1 = 0.0f;
  float acc[8][4];
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
      load_a(qa, q_s + warp * 16 * kStride);
      load_a(ga, g_s + warp * 16 * kStride);
    }
    const int buf = it & 1;
    const bool second = it >= n_chunks;
    const int key0 = (second ? it - n_chunks : it) * kTile;
    const bf16* kc = k_s + buf * kTileElems;
    const Chunk ch{ln.geo.answer_bits(key0 + 2 * t), bias_s + buf * kTile, key0};

    float s[8][4], dp[8][4];
    float cmax[2] = {-FLT_MAX, -FLT_MAX};
    zero(s);
    zero(dp);
    product_nt(s, qa, kc);
    product_nt(dp, ga, v_s + buf * kTileElems);
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
      product_nn(acc, da, kc);
    }
    __syncthreads();  // the buffer is refilled by the load after next
  }
  finish_dq(a, ln, b, h, tile, q_s + warp * 16 * kStride, acc, m, inv_l, delta, dw0, dw1);
}

// dk/dv pass, per 64 keys: one sweep over the Q and g chunks and the rows'
// statistics through two buffers.
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTileElems;
  bf16* q_s = v_s + kTileElems;       // two buffers
  bf16* g_s = q_s + 2 * kTileElems;   // two buffers
  float4* st_s = reinterpret_cast<float4*>(g_s + 2 * kTileElems);  // two blocks of 64 rows

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = a.num_heads * kHeadDim;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = tile * kTile;

  const bf16* qb = a.q + size_t(b) * a.lq * hd + h * kHeadDim;
  const bf16* gb = a.go + size_t(b) * a.lq * hd + h * kHeadDim;
  const float4* st_b = reinterpret_cast<const float4*>(a.stats) +
                       (size_t(b) * a.num_heads + h) * a.lq;
  const int n_chunks = (a.lq + kTile - 1) / kTile;

  auto load_item = [&](int it) {
    const int buf = it & 1, r0 = it * kTile;
    stage_tile(q_s + buf * kTileElems, qb + size_t(r0) * hd, a.lq - r0, hd);
    stage_tile(g_s + buf * kTileElems, gb + size_t(r0) * hd, a.lq - r0, hd);
    if (threadIdx.x < kTile) {  // zeros beyond Lq: 1 / l = 0, so p = 0 there
      const bool valid = r0 + threadIdx.x < a.lq;
      cp_async_16(st_s + buf * kTile + threadIdx.x, st_b + (valid ? r0 + threadIdx.x : 0),
                  valid);
    }
    cp_async_commit();
  };

  const size_t tile_off = (size_t(b) * a.lk + key0) * hd + h * kHeadDim;
  stage_tile(k_s, a.k + tile_off, a.lk - key0, hd);
  stage_tile(v_s, a.v + tile_off, a.lk - key0, hd);
  load_item(0);  // one group with the K and V tiles

  const Geometry geo =
      load_geometry(a.has_geometry, a.row_start, a.text_len, a.offset, a.boundary, a.w, b);
  const uint32_t seed_mix = (a.seed + uint32_t(b * a.num_heads + h)) * 0x9E3779B9u;
  const float c_plain = a.scale;
  const int key_g = key0 + warp * 16 + g;  // this lane's keys: key_g and key_g + 8
  bool key_answer[2];
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_g + 8 * r;
    key_answer[r] = geo.col_is_answer(key);
    bias[r] = key < a.lk ? (1.0f - a.mask[size_t(b) * a.lk + key]) * kNegBias : -INFINITY;
  }

  float dk_acc[8][4], dv_acc[8][4];
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
    const bf16* qc = q_s + buf * kTileElems;
    const bf16* gc = g_s + buf * kTileElems;
    const float4* st = st_s + buf * kTile;

    // S^T = K Q^T: P (kept in pt) and P_cast^T; dv += P_cast^T g. keep_bits
    // holds the chunk's 32 keep flags of this lane for the dP^T half.
    float pt[8][4];
    uint32_t keep_bits = 0u;
    {
      uint32_t ka[4][4], pa[4][4];  // K's fragments are reloaded a chunk: registers
      float pc[8][4];
      load_a(ka, k_s + warp * 16 * kStride);
      zero(pt);
      product_nt(pt, ka, qc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, il = nt * 8 + 2 * t + (e & 1);
          // m, 1 / l, delta, multiplier of query row r0 + il
          const float4 row = st[il];
          const float c = key_answer[r] ? c_plain * row.w : c_plain;
          const float p = exp_minus_max(fmaf(pt[nt][e], c, bias[r]), row.x) * row.y;
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
      product_nn(dv_acc, pa, gc);
    }

    // dP^T = V g^T: dS_raw^T; dk += dS_raw^T Q
    {
      uint32_t va[4][4];
      float dpt[8][4];
      load_a(va, v_s + warp * 16 * kStride);
      zero(dpt);
      product_nt(dpt, va, gc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, il = nt * 8 + 2 * t + (e & 1);
          const float4 row = st[il];
          float dp = dpt[nt][e];
          if (a.dropout) dp = (keep_bits >> (nt * 4 + e)) & 1u ? dp * a.inv_keep : 0.0f;
          const float ds = pt[nt][e] * (dp - row.z);
          dpt[nt][e] = ds * (key_answer[r] ? a.scale * row.w : a.scale);
        }
      }
      uint32_t da[4][4];
      pack_a(da, dpt);
      product_nn(dk_acc, da, qc);
    }
    __syncthreads();  // the buffer is refilled by the load after next
  }

  const int keys_valid = a.lk - key0 - warp * 16;
  store_rows(a.dk + tile_off + size_t(warp) * 16 * hd, hd, keys_valid,
             k_s + warp * 16 * kStride, dk_acc);
  store_rows(a.dv + tile_off + size_t(warp) * 16 * hd, hd, keys_valid,
             v_s + warp * 16 * kStride, dv_acc);
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches both passes on `stream` without synchronising; returns
// cudaGetLastError(). q, k, v, g, dq, dk and dv are bf16, packed (B, L,
// heads * 64); stats is (B, heads, Lq, 4) fp32 scratch, 16-byte aligned;
// dw_part (B, heads, ceil(Lq / 64), 2) fp32 partials of (dw0, dw1);
// inv_keep is 1 / (1 - rate).
int mkg_fused_attention_bwd_mma(const void* q, const void* k, const void* v, const void* g,
                                const void* mask, const void* boundary, const void* w,
                                void* dq, void* dk, void* dv, void* stats, void* dw_part,
                                int batch, int lq, int lk, int num_heads, float scale,
                                int has_geometry, int row_start, int text_len, int offset,
                                int dropout, unsigned int threshold, float inv_keep,
                                unsigned int seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(g),
               static_cast<const float*>(mask), static_cast<const int*>(boundary),
               static_cast<const float*>(w), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
               static_cast<bf16*>(dv), static_cast<float*>(stats),
               static_cast<float*>(dw_part), lq, lk, num_heads, scale, has_geometry,
               row_start, text_len, offset, dropout, threshold, inv_keep, seed};
  const bool resident = lk <= kDqResidentChunks * kTile;
  auto dq_kernel = resident ? dq_resident_kernel : dq_streaming_kernel;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kDqSmem);
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDkvSmem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid_dq((lq + kTile - 1) / kTile, num_heads, batch);
  dq_kernel<<<grid_dq, kThreads, kDqSmem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 grid_dkv((lk + kTile - 1) / kTile, num_heads, batch);
  dkv_kernel<<<grid_dkv, kThreads, kDkvSmem, s>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
