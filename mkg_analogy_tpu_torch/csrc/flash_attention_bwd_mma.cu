// K-blocked (flash) attention backward on the tensor cores, bf16, sm_90a:
// two kernels, two launches.
//
// Replaces, for bf16 inputs, the TPU kernels mkg_analogy_tpu/kernels/
// flash_attention.py:_flash_bwd_kv_kernel (the pl.pallas_call at :453) and
// _flash_bwd_q_kernel (:491), under the jax.custom_vjp at :361-512. Given q,
// k, v, the output cotangent g, the forward's mask, boundary, (w0, w1) and
// seed, its per-row log-sum-exp lse and delta = rowsum(g * out) (both
// (B, heads, Lq) fp32, delta computed by the wrapper as JAX does), they
// recompute p = exp(s - lse) element by element and write
//
//   dv = P_drop_cast^T g       P_drop = dropout(P) rounded to bf16      (:233)
//   dP = (g V^T) * keep / (1 - rate)                                     (:242)
//   dS = P * (dP - delta)                                                (:243)
//   dk = dS_raw^T q,  dq = dS_raw K,   dS_raw = (dS * mult * scale) rounded (:250, :320)
//   dw0 / dw1 = sum(dS * S_raw) over the two analogy regions            (:245-246)
//
// with those cast points, every sum in fp32, on the packed (B, L, heads * 64)
// layout. The plain version is kernels/flash_attention.py:_plain_bwd; fp32
// inputs stay on the CUDA-core kernels of flash_attention_bwd.cu
// (attention_mma.cuh says why).
//
// What bounds it: bytes at the main-path shapes (L <= 611), the products at
// L = 2048 (dK/dV 4 products of 2 * Lq * Lk * 64 flops per (b, head), dQ 3).
// The CUDA-core kernels it takes over from ran one warp per key (dK/dV) or
// query row (dQ) and re-read every staged row from shared memory for each,
// 19-103x above their bounds, the dQ kernel at 153-165 registers, one block
// an SM. Here every product is mma.sync m16n8k16 on ldmatrix fragments
// (attention_mma.cuh), a warp owns 16 keys or rows, a block 64, and the
// streamed operands arrive by 16-byte cp.async in chunks of 64 rows through
// two buffers. The forward hands over lse and the wrapper delta, so each
// kernel sweeps once and no pass waits for a row's statistics:
//   - dK/dV, per (64 keys, head, batch row): K and V staged once and their A
//     fragments kept in registers; the sweep walks the query rows in chunks
//     of q, g and a record per row (lse, delta, the row's dropout index base
//     and seed part, its analogy multiplier and dw regions), each chunk in
//     two halves of 32 rows. S^T = K Q^T and dP^T = V g^T are computed
//     transposed, so P_drop^T and dS_raw^T, packed from the accumulators,
//     are the A fragments of P_drop^T g and dS_raw^T Q (g and Q through
//     ldmatrix.trans); the dk and dv accumulators stay in registers for the
//     whole sweep. (dw needs S^T and dP^T of an element at once: over 64 rows
//     the two tiles beside both accumulators made ptxas spill, over 32 they
//     fit.) The dw partials come from each fragment's coordinates: one
//     (dw0, dw1) a block, which the wrapper sums (no float atomics, fp32
//     results repeat from run to run).
//   - dQ, per (64 query rows, head, batch row): Q and g staged once, their A
//     fragments in registers, lse and delta in registers; the sweep walks the
//     keys in chunks of K, V and a record per key (padding bias, the key's
//     dropout column and seed part, whether it is an answer column):
//     S = Q K^T and dP = g V^T as accumulator tiles, p, dropout, dS, dS_raw
//     packed as the A fragment of dS_raw K (K through ldmatrix.trans).
// A lane holds rows g and g + 8 (g = lane / 4) and columns 2t, 2t + 1
// (t = lane % 4) of each 16 x 8 tile; in the dK/dV kernel the tile's rows
// are keys and its columns query rows.
//
// Dropout is the forward's mask (flash_attention_fwd.cu): the interpret-mode
// hash keyed to the logical (bq, bk) tiles, idx = (r - qb * bq) * bk +
// (c - kb * bk), tile seed seed + ((b * heads + h) * n_qblk + qb) * n_kblk +
// kb, times 0x9E3779B9 (mod 2^32). Both split into a part of the row and a
// part of the key, idx = row_base + col and mix = row_mix + key_mix, each
// derived once per row and once per key, so a 64-row chunk may straddle
// logical tiles of any size (the row stride stays bk in a ragged last tile).
// A score is one FMA from the accumulator in the natural domain
// (attention_mma.cuh: scores) and p = ex2((s - lse) * log2 e), the
// difference first. Padding is a value, not a predicate: a key beyond Lk
// has bias -inf (p exactly 0, as JAX's HARD_MASK gives), a query row beyond
// Lq is given lse = +inf and delta = 0 (p and dS exactly 0); they enter no
// sum, dw or product, and are not stored.

#include "attention_mma.cuh"

using namespace attention_mma;

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
// dK/dV: K, V; q and g in two buffers; two buffers of 64 row records
// (lse, delta, dropout base, row mix) and row geometries (multiplier,
// dw0 region, dw1 region, 0)
constexpr int kDkvSmem = 6 * kTileBytes + 2 * 2 * kTile * int(sizeof(float4));
// dQ: Q, g; K and V in two buffers; two buffers of 64 key records (bias,
// dropout column, key mix, answer column)
constexpr int kDqSmem = 6 * kTileBytes + 2 * kTile * int(sizeof(float4));

struct Args {
  const bf16 *q, *k, *v, *go;
  const float* mask;
  const int* boundary;
  const float* w;
  const float *lse, *delta;  // (B, heads, Lq)
  bf16 *dq, *dk, *dv;
  float* dw_part;            // (B, heads, ceil(Lk / 64), 2)
  int lq, lk, num_heads;
  float scale;
  int has_geometry, row_start, text_len, offset, dropout;
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  int bq, bk, n_qblk, n_kblk;
};

// The key's part of the dropout hash: its column in its logical K tile and
// (seed + cell * n_qblk * n_kblk + kb) * 0x9E3779B9.
__device__ __forceinline__ void key_part(const Args& a, uint32_t cell, int key, uint32_t& col,
                                         uint32_t& mix) {
  const int kb = key / a.bk;
  col = uint32_t(key - kb * a.bk);
  mix = (a.seed + cell * uint32_t(a.n_qblk) * uint32_t(a.n_kblk) + uint32_t(kb)) * kGolden;
}

// The row's part: (r - qb * bq) * bk and qb * n_kblk * 0x9E3779B9.
__device__ __forceinline__ void row_part(const Args& a, int row, uint32_t& base, uint32_t& mix) {
  const int qb = row / a.bq;
  base = uint32_t(row - qb * a.bq) * uint32_t(a.bk);
  mix = uint32_t(qb) * uint32_t(a.n_kblk) * kGolden;
}

// dK/dV, per 64 keys: one sweep over the query rows.
__global__ void __launch_bounds__(kThreads, 2) dkv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float dw_s[kWarps][2];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTileElems;
  bf16* q_s = v_s + kTileElems;      // two buffers
  bf16* g_s = q_s + 2 * kTileElems;  // two buffers
  float4* rec_s = reinterpret_cast<float4*>(g_s + 2 * kTileElems);  // two buffers of 64
  float4* geo_s = rec_s + 2 * kTile;                                 // two buffers of 64

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = a.num_heads * kHeadDim;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = tile * kTile;
  const uint32_t cell = uint32_t(b * a.num_heads + h);
  const Geometry geo =
      load_geometry(a.has_geometry, a.row_start, a.text_len, a.offset, a.boundary, a.w, b);

  const bf16* qb = a.q + size_t(b) * a.lq * hd + h * kHeadDim;
  const bf16* gb = a.go + size_t(b) * a.lq * hd + h * kHeadDim;
  const float* lse_bh = a.lse + size_t(cell) * a.lq;
  const float* delta_bh = a.delta + size_t(cell) * a.lq;
  const int n_chunks = (a.lq + kTile - 1) / kTile;

  auto load_chunk = [&](int it) {
    const int buf = it & 1, r0 = it * kTile;
    stage_tile(q_s + buf * kTileElems, qb + size_t(r0) * hd, a.lq - r0, hd);
    stage_tile(g_s + buf * kTileElems, gb + size_t(r0) * hd, a.lq - r0, hd);
    cp_async_commit();
  };
  // Thread i < 64 writes the record of row i of each chunk; its lse and
  // delta are loaded a chunk ahead of the record they go into.
  float next_lse = INFINITY, next_delta = 0.0f;
  auto fetch = [&](int it) {
    const int row = it * kTile + threadIdx.x;
    next_lse = row < a.lq ? lse_bh[row] : INFINITY;
    next_delta = row < a.lq ? delta_bh[row] : 0.0f;
  };
  auto put_record = [&](int it) {
    const int row = it * kTile + threadIdx.x, slot = (it & 1) * kTile + threadIdx.x;
    uint32_t base, mix;
    row_part(a, row, base, mix);
    rec_s[slot] = make_float4(next_lse, next_delta, __uint_as_float(base), __uint_as_float(mix));
    const RowGeometry rg = geo.row(row);
    geo_s[slot] = make_float4(rg.w, rg.in_scope && rg.is_example ? 1.0f : 0.0f,
                              rg.in_scope && !rg.is_example ? 1.0f : 0.0f, 0.0f);
  };

  const size_t tile_off = (size_t(b) * a.lk + key0) * hd + h * kHeadDim;
  stage_tile(k_s, a.k + tile_off, a.lk - key0, hd);
  stage_tile(v_s, a.v + tile_off, a.lk - key0, hd);
  load_chunk(0);  // one group with the K and V tiles
  if (threadIdx.x < kTile) {
    fetch(0);
    put_record(0);
    if (n_chunks > 1) fetch(1);
  }

  // this lane's keys, key_g and key_g + 8
  const int key_g = key0 + warp * 16 + g;
  float bias[2];
  bool key_answer[2];
  uint32_t col[2], key_mix[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_g + 8 * r;
    bias[r] = key < a.lk ? (1.0f - a.mask[size_t(b) * a.lk + key]) * kNegBias : -INFINITY;
    key_answer[r] = geo.col_is_answer(key);
    key_part(a, cell, key, col[r], key_mix[r]);
  }

  uint32_t ka[4][4], va[4][4];
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  float dw0 = 0.0f, dw1 = 0.0f;

  for (int it = 0; it < n_chunks; ++it) {
    if (it + 1 < n_chunks) {
      load_chunk(it + 1);
      if (threadIdx.x < kTile) {
        put_record(it + 1);  // its buffer was last read before the previous barrier
        if (it + 2 < n_chunks) fetch(it + 2);
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      load_a(ka, k_s + warp * 16 * kStride);
      load_a(va, v_s + warp * 16 * kStride);
    }
    const int buf = it & 1;
    // query rows 32 half .. 32 half + 31 of the chunk; the loop is kept
    // rolled, or the two halves' tiles are scheduled side by side again
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const bf16* qc = q_s + buf * kTileElems + half * 32 * kStride;
      const bf16* gc = g_s + buf * kTileElems + half * 32 * kStride;
      const float4* rec = rec_s + buf * kTile + half * 32;
      const float4* rgeo = geo_s + buf * kTile + half * 32;

      float st[4][4], dpt[4][4];
      zero(dpt);
      product_nt(dpt, va, gc);  // dP^T = V g^T
      zero(st);
      product_nt(st, ka, qc);  // S^T = K Q^T
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, il = nt * 8 + 2 * t + (e & 1);
          const float4 row = rec[il];  // lse, delta, dropout base, row mix of query row il
          float4 rg = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
          if (key_answer[r]) rg = rgeo[il];
          const float acc = st[nt][e];
          const float p = exp_minus_max(fmaf(acc, a.scale * rg.x, bias[r]), row.x);
          float p_drop = p, dp = dpt[nt][e];
          if (a.dropout) {
            const bool keep = dropout_keep(__float_as_uint(row.z) + col[r],
                                           __float_as_uint(row.w) + key_mix[r], a.threshold);
            p_drop = keep ? p * a.inv_keep : 0.0f;
            dp = keep ? dp * a.inv_keep : 0.0f;
          }
          float ds = p * (dp - row.y);
          if (key_answer[r]) {
            const float term = ds * (acc * a.scale);
            dw0 = fmaf(term, rg.y, dw0);
            dw1 = fmaf(term, rg.z, dw1);
            ds *= rg.x;
          }
          st[nt][e] = p_drop;
          dpt[nt][e] = ds * a.scale;
        }
      }
      uint32_t pa[2][4], da[2][4];
      pack_a(pa, st);
      pack_a(da, dpt);
      product_nn(dv_acc, pa, gc);  // dv += P_drop^T g
      product_nn(dk_acc, da, qc);  // dk += dS_raw^T Q
    }
    __syncthreads();  // the buffers are refilled by the load after next
  }

  const int keys_valid = a.lk - key0 - warp * 16;
  store_rows(a.dk + tile_off + size_t(warp) * 16 * hd, hd, keys_valid,
             k_s + warp * 16 * kStride, dk_acc);
  store_rows(a.dv + tile_off + size_t(warp) * 16 * hd, hd, keys_valid,
             v_s + warp * 16 * kStride, dv_acc);
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
    float* dst = a.dw_part + (size_t(cell) * gridDim.x + tile) * 2;
    dst[0] = t0;
    dst[1] = t1;
  }
}

// dQ, per 64 query rows: one sweep over the keys.
__global__ void __launch_bounds__(kThreads, 2) dq_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + kTileElems;
  bf16* k_s = g_s + kTileElems;      // two buffers
  bf16* v_s = k_s + 2 * kTileElems;  // two buffers
  float4* key_s = reinterpret_cast<float4*>(v_s + 2 * kTileElems);  // two buffers of 64

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hd = a.num_heads * kHeadDim;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int row0 = tile * kTile;
  const uint32_t cell = uint32_t(b * a.num_heads + h);
  const Geometry geo =
      load_geometry(a.has_geometry, a.row_start, a.text_len, a.offset, a.boundary, a.w, b);

  const bf16* kb = a.k + size_t(b) * a.lk * hd + h * kHeadDim;
  const bf16* vb = a.v + size_t(b) * a.lk * hd + h * kHeadDim;
  const float* mask_b = a.mask + size_t(b) * a.lk;
  const int n_chunks = (a.lk + kTile - 1) / kTile;

  auto load_chunk = [&](int it) {
    const int buf = it & 1, key0 = it * kTile;
    stage_tile(k_s + buf * kTileElems, kb + size_t(key0) * hd, a.lk - key0, hd);
    stage_tile(v_s + buf * kTileElems, vb + size_t(key0) * hd, a.lk - key0, hd);
    cp_async_commit();
  };
  // Thread j < 64 writes the record of key j of each chunk; its mask value
  // is loaded a chunk ahead of the record it goes into.
  float next_mask = 0.0f;
  auto fetch = [&](int it) {
    const int key = it * kTile + threadIdx.x;
    next_mask = key < a.lk ? mask_b[key] : 0.0f;
  };
  auto put_record = [&](int it) {
    const int key = it * kTile + threadIdx.x;
    uint32_t col, mix;
    key_part(a, cell, key, col, mix);
    key_s[(it & 1) * kTile + threadIdx.x] =
        make_float4(key < a.lk ? (1.0f - next_mask) * kNegBias : -INFINITY,
                    __uint_as_float(col), __uint_as_float(mix),
                    geo.col_is_answer(key) ? 1.0f : 0.0f);
  };

  const size_t tile_off = (size_t(b) * a.lq + row0) * hd + h * kHeadDim;
  stage_tile(q_s, a.q + tile_off, a.lq - row0, hd);
  stage_tile(g_s, a.go + tile_off, a.lq - row0, hd);
  load_chunk(0);  // one group with the Q and g tiles
  if (threadIdx.x < kTile) {
    fetch(0);
    put_record(0);
    if (n_chunks > 1) fetch(1);
  }

  // this lane's rows, row_g and row_g + 8
  const int row_g = row0 + warp * 16 + (lane >> 2);
  float lse[2], delta[2], w_row[2], c_row[2];
  uint32_t row_base[2], row_mix[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    const bool valid = row < a.lq;
    lse[r] = valid ? a.lse[size_t(cell) * a.lq + row] : INFINITY;
    delta[r] = valid ? a.delta[size_t(cell) * a.lq + row] : 0.0f;
    w_row[r] = geo.row(row).w;  // the row's multiplier at answer columns
    c_row[r] = a.scale * w_row[r];
    row_part(a, row, row_base[r], row_mix[r]);
  }

  uint32_t qa[4][4], ga[4][4];
  float acc[8][4];
  zero(acc);

  for (int it = 0; it < n_chunks; ++it) {
    if (it + 1 < n_chunks) {
      load_chunk(it + 1);
      if (threadIdx.x < kTile) {
        put_record(it + 1);  // its buffer was last read before the previous barrier
        if (it + 2 < n_chunks) fetch(it + 2);
      }
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
    const bf16* kc = k_s + buf * kTileElems;
    const float4* keys = key_s + buf * kTile;

    float s[8][4], dp[8][4];
    zero(s);
    product_nt(s, qa, kc);  // S = Q K^T
    zero(dp);
    product_nt(dp, ga, v_s + buf * kTileElems);  // dP = g V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, j = nt * 8 + 2 * t + (e & 1);
        const float4 kr = keys[j];  // bias, dropout column, key mix, answer column
        const bool answer = kr.w != 0.0f;
        const float p =
            exp_minus_max(fmaf(s[nt][e], answer ? c_row[r] : a.scale, kr.x), lse[r]);
        float d = dp[nt][e];
        if (a.dropout) {
          const bool keep = dropout_keep(row_base[r] + __float_as_uint(kr.y),
                                         row_mix[r] + __float_as_uint(kr.z), a.threshold);
          d = keep ? d * a.inv_keep : 0.0f;
        }
        float ds = p * (d - delta[r]);
        if (answer) ds *= w_row[r];
        s[nt][e] = ds * a.scale;
      }
    }
    uint32_t da[4][4];
    pack_a(da, s);
    product_nn(acc, da, kc);  // dq += dS_raw K
    __syncthreads();  // the buffers are refilled by the load after next
  }

  store_rows(a.dq + tile_off + size_t(warp) * 16 * hd, hd, a.lq - row0 - warp * 16,
             q_s + warp * 16 * kStride, acc);
}

Args make_args(const void* q, const void* k, const void* v, const void* g, const void* mask,
               const void* boundary, const void* w, const void* lse, const void* delta,
               int lq, int lk, int num_heads, float scale, int has_geometry, int row_start,
               int text_len, int offset, int dropout, uint32_t threshold, float inv_keep,
               uint32_t seed, int bq, int bk, int n_qblk, int n_kblk) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.go = static_cast<const bf16*>(g);
  a.mask = static_cast<const float*>(mask);
  a.boundary = static_cast<const int*>(boundary);
  a.w = static_cast<const float*>(w);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.lq = lq;
  a.lk = lk;
  a.num_heads = num_heads;
  a.scale = scale;
  a.has_geometry = has_geometry;
  a.row_start = row_start;
  a.text_len = text_len;
  a.offset = offset;
  a.dropout = dropout;
  a.threshold = threshold;
  a.inv_keep = inv_keep;
  a.seed = seed;
  a.bq = bq;
  a.bk = bk;
  a.n_qblk = n_qblk;
  a.n_kblk = n_kblk;
  return a;
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the larger of the two kernels' blocks.
size_t mkg_flash_attention_bwd_mma_smem() { return kDkvSmem > kDqSmem ? kDkvSmem : kDqSmem; }

// dK/dV and the dw partials: launches on `stream` without synchronising and
// returns cudaGetLastError() (cudaErrorInvalidValue for anything but bf16:
// fp32 takes the CUDA-core kernels). q, k, v, g, dk and dv are bf16, packed
// (B, L, heads * 64); lse and delta (B, heads, Lq) fp32; dw_part
// (B, heads, ceil(Lk / 64), 2) fp32 partials of (dw0, dw1).
int mkg_flash_attention_bwd_dkv_mma(const void* q, const void* k, const void* v, const void* g,
                                    const void* mask, const void* boundary, const void* w,
                                    const void* lse, const void* delta, void* dk, void* dv,
                                    void* dw_part, int batch, int lq, int lk, int num_heads,
                                    int is_bf16, float scale, int has_geometry, int row_start,
                                    int text_len, int offset, int dropout,
                                    unsigned int threshold, float inv_keep, unsigned int seed,
                                    int bq, int bk, int n_qblk, int n_kblk, void* stream) {
  if (!is_bf16) return int(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, g, mask, boundary, w, lse, delta, lq, lk, num_heads, scale,
                     has_geometry, row_start, text_len, offset, dropout, threshold, inv_keep,
                     seed, bq, bk, n_qblk, n_kblk);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dw_part = static_cast<float*>(dw_part);
  cudaError_t err =
      cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((lk + kTile - 1) / kTile, num_heads, batch);
  dkv_kernel<<<grid, kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

// dQ: as above, without dw.
int mkg_flash_attention_bwd_dq_mma(const void* q, const void* k, const void* v, const void* g,
                                   const void* mask, const void* boundary, const void* w,
                                   const void* lse, const void* delta, void* dq, int batch,
                                   int lq, int lk, int num_heads, int is_bf16, float scale,
                                   int has_geometry, int row_start, int text_len, int offset,
                                   int dropout, unsigned int threshold, float inv_keep,
                                   unsigned int seed, int bq, int bk, int n_qblk, int n_kblk,
                                   void* stream) {
  if (!is_bf16) return int(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, g, mask, boundary, w, lse, delta, lq, lk, num_heads, scale,
                     has_geometry, row_start, text_len, offset, dropout, threshold, inv_keep,
                     seed, bq, bk, n_qblk, n_kblk);
  a.dq = static_cast<bf16*>(dq);
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((lq + kTile - 1) / kTile, num_heads, batch);
  dq_kernel<<<grid, kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
