// K-blocked (flash) attention forward on the tensor cores, bf16, sm_90a.
//
// Replaces, for bf16 inputs, the TPU kernel mkg_analogy_tpu/kernels/
// flash_attention.py:_flash_fwd_kernel (:98; launched by
// _flash_attention_fwd, the pl.pallas_call at :393). Contract, per (batch
// row, head), on the packed (B, L, heads * D) layout in and out, D = 64 or
// 128 (ViLBERT's visual stream: 1024 wide, 8 heads), each width its own
// instantiation, or any other width up to 256 through the instance of its
// padded width, in a library of its own (attention_width.cuh; the call's
// width rides in the flags' bits 8 and up, so the arguments stay 128 bytes):
//
//   out = softmax(scale * Q K^T (*) analogy multiplier + (1 - mask) * -1e4) V
//   lse = the per-row log-sum-exp of those scores, (B, heads, Lq) fp32
//
// at the cast points of the Pallas body (:133-170) and of the plain version
// (kernels/flash_attention.py:_plain_fwd): an online softmax over the
// logical K tiles of bk = min(block_k, Lk) keys (512 by default),
//   m_new = max(m, the tile's max)               m starts at -1e30 (:113)
//   p     = exp(s - m_new), its sum taken before dropout
//   l     = l * exp(m - m_new) + that sum
//   acc   = acc * exp(m - m_new) + bf16(dropout(p)) V
//   out   = acc / l in fp32 at the end,  lse = m + log(l).
// In bf16 that grouping is part of the result, since p is rounded against
// the tile's max: a row's running max moves once per logical tile, never
// per staged chunk of 64 keys.
//
// What bounds it: bytes at the main-path shapes (a (batch row, head) of the
// pre-train shapes reads (2 Lq + 2 Lk) * 64 bf16 and does 4 Lq Lk 64 flops,
// ~48 flop/byte at 96 x 96, far below the H100's ~295); operations at 2048
// tokens (chip_smoke.py:flash_bound_times). The CUDA-core kernel it took
// over from (the first design of flash_attention_fwd.cu, which keeps fp32,
// as TF32 cannot meet the fp32 bar of 2e-5, and now runs the tiled fp32
// forward of attention_fp32_fwd.cuh) ran 17-74x that bound: one warp per 4
// query rows of a 32-row block, every product an fmaf with each lane
// re-reading K rows and V pairs from shared memory for every row it owns,
// the whole 32 x bk fp32 score tile through shared memory, K and V in
// synchronous chunks of 128 keys with two barriers each. Here
// (attention_mma.cuh):
//   - a block takes one (64 query rows, head, batch row); four warps of 16
//     rows; both products are mma.sync m16n8k16 on ldmatrix fragments, so a
//     K or V fragment read once from shared memory serves 16 rows, and the
//     weights are repacked from the accumulators into the A fragments of
//     P V without passing through shared memory;
//   - K and V arrive by 16-byte cp.async in chunks of 64 keys, one commit
//     group a chunk. Chunks start at each logical tile's first key, so none
//     straddles two tiles: the end of a ragged tile is padding of its last
//     chunk;
//   - where all the keys are one logical tile of at most 256 (Lk <= bk:
//     the pre-train shapes' 96, 99 and 195 keys, the analogy shapes' 128
//     and 227), the tile is resident: all its chunks of K and V staged at
//     once and its score row kept in accumulator registers
//     (fwd_resident_kernel<64, 2> to 128 keys, 47 KB of shared memory a
//     block; <64, 4> to 256, 84 KB), one Q K^T and one exponential an
//     element, and the running max moves once, from -1e30 (the rescaling
//     by exp(-1e30 - m) of an empty sum and accumulator is exactly
//     nothing). Any other walk (512, 522, 611 and 2048 tokens at bk = 512;
//     393 and 418; tiles shorter than Lk) is streamed through two buffers
//     (fwd_streaming_kernel<64>, 46 KB a block whatever the length): two
//     sweeps over each logical tile's chunks, the first streaming K alone for the
//     tile max, the second K and V, recomputing the same score fragments
//     with the same instructions, bit for bit. The second Q K^T costs
//     tensor-core time that a byte-bound kernel has to spare; holding a
//     512-key score row instead would take 128 KB of shared memory a block
//     and leave one block an SM. (A resident walk over several tiles, tried
//     first, kept the accumulator and the Q fragments live beside the score
//     row and spilled at 256 keys.)
//   - bias, multiplier, max, exp, sum, dropout and rounding work on the
//     accumulator fragment: a lane holds rows g and g + 8 (g = lane / 4),
//     columns 2t and 2t + 1 (t = lane % 4) of each 16 x 8 tile;
//   - at D = 128 a block owns 64 of its head's 128 output columns (a half,
//     from blockIdx.x), as the single-block kernels do
//     (fused_attention_fwd_mma.cu): it computes the whole score row (the
//     depth is 128) and stages only its half of V, so its accumulators are
//     those of D = 64 and the score row is paid for twice; the first half's
//     block writes lse. Up to 128 keys are resident
//     (fwd_resident_kernel<128, 2>, 70 KB), longer walks stream
//     (fwd_streaming_kernel<128>, 70 KB: over the 48 KB of static shared
//     memory, so both widths take theirs dynamically). A 16 x 256 score row
//     beside 128 columns of Q fragments would spill. At the other tile
//     widths (16 to 112) a block owns all D output columns (cols_of<D>);
//     keys stay resident up to 256 at D <= 64, up to 128 above. At 192 and
//     256 three or four blocks own 64 output columns each, and the score
//     takes its Q fragments 64 columns at a time (attention_mma.cuh:
//     product_a): 118 KB of shared memory a block at 256.
// A score is one FMA from the accumulator on the plain version's fp32 grid
// (attention_mma.cuh: scores, ScoreRule<D>: at 128 with a geometry s_raw is
// rounded first); exp(s - m) is ex2.approx of (s - m) * log2 e, the
// difference first; lse takes an accurate logf, as the backward pair reads
// it (held to 1e-5).
//
// Dropout: the interpret-mode hash keyed to the logical (bq, bk) tiles, as
// flash_attention_bwd_mma.cu draws it: idx = (r - qb * bq) * bk + (c - kb *
// bk), tile seed seed + (cell * n_qblk + qb) * n_kblk + kb, cell = b *
// cell_stride + h (b * heads + h on one device; a rank of a mesh folds its
// first cell into the seed), times 0x9E3779B9 (mod 2^32). A row's part of
// each (its index base, its seed times the constant) is derived once a
// lane, so a 64-row block may straddle logical Q tiles (bq not a multiple of
// 64); since chunks start inside their tile, a key's part is its offset in
// the tile and kb * 0x9E3779B9: no division in the loop. Applied to the
// unnormalised p after the sum, as p * (1 / (1 - rate)).
//
// Padding is a value, not a predicate: a key beyond its tile (or Lk) is
// zero-filled and has bias -inf, so it takes no part in max or sum and its
// p is exactly 0 (JAX's -1e30 gives the same zero weight); a row beyond Lq
// is zero-filled, and neither out nor lse is stored for it.
//
// Causal calls and a value width of its own (latent attention: queries and
// keys of 192 columns, values of 128) are taken in a library of one padded
// width only (attention_width.cuh; the wrapper sends such a call there
// whatever its width), and only its instances see the code for them (`if
// constexpr (kRagged)`, or the walk's own view of the call): the instances
// of 64 and 128 compile as before, register for register (a value width
// carried through their code, equal in value, moved ptxas's allocation and
// slowed them by 1-2%, tools/time_attention.py --flash, PERF.md):
//   - causal (flags bit 2; Lq = Lk): a key after its row scores -inf, as the
//     padding does (attention_mma.cuh: scores), and a block walks no key past
//     its last row: the resident kernel stops at the chunk of its diagonal,
//     the streaming walk ends there, in whatever logical tile it lies;
//   - d_v <= d (flags bits 17-25; bits 8-16 are d): V, the output and their
//     rows are d_v wide; a block stages d_v - 64 group columns of V, the
//     rest zero, and from 128 up a group that owns none of the d_v columns
//     returns at once.

#include "attention_mma.cuh"

using namespace attention_mma;

namespace {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr float kHardMask = -1e30f;          // flash_attention.py:HARD_MASK, the first max
constexpr int kMaxResidentKeys = 4 * kTile;  // longer keys are streamed (2 kTile at D = 128)

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
  float* lse;  // (B, heads, Lq)
  int lq, lk, num_heads;
  float scale;
  int row_start, text_len, offset;
  int flags;  // bit 0: the analogy geometry applies; bit 1: dropout; bit 2: causal;
             // bits 8-16 the call's head width, 17-25 its value width (bits 2
             // and 8-25 in a library of one padded width only)
  uint32_t threshold;
  float inv_keep;
  uint32_t seed;
  uint32_t cell_stride;  // dropout cell of (b, h): b * cell_stride + h
  int bq, bk, n_qblk, n_kblk;

  __device__ __forceinline__ int has_geometry() const { return flags & 1; }
  __device__ __forceinline__ bool dropout() const { return flags & 2; }
};
// 128 bytes: grown to 136 (the two flags and a cell offset as fields of
// their own), the kernels ran 17-28% slower at every shape, with and without
// dropout (mkg_analogy_tpu_torch/tools/time_attention.py --flash, H100).
static_assert(sizeof(Args) == 128, "keep the forward's arguments at 128 bytes");

// What a lane knows of its two rows, row_g and row_g + 8 of the block.
template <int D>
struct Lane {
  Geometry geo;
  int row_g;
  ScoreRule<D> rule;
  float c_row[2];         // c at the rows' answer columns
  uint32_t row_base[2];   // (r - qb * bq) * bk: the row's part of the dropout index
  uint32_t row_mix[2];    // (seed + (cell * n_qblk + qb) * n_kblk) * 0x9E3779B9

  __device__ __forceinline__ Lane(const Args& a, int b, int h, int row0)
      : rule(a.scale, a.has_geometry()) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t cell = uint32_t(b) * a.cell_stride + uint32_t(h);
    geo = load_geometry(a.has_geometry(), a.row_start, a.text_len, a.offset, a.boundary, a.w, b);
    row_g = row0 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_g + 8 * r;
      const int qb = row / a.bq;
      c_row[r] = rule.c_answer(geo.row(row).w);
      row_base[r] = uint32_t(row - qb * a.bq) * uint32_t(a.bk);
      row_mix[r] =
          (a.seed + (cell * uint32_t(a.n_qblk) + uint32_t(qb)) * uint32_t(a.n_kblk)) * kGolden;
    }
  }

  // the tile seed's part of each row for logical K tile kb
  __device__ __forceinline__ void tile_mix(int kb, uint32_t (&mix)[2]) const {
    mix[0] = row_mix[0] + uint32_t(kb) * kGolden;
    mix[1] = row_mix[1] + uint32_t(kb) * kGolden;
  }
};

// A tile's new running max of the lane's rows, from the lanes' maxima over
// the tile's scores, and alpha = exp(m - m_new), by which the accumulator
// is rescaled here, once a tile.
template <int NT>
__device__ __forceinline__ void open_tile(const float (&cmax)[2], const float (&m)[2],
                                          float (&m_new)[2], float (&alpha)[2],
                                          float (&o)[NT][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = fmaxf(m[r], quad_max(cmax[r]));
    alpha[r] = exp_minus_max(m[r], m_new[r]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    o[nt][0] *= alpha[0];
    o[nt][1] *= alpha[0];
    o[nt][2] *= alpha[1];
    o[nt][3] *= alpha[1];
  }
}

// One chunk's scores -> the weights p = exp(s - m_new), their sum (before
// dropout) folded into the lane's sum, then dropped in place, ready for the
// rounding of pack_a. col0: the chunk's first key, counted in its tile.
template <int D>
__device__ __forceinline__ void weights(float (&s)[8][4], const float (&m_new)[2],
                                        float (&sum)[2], const Args& a, const Lane<D>& ln,
                                        const uint32_t (&mix)[2], int col0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp_minus_max(s[nt][e], m_new[r]);
      sum[r] += p;
      if (a.dropout()) {
        const uint32_t idx = ln.row_base[r] + uint32_t(col0 + nt * 8 + 2 * t + (e & 1));
        p = dropout_keep(idx, mix[r], a.threshold) ? p * a.inv_keep : 0.0f;
      }
      s[nt][e] = p;
    }
  }
}

// The end of a tile: l = l * alpha + the tile's sum, m = m_new.
__device__ __forceinline__ void close_tile(const float (&sum)[2], const float (&alpha)[2],
                                           const float (&m_new)[2], float (&m)[2],
                                           float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), quad_sum(sum[r]));
    m[r] = m_new[r];
  }
}

// The block's coordinates: its tile of 64 query rows, its group of the
// head's output columns (always 0 below D = 128), head and batch row.
template <int D>
struct Block {
  int tile, group, h, b;
  __device__ __forceinline__ Block()
      : tile(blockIdx.x / groups_of<D>()), group(blockIdx.x % groups_of<D>()), h(blockIdx.y),
        b(blockIdx.z) {}
};

// out = acc / l (fp32, then rounded to bf16) of the block's columns and,
// from the first group's block, lse = m + log(l) of the lane's rows; rows
// beyond Lq are not stored. `stage`: the block's Q tile, whose rows of a
// warp no other warp reads.
template <int D>
__device__ __forceinline__ void finish(const Args& a, const Block<D>& blk, int row0,
                                       const Lane<D>& ln, const float (&m)[2],
                                       const float (&l)[2], float (&o)[cols_of<D>() / 8][4],
                                       bf16* stage) {
  constexpr int W = cols_of<D>(), NT = W / 8;
  const int warp = threadIdx.x >> 5;
  int d = D;  // the output's head width: a constant in a library of 64 and 128 (PERF.md)
  if constexpr (kRagged) d = (a.flags >> 17) & 511;
  const int hd = a.num_heads * d;
  const int h = blk.h, b = blk.b;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    o[nt][0] = o[nt][0] / l[0];
    o[nt][1] = o[nt][1] / l[0];
    o[nt][2] = o[nt][2] / l[1];
    o[nt][3] = o[nt][3] / l[1];
  }
  store_rows<D>(a.out + (size_t(b) * a.lq + row0 + warp * 16) * hd + h * d + blk.group * W, hd,
                a.lq - row0 - warp * 16, stage + warp * 16 * stride_of<D>(), o,
                d - blk.group * W);
  if (blk.group == 0 && (threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ln.row_g + 8 * r;
      if (row < a.lq) a.lse[(size_t(b) * a.num_heads + h) * a.lq + row] = m[r] + logf(l[r]);
    }
  }
}

// Keys that are one logical tile of at most 64 NC (Lk <= bk): every chunk
// of K and of the block's columns of V in shared memory, the score row in
// registers, one sweep.
template <int D, int NC>
__global__ void __launch_bounds__(kThreads) fwd_resident_kernel(const Args a) {
  constexpr int W = cols_of<D>(), NT = W / 8;  // the block's output columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + tile_elems<D>();       // NC chunks
  bf16* v_s = k_s + NC * tile_elems<D>();  // NC chunks of the block's W columns
  float* bias_s = reinterpret_cast<float*>(v_s + NC * tile_elems<W>());  // NC rows of 64

  const Block<D> blk;
  const int h = blk.h, b = blk.b;
  int d = D;  // the head width: a constant in a library of 64 and 128 (PERF.md)
  if constexpr (kRagged) d = (a.flags >> 8) & 511;
  int v_cols = d - blk.group * W;
  const int hd = a.num_heads * d;
  int v_ld = hd;  // V's row stride
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int row0 = blk.tile * kTile;
  int n_chunks = (a.lk + kTile - 1) / kTile;  // <= NC
  const bf16* k_bh = a.k + size_t(b) * a.lk * hd + h * d;
  const bf16* v_bh = a.v + size_t(b) * a.lk * hd + h * d + blk.group * W;
  if constexpr (kRagged) {
    const int dv = (a.flags >> 17) & 511;
    if (blk.group * W >= dv) return;  // from 128 up, a group of none of the value columns
    v_cols = dv - blk.group * W;
    v_ld = a.num_heads * dv;
    v_bh = a.v + size_t(b) * a.lk * v_ld + h * dv + blk.group * W;
    if (a.flags & 4) n_chunks = min(n_chunks, blk.tile + 1);  // causal: none past the diagonal's
  }

  // every load of the block, one commit group a chunk: Q with K's first
  stage_tile<D>(q_s, a.q + (size_t(b) * a.lq + row0) * hd + h * d, a.lq - row0, hd, d);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c < n_chunks) {
      stage_tile<D>(k_s + c * tile_elems<D>(), k_bh + size_t(c) * kTile * hd, a.lk - c * kTile,
                    hd, d);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c < n_chunks) {
      stage_tile<W>(v_s + c * tile_elems<W>(), v_bh + size_t(c) * kTile * v_ld,
                    a.lk - c * kTile, v_ld, v_cols);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    stage_bias(bias_s + c * kTile, a.mask + size_t(b) * a.lk, c * kTile, a.lk);
  }
  const Lane<D> ln(a, b, h, row0);

  float s[NC][8][4];
  float cmax[2] = {-FLT_MAX, -FLT_MAX};
  {
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      cp_async_wait_pending(2 * NC - 1 - c);
      __syncthreads();
      if (c == 0) load_a<D>(qa, q_s + warp * 16 * stride_of<D>());
      if (c < n_chunks) {
        zero(s[c]);
        product_nt<D>(s[c], qa, k_s + c * tile_elems<D>());
        if constexpr (kRagged) {
          scores<D>(s[c], ln.geo.answer_bits(c * kTile + 2 * t), ln.rule.c_plain, ln.c_row,
                    bias_s + c * kTile, cmax, ln.rule.pre, (a.flags & 4) ? ln.row_g : -1,
                    c * kTile + 2 * t);
        } else {
          scores<D>(s[c], ln.geo.answer_bits(c * kTile + 2 * t), ln.rule.c_plain, ln.c_row,
                    bias_s + c * kTile, cmax, ln.rule.pre);
        }
      }
    }
  }
  // the one tile: m = max(-1e30, its max); l and the accumulator start from
  // its sums, as l * exp(-1e30 - m) and acc * exp(-1e30 - m) are 0
  float m[2], l[2], sum[2] = {0.0f, 0.0f};
  uint32_t mix[2];
  ln.tile_mix(0, mix);
  m[0] = fmaxf(kHardMask, quad_max(cmax[0]));
  m[1] = fmaxf(kHardMask, quad_max(cmax[1]));
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c < n_chunks) weights(s[c], m, sum, a, ln, mix, c * kTile);
  }
  l[0] = quad_sum(sum[0]);
  l[1] = quad_sum(sum[1]);

  float o[NT][4];
  zero(o);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    cp_async_wait_pending(NC - 1 - c);
    __syncthreads();
    if (c < n_chunks) {
      uint32_t pa[4][4];
      pack_a(pa, s[c]);
      product_nn<W>(o, pa, v_s + c * tile_elems<W>());
    }
  }
  finish(a, blk, row0, ln, m, l, o, q_s);
}

// Where a walk over the keys stands: logical tile kb (keys key0 ..
// tile_end - 1), the sweep over it (0: K alone, for the tile max; 1: K and
// V) and the chunk of 64 keys, counted from the tile's first key.
struct Walk {
  int kb, key0, tile_end, n_chunks, sweep, chunk;

  __device__ __forceinline__ explicit Walk(const Args& a) : kb(0), key0(0), sweep(0), chunk(0) {
    tile(a);
  }
  __device__ __forceinline__ void tile(const Args& a) {
    tile_end = min(key0 + a.bk, a.lk);
    n_chunks = (tile_end - key0 + kTile - 1) / kTile;
  }
  __device__ __forceinline__ bool done(const Args& a) const { return kb >= a.n_kblk; }
  __device__ __forceinline__ bool last_chunk() const { return chunk == n_chunks - 1; }
  __device__ __forceinline__ int chunk_key0() const { return key0 + chunk * kTile; }
  __device__ __forceinline__ void next(const Args& a) {
    if (++chunk < n_chunks) return;
    chunk = 0;
    if (sweep == 0) {
      sweep = 1;
      return;
    }
    sweep = 0;
    ++kb;
    key0 += a.bk;
    tile(a);
  }
};

// Any walk: two sweeps over each logical tile's chunks through two
// buffers. (Blocks of 128 rows, eight warps sharing each chunk, were slower
// at every streamed shape, with two buffers or three.)
template <int D>
__global__ void __launch_bounds__(kThreads) fwd_streaming_kernel(const Args a) {
  constexpr int W = cols_of<D>(), NT = W / 8;  // the block's output columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + tile_elems<D>();       // two buffers
  bf16* v_s = k_s + 2 * tile_elems<D>();   // two buffers of the block's W columns
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * tile_elems<W>());  // two rows of 64

  const Block<D> blk;
  const int h = blk.h, b = blk.b;
  int d = D;  // the head width: a constant in a library of 64 and 128 (PERF.md)
  if constexpr (kRagged) d = (a.flags >> 8) & 511;
  int v_cols = d - blk.group * W;
  const int hd = a.num_heads * d;
  int v_ld = hd;  // V's row stride
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int row0 = blk.tile * kTile;
  const bf16* k_bh = a.k + size_t(b) * a.lk * hd + h * d;
  const bf16* v_bh = a.v + size_t(b) * a.lk * hd + h * d + blk.group * W;
  const float* mask_b = a.mask + size_t(b) * a.lk;
#ifdef MKG_ATTN_DP
  const int dv = (a.flags >> 17) & 511;
  if (blk.group * W >= dv) return;  // from 128 up, a group of none of the value columns
  v_cols = dv - blk.group * W;
  v_ld = a.num_heads * dv;
  v_bh = a.v + size_t(b) * a.lk * v_ld + h * dv + blk.group * W;
  Args wa = a;  // the walk's view of the call: causal, its keys end after the block's rows
  if (a.flags & 4) {
    wa.lk = min(a.lk, row0 + kTile);
    wa.n_kblk = (wa.lk + a.bk - 1) / a.bk;
  }
#else
  const Args& wa = a;
#endif

  // One commit group a chunk: K (and in the second sweep V) and its bias;
  // an empty group past the walk's end keeps the count of groups in flight.
  Walk ahead(wa), wk(wa);
  int ahead_buf = 0;
  auto load_next = [&]() {
    if (!ahead.done(wa)) {
      const int c0 = ahead.chunk_key0();
      stage_tile<D>(k_s + ahead_buf * tile_elems<D>(), k_bh + size_t(c0) * hd,
                    ahead.tile_end - c0, hd, d);
      if (ahead.sweep) {
        stage_tile<W>(v_s + ahead_buf * tile_elems<W>(), v_bh + size_t(c0) * v_ld,
                      ahead.tile_end - c0, v_ld, v_cols);
      }
      stage_bias(bias_s + ahead_buf * kTile, mask_b, c0, ahead.tile_end);
      ahead.next(wa);
      ahead_buf ^= 1;
    }
    cp_async_commit();
  };

  stage_tile<D>(q_s, a.q + (size_t(b) * a.lq + row0) * hd + h * d, a.lq - row0, hd, d);
  load_next();  // one group with the Q tile
  const Lane<D> ln(a, b, h, row0);

  uint32_t qa[D / 16][4];
  float m[2] = {kHardMask, kHardMask}, l[2] = {0.0f, 0.0f};
  float m_new[2] = {kHardMask, kHardMask}, alpha[2] = {1.0f, 1.0f}, sum[2] = {0.0f, 0.0f};
  float cmax[2] = {-FLT_MAX, -FLT_MAX};
  uint32_t mix[2] = {0u, 0u};
  float o[NT][4];
  zero(o);

  for (int buf = 0, first = 1; !wk.done(wa); wk.next(wa), first = 0) {
    load_next();  // into the buffer the previous item was read from
    cp_async_wait<1>();
    __syncthreads();
    if (first) load_a_held<D>(qa, q_s + warp * 16 * stride_of<D>());

    float s[8][4];
    zero(s);
    product_a<D>(s, qa, q_s + warp * 16 * stride_of<D>(), k_s + buf * tile_elems<D>());
    if constexpr (kRagged) {
      scores<D>(s, ln.geo.answer_bits(wk.chunk_key0() + 2 * t), ln.rule.c_plain, ln.c_row,
                bias_s + buf * kTile, cmax, ln.rule.pre, (a.flags & 4) ? ln.row_g : -1,
                wk.chunk_key0() + 2 * t);
    } else {
      scores<D>(s, ln.geo.answer_bits(wk.chunk_key0() + 2 * t), ln.rule.c_plain, ln.c_row,
                bias_s + buf * kTile, cmax, ln.rule.pre);
    }
    if (wk.sweep == 0) {
      if (wk.last_chunk()) {  // the tile max is known
        open_tile(cmax, m, m_new, alpha, o);
        ln.tile_mix(wk.kb, mix);
        sum[0] = sum[1] = 0.0f;
      }
    } else {
      weights(s, m_new, sum, a, ln, mix, wk.chunk * kTile);
      uint32_t pa[4][4];
      pack_a(pa, s);
      product_nn<W>(o, pa, v_s + buf * tile_elems<W>());
      if (wk.last_chunk()) {
        close_tile(sum, alpha, m_new, m, l);
        cmax[0] = cmax[1] = -FLT_MAX;
      }
    }
    buf ^= 1;
    __syncthreads();  // the buffer is refilled by the next load
  }
  finish(a, blk, row0, ln, m, l, o, q_s);
}

int launch_kernel(void (*kernel)(const Args), dim3 grid, int smem, const Args& a,
                  cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// The kernel of a call at tile width D and its shared memory: resident
// where the keys are one logical tile of at most 128 (NC = 2) or, at
// D <= 64, 256 (NC = 4); streaming otherwise.
template <int D>
void (*pick(int lk, int bk, int& smem))(const Args) {
  if (lk <= bk && lk <= 2 * kTile) {
    smem = resident_smem<D>(2);
    return fwd_resident_kernel<D, 2>;
  }
  if constexpr (D <= 64) {
    if (lk <= bk && lk <= kMaxResidentKeys) {
      smem = resident_smem<D>(4);
      return fwd_resident_kernel<D, 4>;
    }
  }
  smem = streaming_smem<D>();
  return fwd_streaming_kernel<D>;
}

template <int D>
int launch(const Args& a, int batch, cudaStream_t s) {
  const dim3 grid((a.lq + kTile - 1) / kTile * groups_of<D>(), a.num_heads, batch);
  int smem = 0;
  void (*kernel)(const Args) = pick<D>(a.lk, a.bk, smem);
  return launch_kernel(kernel, grid, smem, a, s);
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory of one block for Lk keys in logical tiles of bk at head_dim
// 64 or 128 (or a width of this library's padded one; the wrapper holds it
// against the device's opt-in limit before launching); 0 for another width.
size_t mkg_flash_attention_fwd_mma_smem(int lk, int bk, int head_dim) {
  int smem = 0;
  attention_width::with_width(head_dim, 0, [&](auto width) {
    pick<decltype(width)::value>(lk, bk, smem);
    return 0;
  });
  return size_t(smem);
}

// Launches on `stream` without synchronising and returns cudaGetLastError()
// (cudaErrorInvalidValue for anything but bf16, where fp32 takes the
// CUDA-core kernel, for a head_dim this library does not take, or for a
// causal call or a value width other than head_dim outside a library of one
// padded width). q and k are bf16, packed (B, L, heads * head_dim), v and
// out (B, L, heads * head_dim_v), head_dim_v <= head_dim; lse (B, heads,
// Lq) fp32; inv_keep is 1 / (1 - rate); causal needs lq == lk.
int mkg_flash_attention_fwd_mma(const void* q, const void* k, const void* v, const void* mask,
                                const void* boundary, const void* w, void* out, void* lse,
                                int batch, int lq, int lk, int num_heads, int head_dim,
                                int is_bf16, float scale, int has_geometry, int row_start,
                                int text_len, int offset, int dropout, unsigned int threshold,
                                float inv_keep, unsigned int seed, unsigned int cell_stride, int bq,
                                int bk, int n_qblk, int n_kblk, void* stream, int causal,
                                int head_dim_v) {
  if (!is_bf16 || head_dim_v < 1 || head_dim_v > head_dim || (causal && lq != lk) ||
      (!kRagged && (causal || head_dim_v != head_dim))) {
    return int(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const float*>(mask),
               static_cast<const int*>(boundary), static_cast<const float*>(w),
               static_cast<bf16*>(out), static_cast<float*>(lse), lq, lk, num_heads, scale,
               row_start, text_len, offset,
               (has_geometry ? 1 : 0) | (dropout ? 2 : 0) |
                   (kRagged ? (causal ? 4 : 0) | head_dim << 8 | head_dim_v << 17 : 0),
               threshold, inv_keep,
               seed, cell_stride,
               bq, bk, n_qblk, n_kblk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return attention_width::with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    return launch<decltype(width)::value>(a, batch, s);
  });
}

}  // extern "C"
