// K-blocked (flash) fused attention forward for the MarT towers, fp32,
// sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/flash_attention.py:
// _flash_fwd_kernel (:98, launched by _flash_attention_fwd, the
// pl.pallas_call at :393) on the fp32 route; bf16 takes the tensor-core
// kernel (flash_attention_fwd_mma.cu). Contract, per (batch row, head), on
// the packed (B, L, heads * D) layout in and out, D = 64 (BERT-base, ViT-B)
// or 128 (ViLBERT's visual stream: 1024 wide, 8 heads), each its own
// instantiation, or any other width up to 256 through the instance of its
// padded width, in a library of its own (attention_width.cuh):
//
//   out = softmax(scale * Q K^T (*) analogy multiplier + (1 - mask) * -1e4) V
//   lse = the per-row log-sum-exp of those scores, (B, heads, Lq) fp32
//
// which the backward pair (flash_attention_bwd.cu) reads as p = exp(s -
// lse). Dropout: the counter hash of the JAX kernel's interpret mode
// (attention.py:_dropout_keep), keyed to the logical (bq, bk) tiles (bk =
// min(block_k, Lk), 512 by default): idx = row_in_tile * bk + col_in_tile
// (bk even in a ragged last tile), seed = seed + (cell * n_qblk + qb) *
// n_kblk + kb, cell = b * cell_stride + head (b * heads + head on one
// device; a rank of a mesh folds its first cell into the seed)
// (flash_attention.py:_tile_seed), applied to the exp-weights after their
// sum. Keys past Lk are never read: JAX gives them a -1e30 bias
// (_col_bias), an exp-weight of exactly 0. The plain version is
// kernels/flash_attention.py:flash_attention_reference; the kernel's walk,
// in plain PyTorch, kernels/flash_attention.py:_tiled_fwd.
//
// What bounds it: fp32 operations. A (b, head) does 4 * Lq * Lk * D flops
// (Q K^T and P V) on ~16 * L * D bytes: Lk / 4 flops a byte, 24 at 96 x 96,
// above the H100's fp32 balance point of 20 at every main-path shape but
// ViLBERT's 72 x 72 at 128 (bytes there). An fp32 product on the CUDA cores
// is bound by shared-memory traffic unless each load feeds several FMAs, so
// the kernel is the tiled forward of attention_fp32_fwd.cuh with kFlash =
// true, on row 1's tiles (fused_attention_fwd.cu): one block of 256 threads
// per (64 query rows, head, batch row; above D = 128 per 32 rows and 64
// output columns), K and V tiles through a double-buffered cp.async ring,
// 4 x (tile / 16) register micro-tiles for Q K^T and P V, ragged edges
// narrowed to the rows and keys they hold. Each logical K tile is swept
// twice, as JAX's body walks it: its scores and max first (kept in shared
// memory, which therefore grows with bk), then the exp-weights and P V.
// What the flash contract changes (the two sweeps, one lse a row, the
// logical tiles' dropout cells, the first max -1e30, acc / l) is listed in
// that header, each an `if constexpr` on kFlash.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fp32_fwd.cuh"

using namespace attention_fp32;

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory a block takes at this head width and logical tiles
// of bk keys, whatever the lengths (the wrapper holds it against the
// device's opt-in limit before launching); 0 for a width the library does
// not take.
size_t mkg_flash_attention_fwd_smem(int bk, int head_dim) {
  return with_width(head_dim, size_t(0),
                    [&](auto width) { return Fwd<decltype(width)::value, true>::bytes(bk); });
}

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (cudaErrorInvalidValue for a head_dim this library does not take, or
// bf16, which the tensor-core kernel takes). out is (B, Lq, heads *
// head_dim) fp32, lse (B, heads, Lq) fp32; inv_keep is 1 / (1 - rate).
int mkg_flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                            const void* boundary, const void* w, void* out, void* lse,
                            int batch, int lq, int lk, int num_heads, int head_dim,
                            int is_bf16, float scale, int has_geometry, int row_start,
                            int text_len, int offset, int dropout, unsigned int threshold,
                            float inv_keep, unsigned int seed, unsigned int cell_stride, int bq,
                            int bk, int n_qblk, int n_kblk, void* stream) {
  if (is_bf16) return int(cudaErrorInvalidValue);
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
  a.keep = inv_keep;
  a.seed = seed;
  a.cell_stride = cell_stride;
  a.bq = bq;
  a.bk = bk;
  a.n_qblk = n_qblk;
  a.n_kblk = n_kblk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    constexpr int D = decltype(width)::value;
    return launch_kernel(fwd_kernel<D, true>, fwd_grid<D, true>(batch, lq, num_heads),
                         Fwd<D, true>::bytes(bk), a, s);
  });
}

}  // extern "C"
