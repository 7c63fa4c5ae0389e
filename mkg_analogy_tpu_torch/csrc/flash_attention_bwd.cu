// K-blocked (flash) fused attention backward for the MarT towers, fp32,
// sm_90a: two kernels, two launches.
//
// Replaces the TPU kernels mkg_analogy_tpu/kernels/flash_attention.py:
// _flash_bwd_kv_kernel (the pl.pallas_call at :453) and _flash_bwd_q_kernel
// (:491), under the jax.custom_vjp at :361-512, on the fp32 route; bf16
// takes the tensor-core kernels (flash_attention_bwd_mma.cu). Given q, k, v,
// the output cotangent g, the forward's mask, boundary, (w0, w1) and seed,
// its per-row log-sum-exp lse (flash_attention_fwd.cu) and delta =
// rowsum(g * out) (kernels/flash_attention.py:_delta), both (B, heads, Lq)
// fp32, they recompute the probabilities p = exp(s - lse) element by
// element and write
//
//   dv = P_drop^T g            P_drop = dropout(P)
//   dP = (g V^T) * keep / (1 - rate)
//   dS = P * (dP - delta)
//   dq = dS_raw K,  dk = dS_raw^T q,   dS_raw = dS * mult * scale
//   dw0 / dw1 = sum(dS * S_raw) over the two analogy regions
//
// with the cast points of the Pallas bodies (:233-254, :320; each a no-op
// in fp32), on the packed (B, L, heads * D) layout in and out, D = 64 or
// 128 (ViLBERT's visual stream), each its own instantiation, or any other
// width up to 256 through the instance of its padded width, in a library of
// its own (attention_width.cuh). The dropout masks are the forward's: the
// interpret-mode hash keyed to the logical (bq, bk) tiles, idx =
// row_in_tile * bk + col_in_tile, tile seed seed + (cell * n_qblk + qb) *
// n_kblk + kb, cell = b * cell_stride + head (b * heads + head on one
// device; a rank of a mesh passes the global head count and folds its
// first cell into the seed). Nothing else depends on the logical tiles, so
// the kernels tile rows and keys by 64 and compute each (row, key) on its
// own. The plain version is
// kernels/flash_attention.py:flash_attention_bwd_reference; the kernels'
// walk, in plain PyTorch, kernels/flash_attention.py:_tiled_bwd.
//
// What bounds it: fp32 operations. The dK/dV kernel runs 4 products of
// 2 * Lq * Lk * D flops a (b, head) (S^T and dP^T recomputed, dv, dk), the
// dQ kernel 3 (S, dP, dq), on ~8 * L * D bytes each: far above the H100's
// fp32 balance point of 20 flops a byte at every main-path shape (L >= 72,
// D = 64). The bound is the CUDA cores' 67 TFLOP/s (no tensor-core format
// keeps the fp32 bar of 2e-5). An fp32 product on the CUDA cores is bound
// by shared-memory traffic unless each load feeds several FMAs, so both
// kernels are the two passes of the tiled single-block backward
// (attention_fp32_bwd.cuh, kFlash = true: what the flash pair computes
// otherwise is listed there), which hold a 4 x (tile / 16) register
// micro-tile a thread for every product:
//   - dK/dV: one block per (64 keys, head, batch row; above D = 128 per 64
//     columns of dk and dv). It stages its K and V tiles once and sweeps the
//     query rows in tiles through a cp.async ring, with their lse and delta;
//     it writes one (dw0, dw1) partial per (b, head, 64-key tile), which the
//     wrapper sums (no float atomics: fp32 results repeat from run to run).
//   - dQ: one block per (64 query rows, head, batch row; above D = 128 per
//     64 columns of dq). It stages q and g once and sweeps the keys in tiles.
// Sharing the passes rather than copying them: the flash pair and the
// single-block backward differ in four places (statistics, delta, dropout
// cells, which pass sums dw), each an `if constexpr` on kFlash, so one body
// of each pass serves both and their tiling cannot drift apart. Shared
// memory is set by the head width alone (88 / 108 KB at 64, 144 / 156 KB at
// 128, 203 / 211 KB at 256), whatever the lengths.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fp32_bwd.cuh"

using namespace attention_fp32;

namespace {

Args make_args(const void* q, const void* k, const void* v, const void* g, const void* mask,
               const void* boundary, const void* w, const void* lse, const void* delta,
               int lq, int lk, int num_heads, int head_dim, float scale, int has_geometry,
               int row_start, int text_len, int offset, int dropout, unsigned int threshold,
               float inv_keep, unsigned int seed, unsigned int cell_stride, int bq, int bk,
               int n_qblk, int n_kblk) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.g = static_cast<const float*>(g);
  a.mask = static_cast<const float*>(mask);
  a.boundary = static_cast<const int*>(boundary);
  a.w = static_cast<const float*>(w);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.delta = static_cast<float*>(const_cast<void*>(delta));
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
  return a;
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the larger of the two kernels' blocks at this
// head width, whatever the lengths (the wrapper holds it against the
// device's opt-in limit before launching); 0 for a width the library does
// not take.
size_t mkg_flash_attention_bwd_smem(int head_dim) {
  return with_width(head_dim, size_t(0),
                    [&](auto width) { return Bwd<decltype(width)::value>::kBytes; });
}

// dK/dV and the dw partials: launches on `stream` without synchronising and
// returns cudaGetLastError() (cudaErrorInvalidValue for a head_dim this
// library does not take, or bf16, which the tensor-core kernels take).
// lse and delta are (B, heads, Lq) fp32, dw_part (B, heads, ceil(Lk / 64),
// 2) fp32 partials of (dw0, dw1); inv_keep is 1 / (1 - rate).
int mkg_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                const void* mask, const void* boundary, const void* w,
                                const void* lse, const void* delta, void* dk, void* dv,
                                void* dw_part, int batch, int lq, int lk, int num_heads,
                                int head_dim, int is_bf16, float scale, int has_geometry,
                                int row_start, int text_len, int offset, int dropout,
                                unsigned int threshold, float inv_keep, unsigned int seed,
                                unsigned int cell_stride, int bq, int bk, int n_qblk,
                                int n_kblk, void* stream) {
  if (is_bf16) return int(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, g, mask, boundary, w, lse, delta, lq, lk, num_heads, head_dim,
                     scale, has_geometry, row_start, text_len, offset, dropout, threshold,
                     inv_keep, seed, cell_stride, bq, bk, n_qblk, n_kblk);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dw_part = static_cast<float*>(dw_part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    constexpr int D = decltype(width)::value;
    const dim3 grid(((lk + kRows - 1) / kRows) * groups_of<D>(), num_heads, batch);
    return launch_kernel(dkv_kernel<D, true>, grid, Bwd<D>::kDkvBytes, a, s);
  });
}

// dQ: launches on `stream` without synchronising and returns
// cudaGetLastError(), as above.
int mkg_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                               const void* mask, const void* boundary, const void* w,
                               const void* lse, const void* delta, void* dq, int batch,
                               int lq, int lk, int num_heads, int head_dim, int is_bf16,
                               float scale, int has_geometry, int row_start, int text_len,
                               int offset, int dropout, unsigned int threshold,
                               float inv_keep, unsigned int seed, unsigned int cell_stride,
                               int bq, int bk, int n_qblk, int n_kblk, void* stream) {
  if (is_bf16) return int(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, g, mask, boundary, w, lse, delta, lq, lk, num_heads, head_dim,
                     scale, has_geometry, row_start, text_len, offset, dropout, threshold,
                     inv_keep, seed, cell_stride, bq, bk, n_qblk, n_kblk);
  a.dq = static_cast<float*>(dq);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    constexpr int D = decltype(width)::value;
    const dim3 grid(((lq + kRows - 1) / kRows) * groups_of<D>(), num_heads, batch);
    return launch_kernel(dq_kernel<D, true>, grid, Bwd<D>::kDqBytes, a, s);
  });
}

}  // extern "C"
