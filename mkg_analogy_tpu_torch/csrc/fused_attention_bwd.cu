// Fused multi-head attention backward for the MarT towers, fp32, sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/attention.py:_bwd_kernel
// (:159, launched by _fused_attention_bwd, the pl.pallas_call at :350, under
// the jax.custom_vjp at :286-383) on the fp32 route; bf16 takes the
// tensor-core kernels (fused_attention_bwd_mma.cu). Given q, k, v, the
// output cotangent g, the forward's output and row statistics (each row's
// max m and log of its sum, fused_attention_fwd.cu) and its mask, boundary,
// (w0, w1) and seed, it rebuilds the probabilities and the dropout mask and
// writes
//
//   dv = P~^T g             P~ = dropout(P), P = exp(S - m - log l)
//   dP = (g V^T) * keep / (1 - rate)
//   dS = P * (dP - delta),  delta = rowsum(g * out) = rowsum(dP * P)
//   dq = dS_raw K,  dk = dS_raw^T q,   dS_raw = dS * mult * scale
//   dw0 / dw1 = sum(dS * S_raw) over the two analogy regions
//
// with the cast points of _bwd_kernel (:199, :208-217; each a no-op in fp32),
// on the packed (B, L, heads * D) layout in and out, D = 64 or 128, each its
// own instantiation, or any other width up to 256 through the instance of
// its padded width, in a library of its own (attention_width.cuh, as
// fused_attention_fwd.cu). delta = rowsum(g * out) is the identity rows 3-5
// use (kernels/flash_attention.py:_delta): out = P~ V, so g . out =
// sum_j P~_j (g . v_j) = rowsum(dP * P) with dropout too. The dropout mask
// is the counter hash of fused_attention_fwd.cu, so it is the forward's mask
// bit for bit. The plain PyTorch version is
// kernels/attention.py:fused_attention_bwd_reference.
//
// What bounds it: fp32 operations, 10 * Lq * Lk * d flops a (b, head) (S
// recomputed, dP, dv, dq, dk) on ~28 * L * d bytes, above the H100's fp32
// balance point of 20 flops a byte; the bound is the CUDA cores' 67
// TFLOP/s (no tensor-core format keeps the fp32 bar). Hopper blocks run in
// no order and carry nothing, so the work is split in two passes, each one
// sweep over the other side with register micro-tiles
// (attention_fp32_bwd.cuh, shared with the flash backward of rows 4-5):
//   1. dq pass — one block per (query tile of 64 rows, head, batch row; and
//      above D = 128 per 64 columns of dq): it computes its rows' delta
//      from g and out (and writes it for pass 2; where every key fits one
//      tile, rowsum(dP * P) of that tile instead, which is exact where P is
//      one-hot, as the plain version's dS = 0), sweeps the keys and writes
//      one (dw0, dw1) partial per (b, head, query tile), which the wrapper
//      sums.
//   2. dK/dV pass — one block per (key tile of 64 keys, head, batch row;
//      and above D = 128 per 64 columns of dk and dv), sweeping the query
//      rows with their statistics and delta.
// At D <= 64 the other side's tiles are 64 rows in one buffer (4 x 4
// micro-tiles, two blocks an SM: on an H100 faster at ViLT's 418 keys and
// MKGformer's shapes than 32 rows in two buffers, whose 4 x 2 micro-tiles
// read more shared memory an FMA, and a little slower at 1024 x 1024).

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fp32_bwd.cuh"

using namespace attention_fp32;

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the larger of the two passes' blocks at this
// head width, whatever the lengths (the wrapper holds it against the
// device's opt-in limit before launching); 0 for a width the library does
// not take.
size_t mkg_fused_attention_bwd_smem(int head_dim) {
  return with_width(head_dim, size_t(0), [&](auto width) {
    return Bwd<decltype(width)::value>::kBytes;
  });
}

// Launches both passes on `stream` without synchronising (the dq pass
// first: it writes delta, which the dK/dV pass reads); returns
// cudaGetLastError(). fp32 throughout: out is the forward's output, lse its
// (B, heads, Lq, 2) row statistics, delta (B, heads, Lq) scratch, dw_part
// (B, heads, ceil(Lq / 64), 2) the partials of (dw0, dw1). head_dim is 64
// or 128 (or, in a library of one padded width, any width that rounds up
// to it); inv_keep is 1 / (1 - rate).
int mkg_fused_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                            const void* mask, const void* boundary, const void* w,
                            const void* out, const void* lse, void* dq, void* dk, void* dv,
                            void* delta, void* dw_part, int batch, int lq, int lk,
                            int num_heads, int head_dim, float scale, int has_geometry,
                            int row_start, int text_len, int offset, int dropout,
                            unsigned int threshold, float inv_keep, unsigned int seed,
                            unsigned int cell_stride, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.g = static_cast<const float*>(g);
  a.mask = static_cast<const float*>(mask);
  a.boundary = static_cast<const int*>(boundary);
  a.w = static_cast<const float*>(w);
  a.out = static_cast<const float*>(out);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.delta = static_cast<float*>(delta);
  a.dw_part = static_cast<float*>(dw_part);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    constexpr int D = decltype(width)::value;
    const dim3 grid_dq(((lq + kRows - 1) / kRows) * groups_of<D>(), num_heads, batch);
    const dim3 grid_dkv(((lk + kRows - 1) / kRows) * groups_of<D>(), num_heads, batch);
    int err = launch_kernel(dq_kernel<D, false>, grid_dq, Bwd<D>::kDqBytes, a, s);
    if (err != 0) return err;
    return launch_kernel(dkv_kernel<D, false>, grid_dkv, Bwd<D>::kDkvBytes, a, s);
  });
}

}  // extern "C"
