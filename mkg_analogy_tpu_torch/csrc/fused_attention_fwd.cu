// Fused multi-head attention forward for the MarT towers, fp32, sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/attention.py:_fwd_kernel
// (:124, launched by _fused_attention_fwd, the pl.pallas_call at :313) on
// the fp32 route; bf16 takes the tensor-core kernel
// (fused_attention_fwd_mma.cu). Contract:
//
//   out = softmax(scale * Q K^T (*) analogy multiplier + (1 - mask) * -1e4) V
//
// per (batch row, head), on the packed (B, L, heads * D) layout that the
// projection GEMMs produce, in and out; D, the head width, is 64 or 128,
// each its own instantiation, or any other width up to 256 through the
// instance of its padded width, in a library of its own
// (attention_width.cuh: zero beyond the real width; rows staged element by
// element where a head's rows are not 16-byte aligned). The analogy
// multiplier is computed inline from (row, col, boundary[b]) with the
// geometry of attention.py:_geometry_planes (row_start, text_len, offset);
// it is never stored as a plane. w = (w0, w1) arrives already clamped. The
// score is rounded as the plain version rounds it (kernels/attention.py:
// _score): fmaf(acc, scale, bias) without a geometry, fmaf(acc * scale, w
// or 1, bias) with one, acc * scale rounded first.
//
// Dropout uses the counter hash of the JAX kernel's interpret mode
// (attention.py:_dropout_keep): idx = row * Lk + col, with the per-(b, head)
// seed of attention.py:_cell_seed, seed + b * cell_stride + head (a rank of
// a mesh passes the global head count as the stride and folds the global
// cell of its first row and head into the seed). The plain PyTorch version
// (kernels/attention.py:fused_attention_reference) uses the same hash, so
// the two agree mask for mask. The TPU's hardware random bits are not
// reproduced.
//
// What bounds it: fp32 operations. A (b, head) does 4 * Lq * Lk * d flops
// (Q K^T and P V) on 16 * L * d bytes: Lk / 4 flops a byte, 32 at L = 128,
// above the H100's fp32 balance point (67 TFLOP/s over 3.35 TB/s: 20). The
// CUDA cores' 67 TFLOP/s is the bound; no tensor-core format keeps the fp32
// bar of 2e-5 (TF32 keeps three digits). The kernel is the tiled forward of
// attention_fp32_fwd.cuh with kFlash = false (register micro-tiles, a
// cp.async ring of K and V tiles, one online-softmax sweep over any Lk;
// the flash forward of row 3 is the same body): it writes each row's (max,
// log of its sum), whose sum is the row's log-sum-exp, and the backward
// (fused_attention_bwd.cu) rebuilds P from them in one sweep.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fp32_fwd.cuh"

using namespace attention_fp32;

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory a block takes at this head width, whatever the
// lengths (the wrapper holds it against the device's opt-in limit before
// launching); 0 for a width the library does not take.
size_t mkg_fused_attention_fwd_smem(int head_dim) {
  return with_width(head_dim, size_t(0),
                    [&](auto width) { return Fwd<decltype(width)::value, false>::bytes(0); });
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// fp32 q, k, v (B, Lq or Lk, heads * head_dim) and out likewise; lse
// (B, heads, Lq, 2) fp32, each row's max and log of its sum. head_dim is 64
// or 128 (or, in a library of one padded width, any width that rounds up
// to it); keep_div is 1 - rate.
int mkg_fused_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                            const void* boundary, const void* w, void* out, void* lse,
                            int batch, int lq, int lk, int num_heads, int head_dim,
                            float scale, int has_geometry, int row_start, int text_len,
                            int offset, int dropout, unsigned int threshold, float keep_div,
                            unsigned int seed, unsigned int cell_stride, void* stream) {
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
  a.keep = keep_div;
  a.seed = seed;
  a.cell_stride = cell_stride;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_width(head_dim, int(cudaErrorInvalidValue), [&](auto width) {
    constexpr int D = decltype(width)::value;
    return launch_kernel(fwd_kernel<D, false>, fwd_grid<D, false>(batch, lq, num_heads),
                         Fwd<D, false>::bytes(0), a, s);
  });
}

}  // extern "C"
