// Bilinear resize of uint8 image canvases plus channel normalisation, sm_90a.
//
// Replaces the TPU kernel mkg_analogy_tpu/kernels/image_prep.py:_resize_kernel
// (launched by resize_normalize_pallas, the pl.pallas_call at :136). Contract:
//
//   out[b, k] = ((W_y(h_b) @ (canvas[b, :, :, k] / 255)) @ W_x(w_b)^T - mean[k]) / std[k]
//
// for a (B, C, C, 3) uint8 canvas that holds image b in its top-left
// (h_b, w_b) corner and a (B, 2) int32 tensor of those extents, into a
// (B, 3, S, S) fp32 output. W(size) is the (S, C) bilinear interpolation
// matrix of image_prep.py:_interp_matrix (align_corners=False): source
// coordinate (dst + 0.5) * size / S - 0.5 clipped to [0, size - 1], weight
// 1 - frac on floor(src) and frac on the next pixel, all weight on the last
// pixel at the edge.
//
// The TPU kernel builds both matrices and runs two matrix products per
// channel, because its matrix unit is the cheap way to gather. Each row of
// W has at most two non-zeros, so here an output pixel is a 2 x 2 tap: one
// thread per output pixel (b, o, p) derives its two row taps and two column
// taps from (h_b, w_b) with the same fp32 operations as _interp_matrix,
// reads up to four source pixels x 3 channels straight from the uint8
// canvas, and writes the three channel planes. The zeros the matrix products
// add are exact, so the 2-tap sums are the same sums. The order of
// operations is the JAX functions': / 255 on each pixel, the row (W_y)
// combination, then the column (W_x) combination, then the normalisation;
// every step is an explicitly rounded intrinsic, so nvcc contracts nothing
// of its own accord. The three divisions by constants (size / S, x / 255,
// (x - mean) / std) are products with the constant's fp32 reciprocal, and
// the source coordinate (dst + 0.5) * scale - 0.5 is one fused multiply-add,
// as XLA compiles both in the JAX functions (its algebraic simplifier
// rewrites A / const; its code generator contracts the multiply and the
// subtraction) and as the plain PyTorch version computes them. That matters:
// the source coordinate reaches 511, where one ulp is 6e-5, so a coordinate
// that is one ulp off moves a noisy image's result by up to ~4e-4, forty
// times the bar this kernel is held to. Where the coordinate lands within
// an ulp of an integer, this kernel and a matrix-product version may floor
// to neighbouring pixels; the result is continuous there (frac near 0 or
// 1), so they agree to ~1e-6, not bit for bit.
//
// Nothing outside the (h_b, w_b) extent is read: at the last pixel the
// second tap has weight 0 and is skipped. Extents are clamped to [1, C] so
// that a bad size cannot read outside the canvas.
//
// What bounds it: bytes. An output pixel costs a few dozen operations and
// moves 12 bytes out and at most 12 bytes in, so the least time is h * w * 3
// bytes read plus 3 * S * S * 4 bytes written per image over the memory
// rate. Threads with neighbouring p write neighbouring floats of each plane
// (coalesced stores) and read source pixels a constant stride apart in one
// or two canvas rows; the canvas is read through the read-only cache, where
// the overlap between neighbouring taps is served.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;  // output columns per block (one warp a row)
constexpr int kBlockY = 8;   // output rows per block

struct Tap {
  int lo;      // first source pixel
  int hi;      // second source pixel (lo at the edge, where its weight is 0)
  float w_lo;  // 1 - frac, or 1 at the edge
  float w_hi;  // frac, or 0 at the edge
};

// image_prep.py:_interp_matrix for one destination index, as its two
// non-zero entries.
__device__ __forceinline__ Tap make_tap(int size, int dst, float inv_out) {
  const float fsize = static_cast<float>(size);
  const float scale = __fmul_rn(fsize, inv_out);
  float src = __fmaf_rn(__fadd_rn(static_cast<float>(dst), 0.5f), scale, -0.5f);
  src = fminf(fmaxf(src, 0.0f), __fsub_rn(fsize, 1.0f));
  const float lo = floorf(src);
  const float frac = __fsub_rn(src, lo);
  Tap t;
  t.lo = static_cast<int>(lo);
  if (__fadd_rn(lo, 1.0f) >= fsize) {  // last source pixel: all weight on lo
    t.hi = t.lo;
    t.w_lo = 1.0f;
    t.w_hi = 0.0f;
  } else {
    t.hi = t.lo + 1;
    t.w_lo = __fsub_rn(1.0f, frac);
    t.w_hi = frac;
  }
  return t;
}

__device__ __forceinline__ float unit(const uint8_t* p) {
  return __fmul_rn(static_cast<float>(__ldg(p)), 1.0f / 255.0f);
}

// W_y's two taps of one canvas column, one channel.
__device__ __forceinline__ float rows(const uint8_t* top, const uint8_t* bottom,
                                      const Tap& ty) {
  float r = __fmul_rn(ty.w_lo, unit(top));
  if (ty.w_hi != 0.0f) r = __fadd_rn(r, __fmul_rn(ty.w_hi, unit(bottom)));
  return r;
}

__global__ void __launch_bounds__(kBlockX* kBlockY)
resize_normalize_kernel(const uint8_t* __restrict__ canvas,
                        const int* __restrict__ sizes, float* __restrict__ out,
                        int canvas_size, int out_size, float inv_out, float3 mean,
                        float3 inv_std) {
  const int p = blockIdx.x * kBlockX + threadIdx.x;
  const int o = blockIdx.y * kBlockY + threadIdx.y;
  const int b = blockIdx.z;
  if (p >= out_size || o >= out_size) return;
  const int h = min(max(sizes[2 * b], 1), canvas_size);
  const int w = min(max(sizes[2 * b + 1], 1), canvas_size);
  const Tap ty = make_tap(h, o, inv_out);
  const Tap tx = make_tap(w, p, inv_out);

  const size_t row_bytes = size_t(canvas_size) * 3;
  const uint8_t* img = canvas + size_t(b) * canvas_size * row_bytes;
  const uint8_t* top = img + ty.lo * row_bytes;
  const uint8_t* bottom = img + ty.hi * row_bytes;
  const float means[3] = {mean.x, mean.y, mean.z};
  const float inv_stds[3] = {inv_std.x, inv_std.y, inv_std.z};
  const size_t plane = size_t(out_size) * out_size;
  float* dst = out + size_t(b) * 3 * plane + size_t(o) * out_size + p;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float v = __fmul_rn(tx.w_lo, rows(top + tx.lo * 3 + k, bottom + tx.lo * 3 + k, ty));
    if (tx.w_hi != 0.0f) {
      v = __fadd_rn(v, __fmul_rn(tx.w_hi,
                                 rows(top + tx.hi * 3 + k, bottom + tx.hi * 3 + k, ty)));
    }
    dst[k * plane] = __fmul_rn(__fsub_rn(v, means[k]), inv_stds[k]);
  }
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
// inv_out and inv_std* are the fp32 reciprocals of out_size and of the
// channel standard deviations, rounded by the caller.
int mkg_resize_normalize(const void* canvas, const void* sizes, void* out, int batch,
                         int canvas_size, int out_size, float inv_out, float mean0,
                         float mean1, float mean2, float inv_std0, float inv_std1,
                         float inv_std2, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((out_size + kBlockX - 1) / kBlockX, (out_size + kBlockY - 1) / kBlockY,
                  batch);
  resize_normalize_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(canvas), static_cast<const int*>(sizes),
      static_cast<float*>(out), canvas_size, out_size, inv_out,
      make_float3(mean0, mean1, mean2), make_float3(inv_std0, inv_std1, inv_std2));
  return int(cudaGetLastError());
}

}  // extern "C"
