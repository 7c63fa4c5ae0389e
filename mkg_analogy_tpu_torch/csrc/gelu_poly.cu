// gelu_poly forward and backward, one pass each way, sm_90a.
//
// Replaces no TPU kernel: the JAX package's gelu_poly
// (mkg_analogy_tpu/models/common.py, a jax.custom_jvp) is plain jnp, which
// XLA fuses into one loop each way. Eager PyTorch runs the same series as a
// chain of ~59 elementwise kernels each way, each moving an fp32
// intermediate as large as the FFN activation; these two kernels are that
// fused loop. Contract (kernels/gelu_poly.py: gelu_poly_reference and
// gelu_poly_grad_reference, the plain versions):
//
//   s  = clamp((x*x) * (1/18) - 1, -1, 1)
//   y  = (0.5*x) * (1 + clamp(x * q(s), -1, 1))            q: kGeluCheb
//   dx = (clamp(x, -6, 6) * r(s) + 0.5) * g                 r: kGeluDerivCheb
//
// in fp32 for x (and g) of bf16 or fp32, rounded to nearest into x's type,
// where q and r are Chebyshev series in s evaluated by Clenshaw's recurrence
// from the highest coefficient down: (b1, b2) = ((2s*b1 - b2) + c_k, b1),
// then (s*b1 - b2) + c_0.
//
// Bit for bit the plain chain on the card: every step is the plain version's
// operation in its order, spelled with a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn) so that nvcc contracts nothing into a
// fused multiply-add; the coefficients are the Python doubles of
// kernels/gelu_poly.py assigned to floats, rounded as PyTorch rounds a Python
// scalar for an fp32 operation; the clamps return NaN for NaN, as
// torch.clamp does (its payload is not kept, but every clamp feeds an
// arithmetic operation, which makes any NaN the canonical one on the card).
// The build keeps denormals (no -ftz), as PyTorch's own kernels do.
//
// What bounds it: fp32 operations as much as bytes. An element takes 57 of
// them forward and 56 backward (the recurrence's 14 steps of three, the
// argument, the clamps' min and max, the products) against 4 bytes forward
// (bf16 in and out) and 6 backward (x and g in, dx out): 14 and 9 operations
// a byte, against the card's 10 at 33.5 T non-fused fp32 operations a second
// and 3.35 TB/s. So the design keeps every intermediate in registers and
// gives the issue slots to the series: each thread takes 8 neighbouring
// elements as one 16-byte load of bf16 (two of fp32), which also gives each
// warp 8 independent recurrences to interleave against the adds' latency;
// 256 threads a block, one thread per 8 elements. Storage that is not
// 16-byte aligned, and the last n % 8 elements, take one element a thread
// through the same element function.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements a thread on the aligned path

// _GELU_POLY_CHEB of kernels/gelu_poly.py: q(s), c_0 first.
__constant__ float kGeluCheb[15] = {
    0.33028964434727737,
    -0.24219334583714663,
    0.11777000939518502,
    -0.0582491905022037,
    0.027863442342632622,
    -0.012659164253535369,
    0.00542071972438396,
    -0.002180891087797214,
    0.0008237438783073934,
    -0.00029222435125419576,
    9.74498053259353e-05,
    -3.0554179772880074e-05,
    8.974542569486454e-06,
    -2.4208471486769374e-06,
    5.430217595261719e-07,
};

// _GELU_POLY_DERIV_CHEB of kernels/gelu_poly.py: r(s), c_0 first.
__constant__ float kGeluDerivCheb[15] = {
    0.21898524531263905,
    -0.22260624861509148,
    0.14400788421381755,
    -0.0928012135086846,
    0.056602672027503374,
    -0.03207533320570575,
    0.016773504258689072,
    -0.008083637805368912,
    0.0035947343345571346,
    -0.0014786162490729624,
    0.0005640296608659698,
    -0.00019982686276727213,
    6.555459678467149e-05,
    -1.9516758768489917e-05,
    4.780831823745028e-06,
};

// torch.clamp(v, lo, hi): max, then min, NaN for NaN (max.NaN / min.NaN
// return NaN where either operand is NaN; otherwise they are max / min).
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(lo));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(r), "f"(hi));
  return r;
}

// (x*x * (1/18) - 1).clamp(-1, 1)
__device__ __forceinline__ float series_arg(float xf) {
  const float inv18 = static_cast<float>(1.0 / 18.0);
  return clamp_nan(__fsub_rn(__fmul_rn(__fmul_rn(xf, xf), inv18), 1.0f), -1.0f, 1.0f);
}

// _clenshaw_f32: b1 and b2 start at zero and take every step, so a NaN or a
// signed zero travels through the recurrence as in the plain chain.
__device__ __forceinline__ float clenshaw(float s, const float (&c)[15]) {
  const float two_s = __fadd_rn(s, s);
  float b1 = 0.0f;
  float b2 = 0.0f;
#pragma unroll
  for (int k = 14; k >= 1; --k) {
    const float b0 = __fadd_rn(__fsub_rn(__fmul_rn(two_s, b1), b2), c[k]);
    b2 = b1;
    b1 = b0;
  }
  return __fadd_rn(__fsub_rn(__fmul_rn(s, b1), b2), c[0]);
}

__device__ __forceinline__ float gelu_fwd(float xf) {
  const float q = clenshaw(series_arg(xf), kGeluCheb);
  const float t = clamp_nan(__fmul_rn(xf, q), -1.0f, 1.0f);
  return __fmul_rn(__fmul_rn(xf, 0.5f), __fadd_rn(t, 1.0f));
}

__device__ __forceinline__ float gelu_bwd(float xf, float gf) {
  const float xc = clamp_nan(xf, -6.0f, 6.0f);
  const float r = clenshaw(series_arg(xf), kGeluDerivCheb);
  return __fmul_rn(__fadd_rn(__fmul_rn(xc, r), 0.5f), gf);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }

// 8 neighbouring elements as fp32, from one 16-byte load of bf16 (a bf16 is
// the high half of its fp32) or two of fp32; and back, rounded to nearest.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[kVec]) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(u[k] << 16);
    f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[kVec]) {
  uint32_t u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);  // .x low
    u[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void store8(float* p, const float (&f)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// Thread i < n_vec takes elements [8i, 8i + 8); thread n_vec + j takes
// element 8 n_vec + j, for the tail or for all of unaligned storage (n_vec 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gelu_poly_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n, int64_t n_vec) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n_vec) {
    float f[kVec];
    load8(x + i * kVec, f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = gelu_fwd(f[e]);
    store8(y + i * kVec, f);
  } else {
    const int64_t e = n_vec * kVec + (i - n_vec);
    if (e < n) from_float(gelu_fwd(to_float(x[e])), y + e);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gelu_poly_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                     int64_t n, int64_t n_vec) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n_vec) {
    float f[kVec];
    float gf[kVec];
    load8(x + i * kVec, f);
    load8(g + i * kVec, gf);
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = gelu_bwd(f[e], gf[e]);
    store8(dx + i * kVec, f);
  } else {
    const int64_t e = n_vec * kVec + (i - n_vec);
    if (e < n) from_float(gelu_bwd(to_float(x[e]), to_float(g[e])), dx + e);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The grid and n_vec of a call over n elements: a thread for each aligned
// chunk of 8 and one for each element left over.
void geometry(int64_t n, bool aligned, dim3* grid, int64_t* n_vec) {
  *n_vec = aligned ? n / kVec : 0;
  const int64_t threads = *n_vec + (n - *n_vec * kVec);
  *grid = dim3(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
}

template <typename T>
int launch_fwd(const void* x, void* y, int64_t n, cudaStream_t stream) {
  dim3 grid;
  int64_t n_vec;
  geometry(n, aligned16(x) && aligned16(y), &grid, &n_vec);
  gelu_poly_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, n_vec);
  return int(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, int64_t n, cudaStream_t stream) {
  dim3 grid;
  int64_t n_vec;
  geometry(n, aligned16(x) && aligned16(g) && aligned16(dx), &grid, &n_vec);
  gelu_poly_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), n, n_vec);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y = gelu_poly(x) over n >= 1 contiguous elements; dtype 0 bf16, 1 fp32.
// Launches on `stream` without synchronising; returns cudaGetLastError().
int mkg_gelu_poly_fwd(const void* x, void* y, long long n, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_fwd<__nv_bfloat16>(x, y, n, s) : launch_fwd<float>(x, y, n, s);
}

// dx = gelu_poly'(x) * g over n >= 1 contiguous elements of one dtype.
int mkg_gelu_poly_bwd(const void* x, const void* g, void* dx, long long n, int dtype,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_bwd<__nv_bfloat16>(x, g, dx, n, s)
                    : launch_bwd<float>(x, g, dx, n, s);
}

}  // extern "C"
