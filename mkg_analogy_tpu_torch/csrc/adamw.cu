// AdamW over every parameter of a model in one pass, sm_90a.
//
// Replaces no TPU kernel: the JAX package's update is optax.adamw
// (mkg_analogy_tpu/train/optim.py), plain jnp that XLA fuses into a loop per
// leaf. PyTorch's foreach AdamW, which the port ran before, makes eight
// passes over the fp32 parameters (the weight decay, the first moment's lerp,
// the second moment's mul and addcmul, a sqrt into a new tensor, its div and
// add, the addcdiv), ~80 bytes a parameter. This kernel is that update in one
// pass. Contract (kernels/adamw.py: adamw_reference, the plain version, which
// is PyTorch's foreach update op for op), for each element of a parameter p
// with gradient g (zero where the parameter has none) and moments m, v:
//
//   p = p * (1 - lr*wd)                          (only where the group decays)
//   m = lerp(m, g, 1 - b1)
//   v = fma(1 - b2, g*g, v*b2)
//   p = fma(-lr / (1 - b1^t), m / (sqrt(v) / sqrt(1 - b2^t) + eps), p)
//
// in fp32, each scalar a double of the host rounded to fp32 as PyTorch rounds
// a Python scalar for an fp32 operation. Each operation is spelled with a
// round-to-nearest intrinsic (__fmul_rn, __fdiv_rn, __fsqrt_rn, __fmaf_rn, ...)
// where PyTorch's CUDA kernels round, and fused where they fuse: addcmul and
// addcdiv call std::fma (ATen/native/cuda/DeviceAddCmulCdiv.cuh) and nvcc
// contracts at::native::lerp's self + w * (end - self) into one. So on the card
// the result is the plain version's bit for bit. The build keeps denormals (no
// -ftz) and IEEE division and square root, as PyTorch's kernels do.
//
// What bounds it: bytes. An element reads p, g, m and v and writes p, m and v,
// 28 bytes, against some 20 fp32 operations and two divisions and a square
// root; at 3.35 TB/s a 1.61 B-parameter model takes 13.5 ms at the least.
// Nothing but those 28 bytes goes to device memory.
//
// Multi-tensor design. Every parameter is walked as chunks of `chunk`
// elements (kernels/adamw.py: CHUNK). Two tables live in device memory, built
// once when the optimizer first steps (the parameters' and the moments'
// addresses never move): a row a tensor (p, m, v, its size, its group) and a
// row a chunk (its tensor, its index in the tensor). A block walks the chunks
// from its own index by the grid's stride; the grid holds as many blocks as
// fill every SM at this kernel's occupancy. A chunk whose four arrays are
// 16-byte aligned moves float4s, and its last n % 4 elements one at a time;
// any other takes one element a thread. The gradients' addresses change every
// step (zero_grad sets them to None), so the launch carries them by value in
// the kernel's parameter space (__grid_constant__, up to 32,764 bytes from
// CUDA 12.1): kMaxTensors of them a launch, with the groups' scalars. A launch
// copies its parameters when it is enqueued, so no buffer of the host is
// shared with a launch the stream has not run yet, and nothing synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#if CUDART_VERSION < 12010
#error "adamw.cu passes its gradient pointers as kernel parameters beyond 4 KB: CUDA 12.1 or later"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 3072;  // gradient pointers a launch carries
constexpr int kMaxGroups = 4;      // parameter groups

// One parameter group's scalars of this step, each rounded to fp32 by the host.
struct Group {
  float decay;      // 1 - lr * weight_decay; 1 where the group does not decay
  float w1;         // 1 - beta1, the first moment's lerp weight
  float b2;         // beta2
  float c2;         // 1 - beta2
  float step_size;  // -lr / (1 - beta1^t)
  float bc2_sqrt;   // sqrt(1 - beta2^t)
  float eps;
  float unused;
};

struct StepArgs {
  Group groups[kMaxGroups];
  const float* grads[kMaxTensors];  // null: the parameter has no gradient
};
static_assert(sizeof(StepArgs) + 64 <= 32764, "the kernel's parameters pass 32,764 bytes");

// A parameter's row of the tensor table (kernels/adamw.py: five int64s).
struct Row {
  float* p;
  float* m;
  float* v;
  long long n;
  long long group;
};
static_assert(sizeof(Row) == 40, "a row is five int64s");

// at::native::lerp(self, end, w) as nvcc compiles it for PyTorch's foreach
// lerp: self + w * (end - self) for |w| < 0.5, else end - (end - self) * (1 -
// w), each product contracted with its sum into one fused multiply-add.
__device__ __forceinline__ float lerp(float self, float end, float w) {
  const float diff = __fsub_rn(end, self);
  return fabsf(w) < 0.5f ? __fmaf_rn(w, diff, self)
                         : __fmaf_rn(-diff, __fsub_rn(1.0f, w), end);
}

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Group& s) {
  if (s.decay != 1.0f) p = __fmul_rn(p, s.decay);
  m = lerp(m, g, s.w1);
  v = __fmaf_rn(s.c2, __fmul_rn(g, g), __fmul_rn(v, s.b2));
  const float denom = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), s.bc2_sqrt), s.eps);
  p = __fmaf_rn(s.step_size, __fdiv_rn(m, denom), p);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Chunks [chunk_begin, chunk_end) of the chunk table; their tensors start at
// tensor_begin, whose gradient is args.grads[0].
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const Row* __restrict__ rows, const int2* __restrict__ chunks, int chunk_begin,
             int chunk_end, int tensor_begin, long long chunk,
             const __grid_constant__ StepArgs args) {
  for (int c = chunk_begin + blockIdx.x; c < chunk_end; c += gridDim.x) {
    const int2 at = chunks[c];
    const Row row = rows[at.x];
    const Group s = args.groups[row.group];
    const long long start = at.y * chunk;
    const long long n = min(chunk, row.n - start);
    float* p = row.p + start;
    float* m = row.m + start;
    float* v = row.v + start;
    const float* g = args.grads[at.x - tensor_begin];
    if (g != nullptr) g += start;
    const bool vec = aligned16(p) && aligned16(m) && aligned16(v) &&
                     (g == nullptr || aligned16(g));
    const long long n4 = vec ? n / 4 : 0;
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      float4 pv = reinterpret_cast<const float4*>(p)[i];
      float4 mv = reinterpret_cast<const float4*>(m)[i];
      float4 vv = reinterpret_cast<const float4*>(v)[i];
      const float4 gv = g != nullptr ? __ldg(reinterpret_cast<const float4*>(g) + i)
                                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      update(pv.x, gv.x, mv.x, vv.x, s);
      update(pv.y, gv.y, mv.y, vv.y, s);
      update(pv.z, gv.z, mv.z, vv.z, s);
      update(pv.w, gv.w, mv.w, vv.w, s);
      reinterpret_cast<float4*>(p)[i] = pv;
      reinterpret_cast<float4*>(m)[i] = mv;
      reinterpret_cast<float4*>(v)[i] = vv;
    }
    for (long long e = n4 * 4 + threadIdx.x; e < n; e += kThreads) {
      float pe = p[e];
      float me = m[e];
      float ve = v[e];
      update(pe, g != nullptr ? g[e] : 0.0f, me, ve, s);
      p[e] = pe;
      m[e] = me;
      v[e] = ve;
    }
  }
}

// Blocks that fill every SM of the current device at this kernel's
// occupancy, asked of the runtime once a device.
int grid_limit(int* blocks) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < 0 || dev >= 64) return int(cudaErrorInvalidDevice);
  if (cached[dev] == 0) {
    int sms = 0;
    int per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_kernel, kThreads, 0);
    }
    if (err != cudaSuccess) return int(err);
    cached[dev] = sms * std::max(per_sm, 1);
  }
  *blocks = cached[dev];
  return 0;
}

}  // namespace

extern "C" {

const char* mkg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One AdamW step over chunks [chunk_begin, chunk_end) of the chunk table
// `chunks` (int32 pairs: tensor, chunk index), whose tensors are rows
// [tensor_begin, tensor_begin + n_tensors) of `rows`; `grads` holds those
// tensors' gradient addresses (0 for none), `groups` 8 floats a group (the
// fields of Group). `chunk` is a multiple of 4. Launches on `stream` without
// synchronising; returns cudaGetLastError().
int mkg_adamw_step(const void* rows, const void* chunks, int chunk_begin, int chunk_end,
                   int tensor_begin, int n_tensors, long long chunk,
                   const unsigned long long* grads, const float* groups, int n_groups,
                   void* stream) {
  if (n_tensors < 0 || n_tensors > kMaxTensors || n_groups < 1 || n_groups > kMaxGroups ||
      chunk <= 0 || chunk % 4 != 0) {
    return int(cudaErrorInvalidValue);
  }
  if (chunk_end <= chunk_begin) return 0;
  StepArgs args = {};
  for (int k = 0; k < n_groups; ++k) {
    const float* f = groups + 8 * k;
    args.groups[k] = Group{f[0], f[1], f[2], f[3], f[4], f[5], f[6], 0.0f};
  }
  for (int t = 0; t < n_tensors; ++t) {
    args.grads[t] = reinterpret_cast<const float*>(static_cast<uintptr_t>(grads[t]));
  }
  int limit = 0;
  const int err = grid_limit(&limit);
  if (err != 0) return err;
  const int blocks = std::min(chunk_end - chunk_begin, limit);
  adamw_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Row*>(rows), static_cast<const int2*>(chunks), chunk_begin, chunk_end,
      tensor_begin, chunk, args);
  return int(cudaGetLastError());
}

}  // extern "C"
