// The head widths of the attention kernels (rows 1-5), shared by all eight
// attention sources.
//
// The TPU kernels (mkg_analogy_tpu/kernels/attention.py :303,
// flash_attention.py :379) take any head width d = hd / heads. Here a
// kernel is a template on its tile width D, and a library carries either
//   - built as it stands: the instances D = 64 and D = 128, for calls of
//     exactly that width (BERT-base, ViT-B; ViLBERT's visual stream). Their
//     code is what it was before other widths came: every row is the whole
//     tile, every load and store 16 bytes;
//   - built with -DMKG_ATTN_DP=<Dp> (kernels/build.py, one library a padded
//     width): the one instance D = Dp, a multiple of 16 from 16 to 128, or
//     192 or 256 (above 128 the tile widths are multiples of 64, as every
//     block there owns 64 result columns), for every call whose width d
//     rounds up to it (d in Dp - 15 .. Dp up to 128, Dp - 63 .. Dp above;
//     d not 64 or 128). The call passes d. The columns d .. Dp - 1 of every staged
//     tile are zero: a zero column of Q and K leaves each score as it is, a
//     zero column of V or of the output cotangent leaves P V, dP and delta as
//     they are, so the products run over Dp columns as over d and the
//     padded columns of a result are never stored. Rows of a head start
//     h * d elements in: where that is not a multiple of 16 bytes (d not a
//     multiple of 8 in bf16, of 4 in fp32) the kernel loads and stores
//     element by element.
// The scale is the wrapper's, d^-1/2 of the real width (never Dp's).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace attention_width {

#ifdef MKG_ATTN_DP
static_assert((MKG_ATTN_DP % 16 == 0 && MKG_ATTN_DP >= 16 && MKG_ATTN_DP <= 128) ||
                  MKG_ATTN_DP == 192 || MKG_ATTN_DP == 256,
              "MKG_ATTN_DP: a multiple of 16 from 16 to 128, or 192 or 256");
constexpr bool kRagged = true;  // the call's width may be below the tile's
#else
constexpr bool kRagged = false;
#endif

// The tile width of a call of width d: d rounded up to a multiple of 16 up
// to 128, of 64 above (kernels/build.py:padded_width).
__host__ __device__ constexpr int padded_width(int d) {
  return d <= 128 ? (d + 15) / 16 * 16 : (d + 63) / 64 * 64;
}

// f(std::integral_constant<int, D>{}) for the instance of this library that
// takes a call of head width d, or `none` where it has none.
template <class R, class F>
R with_width(int d, R none, F&& f) {
#ifdef MKG_ATTN_DP
  if (d >= 1 && padded_width(d) == MKG_ATTN_DP) {
    return f(std::integral_constant<int, MKG_ATTN_DP>{});
  }
#else
  if (d == 64) return f(std::integral_constant<int, 64>{});
  if (d == 128) return f(std::integral_constant<int, 128>{});
#endif
  return none;
}

// f(T{}) for the element type T of a call to a CUDA-core kernel of this
// library (fused_attention_*.cu, flash_attention_*.cu), or `none` where it
// has none: fp32 and bf16 in a library of 64 and 128 (bf16 only for a
// measurement of the CUDA-core kernel beside the tensor-core one), fp32
// alone in a library of one padded width, whose bf16 calls the
// tensor-core kernels take (so nvcc compiles half as many kernels there).
template <class R, class F>
R with_type(int is_bf16, R none, F&& f) {
  if (!is_bf16) return f(float{});
  if constexpr (kRagged) {
    return none;
  } else {
    return f(__nv_bfloat16{});
  }
}

// Whether every row of a head of `cols` columns that starts at p, rows
// `ld` elements of `elem_bytes` apart, can move in 16-byte pieces.
__device__ __forceinline__ bool rows_aligned(const void* p, int ld, int cols, int elem_bytes) {
  return ((reinterpret_cast<uintptr_t>(p) | uintptr_t(ld) * elem_bytes |
           uintptr_t(cols) * elem_bytes) & 15u) == 0;
}

// Element by element, for the CUDA-core kernels in a library of one
// padded width (fused_attention_*.cu, flash_attention_*.cu): a head's rows
// of d columns are staged into rows of D, zero from d on; a register row
// likewise; a result pair (col, col + 1) stored where its columns are
// below d.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int stride, const T* src, int rows, int ld,
                                           int d) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int j = i / D, c = i % D;
    dst[j * stride + c] = c < d ? src[size_t(j) * ld + c] : static_cast<T>(0.0f);
  }
}

template <int D, typename T>
__device__ __forceinline__ void load_row(const T* p, float* f, int d) {
#pragma unroll
  for (int c = 0; c < D; ++c) f[c] = c < d ? to_float(p[c]) : 0.0f;
}

template <typename T>
__device__ __forceinline__ void store_pair(T* row, int col, int d, float a, float b) {
  if (col < d) from_float(row + col, a);
  if (col + 1 < d) from_float(row + col + 1, b);
}

// Stage `rows` rows of a head (d columns, `ld` elements apart) from src
// into shared-memory rows of D, `stride` apart, zero from d on, with every
// thread of the block: 16 bytes a copy in a library of 64 and 128, element
// by element in one of a padded width (the CUDA-core kernels' streaming
// forms, whose blocks are not those of their resident forms).
template <int D, int stride, typename T>
__device__ __forceinline__ void stage_block(T* dst, const T* src, int rows, int ld, int d) {
  if constexpr (kRagged) {
    stage_rows<D>(dst, stride, src, rows, ld, d);
  } else {
    constexpr int kVec = 16 / sizeof(T), kVecsPerRow = D / kVec;
    for (int i = threadIdx.x; i < rows * kVecsPerRow; i += blockDim.x) {
      const int j = i / kVecsPerRow, c = (i % kVecsPerRow) * kVec;
      *reinterpret_cast<uint4*>(dst + j * stride + c) =
          *reinterpret_cast<const uint4*>(src + size_t(j) * ld + c);
    }
  }
}

// 16 bytes of a staged row as floats (4 fp32 or 8 bf16 values).
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// A staged head row of D columns (shared memory, 16-byte aligned) that is
// one operand of many dot products in the CUDA-core kernels: a warp's
// query, key, value or cotangent row against the rows its lanes take. Up
// to D = 128 its D floats are held in registers, as the kernels held them
// before other widths came; above, where D registers a thread would pass
// the 255 it may hold, it is read again from shared memory at every product
// (a broadcast: every lane reads the same row). Either way a product is
// fmaf(row[c], other[c], acc) over c in order, so the two forms give the
// same sums bit for bit. (The single-block kernels' streaming forms, whose
// blocks of 512 threads leave a thread 128 registers, never hold it.)
template <int D, typename T, bool kHeld = (D <= 128)>
struct HeadRow {
  static constexpr int kVec = 16 / sizeof(T);
  float f[kHeld ? D : 1];
  const T* row;

  __device__ __forceinline__ explicit HeadRow(const T* staged) : row(staged) {
    if constexpr (kHeld) {
#pragma unroll
      for (int c = 0; c < D; c += kVec) load16(staged + c, f + c);
    }
  }

  // the fp32 dot product with another staged row of D columns
  __device__ __forceinline__ float dot(const T* other) const {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < D; c += kVec) {
      float bf[kVec];
      load16(other + c, bf);
      if constexpr (kHeld) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc = fmaf(f[c + i], bf[i], acc);
      } else {
        float af[kVec];
        load16(row + c, af);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc = fmaf(af[i], bf[i], acc);
      }
    }
    return acc;
  }
};

// The shared memory a block may opt into on the current device (227 KB on
// an H100), read once: the CUDA-core single-block kernels hold a head's
// whole K and V (or Q and g) where they fit in it and stream them where
// they do not.
inline int smem_optin() {
  static const int bytes = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return v;
  }();
  return bytes;
}

}  // namespace attention_width
