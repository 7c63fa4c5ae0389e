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

// Whether every row of a head of `cols` columns that starts at p, rows
// `ld` elements of `elem_bytes` apart, can move in 16-byte pieces.
__device__ __forceinline__ bool rows_aligned(const void* p, int ld, int cols, int elem_bytes) {
  return ((reinterpret_cast<uintptr_t>(p) | uintptr_t(ld) * elem_bytes |
           uintptr_t(cols) * elem_bytes) & 15u) == 0;
}

}  // namespace attention_width
