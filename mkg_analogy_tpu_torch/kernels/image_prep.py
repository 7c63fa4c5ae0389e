"""Image preprocessing: bilinear resize of uint8 canvases + channel
normalisation, the CUDA kernel, its wrapper and its plain PyTorch version.

The port of ``mkg_analogy_tpu/kernels/image_prep.py`` (the Pallas
``_resize_kernel`` behind ``resize_normalize_pallas``, and its XLA twin
``resize_normalize``). Images are decoded on the host onto a fixed
(CANVAS, CANVAS, 3) uint8 canvas, anchored top-left, so every batch has one
shape; the device resizes each from its true extent (h, w) to (S, S) with
the ``align_corners=False`` bilinear rule and applies ``(x / 255 - mean) /
std`` per channel.

- ``resize_normalize`` is the one entry point. A CUDA tensor launches the
  hand-written kernel (``csrc/resize_normalize.cu``, built at first use by
  ``kernels/build.py``): one thread per output pixel, a 2 x 2 tap read
  straight from the uint8 canvas. A CPU tensor takes the plain version.
  Nothing falls back from one to the other. It makes no host sync and
  launches on the current stream; the extents travel as an int32 tensor on
  the canvas's device.
- ``resize_normalize_reference`` is the plain version: the two (S, CANVAS)
  interpolation matrices and two ``einsum``s per image, the arithmetic of
  the XLA twin, independent of the kernel's gather. Where ``(dst + 0.5) *
  scale - 0.5`` lands within an ulp of an integer the two may floor to
  neighbouring pixels; the result is continuous there, so they are held to
  1e-5 absolute (the bar of the JAX package's own test of its two
  versions), not to bit equality.
- The three divisions by constants (``size / S``, ``x / 255``, ``(x - mean)
  / std``) are products with the constant's fp32 reciprocal (``_recip``), in
  the plain version and in the kernel. XLA compiles the JAX functions that
  way (its algebraic simplifier rewrites ``A / const``), and PyTorch divides
  a CUDA tensor by a Python number that way too but a CPU tensor exactly.
  XLA also contracts ``(dst + 0.5) * scale - 0.5`` into one fused
  multiply-add, rounded once; the kernel uses ``__fmaf_rn`` there and the
  plain version forms the exact product and difference in fp64 and rounds
  once to fp32, which is the same value. The source coordinate reaches 511,
  where one ulp is 6e-5: a coordinate one ulp off moves a noisy image's
  result by up to ~4e-4, so the three versions must round it alike to stay
  within 1e-5 of each other (tests/test_torch_port_image.py holds the plain
  version to the JAX function at extents of 500-512 px).
- ``LAUNCHES_RESIZE`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from . import build

# CLIP pixel statistics (openai/clip-vit-base-patch32 processor config).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# ViLT uses ImageNet-0.5 statistics.
VILT_MEAN = (0.5, 0.5, 0.5)
VILT_STD = (0.5, 0.5, 0.5)

CANVAS = 512
LAUNCHES_RESIZE = 0  # kernel launches since import (or a caller's reset)


def _recip(c: float) -> float:
    """The fp32 reciprocal of a constant, as XLA folds ``1 / const``."""
    return float(np.float32(1.0) / np.float32(c))


def _interp_matrix(size: torch.Tensor, out_dim: int, canvas: int) -> torch.Tensor:
    """(B, out_dim, canvas) bilinear interpolation matrices for the source
    extents ``size`` (B,) (align_corners=False convention, PIL/torch
    parity): image_prep.py:_interp_matrix, batched."""
    fsize = size.to(torch.float32)[:, None]                      # (B, 1)
    scale = fsize * _recip(out_dim)
    dst = torch.arange(out_dim, dtype=torch.float32, device=size.device)[None]
    # one fused multiply-add: the fp64 product of two fp32 numbers and its
    # difference with 0.5 are exact, so this rounds once
    src = ((dst + 0.5).double() * scale.double() - 0.5).float()
    src = torch.minimum(torch.clamp_min(src, 0.0), fsize - 1.0)  # (B, O)
    lo = torch.floor(src)
    frac = (src - lo)[:, :, None]
    lo = lo[:, :, None]
    cols = torch.arange(canvas, dtype=torch.float32, device=size.device)[None, None]
    zero = torch.zeros((), dtype=torch.float32, device=size.device)
    w = torch.where(cols == lo, 1.0 - frac, zero)
    w = w + torch.where(cols == lo + 1.0, frac, zero)
    # last source pixel: lo == size-1 -> all weight on lo
    at_edge = (lo + 1.0 >= fsize[:, :, None]) & (cols == lo)
    return torch.where(at_edge, torch.ones((), dtype=torch.float32, device=size.device), w)


def resize_normalize_reference(
    canvas: torch.Tensor,  # (B, CANVAS, CANVAS, 3) uint8/float
    sizes: torch.Tensor,   # (B, 2) int32: true (h, w) of each image
    out_size: int = 224,
    mean: Sequence[float] = CLIP_MEAN,
    std: Sequence[float] = CLIP_STD,
) -> torch.Tensor:
    """Plain PyTorch version -> (B, 3, out_size, out_size) float32: the
    interpolation matrices and two contractions, rows first, as the JAX
    ``resize_normalize``. The extents are clamped to [1, CANVAS], as in the
    kernel."""
    x = canvas.to(torch.float32) * _recip(255.0)
    cv = canvas.shape[1]
    sizes = sizes.to(canvas.device).clamp(1, cv)
    wy = _interp_matrix(sizes[:, 0], out_size, cv)  # (B, O, C)
    wx = _interp_matrix(sizes[:, 1], out_size, cv)
    out = torch.einsum("boc,bcwk->bowk", wy, x)     # rows: (B, O, C, 3)
    out = torch.einsum("bpw,bowk->bopk", wx, out)   # cols: (B, O, O, 3)
    m = torch.tensor(tuple(mean), dtype=torch.float32, device=canvas.device)
    inv_s = torch.tensor([_recip(v) for v in std], dtype=torch.float32,
                         device=canvas.device)
    out = (out - m) * inv_s
    return out.permute(0, 3, 1, 2).contiguous()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("resize_normalize")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mkg_resize_normalize.argtypes = [
        p, p, p,             # canvas sizes out
        i, i, i, f,          # batch canvas_size out_size 1/out_size
        f, f, f, f, f, f,    # mean[3] 1/std[3]
        p,                   # stream
    ]
    lib.mkg_resize_normalize.restype = ctypes.c_int
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(canvas, sizes, out_size, mean, std):
    global LAUNCHES_RESIZE
    if canvas.dtype != torch.uint8:
        raise ValueError(
            f"the resize_normalize kernel takes uint8 canvases, got {canvas.dtype}; "
            "resize_normalize_reference is the plain version for other dtypes")
    if canvas.dim() != 4 or canvas.shape[1] != canvas.shape[2] or canvas.shape[3] != 3 \
            or not canvas.is_contiguous():
        raise ValueError("canvas must be a contiguous (B, C, C, 3) tensor, got "
                         f"{tuple(canvas.shape)}")
    b, cv = canvas.shape[0], canvas.shape[1]
    if not 1 <= b <= 65535:
        raise ValueError(f"the resize_normalize kernel takes 1..65535 images, got {b}")
    if sizes.device != canvas.device or sizes.dtype != torch.int32 \
            or sizes.shape != (b, 2) or not sizes.is_contiguous():
        raise ValueError(
            f"sizes must be a contiguous int32 (B, 2) = ({b}, 2) tensor on {canvas.device}, "
            f"got {sizes.dtype} {tuple(sizes.shape)} on {sizes.device}")
    if out_size < 1 or len(mean) != 3 or len(std) != 3:
        raise ValueError(f"out_size {out_size}, mean {mean}, std {std}")
    lib = _lib()
    out = torch.empty(b, 3, out_size, out_size, dtype=torch.float32, device=canvas.device)
    with torch.cuda.device(canvas.device):
        err = lib.mkg_resize_normalize(
            canvas.data_ptr(), sizes.data_ptr(), out.data_ptr(), b, cv, out_size,
            _recip(out_size), *(float(m) for m in mean), *(_recip(s) for s in std),
            torch.cuda.current_stream(canvas.device).cuda_stream)
    if err != 0:
        raise RuntimeError("resize_normalize launch failed: "
                           + lib.mkg_cuda_error_string(err).decode())
    LAUNCHES_RESIZE += 1
    return out


def resize_normalize(
    canvas: torch.Tensor,  # (B, CANVAS, CANVAS, 3) uint8
    sizes: torch.Tensor,   # (B, 2) int32: true (h, w) of each image
    out_size: int = 224,
    mean: Sequence[float] = CLIP_MEAN,
    std: Sequence[float] = CLIP_STD,
) -> torch.Tensor:
    """Resize each image from its (h, w) extent of the canvas to (out_size,
    out_size), bilinear with align_corners=False, and normalise each
    channel -> (B, 3, out_size, out_size) float32. On a CPU tensor this is
    the plain version (uint8 or float canvases); on a CUDA tensor it
    launches the kernel (uint8 canvases, int32 extents on the same device)
    or raises."""
    if canvas.device.type == "cpu":
        return resize_normalize_reference(canvas, sizes, out_size, mean, std)
    return _launch(canvas, sizes, out_size, tuple(mean), tuple(std))
