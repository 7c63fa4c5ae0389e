"""``gelu_poly``, the bf16 models' gelu: its CUDA kernels, their wrapper and
the plain PyTorch version.

The port of the JAX package's ``gelu_poly`` (models/common.py, a
``jax.custom_jvp``): x/2 * (1 + clip(x * q(s), -1, 1)) with s = clip(x^2/18
- 1, -1, 1) and q a Chebyshev series of 15 coefficients evaluated by
Clenshaw's recurrence in fp32; its derivative is a second fitted series,
0.5 + clip(x, -6, 6) * r(s). JAX's version is plain ``jnp``, which XLA fuses
into one loop each way; it has no Pallas kernel.

- ``gelu_poly`` is the one entry point, an autograd function that saves only
  x. A CUDA tensor of bf16 or fp32 launches the hand-written kernels
  (``csrc/gelu_poly.cu``, built at first use by ``kernels/build.py``): one
  launch forward and one backward, each reading x (and the cotangent) once,
  evaluating the series in registers and writing once. Another dtype on
  CUDA raises. A CPU tensor takes the plain version. Nothing falls back from
  one to the other. The models call it in bf16 only (``models/common.py:
  gelu`` sends fp32 to exact ``F.gelu``); the fp32 instance serves a direct
  call in fp32, which JAX's ``gelu_poly`` also takes, so that no CUDA
  input the function accepts runs the ~59-kernel chain.
- ``gelu_poly_reference`` and ``gelu_poly_grad_reference`` are the plain
  versions: the eager chain, one PyTorch operation a step (~59 kernels each
  way on a card, each with an fp32 intermediate of the activation's size).
  The kernels compute the same operations in the same order, each rounded
  to nearest and none contracted into a fused multiply-add, so on the card
  they are the plain versions bit for bit.
- ``LAUNCHES_GELU_FWD`` and ``LAUNCHES_GELU_BWD`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

# Chebyshev coefficients of q in s = clip(x^2/18 - 1, -1, 1), fitted so that
# clip(x*q(s), -1, 1) is a minimax approximation of erf(x/sqrt(2)) (max
# error 2.2e-6 evaluated in fp32). The fit and its validation gates are
# tools/fit_gelu_poly.py of the JAX package; the values are its
# models/common.py:_GELU_POLY_CHEB. csrc/gelu_poly.cu spells them alike.
_GELU_POLY_CHEB = (
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
)

# Chebyshev coefficients of r in the same s, fitted so that 0.5 + clip(x,
# -6, 6) * r(s) approximates gelu'(x) within 4.3e-6 over the real line
# (_GELU_POLY_DERIV_CHEB of the JAX package): the backward of ``gelu_poly``.
_GELU_POLY_DERIV_CHEB = (
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
)

# the kernels' dtype argument
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

LAUNCHES_GELU_FWD = 0  # kernel launches since import (or a caller's reset)
LAUNCHES_GELU_BWD = 0


def _clenshaw_f32(s: torch.Tensor, coeffs) -> torch.Tensor:
    two_s = s + s
    b1 = torch.zeros_like(s)
    b2 = torch.zeros_like(s)
    for ci in coeffs[:0:-1]:
        b1, b2 = two_s * b1 - b2 + ci, b1
    return s * b1 - b2 + coeffs[0]


def _gelu_poly_s(xf: torch.Tensor) -> torch.Tensor:
    return (xf * xf * (1.0 / 18.0) - 1.0).clamp(-1.0, 1.0)


def gelu_poly_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain forward: the series in fp32, rounded into x's dtype."""
    xf = x.to(torch.float32)
    t = (xf * _clenshaw_f32(_gelu_poly_s(xf), _GELU_POLY_CHEB)).clamp(-1.0, 1.0)
    return (0.5 * xf * (1.0 + t)).to(x.dtype)


def gelu_poly_grad_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain backward: the fitted derivative series times the cotangent
    ``g`` in fp32, rounded into x's dtype."""
    xf = x.to(torch.float32)
    d = 0.5 + xf.clamp(-6.0, 6.0) * _clenshaw_f32(_gelu_poly_s(xf), _GELU_POLY_DERIV_CHEB)
    return (d * g.to(torch.float32)).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("gelu_poly")
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mkg_gelu_poly_fwd.argtypes = [p, p, n, i, p]     # x y n dtype stream
    lib.mkg_gelu_poly_fwd.restype = ctypes.c_int
    lib.mkg_gelu_poly_bwd.argtypes = [p, p, p, n, i, p]  # x g dx n dtype stream
    lib.mkg_gelu_poly_bwd.restype = ctypes.c_int
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _dtype_code(x: torch.Tensor) -> int:
    code = _DTYPE_CODES.get(x.dtype)
    if x.device.type != "cuda" or code is None:
        raise ValueError(
            f"the gelu_poly kernels take CUDA tensors of bfloat16 or float32, got {x.dtype} "
            f"on {x.device}; gelu_poly_reference is the plain version")
    return code


def _raise_if(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: " + lib.mkg_cuda_error_string(err).decode())


def _launch_fwd(x: torch.Tensor) -> torch.Tensor:
    global LAUNCHES_GELU_FWD
    code = _dtype_code(x)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel():
        lib = _lib()
        with torch.cuda.device(x.device):
            err = lib.mkg_gelu_poly_fwd(x.data_ptr(), y.data_ptr(), x.numel(), code,
                                        torch.cuda.current_stream(x.device).cuda_stream)
        _raise_if(err, lib, "gelu_poly_fwd")
        LAUNCHES_GELU_FWD += 1
    return y


def _launch_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    global LAUNCHES_GELU_BWD
    code = _dtype_code(x)
    if g.dtype != x.dtype or g.device != x.device or g.shape != x.shape:
        raise ValueError(f"the cotangent must match x ({x.dtype} {tuple(x.shape)} on "
                         f"{x.device}), got {g.dtype} {tuple(g.shape)} on {g.device}")
    x, g = x.contiguous(), g.contiguous()
    dx = torch.empty_like(x)
    if x.numel():
        lib = _lib()
        with torch.cuda.device(x.device):
            err = lib.mkg_gelu_poly_bwd(x.data_ptr(), g.data_ptr(), dx.data_ptr(), x.numel(),
                                        code, torch.cuda.current_stream(x.device).cuda_stream)
        _raise_if(err, lib, "gelu_poly_bwd")
        LAUNCHES_GELU_BWD += 1
    return dx


class _GeluPoly(torch.autograd.Function):
    """The JAX custom JVP (models/common.py:164-194): the forward's series,
    and for the backward the fitted derivative series ``0.5 + clip(x, -6, 6)
    * r(s)`` instead of autograd through the Clenshaw chain, which would keep
    its ~30 fp32 intermediates of every FFN activation. Saves only x."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return gelu_poly_reference(x)
        return _launch_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        if x.device.type == "cpu":
            return gelu_poly_grad_reference(x, g)
        return _launch_bwd(x, g)


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """Exact-gelu via structural polynomial: x/2*(1+clip(x*q(x^2), -1, 1)),
    q a degree-14 Chebyshev series evaluated by Clenshaw in fp32 (within
    2.1e-6 of erf-gelu everywhere); its gradient is the fitted derivative
    series (within 4.3e-6 of erf-gelu's). One kernel launch each way on a
    card (bf16 or fp32), the plain version on the CPU."""
    return _GeluPoly.apply(x)
