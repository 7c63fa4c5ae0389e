"""Fused multi-head attention, forward and backward: the CUDA kernels, their
wrappers and their plain PyTorch versions.

The port of ``mkg_analogy_tpu/kernels/attention.py:fused_attention`` (the
Pallas ``_fwd_kernel`` and ``_bwd_kernel`` under a ``jax.custom_vjp``). One
call computes, per (batch row, head)::

    softmax(d^-1/2 · Q Kᵀ ∘ analogy multiplier + (1 - mask) · -1e4) · V

with fp32 scores and softmax, attention dropout, and the probabilities cast
to the compute dtype before the product with V, on the packed
(B, L, heads·d) layout of the projection GEMMs, in and out.

- ``fused_attention`` is the entry point, with the JAX signature, and is
  differentiable: a ``torch.autograd.Function`` that saves q, k, v, the
  mask, the boundary, (w0, w1) and the dropout seed — never the
  probabilities — and recomputes them in the backward, as the JAX custom VJP
  does. A CUDA tensor launches the hand-written kernels, built at first use
  by ``kernels/build.py``, and the dtype alone picks them: bf16, which every
  main path runs, the tensor-core kernels (``csrc/fused_attention_fwd_mma.cu``,
  ``csrc/fused_attention_bwd_mma.cu``: ``mma.sync`` products on ``ldmatrix``
  fragments, ``cp.async`` staging, helpers in ``csrc/attention_mma.cuh``);
  fp32, whose bar of 2e-5 TF32 cannot meet, the CUDA-core kernels
  (``csrc/fused_attention_fwd.cu``, ``csrc/fused_attention_bwd.cu``). A CPU
  tensor takes the plain versions. Nothing falls back from one to another.
  The clamps of w0/w1 stay outside, so autograd chains them.
- ``fused_attention_reference`` is the plain forward (the
  ``AttentionCore._einsum`` math on the packed layout) and
  ``fused_attention_bwd_reference`` the plain backward: the formula of
  ``_bwd_kernel`` written out, with its cast points, not autograd through the
  forward. The CPU tests hold both to the JAX kernels in interpret mode, and
  ``chip_smoke.py`` holds the CUDA kernels to them on the card.
- ``LAUNCHES`` and ``LAUNCHES_BWD`` count kernel launches, so a run can show
  that its main path went through the kernels.

Dropout masks come from the counter hash of the JAX kernel's interpret mode
(``_dropout_keep``: lowbias32 on ``row * Lk + col`` xor ``seed *
0x9E3779B9``, per-(b, head) seed ``seed + b * heads + head``), in the plain
versions and in both kernels, so the backward regenerates the forward's
mask. The plain versions match the JAX interpret-mode kernels bit for bit
in their masks, and the CUDA kernels match the plain versions; none
reproduces the TPU's hardware random bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

NEG_BIAS = -10000.0  # reference padding bias (modeling_unimo.py:56)
HEAD_DIM = 64        # the kernels' head width (BERT-base and ViT-B/32)
ROWS_PER_BLOCK = 64  # query rows per block of every kernel (csrc kRowsPerBlock, kTile)
# The single-block route's longest bf16 key sequence. The CUDA-core kernels'
# shared memory set it; the tensor-core kernels stream their keys in chunks
# and have no such limit of their own, but each 64-row tile walks every key
# twice, and the set of calls the route accepts stays what it was: longer
# sequences are the flash kernels' work.
MAX_KEYS_BF16 = 717
LAUNCHES = 0         # forward kernel launches since import (or a caller's reset)
LAUNCHES_BWD = 0     # backward kernel launches, likewise

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant, without leaving int64's range (PyTorch has no uint32 math)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash_keep(seeds: torch.Tensor, rows: int, cols: int, rate: float) -> torch.Tensor:
    """(..., rows, cols) keep mask of the JAX interpret-mode ``_dropout_keep``
    on a (rows, cols) plane for each int64 seed in ``seeds`` (any shape):
    lowbias32 of ``row * cols + col`` xor ``seed * 0x9E3779B9``."""
    mix = _mul32(seeds & _M32, 0x9E3779B9)[..., None, None]
    idx = (torch.arange(rows, device=seeds.device)[:, None] * cols
           + torch.arange(cols, device=seeds.device)[None, :])
    x = idx ^ mix
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= int(rate * float(2 ** 32))


def dropout_keep(batch: int, num_heads: int, lq: int, lk: int, rate: float,
                 seed: int, device) -> torch.Tensor:
    """(B, heads, Lq, Lk) keep mask of the JAX interpret-mode kernel
    (attention.py:_dropout_keep with the seeds of ``_cell_seed``)."""
    cell = torch.arange(batch * num_heads, device=device).reshape(batch, num_heads)
    return hash_keep(cell + seed, lq, lk, rate)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """Scores, softmax and sums run in fp32 (fp64 for fp64 inputs, which
    only the gradient checks use)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _geometry_planes(boundary, w, lq, lk, geometry):
    """(mult, region0, region1), each (B, 1, Lq, Lk), of the analogy geometry
    (attention.py:_geometry_planes); ``w`` holds the clamped (w0, w1) and
    region0/region1 are the 0/1 planes of the dw0/dw1 sums."""
    row_start, text_len, offset = geometry
    rows = torch.arange(lq, device=boundary.device)[:, None]
    cols = torch.arange(lk, device=boundary.device)[None, :]
    bnd = (boundary.long() + offset)[:, None, None]
    col_is_answer = (cols >= bnd) & (cols < text_len)
    row_is_example = (rows >= row_start) & (rows < bnd)
    row_is_answer = rows >= bnd
    row_in_scope = (row_is_example | row_is_answer) & (rows < text_len)
    region0 = col_is_answer & row_in_scope & row_is_example
    region1 = col_is_answer & row_in_scope & ~row_is_example
    one = torch.ones((), dtype=w.dtype, device=boundary.device)
    mult = torch.where(region0, w[0], torch.where(region1, w[1], one))
    return mult[:, None], region0[:, None].to(w.dtype), region1[:, None].to(w.dtype)


def _resolve(q, boundary, w0, w1, text_len, row_start, offset, dropout_rate,
             deterministic, dropout_seed):
    """The call's normalised arguments, as attention.py:fused_attention
    resolves them: the int32 boundary (zeros when absent), (w0, w1) as one
    tensor (ones when absent), the geometry (row_start, text_len, offset) or
    None, the dropout rate in effect (0 when deterministic) and the seed."""
    b, lq = q.shape[0], q.shape[1]
    acc = _acc_dtype(q)
    if w0 is None:
        w = torch.ones(2, dtype=acc, device=q.device)
    else:
        w = torch.stack([w0.reshape(()), w1.reshape(())]).to(acc)
    geometry = None
    if boundary is None:
        bnd = torch.zeros(b, dtype=torch.int32, device=q.device)
    else:
        bnd = boundary.to(device=q.device, dtype=torch.int32).reshape(b)
        geometry = (int(row_start), lq if text_len is None else int(text_len),
                    int(offset))
    rate = 0.0 if deterministic else float(dropout_rate)
    return bnd, w, geometry, rate, int(dropout_seed or 0)


def _split_heads(x, num_heads, dtype):
    b, length, hd = x.shape
    return x.reshape(b, length, num_heads, hd // num_heads).transpose(1, 2).to(dtype)


def _merge_heads(x, dtype):
    b, h, length, d = x.shape
    return x.transpose(1, 2).reshape(b, length, h * d).to(dtype)


def _score(products, scale, mult, bias):
    """(s_raw, s) of the raw q·k products as XLA computes the JAX kernels'
    ``s_raw = dot * scale; s = s_raw * mult + bias`` inside them (their
    interpret mode, on the CPU): s_raw rounded, and s contracted into one
    multiply-add, ``dot * scale + bias`` without the analogy multiplier,
    ``s_raw * mult + bias`` with it. Where a row's keys are all masked its
    scores sit at -1e4, where an fp32 ulp is 9.8e-4, and a product rounded
    first moves a score there by a whole ulp now and then. The port's
    products themselves still sum in torch.matmul's order, not XLA's dot's,
    which no plain PyTorch call reproduces."""
    s_raw = products * scale
    if mult is None:
        return s_raw, _fma(products, scale, bias)
    return s_raw, _fma(s_raw, mult, bias)


def _fma(a, b, c):
    """a * b + c rounded once to a's dtype: the product of two fp32 values
    is exact in fp64, and the fp64 sum rounds to another fp32 value than
    the exact one only where 29 bits below fp32's last one happen to read
    1000...0. fp64 inputs (the gradient checks) take a plain a * b + c."""
    if a.dtype == torch.float64:
        return a * b + c
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _scores(q, k, mask, num_heads, bnd, w, geometry):
    """(s_raw, planes or None, p): the scaled scores, the geometry planes
    and the softmax, (B, heads, Lq, Lk) in the accumulation dtype."""
    acc = _acc_dtype(q)
    # products of the (possibly bf16) inputs, summed in fp32
    products = torch.matmul(_split_heads(q, num_heads, acc),
                            _split_heads(k, num_heads, acc).transpose(-1, -2))
    return _softmax_scores(products, mask, bnd, w, geometry,
                           float(q.shape[2] // num_heads) ** -0.5)


def _softmax_scores(products, mask, bnd, w, geometry, scale):
    """_scores from the raw (B, heads, Lq, Lk) q·k products."""
    lq, lk = products.shape[-2:]
    planes = None if geometry is None else _geometry_planes(bnd, w, lq, lk, geometry)
    bias = ((1.0 - mask.to(products.dtype)) * NEG_BIAS)[:, None, None, :]
    s_raw, s = _score(products, scale, None if planes is None else planes[0], bias)
    return s_raw, planes, torch.softmax(s, dim=-1)


def _plain_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed,
               compute_dtype):
    b, lq, _ = q.shape
    lk = k.shape[1]
    _, _, p = _scores(q, k, mask, num_heads, bnd, w, geometry)
    if rate > 0.0:
        keep = dropout_keep(b, num_heads, lq, lk, rate, seed, q.device)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros((), dtype=p.dtype,
                                                           device=q.device))
    ctx = torch.matmul(p.to(compute_dtype), _split_heads(v, num_heads, compute_dtype))
    return _merge_heads(ctx, q.dtype)


def _plain_bwd(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed,
               compute_dtype):
    """attention.py:_bwd_kernel :163-233, written out with its cast points."""
    b, lq, _ = q.shape
    lk = k.shape[1]
    acc = _acc_dtype(q)
    scale = float(q.shape[2] // num_heads) ** -0.5
    s_raw, planes, p = _scores(q, k, mask, num_heads, bnd, w, geometry)
    zero = torch.zeros((), dtype=acc, device=q.device)
    keep = None
    p_drop = p
    if rate > 0.0:
        keep = dropout_keep(b, num_heads, lq, lk, rate, seed, q.device)
        inv = 1.0 / (1.0 - rate)
        p_drop = torch.where(keep, p * inv, zero)
    gh = _split_heads(g, num_heads, acc)
    # the forward casts the probabilities before ·V; so does dv (:199)
    p_cast = p_drop.to(compute_dtype).to(acc)
    dv = torch.matmul(p_cast.transpose(-1, -2), gh)
    dp = torch.matmul(gh, _split_heads(v, num_heads, acc).transpose(-1, -2))
    if keep is not None:
        dp = torch.where(keep, dp * inv, zero)                      # :208-209
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))         # :210
    if planes is not None:
        mult, region0, region1 = planes
        dw = torch.stack([torch.sum(ds * s_raw * region0),          # :212-213
                          torch.sum(ds * s_raw * region1)])
        ds = ds * mult
    else:
        dw = torch.zeros(2, dtype=acc, device=q.device)
    ds_raw = (ds * scale).to(compute_dtype).to(acc)                 # :217
    dq = torch.matmul(ds_raw, _split_heads(k, num_heads, acc))
    dk = torch.matmul(ds_raw.transpose(-1, -2), _split_heads(q, num_heads, acc))
    return (_merge_heads(dq, q.dtype), _merge_heads(dk, k.dtype),
            _merge_heads(dv, v.dtype), dw.to(w.dtype))


def fused_attention_reference(
    q: torch.Tensor,              # (B, Lq, heads*d) packed
    k: torch.Tensor,              # (B, Lk, heads*d)
    v: torch.Tensor,              # (B, Lk, heads*d)
    mask: torch.Tensor,           # (B, Lk) 1=attend, 0=pad
    num_heads: int,
    *,
    boundary: Optional[torch.Tensor] = None,
    w0: Optional[torch.Tensor] = None,
    w1: Optional[torch.Tensor] = None,
    text_len: Optional[int] = None,
    row_start: int = 0,
    offset: int = 0,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    dropout_seed: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_attention` (same arguments).
    Autograd differentiates it as it stands: the attention of
    ``--fused_attention 0``."""
    bnd, w, geometry, rate, seed = _resolve(q, boundary, w0, w1, text_len, row_start,
                                            offset, dropout_rate, deterministic,
                                            dropout_seed)
    return _plain_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed,
                      compute_dtype)


def fused_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    g: torch.Tensor,              # (B, Lq, heads*d) cotangent of the output
    num_heads: int,
    *,
    boundary: Optional[torch.Tensor] = None,
    w0: Optional[torch.Tensor] = None,
    w1: Optional[torch.Tensor] = None,
    text_len: Optional[int] = None,
    row_start: int = 0,
    offset: int = 0,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    dropout_seed: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """Plain PyTorch version of the backward: (dq, dk, dv, dw), dw the (2,)
    gradient of the clamped (w0, w1) (zeros without a geometry)."""
    bnd, w, geometry, rate, seed = _resolve(q, boundary, w0, w1, text_len, row_start,
                                            offset, dropout_rate, deterministic,
                                            dropout_seed)
    return _plain_bwd(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed,
                      compute_dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fused_attention_fwd")
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.mkg_fused_attention_fwd.argtypes = [
        p, p, p, p, p, p, p,        # q k v mask boundary w out
        i, i, i, i, i,              # batch lq lk num_heads is_bf16
        f,                          # scale
        i, i, i, i,                 # has_geometry row_start text_len offset
        i, u, f, u,                 # dropout threshold keep_div seed
        p,                          # stream
    ]
    lib.mkg_fused_attention_fwd.restype = ctypes.c_int
    lib.mkg_fused_attention_fwd_smem.argtypes = [i, i]
    lib.mkg_fused_attention_fwd_smem.restype = ctypes.c_size_t
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = build.load("fused_attention_bwd")
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.mkg_fused_attention_bwd.argtypes = [
        p, p, p, p, p, p, p,        # q k v g mask boundary w
        p, p, p, p, p,              # dq dk dv stats dw_part
        i, i, i, i, i,              # batch lq lk num_heads is_bf16
        f,                          # scale
        i, i, i, i,                 # has_geometry row_start text_len offset
        i, u, f, u,                 # dropout threshold inv_keep seed
        p,                          # stream
    ]
    lib.mkg_fused_attention_bwd.restype = ctypes.c_int
    lib.mkg_fused_attention_bwd_smem.argtypes = [i, i, i]
    lib.mkg_fused_attention_bwd_smem.restype = ctypes.c_size_t
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_mma() -> ctypes.CDLL:
    lib = build.load("fused_attention_fwd_mma")
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.mkg_fused_attention_fwd_mma.argtypes = [
        p, p, p, p, p, p, p,        # q k v mask boundary w out
        i, i, i, i,                 # batch lq lk num_heads
        f,                          # scale
        i, i, i, i,                 # has_geometry row_start text_len offset
        i, u, f, u,                 # dropout threshold inv_keep seed
        p,                          # stream
    ]
    lib.mkg_fused_attention_fwd_mma.restype = ctypes.c_int
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_bwd_mma() -> ctypes.CDLL:
    lib = build.load("fused_attention_bwd_mma")
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.mkg_fused_attention_bwd_mma.argtypes = [
        p, p, p, p, p, p, p,        # q k v g mask boundary w
        p, p, p, p, p,              # dq dk dv stats dw_part
        i, i, i, i,                 # batch lq lk num_heads
        f,                          # scale
        i, i, i, i,                 # has_geometry row_start text_len offset
        i, u, f, u,                 # dropout threshold inv_keep seed
        p,                          # stream
    ]
    lib.mkg_fused_attention_bwd_mma.restype = ctypes.c_int
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_tensor(name, t, q):
    if t.device != q.device or t.dtype != q.dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, q: {q.dtype} on {q.device}")
    if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"(B, L, heads*d) tensor, got {tuple(t.shape)}")


def _check_inputs(q, k, v, mask, num_heads, compute_dtype, kernel="fused_attention"):
    if q.device.type != "cuda":
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{kernel} kernel takes bfloat16 or float32, got {q.dtype}")
    if compute_dtype != q.dtype:
        raise ValueError(
            f"{kernel} kernel computes in the inputs' dtype ({q.dtype}), "
            f"got compute_dtype={compute_dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, t, q)
    b, lq, hd = q.shape
    lk = k.shape[1]
    if hd != num_heads * HEAD_DIM:
        raise ValueError(f"{kernel} kernel takes head_dim {HEAD_DIM}: "
                         f"width {hd} for {num_heads} heads")
    if k.shape != (b, lk, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if lq < 1 or lk < 1:
        raise ValueError(f"{kernel} needs at least one query and one key")
    if mask.shape != (b, lk):
        raise ValueError(f"mask {tuple(mask.shape)} is not (B, Lk) = {(b, lk)}")


FLASH_HINT = ("longer sequences take the flash kernels "
              "(kernels/flash_attention.py, --fused_attention flash)")


def _check_smem(smem, q, what, hint=FLASH_HINT):
    limit = torch.cuda.get_device_properties(q.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"{what} needs {smem} bytes of shared memory per block, above the "
            f"device's {limit}: {hint}")


def _check_keys_bf16(lk):
    if lk > MAX_KEYS_BF16:
        raise ValueError(f"Lk={lk} is above the single-block kernels' {MAX_KEYS_BF16} "
                         f"bf16 keys: {FLASH_HINT}")


def _geometry_args(geometry, lq):
    row_start, text_len, offset = geometry if geometry is not None else (0, lq, 0)
    return int(geometry is not None), row_start, text_len, offset


def _raise_if(err, lib, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: " + lib.mkg_cuda_error_string(err).decode())


def _call_tail(q, geometry, rate, seed, keep):
    """The arguments every launcher ends with: scale, the geometry, the
    dropout flag, threshold and ``keep`` (how the kernel scales a kept
    probability: its divisor 1 - rate or its factor 1 / (1 - rate)), the
    seed, the stream."""
    return (float(HEAD_DIM) ** -0.5, *_geometry_args(geometry, q.shape[1]),
            int(rate > 0.0), int(rate * float(2 ** 32)), keep, seed & _M32,
            torch.cuda.current_stream(q.device).cuda_stream)


def _inv_keep(rate):
    return (1.0 / (1.0 - rate)) if rate > 0.0 else 1.0


def _launch_fwd_cuda_cores(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed):
    """The CUDA-core forward (csrc/fused_attention_fwd.cu): the fp32 route.
    It also takes bf16, which :func:`_launch_fwd` never sends it; only a
    measurement that wants the earlier kernel's time beside the new one's
    calls it so."""
    global LAUNCHES
    b, lq, _ = q.shape
    lk = k.shape[1]
    lib = _lib()
    is_bf16 = int(q.dtype == torch.bfloat16)
    _check_smem(lib.mkg_fused_attention_fwd_smem(lk, is_bf16), q, f"Lk={lk}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.mkg_fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            bnd.data_ptr(), w.data_ptr(), out.data_ptr(), b, lq, lk, num_heads, is_bf16,
            *_call_tail(q, geometry, rate, seed, 1.0 - rate))
    _raise_if(err, lib, "fused_attention_fwd")
    LAUNCHES += 1
    return out


def _launch_fwd_mma(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed):
    """The tensor-core forward (csrc/fused_attention_fwd_mma.cu), bf16."""
    global LAUNCHES
    b, lq, _ = q.shape
    lk = k.shape[1]
    _check_keys_bf16(lk)
    lib = _lib_mma()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.mkg_fused_attention_fwd_mma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            bnd.data_ptr(), w.data_ptr(), out.data_ptr(), b, lq, lk, num_heads,
            *_call_tail(q, geometry, rate, seed, _inv_keep(rate)))
    _raise_if(err, lib, "fused_attention_fwd_mma")
    LAUNCHES += 1
    return out


def _launch_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed):
    """One forward launch; the dtype alone picks the kernel."""
    launch = _launch_fwd_mma if q.dtype == torch.bfloat16 else _launch_fwd_cuda_cores
    return launch(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed)


def _bwd_buffers(q, k, v, g, num_heads, stats_width):
    """(dq, dk, dv, stats, dw_part) of one backward: the results, the
    ``stats_width`` fp32 row statistics that the dq pass hands the dk/dv
    pass, and one (dw0, dw1) partial per (b, head, query tile)."""
    _check_tensor("g", g, q)
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} is not q's shape {tuple(q.shape)}")
    b, lq, _ = q.shape
    stats = torch.empty(b, num_heads, lq, stats_width, dtype=torch.float32, device=q.device)
    tiles = -(-lq // ROWS_PER_BLOCK)
    dw_part = torch.empty(b, num_heads, tiles, 2, dtype=torch.float32, device=q.device)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), stats, dw_part


def _bwd_pointers(q, k, v, g, mask, bnd, w, buffers):
    return [t.data_ptr() for t in (q, k, v, g, mask, bnd, w, *buffers)]


def _launch_bwd_cuda_cores(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed):
    """The CUDA-core backward (csrc/fused_attention_bwd.cu): the fp32 route
    (bf16 only for a measurement, as :func:`_launch_fwd_cuda_cores`)."""
    global LAUNCHES_BWD
    b, lq, _ = q.shape
    lk = k.shape[1]
    buffers = _bwd_buffers(q, k, v, g, num_heads, 3)  # m, l, delta a row
    lib = _lib_bwd()
    is_bf16 = int(q.dtype == torch.bfloat16)
    _check_smem(lib.mkg_fused_attention_bwd_smem(lq, lk, is_bf16), q,
                f"the backward at Lq={lq}, Lk={lk}")
    with torch.cuda.device(q.device):
        err = lib.mkg_fused_attention_bwd(
            *_bwd_pointers(q, k, v, g, mask, bnd, w, buffers), b, lq, lk, num_heads, is_bf16,
            *_call_tail(q, geometry, rate, seed, _inv_keep(rate)))
    _raise_if(err, lib, "fused_attention_bwd")
    LAUNCHES_BWD += 1
    dq, dk, dv, _, dw_part = buffers
    return dq, dk, dv, dw_part.sum(dim=(0, 1, 2)).to(w.dtype)


def _launch_bwd_mma(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed):
    """The tensor-core backward (csrc/fused_attention_bwd_mma.cu), bf16."""
    global LAUNCHES_BWD
    b, lq, _ = q.shape
    lk = k.shape[1]
    _check_keys_bf16(lk)
    # m, 1 / l, delta and the row's multiplier: 16 bytes a row
    buffers = _bwd_buffers(q, k, v, g, num_heads, 4)
    lib = _lib_bwd_mma()
    with torch.cuda.device(q.device):
        err = lib.mkg_fused_attention_bwd_mma(
            *_bwd_pointers(q, k, v, g, mask, bnd, w, buffers), b, lq, lk, num_heads,
            *_call_tail(q, geometry, rate, seed, _inv_keep(rate)))
    _raise_if(err, lib, "fused_attention_bwd_mma")
    LAUNCHES_BWD += 1
    dq, dk, dv, _, dw_part = buffers
    return dq, dk, dv, dw_part.sum(dim=(0, 1, 2)).to(w.dtype)


def _launch_bwd(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed):
    """dq, dk, dv and the (2,) dw of one backward; the dtype alone picks the
    kernels. They write one (dw0, dw1) partial per (b, head, query tile) and
    the launcher sums them, so no float atomics run and fp32 results repeat
    from run to run."""
    launch = _launch_bwd_mma if q.dtype == torch.bfloat16 else _launch_bwd_cuda_cores
    return launch(q, k, v, mask, g, num_heads, bnd, w, geometry, rate, seed)


class _FusedAttention(torch.autograd.Function):
    """The custom VJP of attention.py:286-383: the forward saves its inputs
    and the seed, the backward recomputes the probabilities and the dropout
    mask. Gradients flow to q, k, v and the stacked (w0, w1)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bnd, w, num_heads, geometry, rate, seed,
                compute_dtype):
        ctx.save_for_backward(q, k, v, mask, bnd, w)
        ctx.call = (num_heads, geometry, rate, seed, compute_dtype)
        if q.device.type == "cpu":
            return _plain_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate,
                              seed, compute_dtype)
        return _launch_fwd(q, k, v, mask, num_heads, bnd, w, geometry, rate, seed)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, bnd, w = ctx.saved_tensors
        num_heads, geometry, rate, seed, compute_dtype = ctx.call
        if q.device.type == "cpu":
            dq, dk, dv, dw = _plain_bwd(q, k, v, mask, g, num_heads, bnd, w,
                                        geometry, rate, seed, compute_dtype)
        else:
            # g comes from the out-projection's backward
            dq, dk, dv, dw = _launch_bwd(q, k, v, mask, g.to(q.dtype).contiguous(),
                                         num_heads, bnd, w, geometry, rate, seed)
        return dq, dk, dv, None, None, dw, None, None, None, None, None


def fused_attention(
    q: torch.Tensor,              # (B, Lq, heads*d) packed
    k: torch.Tensor,              # (B, Lk, heads*d)
    v: torch.Tensor,              # (B, Lk, heads*d)
    mask: torch.Tensor,           # (B, Lk) 1=attend, 0=pad
    num_heads: int,
    *,
    boundary: Optional[torch.Tensor] = None,  # (B,) sep_idx[:, 2]
    w0: Optional[torch.Tensor] = None,        # clamped scalar, shape (1,)
    w1: Optional[torch.Tensor] = None,
    text_len: Optional[int] = None,
    row_start: int = 0,
    offset: int = 0,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    dropout_seed: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """softmax(scale·QKᵀ ∘ analogy_mult + pad_bias) @ V, fused, in the
    packed (B, L, H) head layout of the projection GEMMs; differentiable in
    q, k, v, w0 and w1.

    ``boundary``/``w0``/``w1`` enable the analogy multiplier with the
    ops/masks.py geometry (row_start / text_len / compat offset); w0 and w1
    arrive clamped. On CPU tensors this is the plain forward and backward; on
    CUDA tensors it launches the kernels (bf16 or fp32, head_dim 64, compute
    dtype = the inputs' dtype) or raises.
    """
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    bnd, w, geometry, rate, seed = _resolve(q, boundary, w0, w1, text_len, row_start,
                                            offset, dropout_rate, deterministic,
                                            dropout_seed)
    maskf = mask.to(device=q.device, dtype=_acc_dtype(q)).contiguous()
    if q.device.type != "cpu":
        _check_inputs(q, k, v, maskf, num_heads, compute_dtype)
    return _FusedAttention.apply(q, k, v, maskf, bnd.contiguous(), w.contiguous(),
                                 num_heads, geometry, rate, seed, compute_dtype)
