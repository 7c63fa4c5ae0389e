"""Fused multi-head attention forward: the CUDA kernel, its wrapper and its
plain PyTorch version.

The port of ``mkg_analogy_tpu/kernels/attention.py:fused_attention`` (the
Pallas ``_fwd_kernel``). One call computes, per (batch row, head)::

    softmax(d^-1/2 · Q Kᵀ ∘ analogy multiplier + (1 - mask) · -1e4) · V

with fp32 scores and softmax, attention dropout, and the probabilities cast
to the compute dtype before the product with V, on the packed
(B, L, heads·d) layout of the projection GEMMs, in and out.

- ``fused_attention`` is the entry point, with the JAX signature. A CUDA
  tensor launches the hand-written kernel (``csrc/fused_attention_fwd.cu``,
  built at first use by ``kernels/build.py``); a CPU tensor takes
  ``fused_attention_reference``. Nothing falls back from one to the other.
- ``fused_attention_reference`` is the plain version: the
  ``AttentionCore._einsum`` math on the packed layout. The CPU tests hold it
  to the JAX kernel in interpret mode, and ``chip_smoke.py`` holds the CUDA
  kernel to it on the card.
- ``LAUNCHES`` counts kernel launches, so a run can show that its main path
  went through the kernel.

Dropout masks come from the counter hash of the JAX kernel's interpret mode
(``_dropout_keep``: lowbias32 on ``row * Lk + col`` xor ``seed *
0x9E3779B9``, per-(b, head) seed ``seed + b * heads + head``), in both the
plain version and the kernel. So the plain version matches the JAX
interpret-mode kernel bit for bit, and the CUDA kernel matches the plain
version; neither reproduces the TPU's hardware random bits. The backward
(``_bwd_kernel``) comes with the training slice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

NEG_BIAS = -10000.0  # reference padding bias (modeling_unimo.py:56)
HEAD_DIM = 64        # the kernel's head width (BERT-base and ViT-B/32)
LAUNCHES = 0         # kernel launches since import (or since a caller reset it)

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant, without leaving int64's range (PyTorch has no uint32 math)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def dropout_keep(batch: int, num_heads: int, lq: int, lk: int, rate: float,
                 seed: int, device) -> torch.Tensor:
    """(B, heads, Lq, Lk) keep mask of the JAX interpret-mode kernel
    (attention.py:_dropout_keep with the seeds of ``_cell_seed``)."""
    cell = torch.arange(batch * num_heads, device=device).reshape(batch, num_heads)
    cell_seed = (cell + seed) & _M32
    mix = _mul32(cell_seed, 0x9E3779B9)[:, :, None, None]
    idx = (torch.arange(lq, device=device)[:, None] * lk
           + torch.arange(lk, device=device)[None, :])
    x = idx ^ mix
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= int(rate * float(2 ** 32))


def _geometry_multiplier(boundary, w, lq, lk, row_start, text_len, offset):
    """(B, 1, Lq, Lk) analogy multiplier (attention.py:_geometry_planes);
    ``w`` holds the clamped (w0, w1)."""
    rows = torch.arange(lq, device=boundary.device)[:, None]
    cols = torch.arange(lk, device=boundary.device)[None, :]
    bnd = (boundary.long() + offset)[:, None, None]
    col_is_answer = (cols >= bnd) & (cols < text_len)
    row_is_example = (rows >= row_start) & (rows < bnd)
    row_is_answer = rows >= bnd
    row_in_scope = (row_is_example | row_is_answer) & (rows < text_len)
    one = torch.ones((), dtype=torch.float32, device=boundary.device)
    mult = torch.where(col_is_answer & row_in_scope,
                       torch.where(row_is_example, w[0], w[1]), one)
    return mult[:, None]


def _resolve(q, w0, w1, text_len):
    """The (w0, w1) pair as one fp32 tensor (ones when absent) and the text
    length of the geometry (Lq when absent), as attention.py:fused_attention
    resolves them."""
    if w0 is None:
        w = torch.ones(2, dtype=torch.float32, device=q.device)
    else:
        w = torch.stack([w0.reshape(()), w1.reshape(())]).to(torch.float32)
    lq = q.shape[1]
    text_len = lq if text_len is None else int(text_len)
    return w, text_len


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
    """Plain PyTorch version of :func:`fused_attention` (same arguments)."""
    b, lq, hd = q.shape
    lk = k.shape[1]
    d = hd // num_heads
    scale = float(d) ** -0.5

    def heads(x, length, dtype):
        return x.reshape(b, length, num_heads, d).transpose(1, 2).to(dtype)

    # fp32 scores: products of the (possibly bf16) inputs, summed in fp32
    s = torch.matmul(heads(q, lq, torch.float32),
                     heads(k, lk, torch.float32).transpose(-1, -2)) * scale
    if boundary is not None:
        w, text_len = _resolve(q, w0, w1, text_len)
        s = s * _geometry_multiplier(boundary, w, lq, lk, row_start, text_len,
                                     offset)
    s = s + ((1.0 - mask.to(torch.float32)) * NEG_BIAS)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    if not deterministic and dropout_rate > 0.0:
        keep = dropout_keep(b, num_heads, lq, lk, dropout_rate,
                            int(dropout_seed or 0), q.device)
        p = torch.where(keep, p / (1.0 - dropout_rate), torch.zeros((), device=q.device))
    ctx = torch.matmul(p.to(compute_dtype), heads(v, lk, compute_dtype))
    return ctx.transpose(1, 2).reshape(b, lq, hd).to(q.dtype)


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


def _check_inputs(q, k, v, mask, num_heads, compute_dtype):
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_attention kernel takes bfloat16 or float32, got {q.dtype}")
    if compute_dtype != q.dtype:
        raise ValueError(
            f"fused_attention kernel computes in the inputs' dtype ({q.dtype}), "
            f"got compute_dtype={compute_dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, q: {q.dtype} on {q.device}")
        if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"(B, L, heads*d) tensor, got {tuple(t.shape)}")
    b, lq, hd = q.shape
    lk = k.shape[1]
    if hd != num_heads * HEAD_DIM:
        raise ValueError(f"fused_attention kernel takes head_dim {HEAD_DIM}: "
                         f"width {hd} for {num_heads} heads")
    if k.shape != (b, lk, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if lq < 1 or lk < 1:
        raise ValueError("fused_attention needs at least one query and one key")
    if mask.shape != (b, lk):
        raise ValueError(f"mask {tuple(mask.shape)} is not (B, Lk) = {(b, lk)}")


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
    packed (B, L, H) head layout of the projection GEMMs.

    ``boundary``/``w0``/``w1`` enable the analogy multiplier with the
    ops/masks.py geometry (row_start / text_len / compat offset); w0 and w1
    arrive clamped. On a CPU tensor this is the plain version; on a CUDA
    tensor it launches the kernel (bf16 or fp32, head_dim 64, compute dtype
    = the inputs' dtype) or raises.
    """
    global LAUNCHES
    args = dict(boundary=boundary, w0=w0, w1=w1, text_len=text_len,
                row_start=row_start, offset=offset, dropout_rate=dropout_rate,
                deterministic=deterministic, dropout_seed=dropout_seed,
                compute_dtype=compute_dtype)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, mask, num_heads, **args)
    _check_inputs(q, k, v, mask, num_heads, compute_dtype)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    b, lq, _ = q.shape
    lk = k.shape[1]
    lib = _lib()
    is_bf16 = int(q.dtype == torch.bfloat16)
    smem = lib.mkg_fused_attention_fwd_smem(lk, is_bf16)
    limit = torch.cuda.get_device_properties(q.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"Lk={lk} needs {smem} bytes of shared memory per block, above the "
            f"device's {limit}: longer keys are the flash kernel's "
            f"(kernels/flash_attention.py in the JAX package), a later slice")
    w, text_len = _resolve(q, w0, w1, text_len)
    has_geometry = int(boundary is not None)
    if boundary is None:
        bnd = torch.zeros(b, dtype=torch.int32, device=q.device)
    else:
        bnd = boundary.to(device=q.device, dtype=torch.int32).reshape(b).contiguous()
    maskf = mask.to(device=q.device, dtype=torch.float32).contiguous()
    w = w.to(q.device).contiguous()
    dropout = int(not deterministic and dropout_rate > 0.0)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mkg_fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), maskf.data_ptr(),
            bnd.data_ptr(), w.data_ptr(), out.data_ptr(),
            b, lq, lk, num_heads, is_bf16, float(HEAD_DIM) ** -0.5,
            has_geometry, int(row_start), text_len, int(offset),
            dropout, int(dropout_rate * float(2 ** 32)), 1.0 - dropout_rate,
            int(dropout_seed or 0) & _M32, stream,
        )
    if err != 0:
        raise RuntimeError("fused_attention_fwd launch failed: "
                           + lib.mkg_cuda_error_string(err).decode())
    LAUNCHES += 1
    return out
