"""Shared building blocks for the vision-language models
(``mkg_analogy_tpu/models/common.py``).

Parameters stay in float32; each layer computes in its ``dtype`` (the
compute dtype of the precision policy) by casting its parameters where they
are used, as the Flax layers with ``dtype=`` do.

Dropout draws from explicit generators (``DropoutRNG``), never from the
global one: a training forward takes one, an evaluation none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import fused_attention, fused_attention_reference
from ..kernels.flash_attention import flash_attention

# Attention at or above this query length takes the flash kernel even on the
# plain route (``--fused_attention 0``), as the JAX AttentionCore routes it
# (models/common.py:230-235, :331-338).
FLASH_AUTO_MIN_LEN = 512

# backend -> the attention function: "single" the single-block fused kernel
# (``--fused_attention 1``), "flash" the K-blocked kernel (``--fused_attention
# flash``), "plain" the plain forward under autograd (``--fused_attention 0``)
ATTENTION_BACKENDS = {"single": fused_attention, "flash": flash_attention,
                      "plain": fused_attention_reference}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


# Chebyshev coefficients of q in s = clip(x^2/18 - 1, -1, 1), fitted so that
# clip(x*q(s), -1, 1) is a minimax approximation of erf(x/sqrt(2)) (max
# error 2.2e-6 evaluated in fp32). The fit and its validation gates are
# tools/fit_gelu_poly.py of the JAX package; the values are its
# models/common.py:_GELU_POLY_CHEB.
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


def _clenshaw_f32(s: torch.Tensor, coeffs) -> torch.Tensor:
    two_s = s + s
    b1 = torch.zeros_like(s)
    b2 = torch.zeros_like(s)
    for ci in coeffs[:0:-1]:
        b1, b2 = two_s * b1 - b2 + ci, b1
    return s * b1 - b2 + coeffs[0]


def _gelu_poly_s(xf: torch.Tensor) -> torch.Tensor:
    return (xf * xf * (1.0 / 18.0) - 1.0).clamp(-1.0, 1.0)


class _GeluPoly(torch.autograd.Function):
    """The JAX custom JVP (models/common.py:164-194): the forward's series,
    and for the backward the fitted derivative series ``0.5 + clip(x, -6, 6)
    * r(s)`` instead of autograd through the Clenshaw chain, which would keep
    its ~30 fp32 intermediates of every FFN activation. Saves only x."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.to(torch.float32)
        t = (xf * _clenshaw_f32(_gelu_poly_s(xf), _GELU_POLY_CHEB)).clamp(-1.0, 1.0)
        return (0.5 * xf * (1.0 + t)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xf = x.to(torch.float32)
        d = 0.5 + xf.clamp(-6.0, 6.0) * _clenshaw_f32(_gelu_poly_s(xf),
                                                      _GELU_POLY_DERIV_CHEB)
        return (d * g.to(torch.float32)).to(x.dtype)


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """Exact-gelu via structural polynomial: x/2*(1+clip(x*q(x^2), -1, 1)),
    q a degree-14 Chebyshev series evaluated by Clenshaw in fp32 (within
    2.1e-6 of erf-gelu everywhere); its gradient is the fitted derivative
    series (within 4.3e-6 of erf-gelu's)."""
    return _GeluPoly.apply(x)


def gelu(x: torch.Tensor, impl: str = "poly") -> torch.Tensor:
    """The reference's exact-erf gelu. fp32 inputs always take exact erf;
    other dtypes take ``impl``: "poly" (the JAX package's bf16 default),
    "erf", or "tanh" (opt-in approximation; see the JAX CLI's --gelu_impl)."""
    if impl == "erf" or x.dtype == torch.float32:
        return F.gelu(x)
    if impl == "poly":
        return gelu_poly(x)
    if impl == "tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown gelu impl {impl!r}")


def get_activation(name: str, gelu_impl: str = "poly"):
    """The activations UniMo uses: "gelu" (BERT) and "quick_gelu" (CLIP)."""
    if name == "gelu":
        return lambda x: gelu(x, gelu_impl)
    if name == "quick_gelu":
        return quick_gelu
    raise KeyError(name)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` with its gradient: at a tie with a bound the gradient is
    split, half to x (``torch.minimum``/``torch.maximum`` with tensor bounds
    do that; ``torch.clamp`` passes it whole). ``adaptive_w1`` starts exactly
    at its lower bound 0.5, so this decides its first step."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


@dataclass
class DropoutRNG:
    """The generators one training forward draws from: ``device`` for the
    hidden-dropout masks (``torch.rand`` on the activations' device) and
    ``seeds``, on the CPU, for the attention kernel's per-call seeds, drawn
    as Python ints so that no device sync occurs."""

    device: torch.Generator
    seeds: torch.Generator

    @classmethod
    def from_seed(cls, seed: int, device) -> "DropoutRNG":
        device = torch.device(device)
        # the xor gives the seed stream its own seed, unrelated to the masks'
        return cls(torch.Generator(device=device).manual_seed(seed),
                   torch.Generator().manual_seed(seed ^ 0x5DEECE66D))

    def attention_seed(self) -> int:
        """A seed in [0, 2^31 - 1), the range of the JAX model's
        ``jax.random.randint(..., 0, int32 max)``."""
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.seeds))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep where a uniform draw is >= rate, kept
    values scaled by 1/(1-rate), in x's dtype."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` from fp32 parameters (Flax
    ``nn.Dense(dtype=...)``: inputs, kernel and bias cast, then the GEMM)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with fp32 statistics and its output in ``dtype``
    (Flax ``nn.LayerNorm(dtype=...)``)."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(torch.float32), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


class AttentionCore(nn.Module):
    """Q/K/V projection + scaled dot-product attention on (B, L, H) inputs.

    ``analogy``: None or (boundary (B,), w0 (1,), w1 (1,), row_start,
    text_len, offset) — the adaptive-mask geometry of ops/masks.py.
    ``extra_kv``: (K, V) of another tower, packed (B, L', H), *prepended* to
    the keys (UniMo feeds text K/V into the vision tower that way,
    modeling_unimo.py:227-229), with ``extra_kv_bias`` masking their padding.

    ``backend``: "single" sends the attention through ``kernels.attention.
    fused_attention`` and "flash" through ``kernels.flash_attention.
    flash_attention`` (the CUDA kernels on a CUDA tensor, their plain
    versions on the CPU); "plain" through the plain forward on every device,
    differentiated by autograd (the JAX package's einsum path, the same
    math), except that a query length of ``FLASH_AUTO_MIN_LEN`` or more
    takes the flash kernel there, as in JAX.

    ``dropout_rate`` is the attention dropout, applied when a ``DropoutRNG``
    is given (a training forward); each call draws the kernel's seed from it.
    """

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, out_bias: bool = True,
                 backend: str = "single", dropout_rate: float = 0.0):
        super().__init__()
        if backend not in ATTENTION_BACKENDS:
            raise ValueError(f"attention backend {backend!r}: one of "
                             f"{sorted(ATTENTION_BACKENDS)}")
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.backend = backend
        self.dropout_rate = dropout_rate
        self.query = Dense(hidden_size, inner, dtype=dtype)
        self.key = Dense(hidden_size, inner, dtype=dtype)
        self.value = Dense(hidden_size, inner, dtype=dtype)
        self.out = Dense(inner, inner, bias=out_bias, dtype=dtype)

    def forward(
        self,
        hidden_states: torch.Tensor,
        attention_bias: Optional[torch.Tensor] = None,
        analogy: Optional[tuple] = None,
        extra_kv: Optional[tuple] = None,
        extra_kv_bias: Optional[torch.Tensor] = None,
        output_kv: bool = False,
        output_context: bool = False,
        rng: Optional[DropoutRNG] = None,
    ):
        b, l, _ = hidden_states.shape
        q = self.query(hidden_states)
        k = self.key(hidden_states)
        v = self.value(hidden_states)
        kv_out = (k, v) if output_kv else None
        if extra_kv is not None:
            k = torch.cat([extra_kv[0].to(k.dtype), k], dim=1)
            v = torch.cat([extra_kv[1].to(v.dtype), v], dim=1)
            if extra_kv_bias is not None:
                # Mask padded text keys when they feed another tower's
                # attention (the reference leaves them attendable; see the
                # JAX AttentionCore).
                if attention_bias is not None:
                    raise ValueError("extra_kv_bias replaces attention_bias")
                zeros = extra_kv_bias.new_zeros(extra_kv_bias.shape[:-1] + (l,))
                attention_bias = torch.cat([extra_kv_bias, zeros], dim=-1)

        lk = k.shape[1]
        if attention_bias is None:
            mask = torch.ones(b, lk, dtype=torch.float32, device=q.device)
        else:
            # bias is 0 / -10000 of shape (B, 1, 1, Lk) everywhere in this
            # codebase (ops/masks.attention_bias + the extra_kv concat)
            mask = (attention_bias[:, 0, 0, :] > -1.0).to(torch.float32)
        kwargs = {}
        if analogy is not None:
            boundary, w0, w1, row_start, text_len, offset = analogy
            w0, w1 = clip(w0, 0.0, 0.5), clip(w1, 0.5, 1.0)
            if offset:
                # compat geometry: boundary shifts, rows start at
                # img_length+1, columns run to the sequence end
                kwargs = dict(boundary=boundary, w0=w0, w1=w1,
                              row_start=offset + 1, text_len=lk, offset=offset)
            else:
                kwargs = dict(boundary=boundary, w0=w0, w1=w1,
                              row_start=row_start,
                              text_len=l if text_len is None else text_len,
                              offset=0)
        if rng is not None and self.dropout_rate > 0.0:
            kwargs.update(dropout_rate=self.dropout_rate, deterministic=False,
                          dropout_seed=rng.attention_seed())
        backend = self.backend
        if backend == "plain" and l >= FLASH_AUTO_MIN_LEN:
            backend = "flash"
        ctx = ATTENTION_BACKENDS[backend](q, k, v, mask, self.num_heads,
                                          compute_dtype=self.dtype, **kwargs)
        out = self.out(ctx)
        if output_context:
            # raw pre-out-projection context (UniMo's BertFusion consumes
            # this, modeling_unimo.py:367-373)
            return out, kv_out, ctx
        return out, kv_out


def gather_positions(seq: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """seq (B, L, H), positions (B, P) -> (B, P, H)."""
    idx = positions.long()[:, :, None].expand(-1, -1, seq.shape[-1])
    return torch.gather(seq, 1, idx)


class MLMTransform(nn.Module):
    """BertPredictionHeadTransform: dense + act + LayerNorm
    (modeling_unimo.py:962-976)."""

    def __init__(self, hidden_size: int, hidden_act: str = "gelu",
                 layer_norm_eps: float = 1e-12, dtype: torch.dtype = torch.float32,
                 gelu_impl: str = "poly"):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size, dtype=dtype)
        self.act = get_activation(hidden_act, gelu_impl)
        self.ln = LayerNorm(hidden_size, layer_norm_eps, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.act(self.dense(x)))


def tied_logits(word_embeddings, mlm_bias, trans_hidden, compute_dtype,
                vocab_ids=None, vocab_start=None, vocab_end=None):
    """Tied-decoder logits over a vocab slice, fp32 out: the products of
    compute-dtype operands summed in fp32 (``preferred_element_type``)."""
    table, bias = word_embeddings, mlm_bias
    if vocab_ids is not None:
        ids = torch.as_tensor(vocab_ids, device=table.device).long()
        table, bias = table[ids], bias[ids]
    elif vocab_start is not None:
        table, bias = table[vocab_start:vocab_end], bias[vocab_start:vocab_end]
    x = trans_hidden.to(compute_dtype).to(torch.float32)
    table = table.to(compute_dtype).to(torch.float32)
    return torch.matmul(x, table.T) + bias.to(torch.float32)


class PatchEmbed(nn.Conv2d):
    """Non-overlapping patch embedding (one linear map per patch): a conv
    with stride = kernel = patch size, computed in ``dtype``."""

    def __init__(self, in_channels: int, hidden_size: int, patch_size: int,
                 dtype: torch.dtype = torch.float32, use_bias: bool = False):
        super().__init__(in_channels, hidden_size, patch_size,
                         stride=patch_size, bias=use_bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C, H, W) -> (N, H/P * W/P, hidden), patches row-major."""
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        out = F.conv2d(x.to(dt), self.weight.to(dt), bias, stride=self.stride)
        return out.flatten(2).transpose(1, 2)
