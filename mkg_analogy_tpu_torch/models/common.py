"""Shared building blocks for the vision-language models
(``mkg_analogy_tpu/models/common.py``).

Parameters stay in float32; each layer computes in its ``dtype`` (the
compute dtype of the precision policy) by casting its parameters where they
are used, as the Flax layers with ``dtype=`` do.

Dropout draws from explicit generators (``DropoutRNG``), never from the
global one: a training forward takes one, an evaluation none.

Tensor parallelism (``parallel/shardings.py:shard_module``) splits the
leaves JAX's rules split and marks the blocks that hold them: a ``Dense``
becomes column-parallel (its outputs split; its input enters through
``copy_to``) or row-parallel (its inputs split; its partial products summed
over ``tp`` before the bias), an ``AttentionCore`` runs its rank's heads, and
the vocab-parallel word table is looked up by ``gather_rows`` and decoded by
``tied_logits`` into ``ShardedLogits``. Under data parallelism a rank holds
a slice of the batch rows (``DropoutRNG.rows``): its dropout masks are the
global batch's rows, as the attention kernels' are its global cells.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import _qk_products, fused_attention, fused_attention_reference
from ..kernels.flash_attention import flash_attention
from ..kernels.gelu_poly import gelu_poly
from ..parallel.collectives import ShardedLogits, copy_to, reduce_from, shard_of

# Attention at or above this query length takes the flash kernel even on the
# plain route (``--fused_attention 0``), as the JAX AttentionCore routes it
# (models/common.py:230-235, :331-338).
FLASH_AUTO_MIN_LEN = 512

# backend -> the attention function: "single" the single-block fused kernel
# (``--fused_attention 1``), "flash" the K-blocked kernel (``--fused_attention
# flash``), "plain" the plain forward under autograd (``--fused_attention 0``)
ATTENTION_BACKENDS = {"single": fused_attention, "flash": flash_attention,
                      "plain": fused_attention_reference}


class _QKScoresBF16Grad(torch.autograd.Function):
    """The JAX package's ``_qk_scores_bf16grad`` custom VJP
    (models/common.py:60-100, its ``QK_BF16_GRAD``), on (B, heads, L, d)
    heads. The forward is the plain route's product as it stands
    (``kernels.attention._qk_products``: upcast to fp32 and multiplied), so
    it is bit-identical. The backward casts the fp32 score cotangent to the
    inputs' dtype and computes dq and dk as products in that dtype, cast to
    the inputs' dtypes (``_qk_scores_bwd``), where autograd would run them
    in fp32: the cotangent's signal is already bf16-grained, as it comes out
    of the bf16 probabilities' backward."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return _qk_products(q, k)

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        gc = g.to(q.dtype)
        dq = torch.matmul(gc, k)
        dk = torch.matmul(gc.transpose(-1, -2), q)
        return dq.to(q.dtype), dk.to(k.dtype)


def _qk_scores_bf16grad(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 q·k products of (B, heads, L, d) heads whose backward runs in
    the inputs' dtype (``_QKScoresBF16Grad``)."""
    return _QKScoresBF16Grad.apply(q, k)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


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
    as Python ints so that no device sync occurs. ``rows`` (first row,
    global row count) where the batch is a slice of a global one (data
    parallelism): masks are drawn for the global batch and sliced, so each
    row's mask is the one a single process draws for it."""

    device: torch.Generator
    seeds: torch.Generator
    rows: Optional[Tuple[int, int]] = None

    @classmethod
    def from_seed(cls, seed: int, device, rows: Optional[Tuple[int, int]] = None
                  ) -> "DropoutRNG":
        device = torch.device(device)
        # the xor gives the seed stream its own seed, unrelated to the masks'
        return cls(torch.Generator(device=device).manual_seed(seed),
                   torch.Generator().manual_seed(seed ^ 0x5DEECE66D), rows)

    @property
    def row_offset(self) -> int:
        return 0 if self.rows is None else self.rows[0]

    def get_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both generators' states (a layer run again under remat restores
        them, models/unimo.py:_remat)."""
        return self.device.get_state(), self.seeds.get_state()

    def set_state(self, state: Tuple[torch.Tensor, torch.Tensor]) -> None:
        self.device.set_state(state[0])
        self.seeds.set_state(state[1])

    def attention_seed(self) -> int:
        """A seed in [0, 2^31 - 1), the range of the JAX model's
        ``jax.random.randint(..., 0, int32 max)``."""
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.seeds))


def dropout(x: torch.Tensor, rate: float, rng) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep where a uniform draw is >= rate, kept
    values scaled by 1/(1-rate), in x's dtype. ``rng`` a ``DropoutRNG``
    (its ``device`` generator; with ``rows``, x's rows are those rows of the
    global batch, drawn whole and sliced) or a generator."""
    if isinstance(rng, DropoutRNG) and rng.rows is not None:
        first, total = rng.rows
        draw = torch.rand((total,) + tuple(x.shape[1:]), generator=rng.device,
                          device=x.device)
        keep = draw[first:first + x.shape[0]] >= rate
    else:
        generator = rng.device if isinstance(rng, DropoutRNG) else rng
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` from fp32 parameters (Flax
    ``nn.Dense(dtype=...)``: inputs, kernel and bias cast, then the GEMM).

    ``tp`` (set by ``parallel/shardings.py:shard_module``): None, or
    ("column", group) where this rank holds a slice of the outputs (the
    replicated input enters through ``copy_to``), or ("row", group) where it
    holds a slice of the inputs (the partial products are summed over the
    group, then the replicated bias is added)."""

    tp = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.tp is None:
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        mode, group = self.tp
        if mode == "column":
            return F.linear(copy_to(x, group).to(dt), self.weight.to(dt), bias)
        y = reduce_from(F.linear(x.to(dt), self.weight.to(dt)), group)
        return y if bias is None else y + bias


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

    ``qk_bf16_grad`` (JAX's ``QK_BF16_GRAD``, default off): on the plain
    route, below ``FLASH_AUTO_MIN_LEN`` and in a compute dtype other than
    fp32, the q·k products take ``_qk_scores_bf16grad``, whose dq/dk
    backward runs in the compute dtype; elsewhere it changes nothing.
    ``fused_qkv`` (JAX's ``USE_FUSED_QKV``, default off): one (H, 3·inner)
    projection named ``qkv`` in place of ``query``, ``key`` and ``value``,
    split into those three in that order (``models/convert.py:fuse_qkv``
    maps an unfused tree onto it).

    ``tp`` (set by ``parallel/shardings.py:shard_module``, with ``num_heads``
    then this rank's heads): None, or (group, first head, global heads).
    Q/K/V are column-parallel and ``out`` row-parallel, so the attention
    runs on the rank's heads; the adaptive analogy scalars enter through
    ``copy_to``, since each rank's heads give only part of their gradient.
    A fused ``qkv`` stays whole on every rank, as JAX keeps it (no rule
    names it): the rank projects with its heads' rows of Q, K and V, and the
    leaf enters through ``copy_to`` too, so its gradient is summed over tp
    and every rank holds the whole one (the optimizer counts it once, as
    any replicated leaf).
    On a mesh the dropout cells are the global row's and head's
    (``cell_stride``/``cell_offset`` of the kernels).
    """

    tp = None

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, out_bias: bool = True,
                 backend: str = "single", dropout_rate: float = 0.0,
                 qk_bf16_grad: bool = False, fused_qkv: bool = False):
        super().__init__()
        if backend not in ATTENTION_BACKENDS:
            raise ValueError(f"attention backend {backend!r}: one of "
                             f"{sorted(ATTENTION_BACKENDS)}")
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.backend = backend
        self.dropout_rate = dropout_rate
        self.qk_bf16_grad = qk_bf16_grad
        self.fused_qkv = fused_qkv
        if fused_qkv:
            self.qkv = Dense(hidden_size, 3 * inner, dtype=dtype)
        else:
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
        if self.fused_qkv:
            # contiguous copies: the kernels read packed (B, L, heads·d) rows
            q, k, v = (t.contiguous() for t in self._qkv(hidden_states).chunk(3, dim=-1))
        else:
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
            if self.tp is not None:
                w0, w1 = copy_to(w0, self.tp[0]), copy_to(w1, self.tp[0])
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
            if self.tp is not None or rng.rows is not None:
                _, first_head, heads = self.tp or (None, 0, self.num_heads)
                kwargs.update(cell_stride=heads,
                              cell_offset=rng.row_offset * heads + first_head)
        backend = self.backend
        if backend == "plain" and l >= FLASH_AUTO_MIN_LEN:
            backend = "flash"
        if backend == "plain" and self.qk_bf16_grad and self.dtype != torch.float32:
            kwargs["qk_products"] = _qk_scores_bf16grad
        ctx = ATTENTION_BACKENDS[backend](q, k, v, mask, self.num_heads,
                                          compute_dtype=self.dtype, **kwargs)
        out = self.out(ctx)
        if output_context:
            # raw pre-out-projection context (UniMo's BertFusion consumes
            # this, modeling_unimo.py:367-373)
            return out, kv_out, ctx
        return out, kv_out


    def _qkv(self, x: torch.Tensor) -> torch.Tensor:
        """The fused projection: the whole ``qkv``, or under tp the rank's
        heads' rows of each of Q, K and V from the whole leaf."""
        if self.tp is None:
            return self.qkv(x)
        group, first, heads = self.tp
        inner, d = heads * self.head_dim, self.head_dim
        rows = torch.cat([torch.arange(p * inner + first * d,
                                       p * inner + (first + self.num_heads) * d)
                          for p in range(3)]).to(x.device)
        dt = self.qkv.compute_dtype
        weight = copy_to(self.qkv.weight, group)[rows].to(dt)
        bias = copy_to(self.qkv.bias, group)[rows].to(dt)
        return F.linear(copy_to(x, group).to(dt), weight, bias)


def attention_head_dims(model: nn.Module) -> list:
    """The head widths of a model's attention cores, each once: the widths
    whose kernels a run on a CUDA device launches."""
    return sorted({m.head_dim for m in model.modules() if isinstance(m, AttentionCore)})


def attention_options(cfg) -> dict:
    """The AttentionCore switches a model config carries beside its backend
    and gelu implementation: ``qk_bf16_grad`` and ``fused_qkv``."""
    return dict(qk_bf16_grad=cfg.qk_bf16_grad, fused_qkv=cfg.fused_qkv)


def init_flax_defaults(model: nn.Module, generator: torch.Generator) -> None:
    """Random parameters with the Flax modules' default initializers, for
    every submodule of the standard types: Dense/conv kernels lecun-normal
    (a truncated normal of variance 1/fan_in), biases zero, LayerNorm and
    BatchNorm scale one and bias zero (running mean 0, variance 1), the
    adaptive analogy scalars w0 ~ U(0, 0.5) and w1 = 0.5
    (modeling_unimo.py:305-310). Embedding tables and class tokens are the
    owning model's to draw. In place, under ``torch.no_grad``."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                fan_in = module.weight[0].numel()
                # flax lecun_normal: a standard normal truncated at +-2 (by
                # inverse CDF), variance-corrected to 1/fan_in
                lim = math.erf(2.0 / math.sqrt(2.0))
                module.weight.uniform_(-lim, lim, generator=generator)
                module.weight.erfinv_().mul_(
                    math.sqrt(2.0) * fan_in ** -0.5 / 0.87962566103423978)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (nn.LayerNorm, nn.BatchNorm2d)):
                module.weight.fill_(1.0)
                module.bias.zero_()
                if isinstance(module, nn.BatchNorm2d):
                    module.running_mean.zero_()
                    module.running_var.fill_(1.0)
            if hasattr(module, "adaptive_w0"):
                module.adaptive_w0.uniform_(0.0, 0.5, generator=generator)
                module.adaptive_w1.fill_(0.5)


def adaptive_weights(module: nn.Module) -> None:
    """Declare the per-layer adaptive analogy-mask scalars on ``module``
    (``adaptive_w0``, ``adaptive_w1``, shape (1,)); ``init_flax_defaults``
    draws them."""
    module.adaptive_w0 = nn.Parameter(torch.empty(1))
    module.adaptive_w1 = nn.Parameter(torch.empty(1))


class EncoderLayer(nn.Module):
    """Generic transformer layer: post-LN (BERT) or pre-LN (ViT) residual
    wiring, optional adaptive analogy score multiplier. Hidden dropout
    follows the attention's output projection and the FFN, attention dropout
    sits in the attention; both run only when a ``DropoutRNG`` is given."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 hidden_act: str = "gelu", layer_norm_eps: float = 1e-12,
                 dtype: torch.dtype = torch.float32, pre_norm: bool = False,
                 hidden_dropout: float = 0.1, attention_dropout: float = 0.1,
                 backend: str = "single", gelu_impl: str = "poly",
                 qk_bf16_grad: bool = False, fused_qkv: bool = False):
        super().__init__()
        self.pre_norm = pre_norm
        self.hidden_dropout = hidden_dropout
        self.attn = AttentionCore(hidden_size, num_heads, hidden_size // num_heads,
                                  dtype=dtype, backend=backend,
                                  dropout_rate=attention_dropout,
                                  qk_bf16_grad=qk_bf16_grad, fused_qkv=fused_qkv)
        self.ln1 = LayerNorm(hidden_size, layer_norm_eps, dtype=dtype)
        self.ln2 = LayerNorm(hidden_size, layer_norm_eps, dtype=dtype)
        self.fc1 = Dense(hidden_size, intermediate_size, dtype=dtype)
        self.fc2 = Dense(intermediate_size, hidden_size, dtype=dtype)
        self.act = get_activation(hidden_act, gelu_impl)

    def _drop(self, h, rng):
        if rng is not None and self.hidden_dropout > 0.0:
            return dropout(h, self.hidden_dropout, rng)
        return h

    def forward(self, x, attn_bias=None, analogy=None,
                rng: Optional[DropoutRNG] = None):
        if self.pre_norm:
            h, _ = self.attn(self.ln1(x), attention_bias=attn_bias, analogy=analogy,
                             rng=rng)
            x = x + self._drop(h, rng)
            h = self.fc2(self.act(self.fc1(self.ln2(x))))
            return x + self._drop(h, rng)
        h, _ = self.attn(x, attention_bias=attn_bias, analogy=analogy, rng=rng)
        x = self.ln1(x + self._drop(h, rng))
        h = self.fc2(self.act(self.fc1(x)))
        return self.ln2(x + self._drop(h, rng))


class AnalogyEncoderLayer(nn.Module):
    """EncoderLayer + per-layer adaptive analogy mask over the text block.

    ``row_start`` follows the reference's per-family slice start (0 for
    UniMo-style, 1 for ViLBERT/FLAVA which skip the CLS row).
    ``compat_img_offset`` (a static image length) opts into the reference's
    shifted mask geometry for single-stream models; see ops/masks.py.
    """

    def __init__(self, *args, row_start: int = 0,
                 compat_img_offset: Optional[int] = None, **kwargs):
        super().__init__()
        self.row_start = row_start
        self.compat_img_offset = compat_img_offset
        adaptive_weights(self)
        self.layer = EncoderLayer(*args, **kwargs)

    def forward(self, x, attn_bias=None, boundary=None, text_len=None,
                rng: Optional[DropoutRNG] = None):
        analogy = None
        if boundary is not None:
            if self.compat_img_offset is not None:
                text_len, offset = None, self.compat_img_offset
            else:
                offset = 0
            analogy = (boundary, self.adaptive_w0, self.adaptive_w1, self.row_start,
                       text_len, offset)
        return self.layer(x, attn_bias=attn_bias, analogy=analogy, rng=rng)


def training_rng(deterministic: bool, rng: Optional[DropoutRNG]) -> Optional[DropoutRNG]:
    """The generators a forward draws from: none for an evaluation
    (``deterministic``), the given ones for a training forward, which must
    have them."""
    if deterministic:
        return None
    if rng is None:
        raise ValueError("a training forward (deterministic=False) needs a DropoutRNG")
    return rng


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


def _sharded_tied_logits(word_embeddings, mlm_bias, trans_hidden, compute_dtype,
                         vocab_ids, vocab_start, vocab_end) -> ShardedLogits:
    """``tied_logits`` over a table split by rows: this rank's columns of
    the slice (the ids it holds, or its part of the range)."""
    shard = shard_of(word_embeddings)
    dev = word_embeddings.device
    if vocab_ids is not None:
        ids = torch.as_tensor(vocab_ids, device=dev).long()
        cols = torch.nonzero((ids >= shard.start) & (ids < shard.stop)).flatten()
        rows, width = ids[cols] - shard.start, ids.numel()
    else:
        start = vocab_start or 0
        end = shard.whole if vocab_end is None else vocab_end
        lo, hi = max(start, shard.start), min(end, shard.stop)
        cols = torch.arange(lo, max(hi, lo), device=dev) - start
        rows, width = cols + (start - shard.start), end - start
    # each rank's columns give part of the hidden states' gradient
    x = copy_to(trans_hidden, shard.group).to(compute_dtype).to(torch.float32)
    table = word_embeddings[rows].to(compute_dtype).to(torch.float32)
    values = torch.matmul(x, table.T) + mlm_bias[rows].to(torch.float32)
    return ShardedLogits(values, cols, width, shard.group)


def tied_logits(word_embeddings, mlm_bias, trans_hidden, compute_dtype,
                vocab_ids=None, vocab_start=None, vocab_end=None):
    """Tied-decoder logits over a vocab slice, fp32 out: the products of
    compute-dtype operands summed in fp32 (``preferred_element_type``).
    Over a vocab-parallel table (``word_embeddings.tp_shard``) this rank's
    columns, as ``ShardedLogits``."""
    if shard_of(word_embeddings) is not None:
        return _sharded_tied_logits(word_embeddings, mlm_bias, trans_hidden, compute_dtype,
                                    vocab_ids, vocab_start, vocab_end)
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
