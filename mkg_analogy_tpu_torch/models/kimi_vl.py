"""Kimi-VL-A3B's language model as a MarT backbone (moonshotai/Kimi-VL-A3B-
Instruct, config.json: a DeepSeek-V3-style decoder), fed MARS's two images
as tokens.

- images: each of the two image slots through CLIP-ViT-B/32 (MKGformer's
  vision classes, ``models/unimo.py``; one image a pass: its CLS and 49
  patches, 50 states), a LayerNorm and the projector Linear(768 -> 2048),
  gelu, Linear(2048 -> 2048); an empty slot (mode 0) is the pad row's
  image, as MKGformer takes it. The 100 image positions come before the 128
  text positions, whose word rows are the untied embedding's; RoPE
  positions 0 .. 227; ``token_type_ids`` is unused;
- a block: ``h = x + MLA(RMSNorm(x))``, ``out = h + FFN(RMSNorm(h))``; a
  final RMSNorm;
- MLA (multi-head latent attention, no q LoRA): ``q = x W_q`` (heads of 128
  + 64), ``[c, k_pe] = x W_kva`` (512 + 64), ``c = RMSNorm(c)``,
  ``[k_nope, v] = c W_kvb`` (heads of 128 + 128); RoPE (theta 800,000, the
  pairs (2i, 2i + 1) rotated) on ``q_pe`` and on the one ``k_pe`` all heads
  share; scale 1/sqrt(192); the causal mask, the key-padding mask and
  MarT's analogy multiplier (``adaptive_w0``/``w1`` over the text rows and
  answer columns, after the image prefix) in the flash kernels
  (``kernels/flash_attention.py``: causal, value width 128 under 192);
- FFN: a SwiGLU ``W_down(silu(W_gate x) * W_up x)``, of width 11,264 in the
  first ``first_dense_layers`` layers; then expert layers
  (:class:`ExpertLayer`): scores ``s = sigmoid(x W_r)`` in fp32 over all
  ``router_experts``; the choice ``top-k(s + b)`` with the selection bias
  ``b`` (``router.bias``, noaux_tc's ``e_score_correction_bias``, which
  moves the choice and not the weights, and takes no gradient: it is held
  fixed); weights ``s_chosen / sum(s_chosen) * routed_scaling_factor`` over
  all k chosen; ``y = shared(x) + sum over the chosen and held experts of
  w_e E_e(x)``, the shared experts one SwiGLU of 2 x 1,408;
- the layer is told which experts it holds (``first_held_expert``,
  ``held_experts``): it routes over all of them and computes the part of
  the result its own experts give, dropless, the gate and up products and
  then the down product each one grouped product over the held experts
  (``torch._grouped_mm``), as one rank of an expert-parallel deployment
  does without its exchange;
- MarT's head: the final states at the five gathered positions (offset by
  the image prefix), and the logits of the untied head's rows.

Precision: parameters fp32, computed in the compute dtype (``Dense``);
norms, RoPE, the router, the expert weights and the activations' products
in fp32, rounded once.

Spans (``utils/profiling.py``): ``moe.route``, ``moe.dispatch``,
``moe.experts`` (forward, and its custom backward), ``moe.shared`` and
``moe.combine`` in each expert layer. Counters: ``TOKENS_ROUTED_HELD`` (the
(token, held expert) pairs routed, summed over forwards), ``MOE_CALLS``
(expert-layer forwards) and ``GROUPED_PRODUCTS`` (grouped-product launches,
two a forward and four a backward).

No dropout: the published model has none (attention_dropout 0).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import to_dtype
from ..kernels.flash_attention import flash_attention
from ..parallel.collectives import gather_rows
from ..utils.profiling import span
from .common import Dense, LayerNorm, clip, gather_positions, get_activation
from .unimo import CLIPLayer, CLIPVisionEmbeddings, VisionConfig

TOKENS_ROUTED_HELD = 0  # (token, held expert) pairs routed, over every forward
MOE_CALLS = 0           # expert-layer forwards
GROUPED_PRODUCTS = 0    # grouped-product launches: two a forward, four a backward


@dataclass(frozen=True)
class KimiVLConfig:
    """The published widths (Kimi-VL-A3B-Instruct's text_config) and this
    card's share of the stated deployment: ``num_layers`` (27 published; 14,
    pipeline stage 1 of 2), ``held_experts`` of ``router_experts`` (8 of 64:
    EP8, experts 0-7 here) and ``vocab_size`` (an eighth of the word rows
    and MarT's tokens, 32,000 padded; 163,840 published)."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 14
    num_heads: int = 16
    intermediate_size: int = 11264       # the dense layers' SwiGLU
    moe_intermediate_size: int = 1408    # an expert's SwiGLU
    first_dense_layers: int = 1          # first_k_dense_replace
    router_experts: int = 64             # n_routed_experts published: the router's width
    held_experts: int = 8                # the experts this card holds
    first_held_expert: int = 0
    experts_per_token: int = 6
    shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 800000.0
    rms_norm_eps: float = 1e-5
    kv_a_norm_eps: float = 1e-6          # kv_a_layernorm: DeepSeek-V3's RMSNorm default
    vision: VisionConfig = field(default_factory=lambda: VisionConfig(num_images=1))
    num_images: int = 2
    dtype: str = "bfloat16"
    attention: str = "flash"  # the vision tower's backend; MLA always takes flash
    gelu_impl: str = "poly"   # the projector's gelu under non-fp32 compute

    @property
    def compute_dtype(self) -> torch.dtype:
        return to_dtype(self.dtype)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def image_tokens(self) -> int:
        return self.num_images * self.vision.num_tokens


class RMSNorm(nn.RMSNorm):
    """RMSNorm with fp32 statistics and its output in ``dtype``."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.to(torch.float32), self.normalized_shape, self.weight,
                          self.eps).to(self.compute_dtype)


def rope_tables(positions: int, width: int, theta: float, device):
    """(cos, sin), each (positions, width / 2) fp32: angle p * theta^(-2i /
    width), computed in fp64."""
    inv = theta ** (-torch.arange(0, width, 2, dtype=torch.float64, device=device) / width)
    angle = torch.arange(positions, dtype=torch.float64, device=device)[:, None] * inv
    return angle.cos().to(torch.float32), angle.sin().to(torch.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, L, heads, width) with each pair (2i, 2i + 1) rotated by its
    angle, in fp32, rounded to x's dtype."""
    x32 = x.to(torch.float32)
    even, odd = x32[..., 0::2], x32[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([even * c - odd * s, odd * c + even * s], dim=-1).flatten(-2).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in fp32, rounded once to gate's dtype."""
    return (F.silu(gate.to(torch.float32)) * up.to(torch.float32)).to(gate.dtype)


class SwiGLU(nn.Module):
    """``down(silu(gate x) * up x)``, no biases."""

    def __init__(self, hidden: int, inner: int, dtype: torch.dtype):
        super().__init__()
        self.gate_proj = Dense(hidden, inner, bias=False, dtype=dtype)
        self.up_proj = Dense(hidden, inner, bias=False, dtype=dtype)
        self.down_proj = Dense(inner, hidden, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LatentAttention(nn.Module):
    """MLA without q LoRA, through the causal flash kernels (queries and keys
    of qk_nope + qk_rope columns a head, values of v_head_dim)."""

    def __init__(self, cfg: KimiVLConfig, dtype: torch.dtype):
        super().__init__()
        h, heads = cfg.hidden_size, cfg.num_heads
        self.cfg, self.dtype = cfg, dtype
        self.q_proj = Dense(h, heads * cfg.qk_head_dim, bias=False, dtype=dtype)
        self.kv_a_proj = Dense(h, cfg.kv_lora_rank + cfg.qk_rope_head_dim, bias=False,
                               dtype=dtype)
        self.kv_a_ln = RMSNorm(cfg.kv_lora_rank, cfg.kv_a_norm_eps, dtype)
        self.kv_b_proj = Dense(cfg.kv_lora_rank, heads * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                               bias=False, dtype=dtype)
        self.o_proj = Dense(heads * cfg.v_head_dim, h, bias=False, dtype=dtype)

    def forward(self, x, mask, rope, analogy):
        cfg = self.cfg
        b, n, _ = x.shape
        heads, nope, pe = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        q_nope, q_pe = self.q_proj(x).view(b, n, heads, nope + pe).split([nope, pe], dim=-1)
        c, k_pe = self.kv_a_proj(x).split([cfg.kv_lora_rank, pe], dim=-1)
        kv = self.kv_b_proj(self.kv_a_ln(c)).view(b, n, heads, nope + cfg.v_head_dim)
        k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
        q_pe = apply_rope(q_pe, *rope)
        k_pe = apply_rope(k_pe[:, :, None, :], *rope).expand(b, n, heads, pe)
        q = torch.cat([q_nope, q_pe], dim=-1).reshape(b, n, heads * cfg.qk_head_dim)
        k = torch.cat([k_nope, k_pe], dim=-1).reshape(b, n, heads * cfg.qk_head_dim)
        ctx = flash_attention(q, k, v.reshape(b, n, heads * cfg.v_head_dim).contiguous(), mask,
                              heads, causal=True, compute_dtype=self.dtype, **analogy)
        return self.o_proj(ctx)


def choose(scores: torch.Tensor, bias: torch.Tensor, k: int):
    """(the chosen scores (T, k), their experts (T, k)): top-k of ``scores +
    bias``. The bias moves the choice and not the weights, and takes no
    gradient (the optimizer gives a leaf without one zeros, so it stays)."""
    idx = torch.topk(scores + bias.detach(), k, dim=-1).indices
    return scores.gather(-1, idx), idx


def _grouped(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    global GROUPED_PRODUCTS
    GROUPED_PRODUCTS += 1
    return torch._grouped_mm(a, b, offs=offs)


class _GroupedSwiGLU(torch.autograd.Function):
    """The held experts' SwiGLU over their rows, ``x`` (M, H) sorted by
    expert, ``offs`` the experts' cumulative row counts (int32): one
    grouped product for gate and up (``gate_up`` (E, H, 2I)), the
    activation in fp32 rounded once, one for down (``down`` (E, I, H)).
    The backward recomputes the activation from the saved gate and up and
    runs four grouped products (dA, dW_down, dX, dW_gate_up)."""

    @staticmethod
    def forward(ctx, x, gate_up, down, offs):
        h = _grouped(x, gate_up, offs)
        gate, up = h.chunk(2, dim=-1)
        y = _grouped(swiglu(gate, up), down, offs)
        ctx.save_for_backward(x, gate_up, down, offs, h)
        return y

    @staticmethod
    def backward(ctx, dy):
        with span("moe.experts"):
            x, gate_up, down, offs, h = ctx.saved_tensors
            gate, up = (t.to(torch.float32) for t in h.chunk(2, dim=-1))
            sig = torch.sigmoid(gate)
            silu = gate * sig
            act = (silu * up).to(x.dtype)
            dy = dy.contiguous()
            da = _grouped(dy, down.transpose(1, 2), offs).to(torch.float32)
            d_down = _grouped(act.t(), dy, offs)
            d_gate = da * up * sig * (1.0 + gate * (1.0 - sig))
            dh = torch.cat([d_gate, da * silu], dim=-1).to(x.dtype)
            dx = _grouped(dh, gate_up.transpose(1, 2), offs)
            d_gate_up = _grouped(x.t(), dh, offs)
        return dx, d_gate_up, d_down, None


class Router(nn.Module):
    """The router's fp32 kernel (experts, H) and the selection bias."""

    def __init__(self, hidden: int, experts: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, hidden))
        self.bias = nn.Parameter(torch.empty(experts))


class GroupedExperts(nn.Module):
    """The held experts' weights: ``gate_up`` (E, H, 2I), gate then up, and
    ``down`` (E, I, H), each multiplied from the right."""

    def __init__(self, experts: int, hidden: int, inner: int):
        super().__init__()
        self.gate_up = nn.Parameter(torch.empty(experts, hidden, 2 * inner))
        self.down = nn.Parameter(torch.empty(experts, inner, hidden))


class ExpertLayer(nn.Module):
    """Sigmoid top-k routing over all ``router_experts`` with the selection
    bias, the shared experts, and the held experts' part of the routed sum
    (see the module's docstring)."""

    def __init__(self, cfg: KimiVLConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        h, inner = cfg.hidden_size, cfg.moe_intermediate_size
        self.router = Router(h, cfg.router_experts)
        self.shared = SwiGLU(h, cfg.shared_experts * inner, dtype)
        self.experts = GroupedExperts(cfg.held_experts, h, inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        global TOKENS_ROUTED_HELD, MOE_CALLS
        cfg, dt = self.cfg, self.dtype
        shape, k, held = x.shape, cfg.experts_per_token, cfg.held_experts
        flat = x.reshape(-1, shape[-1])
        with span("moe.route"):
            scores = torch.sigmoid(F.linear(flat.to(torch.float32), self.router.weight))
            chosen, experts = choose(scores, self.router.bias, k)
            weights = chosen / chosen.sum(dim=-1, keepdim=True) * cfg.routed_scaling_factor
        with span("moe.shared"):
            out = self.shared(flat)
        with span("moe.dispatch"):
            local = experts.flatten() - cfg.first_held_expert
            # the held experts' slots first, by expert; the others after them
            key = torch.where((local >= 0) & (local < held), local, torch.full_like(local, held))
            order = torch.argsort(key, stable=True)
            counts = torch.bincount(key, minlength=held + 1)[:held]
            offs = counts.cumsum(0).to(torch.int32)
            rows = int(offs[-1])  # the one host sync: the rows the grouped products take
            slots = order[:rows]
            rows_in = flat[slots // k]
        TOKENS_ROUTED_HELD += rows
        MOE_CALLS += 1
        with span("moe.experts"):
            routed = _GroupedSwiGLU.apply(rows_in, self.experts.gate_up.to(dt),
                                          self.experts.down.to(dt), offs)
        with span("moe.combine"):
            routed = (routed.to(torch.float32) * weights.flatten()[slots, None]).to(dt)
            # each slot's result at its place, then the k slots of a token summed
            per_slot = routed.new_zeros(flat.shape[0] * k, flat.shape[1])
            per_slot = per_slot.index_copy(0, slots, routed)
            out = out + per_slot.view(-1, k, flat.shape[1]).sum(dim=1)
        return out.view(shape)


class DecoderLayer(nn.Module):
    """``h = x + MLA(RMSNorm(x))``, ``h + FFN(RMSNorm(h))``: a dense SwiGLU
    or an expert layer; MarT's adaptive analogy scalars."""

    def __init__(self, cfg: KimiVLConfig, dtype: torch.dtype, dense: bool):
        super().__init__()
        self.adaptive_w0 = nn.Parameter(torch.empty(1))
        self.adaptive_w1 = nn.Parameter(torch.empty(1))
        self.input_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.attn = LatentAttention(cfg, dtype)
        self.post_attn_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.dense = dense
        if dense:
            self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype)
        else:
            self.moe = ExpertLayer(cfg, dtype)

    def forward(self, x, mask, rope, geometry):
        analogy = {}
        if geometry is not None:
            analogy = dict(geometry, w0=clip(self.adaptive_w0, 0.0, 0.5),
                           w1=clip(self.adaptive_w1, 0.5, 1.0))
        h = x + self.attn(self.input_ln(x), mask, rope, analogy)
        ffn = self.mlp if self.dense else self.moe
        return h + ffn(self.post_attn_ln(h))


class KimiVLForMaskedLM(nn.Module):
    """The decoder over [image tokens ; text], MarT's gathered states and the
    untied head's logits. Parameter names: ``layers_<i>.attn.q_proj.weight``,
    ``layers_<i>.moe.experts.gate_up``, ``vision_<i>.fc1.weight``, ..."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.cfg = cfg
        dtype, h, v = cfg.compute_dtype, cfg.hidden_size, cfg.vision
        self.word_embeddings = nn.Parameter(torch.empty(cfg.vocab_size, h))
        self.lm_head = nn.Parameter(torch.empty(cfg.vocab_size, h))
        self.vision_embeddings = CLIPVisionEmbeddings(v, dtype)
        self.vision_pre_ln = LayerNorm(v.hidden_size, v.layer_norm_eps, dtype=dtype)
        for i in range(v.num_layers):
            self.add_module(f"vision_{i}", CLIPLayer(v, dtype, cfg.attention))
        self.vision_post_ln = LayerNorm(v.hidden_size, v.layer_norm_eps, dtype=dtype)
        self.projector_fc1 = Dense(v.hidden_size, h, dtype=dtype)
        self.projector_fc2 = Dense(h, h, dtype=dtype)
        self.projector_act = get_activation("gelu", cfg.gelu_impl)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", DecoderLayer(cfg, dtype, i < cfg.first_dense_layers))
        self.final_ln = RMSNorm(h, cfg.rms_norm_eps, dtype)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """N(0, 0.02^2) for every kernel, table, token, expert and router
        row (the published initializer_range), biases and the selection bias
        0, norm scales 1, w0 ~ U(0, 0.5), w1 = 0.5."""
        norms = {id(m.weight) for m in self.modules() if isinstance(m, (nn.LayerNorm, nn.RMSNorm))}
        for name, p in self.named_parameters():
            if name.endswith("adaptive_w0"):
                p.uniform_(0.0, 0.5, generator=generator)
            elif name.endswith("adaptive_w1"):
                p.fill_(0.5)
            elif id(p) in norms:
                p.fill_(1.0)
            elif name.rpartition(".")[2] == "bias":
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, 2, 3, S, S) pixels -> (B, 100, H): each image's 50 CLIP states,
        projected."""
        cfg = self.cfg
        b = pixel_values.shape[0]
        x = self.vision_pre_ln(self.vision_embeddings(
            pixel_values.reshape((b * cfg.num_images,) + pixel_values.shape[2:])))
        for i in range(cfg.vision.num_layers):
            x = getattr(self, f"vision_{i}")(x)
        x = self.projector_fc2(self.projector_act(self.projector_fc1(self.vision_post_ln(x))))
        return x.reshape(b, cfg.image_tokens, cfg.hidden_size)

    def forward(self, input_ids, attention_mask, token_type_ids, pixel_values, positions,
                boundary=None, visual_attention_mask=None, deterministic=True, rng=None):
        """The final states at ``positions`` of the text (B, P, H).
        ``token_type_ids``, ``visual_attention_mask`` and the dropout
        generators are unused: the model has no dropout."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        img = self.images(pixel_values)
        txt = gather_rows(self.word_embeddings, input_ids).to(dtype)
        x = torch.cat([img, txt], dim=1)
        b, n, _ = x.shape
        prefix = img.shape[1]
        mask = torch.cat([attention_mask.new_ones(b, prefix), attention_mask],
                         dim=1).to(torch.float32)
        rope = rope_tables(n, cfg.qk_rope_head_dim, cfg.rope_theta, x.device)
        geometry = None
        if boundary is not None:
            # MarT's geometry on the text rows and columns, after the images
            geometry = dict(boundary=boundary, row_start=prefix, text_len=n, offset=prefix)
        for i in range(cfg.num_layers):
            x = getattr(self, f"layers_{i}")(x, mask, rope, geometry)
        x = self.final_ln(x)
        return gather_positions(x, positions.long() + prefix)

    def logits(self, trans_hidden, vocab_ids=None, vocab_start=None, vocab_end=None):
        """The untied head's logits (fp32) for ``trans_hidden`` (..., H): the
        products of compute-dtype operands summed in fp32, over ``vocab_ids``
        rows, the range ``vocab_start:vocab_end``, or every row."""
        dtype = self.cfg.compute_dtype
        table = self.lm_head
        if vocab_ids is not None:
            table = table[torch.as_tensor(vocab_ids, device=table.device).long()]
        elif vocab_start is not None:
            table = table[vocab_start:vocab_end]
        x = trans_hidden.to(dtype).to(torch.float32)
        return torch.matmul(x, table.to(dtype).to(torch.float32).T)
