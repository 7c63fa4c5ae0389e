"""MKGformer / UniMo: dual-tower CLIP-ViT + BERT encoder advanced in lockstep
(``mkg_analogy_tpu/models/unimo.py``; reference MarT/models/modeling_unimo.py).

- the 12 vision (CLIP) and 12 text (BERT) layers run in lockstep; from layer
  ``fusion_start`` (=8) the vision layer attends over [text K/V of the
  *previous* text layer ; vision tokens] (modeling_unimo.py:609-643), and
  the text layer's FFN receives a softmax cross-attention fusion of the
  *current* vision hidden states (BertFusion, modeling_unimo.py:394-414);
- every text self-attention applies the adaptive analogy multiplier, built
  inside the attention from the ``sep_idx[:,2]`` boundary;
- two images are patch-embedded and concatenated: [CLS, patches(img0),
  patches(img1)] with position embeddings [pos, pos[1:]]
  (modeling_unimo.py:119-132) — 2*(224/32)^2 + 1 = 99 vision tokens;
- the MLM head evaluates the tied decoder only at *gathered positions* and
  only over the requested vocab slice.

Parameter names follow the Flax tree (``encoder.text_3.attn.query.weight``
for ``encoder/text_3/attn/query/kernel``), so ``models/convert.py`` maps it
mechanically.

Dropout sits where the JAX model has it: hidden dropout after the text
embedding LayerNorm, after each text attention's output projection and after
each text FFN, attention dropout in the text self-attention (the vision
tower has none). It runs only in a training forward (``deterministic=False``
with a ``DropoutRNG``); evaluation is deterministic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
from torch import nn

from ..core.precision import to_dtype
from ..ops.masks import attention_bias
from .common import (
    AttentionCore,
    Dense,
    DropoutRNG,
    LayerNorm,
    MLMTransform,
    PatchEmbed,
    dropout,
    gather_positions,
    get_activation,
    tied_logits,
)


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 42112  # padded: wordpiece + entities + relations + [R]
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class VisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 32
    num_images: int = 2
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    attention_dropout: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patches_per_image(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        return self.num_images * self.patches_per_image + 1


@dataclass(frozen=True)
class UnimoConfig:
    text: TextConfig = field(default_factory=TextConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    fusion_start: int = 8  # first layer with cross-modal flow (idx >= 8)
    dtype: str = "bfloat16"
    # attention backend of every layer (models/common.py:AttentionCore):
    # "single" (the single-block CUDA kernel), "flash" (the K-blocked CUDA
    # kernels) or "plain" (the einsum path; flash from FLASH_AUTO_MIN_LEN)
    attention: str = "single"
    gelu_impl: str = "poly"  # gelu under non-fp32 compute (fp32: exact erf)

    @property
    def compute_dtype(self) -> torch.dtype:
        return to_dtype(self.dtype)


class CLIPVisionEmbeddings(nn.Module):
    """Patch-embed ``num_images`` images and concat with a single CLS token
    (modeling_unimo.py:100-132)."""

    def __init__(self, cfg: VisionConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embedding = PatchEmbed(3, cfg.hidden_size, cfg.patch_size,
                                          dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.patches_per_image + 1, cfg.hidden_size))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = pixel_values.shape[0]
        x = pixel_values.reshape(b * cfg.num_images, 3, cfg.image_size, cfg.image_size)
        patches = self.patch_embedding(x).reshape(
            b, cfg.num_images * cfg.patches_per_image, cfg.hidden_size)
        cls = self.class_embedding.to(self.dtype).expand(b, 1, cfg.hidden_size)
        embeds = torch.cat([cls, patches], dim=1)  # (B, 99, H)
        table = self.position_embedding.to(self.dtype)
        # [pos(50), pos[1:](49), pos[1:](49), ...] for num_images images
        pos = torch.cat([table] + [table[1:]] * (cfg.num_images - 1), dim=0)
        return embeds + pos[None]


class TextEmbeddings(nn.Module):
    """Word + position + token-type embeddings with LN. The word table is
    passed in (owned by the LM head for weight tying)."""

    def __init__(self, cfg: TextConfig, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.hidden_dropout = cfg.hidden_dropout
        self.position_embeddings = nn.Parameter(
            torch.empty(cfg.max_position_embeddings, cfg.hidden_size))
        self.token_type_embeddings = nn.Parameter(
            torch.empty(cfg.type_vocab_size, cfg.hidden_size))
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype=dtype)

    def forward(self, input_ids, token_type_ids, word_table,
                rng: Optional[DropoutRNG] = None):
        seq_len = input_ids.shape[1]
        x = (
            word_table[input_ids.long()].to(self.dtype)
            + self.position_embeddings[:seq_len][None].to(self.dtype)
            + self.token_type_embeddings[token_type_ids.long()].to(self.dtype)
        )
        x = self.ln(x)
        if rng is not None and self.hidden_dropout > 0.0:
            x = dropout(x, self.hidden_dropout, rng.device)
        return x


class CLIPLayer(nn.Module):
    """Pre-LN CLIP encoder layer, optionally attending over prepended text
    K/V (modeling_unimo.py:481-527)."""

    def __init__(self, cfg: VisionConfig, dtype: torch.dtype, backend: str):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype=dtype)
        self.attn = AttentionCore(cfg.hidden_size, cfg.num_heads, cfg.head_dim,
                                  dtype=dtype, backend=backend,
                                  dropout_rate=cfg.attention_dropout)
        self.ln2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype=dtype)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, dtype=dtype)
        self.act = get_activation(cfg.hidden_act)

    def forward(self, x, extra_kv=None, extra_kv_bias=None,
                rng: Optional[DropoutRNG] = None):
        h, _ = self.attn(self.ln1(x), extra_kv=extra_kv, extra_kv_bias=extra_kv_bias,
                         rng=rng)
        x = x + h
        return x + self.fc2(self.act(self.fc1(self.ln2(x))))


class BertFusion(nn.Module):
    """Parameter-free softmax cross-attention of text context over vision
    hidden states (modeling_unimo.py:394-414): fp32 scores of compute-dtype
    operands, probs cast back, then ·V in the compute dtype."""

    def forward(self, text_ctx: torch.Tensor, vision_hidden: torch.Tensor):
        scores = torch.matmul(text_ctx.to(torch.float32),
                              vision_hidden.to(torch.float32).transpose(1, 2))
        probs = torch.softmax(scores, dim=-1).to(vision_hidden.dtype)
        return torch.matmul(probs, vision_hidden)


class BertLayer(nn.Module):
    """Post-LN BERT layer with adaptive analogy mask, optional vision fusion
    into the FFN, and optional K/V export (modeling_unimo.py:290-377,
    448-464, 530-577). Only layers from ``fusion_start`` on carry
    ``fusion_dense``, as in the Flax tree."""

    def __init__(self, cfg: TextConfig, dtype: torch.dtype, backend: str,
                 has_fusion: bool, gelu_impl: str = "poly"):
        super().__init__()
        # adaptive analogy mask scalars: w0 ~ U(0, 0.5), w1 = 0.5
        # (modeling_unimo.py:305-310)
        self.adaptive_w0 = nn.Parameter(torch.empty(1))
        self.adaptive_w1 = nn.Parameter(torch.empty(1))
        self.attn = AttentionCore(cfg.hidden_size, cfg.num_heads, cfg.head_dim,
                                  dtype=dtype, backend=backend,
                                  dropout_rate=cfg.attention_dropout)
        self.hidden_dropout = cfg.hidden_dropout
        self.attn_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype=dtype)
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)
        if has_fusion:
            self.fusion = BertFusion()
            self.fusion_dense = Dense(cfg.hidden_size, cfg.intermediate_size,
                                      dtype=dtype)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size, dtype=dtype)
        self.out_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype=dtype)
        self.act = get_activation(cfg.hidden_act, gelu_impl)

    def forward(self, x, attn_bias, boundary=None, vision_hidden=None,
                output_kv=False, rng: Optional[DropoutRNG] = None):
        analogy = None
        if boundary is not None:
            # UniMo geometry: rows from 0, full text coords
            # (modeling_unimo.py:342-349)
            analogy = (boundary, self.adaptive_w0, self.adaptive_w1, 0, None, 0)
        out, kv, raw_ctx = self.attn(x, attention_bias=attn_bias, analogy=analogy,
                                     output_kv=output_kv, output_context=True,
                                     rng=rng)
        drop = rng is not None and self.hidden_dropout > 0.0
        if drop:
            out = dropout(out, self.hidden_dropout, rng.device)
        attn_out = self.attn_ln(out + x)
        h = self.intermediate(attn_out)
        if vision_hidden is not None:
            # fusion consumes the RAW attention context, pre out-projection
            # (modeling_unimo.py:367-373)
            h = h + self.fusion_dense(self.fusion(raw_ctx, vision_hidden))
        h = self.output(self.act(h))
        if drop:
            h = dropout(h, self.hidden_dropout, rng.device)
        return self.out_ln(h + attn_out), kv


class UnimoEncoder(nn.Module):
    """Lockstep dual-tower loop (modeling_unimo.py:580-658)."""

    def __init__(self, cfg: UnimoConfig):
        super().__init__()
        if cfg.text.num_layers != cfg.vision.num_layers:
            raise ValueError("UniMo runs its towers in lockstep: equal depths")
        self.cfg = cfg
        dtype = cfg.compute_dtype
        for idx in range(cfg.text.num_layers):
            self.add_module(f"vision_{idx}", CLIPLayer(
                cfg.vision, dtype, cfg.attention))
            self.add_module(f"text_{idx}", BertLayer(
                cfg.text, dtype, cfg.attention,
                has_fusion=idx >= cfg.fusion_start, gelu_impl=cfg.gelu_impl))

    def forward(self, vision_embeds, text_embeds, attn_bias, boundary=None,
                rng: Optional[DropoutRNG] = None):
        cfg = self.cfg
        vision_h, text_h = vision_embeds, text_embeds
        prev_text_kv: Optional[Tuple] = None
        for idx in range(cfg.text.num_layers):
            # Vision layer idx >= fusion_start attends over the *previous*
            # text layer's K/V (exported from idx >= fusion_start - 1).
            extra_kv = prev_text_kv if idx >= cfg.fusion_start else None
            vision_h = getattr(self, f"vision_{idx}")(
                vision_h, extra_kv, attn_bias if extra_kv is not None else None,
                rng=rng)
            vision_for_text = vision_h if idx >= cfg.fusion_start else None
            text_h, prev_text_kv = getattr(self, f"text_{idx}")(
                text_h, attn_bias, boundary, vision_for_text,
                output_kv=idx >= cfg.fusion_start - 1, rng=rng)
        return text_h, vision_h


class UnimoForMaskedLM(nn.Module):
    """UniMo with a tied-embedding MLM head returning the transformed hidden
    states at gathered positions (modeling_unimo.py:839-959 parity) and
    logits over a vocab slice."""

    def __init__(self, cfg: UnimoConfig):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.compute_dtype
        self.word_embeddings = nn.Parameter(
            torch.empty(cfg.text.vocab_size, cfg.text.hidden_size))
        self.mlm_bias = nn.Parameter(torch.empty(cfg.text.vocab_size))
        self.vision_embeddings = CLIPVisionEmbeddings(cfg.vision, dtype)
        self.vision_pre_ln = LayerNorm(cfg.vision.hidden_size,
                                       cfg.vision.layer_norm_eps, dtype=dtype)
        self.text_embeddings = TextEmbeddings(cfg.text, dtype)
        self.encoder = UnimoEncoder(cfg)
        self.mlm_transform = MLMTransform(
            cfg.text.hidden_size, cfg.text.hidden_act, cfg.text.layer_norm_eps,
            dtype=dtype, gelu_impl=cfg.gelu_impl)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random parameters with the Flax initializers' distributions:
        Dense/conv kernels lecun-normal (truncated normal of variance
        1/fan_in), biases zero, LayerNorm scale one, embeddings normal(0.02),
        the CLS embedding normal(1), w0 ~ U(0, 0.5), w1 = 0.5. The draws
        differ from JAX's: a converted Flax tree is how to get JAX's."""
        std = self.cfg.text.initializer_range
        for module in self.modules():
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
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, BertLayer):
                module.adaptive_w0.uniform_(0.0, 0.5, generator=generator)
                module.adaptive_w1.fill_(0.5)
        te, ve = self.text_embeddings, self.vision_embeddings
        for p, s in ((self.word_embeddings, std), (te.position_embeddings, std),
                     (te.token_type_embeddings, std), (ve.class_embedding, 1.0),
                     (ve.position_embedding, 0.02)):
            p.normal_(0.0, s, generator=generator)
        self.mlm_bias.zero_()

    def encode(self, input_ids, attention_mask, token_type_ids, pixel_values,
               boundary=None, deterministic=True, rng: Optional[DropoutRNG] = None):
        if deterministic:
            rng = None
        elif rng is None:
            raise ValueError("a training forward (deterministic=False) needs a "
                             "DropoutRNG")
        vis = self.vision_pre_ln(self.vision_embeddings(pixel_values))
        txt = self.text_embeddings(input_ids, token_type_ids, self.word_embeddings,
                                   rng=rng)
        bias = attention_bias(attention_mask, dtype=torch.float32)
        text_h, _ = self.encoder(vis, txt, bias, boundary=boundary, rng=rng)
        return text_h

    def forward(self, input_ids, attention_mask, token_type_ids, pixel_values,
                positions, boundary=None, visual_attention_mask=None,
                deterministic=True, rng: Optional[DropoutRNG] = None):
        """Transformed hidden states at ``positions`` (B, P, H); feed slices
        of them to :meth:`logits`. ``visual_attention_mask`` is unused: UniMo
        consumes raw pixels. ``deterministic=False`` is a training forward,
        with dropout drawn from ``rng``."""
        seq = self.encode(input_ids, attention_mask, token_type_ids,
                          pixel_values, boundary=boundary,
                          deterministic=deterministic, rng=rng)
        return self.mlm_transform(gather_positions(seq, positions))

    def logits(self, trans_hidden, vocab_ids=None, vocab_start=None, vocab_end=None):
        """Tied-decoder logits (fp32) for ``trans_hidden`` (..., H):
        ``vocab_ids`` rows (e.g. the 2,063 analogy entities), or the range
        ``vocab_start:vocab_end``, or the full vocab."""
        return tied_logits(self.word_embeddings, self.mlm_bias, trans_hidden,
                           self.cfg.compute_dtype, vocab_ids=vocab_ids,
                           vocab_start=vocab_start, vocab_end=vocab_end)
