"""FLAVA: separate image/text towers + multimodal fusion tower
(``mkg_analogy_tpu/models/flava.py``; reference
MarT/models/modeling_flava.py, M9).

- image tower (ViT-B/16 pre-LN) embeds BOTH images: [CLS ; patches(head)]
  gets position rows 0..P, patches(tail) get position rows 0..P-1 (the
  reference reuses the table head *including* the CLS row,
  modeling_flava.py:336-343) -> 2*196 + 1 = 393 tokens;
- text tower applies the adaptive analogy mask inside its attention with
  rows starting at 1 (modeling_flava.py:491-496);
- the multimodal tower consumes the towers' *pre-final-layernorm* states
  ("Note that these states don't use final layernorm",
  modeling_flava.py:1429-1450), runs UNMASKED (the reference passes no
  attention mask to the multimodal model, modeling_flava.py:1456), prepends
  its own CLS, and the MLM head reads the text slice of its post-layernorm
  output (modeling_flava.py:1452-1457, 2127-2204). The towers' final
  layernorms and poolers are dead parameters in the MaskedLM path and are
  not instantiated here.

The multimodal tower attends over 1 + 393 + L tokens, 522 at L=128: at the
length from which the plain route takes the flash kernels
(models/common.py:FLASH_AUTO_MIN_LEN), within the single-block kernel's
shared memory in bf16 and not in fp32.

Parameter names follow the Flax tree (``text_3.layer.attn.query.weight``,
``image_0.fc1.weight``, ``mm_cls_token``), so ``models/convert.py`` maps it
mechanically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from ..core.precision import to_dtype
from ..ops.masks import attention_bias
from .common import (
    AnalogyEncoderLayer,
    Dense,
    DropoutRNG,
    EncoderLayer,
    LayerNorm,
    MLMTransform,
    PatchEmbed,
    attention_options,
    dropout,
    gather_positions,
    init_flax_defaults,
    tied_logits,
    training_rng,
)
from .unimo import TextConfig, TextEmbeddings


@dataclass(frozen=True)
class FlavaConfig:
    text: TextConfig = field(default_factory=TextConfig)
    image_size: int = 224
    patch_size: int = 16
    image_layers: int = 12
    multimodal_layers: int = 6
    layer_norm_eps: float = 1e-12
    dtype: str = "bfloat16"
    attention: str = "flash"  # attention backend (models/common.py:AttentionCore)
    gelu_impl: str = "poly"   # gelu under non-fp32 compute (fp32: exact erf)
    # AttentionCore switches (models/common.py), default off: the plain
    # route's bf16 dq/dk backward, one fused Q/K/V projection
    qk_bf16_grad: bool = False
    fused_qkv: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return to_dtype(self.dtype)

    @property
    def patches_per_image(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def image_tokens(self) -> int:
        return 2 * self.patches_per_image + 1  # head CLS + 2x patches


class FlavaImageEmbeddings(nn.Module):
    """Stacked 2-image embedding: [CLS ; patches(head) ; patches(tail)] with
    positions [pos ; pos[:P]] (modeling_flava.py:310-344)."""

    def __init__(self, cfg: FlavaConfig):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.text.hidden_size
        self.patch_embedding = PatchEmbed(3, hidden, cfg.patch_size,
                                          dtype=cfg.compute_dtype, use_bias=True)
        # HF FLAVA zero-inits CLS/positions and loads pretrained weights at
        # once; from scratch with a zero image store that would make the
        # whole image tower exactly zero, and every zero-variance LayerNorm
        # backward then scales gradients by rsqrt(eps) = 1e6 a layer. A small
        # random init (init_params) keeps the variance positive.
        self.cls_token = nn.Parameter(torch.empty(1, 1, hidden))
        self.position_embeddings = nn.Parameter(
            torch.empty(cfg.patches_per_image + 1, hidden))

    def forward(self, pixel_values, rng: Optional[DropoutRNG] = None):
        cfg = self.cfg
        dtype = cfg.compute_dtype
        hidden = cfg.text.hidden_size
        b = pixel_values.shape[0]
        x = pixel_values.reshape(b * 2, 3, cfg.image_size, cfg.image_size)
        patches = self.patch_embedding(x).reshape(b, 2 * cfg.patches_per_image, hidden)
        cls = self.cls_token.to(dtype).expand(b, 1, hidden)
        tokens = torch.cat([cls, patches], dim=1)
        pos = self.position_embeddings.to(dtype)
        # tail patches reuse table rows 0..P-1 (including the CLS row 0:
        # modeling_flava.py:336-343, position_embeddings[:, :tail.shape[1]])
        full_pos = torch.cat([pos, pos[: cfg.patches_per_image]], dim=0)
        tokens = tokens + full_pos[None]
        if rng is not None and cfg.text.hidden_dropout > 0.0:
            tokens = dropout(tokens, cfg.text.hidden_dropout, rng)
        return tokens


class FlavaForMaskedLM(nn.Module):
    def __init__(self, cfg: FlavaConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        dtype = cfg.compute_dtype
        hidden = t.hidden_size
        self.word_embeddings = nn.Parameter(torch.empty(t.vocab_size, hidden))
        self.mlm_bias = nn.Parameter(torch.empty(t.vocab_size))
        self.image_embeddings = FlavaImageEmbeddings(cfg)
        self.text_embeddings = TextEmbeddings(t, dtype)

        def vit_layer(analogy=False):
            klass = AnalogyEncoderLayer if analogy else EncoderLayer
            extra = {"row_start": 1} if analogy else {}  # flava:493 rows 1:idx2
            return klass(
                hidden, t.num_heads, t.intermediate_size, hidden_act="gelu",
                layer_norm_eps=cfg.layer_norm_eps, dtype=dtype, pre_norm=True,
                hidden_dropout=t.hidden_dropout, attention_dropout=t.attention_dropout,
                backend=cfg.attention, gelu_impl=cfg.gelu_impl, **attention_options(cfg), **extra)

        for i in range(cfg.image_layers):
            self.add_module(f"image_{i}", vit_layer())
        for i in range(t.num_layers):
            self.add_module(f"text_{i}", vit_layer(analogy=True))
        self.image_to_mm = Dense(hidden, hidden, dtype=dtype)
        self.text_to_mm = Dense(hidden, hidden, dtype=dtype)
        self.mm_cls_token = nn.Parameter(torch.empty(1, 1, hidden))
        for i in range(cfg.multimodal_layers):
            self.add_module(f"mm_{i}", vit_layer())
        self.mm_ln = LayerNorm(hidden, cfg.layer_norm_eps, dtype=dtype)
        self.mlm_transform = MLMTransform(hidden, "gelu", cfg.layer_norm_eps,
                                          dtype=dtype, gelu_impl=cfg.gelu_impl)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random parameters with the Flax initializers' distributions
        (models/common.py:init_flax_defaults; the tables normal(0.02))."""
        init_flax_defaults(self, generator)
        te, ie = self.text_embeddings, self.image_embeddings
        for p, s in ((self.word_embeddings, self.cfg.text.initializer_range),
                     (te.position_embeddings, self.cfg.text.initializer_range),
                     (te.token_type_embeddings, self.cfg.text.initializer_range),
                     (ie.cls_token, 0.02), (ie.position_embeddings, 0.02),
                     (self.mm_cls_token, 0.02)):
            p.normal_(0.0, s, generator=generator)
        self.mlm_bias.zero_()

    def forward(self, input_ids, attention_mask, token_type_ids,
                pixel_values,  # (B, 2, 3, 224, 224)
                positions, boundary=None, visual_attention_mask=None,
                deterministic=True, rng: Optional[DropoutRNG] = None):
        """Transformed hidden states at ``positions`` (B, P, H).
        ``visual_attention_mask`` is unused: FLAVA consumes raw pixels."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        rng = training_rng(deterministic, rng)
        b = input_ids.shape[0]

        img = self.image_embeddings(pixel_values, rng=rng)
        for i in range(cfg.image_layers):
            img = getattr(self, f"image_{i}")(img, rng=rng)

        txt = self.text_embeddings(input_ids, token_type_ids, self.word_embeddings, rng=rng)
        txt_bias = attention_bias(attention_mask, dtype=torch.float32)
        for i in range(cfg.text.num_layers):
            txt = getattr(self, f"text_{i}")(txt, attn_bias=txt_bias, boundary=boundary,
                                             rng=rng)

        # the multimodal tower consumes the PRE-final-layernorm states
        # (modeling_flava.py:1429-1450) and runs without an attention mask
        # (modeling_flava.py:1456), as the reference does
        mm_img = self.image_to_mm(img)
        mm_txt = self.text_to_mm(txt)
        cls = self.mm_cls_token.to(dtype).expand(b, 1, cfg.text.hidden_size)
        mm = torch.cat([cls, mm_img, mm_txt], dim=1)
        n_prefix = 1 + img.shape[1]
        for i in range(cfg.multimodal_layers):
            mm = getattr(self, f"mm_{i}")(mm, rng=rng)
        mm = self.mm_ln(mm)

        text_seq = mm[:, n_prefix:]  # MLM over the text slice (flava:2127-2204)
        return self.mlm_transform(gather_positions(text_seq, positions))

    def logits(self, trans_hidden, vocab_ids=None, vocab_start=None, vocab_end=None):
        return tied_logits(self.word_embeddings, self.mlm_bias, trans_hidden,
                           self.cfg.compute_dtype, vocab_ids=vocab_ids,
                           vocab_start=vocab_start, vocab_end=vocab_end)
