"""ViLT: single-stream pre-LN transformer over [text ; patches of 2 images]
(``mkg_analogy_tpu/models/vilt.py``; reference MarT/models/modeling_vilt.py,
M8).

- both 384x384 images are patch-embedded (32x32 -> 144 patches + CLS each)
  and concatenated after the text (modeling_vilt.py:216-224, 240);
- modality type embeddings (0=text, 1=image) are added on top of the text's
  segment token-types (modeling_vilt.py:232-236);
- the reference's multinomial patch sampling with interpolated positions
  (modeling_vilt.py:112-196) exists to bound dynamic sequence lengths; with
  fixed-size square inputs every patch is valid, so all 145 tokens per image
  are kept: static shapes, no sampling;
- adaptive analogy mask on text->text attention in true text coordinates,
  rows from 1 (the reference shifts sep_idx by the image length although
  images FOLLOW the text, modeling_vilt.py:843-844 + 370-375; see
  ops/masks); ``compat_ref_mask_offset=True`` reproduces the reference
  geometry;
- embedding dropout on the image tokens after position add
  (modeling_vilt.py:189-192).

The sequence is L + 2 * 145 tokens, 418 at L=128: within the single-block
attention kernel's shared memory in bf16, not in fp32, where the flash
kernels (``attention="flash"``) take it.

Parameter names follow the Flax tree (``layer_3.layer.attn.query.weight``
for ``layer_3/layer/attn/query/kernel``), so ``models/convert.py`` maps it
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
    DropoutRNG,
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
class ViltConfig:
    text: TextConfig = field(default_factory=TextConfig)
    image_size: int = 384
    patch_size: int = 32
    num_images: int = 2
    layer_norm_eps: float = 1e-12
    dtype: str = "bfloat16"
    # opt-in reference quirk: apply the adaptive mask with sep_idx shifted
    # by the image length (modeling_vilt.py:843-844)
    compat_ref_mask_offset: bool = False
    attention: str = "single"  # attention backend (models/common.py:AttentionCore)
    gelu_impl: str = "poly"    # gelu under non-fp32 compute (fp32: exact erf)
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
    def tokens_per_image(self) -> int:
        return self.patches_per_image + 1  # + per-image CLS


class ViltImageEmbeddings(nn.Module):
    def __init__(self, cfg: ViltConfig):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.text.hidden_size
        self.patch_embedding = PatchEmbed(3, hidden, cfg.patch_size,
                                          dtype=cfg.compute_dtype, use_bias=True)
        self.cls_token = nn.Parameter(torch.empty(1, 1, hidden))
        self.position_embeddings = nn.Parameter(torch.empty(cfg.tokens_per_image, hidden))

    def forward(self, pixel_values, rng: Optional[DropoutRNG] = None):
        cfg = self.cfg
        dtype = cfg.compute_dtype
        hidden = cfg.text.hidden_size
        b, n_img = pixel_values.shape[0], cfg.num_images
        x = pixel_values.reshape(b * n_img, 3, cfg.image_size, cfg.image_size)
        patches = self.patch_embedding(x)  # (B*N, patches, H)
        cls = self.cls_token.to(dtype).expand(b * n_img, 1, hidden)
        tokens = torch.cat([cls, patches], dim=1)  # (B*N, 145, H)
        tokens = tokens + self.position_embeddings[None].to(dtype)
        # embedding dropout on the image path (modeling_vilt.py:189-192)
        if rng is not None and cfg.text.hidden_dropout > 0.0:
            tokens = dropout(tokens, cfg.text.hidden_dropout, rng)
        return tokens.reshape(b, n_img * cfg.tokens_per_image, hidden)


class ViltForMaskedLM(nn.Module):
    def __init__(self, cfg: ViltConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        dtype = cfg.compute_dtype
        self.word_embeddings = nn.Parameter(torch.empty(t.vocab_size, t.hidden_size))
        self.mlm_bias = nn.Parameter(torch.empty(t.vocab_size))
        self.text_embeddings = TextEmbeddings(t, dtype)
        self.image_embeddings = ViltImageEmbeddings(cfg)
        # modality type embeddings: 0 = text, 1 = image (vilt parity)
        self.modal_type_embeddings = nn.Parameter(torch.empty(2, t.hidden_size))
        for i in range(t.num_layers):
            self.add_module(f"layer_{i}", AnalogyEncoderLayer(
                t.hidden_size, t.num_heads, t.intermediate_size, hidden_act="gelu",
                layer_norm_eps=cfg.layer_norm_eps, dtype=dtype, pre_norm=True,
                hidden_dropout=t.hidden_dropout, attention_dropout=t.attention_dropout,
                backend=cfg.attention, gelu_impl=cfg.gelu_impl, **attention_options(cfg),
                # corrected default: text coordinates, rows from 1 (the
                # reference's img_length+1 slice start, modeling_vilt.py:371)
                row_start=1,
                compat_img_offset=(cfg.num_images * cfg.tokens_per_image
                                   if cfg.compat_ref_mask_offset else None)))
        self.final_ln = LayerNorm(t.hidden_size, cfg.layer_norm_eps, dtype=dtype)
        self.mlm_transform = MLMTransform(t.hidden_size, "gelu", cfg.layer_norm_eps,
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
                     (self.modal_type_embeddings, 0.02)):
            p.normal_(0.0, s, generator=generator)
        self.mlm_bias.zero_()

    def forward(self, input_ids, attention_mask, token_type_ids,
                pixel_values,  # (B, 2, 3, 384, 384)
                positions, boundary=None, visual_attention_mask=None,
                deterministic=True, rng: Optional[DropoutRNG] = None):
        """Transformed hidden states at ``positions`` (B, P, H).
        ``visual_attention_mask`` is unused: ViLT consumes raw pixels."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        rng = training_rng(deterministic, rng)
        length = input_ids.shape[1]
        txt = self.text_embeddings(input_ids, token_type_ids, self.word_embeddings, rng=rng)
        txt = txt + self.modal_type_embeddings[0].to(dtype)
        img = self.image_embeddings(pixel_values, rng=rng)
        img = img + self.modal_type_embeddings[1].to(dtype)
        x = torch.cat([txt, img], dim=1)
        img_mask = attention_mask.new_ones(img.shape[:2])
        bias = attention_bias(torch.cat([attention_mask, img_mask], dim=1),
                              dtype=torch.float32)
        for i in range(cfg.text.num_layers):
            x = getattr(self, f"layer_{i}")(x, attn_bias=bias, boundary=boundary,
                                            text_len=length, rng=rng)
        x = self.final_ln(x)
        text_seq = x[:, :length]  # MLM over the text slice (modeling_vilt.py:949-952)
        return self.mlm_transform(gather_positions(text_seq, positions))

    def logits(self, trans_hidden, vocab_ids=None, vocab_start=None, vocab_end=None):
        return tied_logits(self.word_embeddings, self.mlm_bias, trans_hidden,
                           self.cfg.compute_dtype, vocab_ids=vocab_ids,
                           vocab_start=vocab_start, vocab_end=vocab_end)
