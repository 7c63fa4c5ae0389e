"""VisualBERT: single-stream BERT over [text ; 72 x 2048 detector region
features] (``mkg_analogy_tpu/models/visualbert.py``; reference
MarT/models/modeling_visual_bert.py, M6).

- the sequence is [text(0..L) ; visual(L..L+72)]
  (modeling_visual_bert.py:196), 200 tokens at L=128;
- reference-exact embeddings (modeling_visual_bert.py:72-201): text = word
  + token-type + position; visual = projection(features) + visual-position
  row 0 (every region shares position id 0) + visual-token-type row 1; one
  shared LayerNorm + dropout over the concatenated sequence;
- the adaptive analogy mask scales text->text attention in true text
  coordinates, rows from 1; ``compat_ref_mask_offset=True`` reproduces the
  reference geometry, its slice bounds shifted by the 72 regions
  (modeling_visual_bert.py:255-260, 864-866; see ops/masks).

Every layer's attention goes through the backend of ``attention``
(models/common.py:AttentionCore), head_dim 64.

Parameter names follow the Flax tree (``layer_3.layer.attn.query.weight``,
``embeddings.visual_projection.weight``), so ``models/convert.py`` maps it
mechanically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from ..core.precision import to_dtype
from ..ops.masks import attention_bias
from ..parallel.collectives import gather_rows
from .common import (
    AnalogyEncoderLayer,
    Dense,
    DropoutRNG,
    LayerNorm,
    MLMTransform,
    attention_options,
    dropout,
    gather_positions,
    init_flax_defaults,
    tied_logits,
    training_rng,
)
from .unimo import TextConfig


@dataclass(frozen=True)
class VisualBertConfig:
    text: TextConfig = field(default_factory=TextConfig)
    visual_embedding_dim: int = 2048
    num_regions: int = 72
    dtype: str = "bfloat16"
    # opt-in reference quirk: apply the adaptive mask with sep_idx shifted
    # by the image length (modeling_visual_bert.py:864-866)
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


class VisualBertEmbeddings(nn.Module):
    """Reference-exact joint embedding (modeling_visual_bert.py:72-201):
    all regions share visual-position row 0 and visual-token-type row 1,
    and one LayerNorm covers the concatenated sequence."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        self.position_embeddings = nn.Parameter(
            torch.empty(t.max_position_embeddings, t.hidden_size))
        self.token_type_embeddings = nn.Parameter(torch.empty(t.type_vocab_size, t.hidden_size))
        self.visual_position_embeddings = nn.Parameter(
            torch.empty(t.max_position_embeddings, t.hidden_size))
        self.visual_token_type_embeddings = nn.Parameter(
            torch.empty(t.type_vocab_size, t.hidden_size))
        self.visual_projection = Dense(cfg.visual_embedding_dim, t.hidden_size,
                                       dtype=cfg.compute_dtype)
        self.ln = LayerNorm(t.hidden_size, t.layer_norm_eps, dtype=cfg.compute_dtype)

    def forward(self, input_ids, token_type_ids, visual_feats, word_table,
                rng: Optional[DropoutRNG] = None):
        t = self.cfg.text
        dtype = self.cfg.compute_dtype
        length = input_ids.shape[1]
        txt = (gather_rows(word_table, input_ids).to(dtype)
               + self.token_type_embeddings[token_type_ids.long()].to(dtype)
               + self.position_embeddings[:length][None].to(dtype))
        vis = self.visual_projection(visual_feats.to(dtype))
        # every region gets position id 0 and token-type id 1
        # (modeling_visual_bert.py:188-195)
        vis = (vis + self.visual_position_embeddings[0].to(dtype)
               + self.visual_token_type_embeddings[1].to(dtype))
        x = self.ln(torch.cat([txt, vis], dim=1))
        if rng is not None and t.hidden_dropout > 0.0:
            x = dropout(x, t.hidden_dropout, rng)
        return x


class VisualBertForMaskedLM(nn.Module):
    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        dtype = cfg.compute_dtype
        self.word_embeddings = nn.Parameter(torch.empty(t.vocab_size, t.hidden_size))
        self.mlm_bias = nn.Parameter(torch.empty(t.vocab_size))
        self.embeddings = VisualBertEmbeddings(cfg)
        for i in range(t.num_layers):
            self.add_module(f"layer_{i}", AnalogyEncoderLayer(
                t.hidden_size, t.num_heads, t.intermediate_size, hidden_act=t.hidden_act,
                layer_norm_eps=t.layer_norm_eps, dtype=dtype,
                hidden_dropout=t.hidden_dropout, attention_dropout=t.attention_dropout,
                backend=cfg.attention, gelu_impl=cfg.gelu_impl, **attention_options(cfg),
                # corrected default: true text coordinates, rows from 1 (the
                # reference's img_length+1 slice start); the compat flag
                # reproduces the shifted reference geometry instead
                row_start=1,
                compat_img_offset=cfg.num_regions if cfg.compat_ref_mask_offset else None))
        self.mlm_transform = MLMTransform(t.hidden_size, t.hidden_act, t.layer_norm_eps,
                                          dtype=dtype, gelu_impl=cfg.gelu_impl)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random parameters with the Flax initializers' distributions
        (models/common.py:init_flax_defaults; the tables normal(0.02))."""
        init_flax_defaults(self, generator)
        e = self.embeddings
        for p in (self.word_embeddings, e.position_embeddings, e.token_type_embeddings,
                  e.visual_position_embeddings, e.visual_token_type_embeddings):
            p.normal_(0.0, self.cfg.text.initializer_range, generator=generator)
        self.mlm_bias.zero_()

    def forward(self, input_ids, attention_mask, token_type_ids,
                pixel_values,  # (B, 72, 2048) region features
                positions, boundary=None, visual_attention_mask=None,
                deterministic=True, rng: Optional[DropoutRNG] = None):
        """Transformed hidden states at ``positions`` (B, P, H)."""
        rng = training_rng(deterministic, rng)
        length = input_ids.shape[1]
        x = self.embeddings(input_ids, token_type_ids, pixel_values, self.word_embeddings,
                            rng=rng)
        if visual_attention_mask is None:
            visual_attention_mask = attention_mask.new_ones(pixel_values.shape[:2])
        full_mask = torch.cat([attention_mask, visual_attention_mask.to(attention_mask.dtype)],
                              dim=1)
        bias = attention_bias(full_mask, dtype=torch.float32)
        for i in range(self.cfg.text.num_layers):
            x = getattr(self, f"layer_{i}")(x, attn_bias=bias, boundary=boundary,
                                            text_len=length, rng=rng)
        return self.mlm_transform(gather_positions(x[:, :length], positions))

    def logits(self, trans_hidden, vocab_ids=None, vocab_start=None, vocab_end=None):
        return tied_logits(self.word_embeddings, self.mlm_bias, trans_hidden,
                           self.cfg.compute_dtype, vocab_ids=vocab_ids,
                           vocab_start=vocab_start, vocab_end=vocab_end)
