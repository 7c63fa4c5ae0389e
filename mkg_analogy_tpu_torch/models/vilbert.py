"""ViLBERT: two-stream transformer with co-attention connection layers
(``mkg_analogy_tpu/models/vilbert.py``; reference MarT/models/vilbert.py,
M7).

- a text stream (BERT-base, adaptive analogy mask over rows from 1 —
  vilbert.py:421-454) and a region-feature visual stream of its own width
  (``v_hidden_size`` 1024, 8 heads: head_dim 128, which the single-block
  attention kernels take beside 64);
- the interleave schedule follows ``v_biattention_id`` /
  ``t_biattention_id`` (vilbert.py:979-1025): advance each stream to the
  next rendezvous layer, run a ConnectionLayer (bi-directional
  cross-attention + per-stream FFN), repeat; leftover layers run after the
  last rendezvous;
- region features arrive as (B, 72, 2048) + visual_attention_mask
  (data_module.py:129-159). Spatial location features are not taken: the
  Flax model declares ``loc_proj`` in ``setup`` but materialises its
  parameters only when init passes ``image_locs``, which no caller does, so
  its trees have none and this module has none either; passing
  ``image_locs`` raises;
- the cross-attention (``CrossAttention``) is plain PyTorch, as it is a
  plain einsum outside any Pallas kernel in JAX: ``torch.matmul``, softmax
  and dropout;
- MLM over the text stream with the tied decoder.

Parameter names follow the Flax tree (``t_layer_3.layer.attn.query.weight``,
``c_layer_0.img_from_txt.query.weight``), so ``models/convert.py`` maps it
mechanically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

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
    attention_options,
    dropout,
    gather_positions,
    get_activation,
    init_flax_defaults,
    tied_logits,
    training_rng,
)
from .unimo import TextConfig, TextEmbeddings


@dataclass(frozen=True)
class VilBertConfig:
    text: TextConfig = field(default_factory=TextConfig)
    v_hidden_size: int = 1024
    v_num_layers: int = 6
    v_num_heads: int = 8
    v_intermediate_size: int = 1024
    v_feature_size: int = 2048
    bi_hidden_size: int = 1024
    bi_num_heads: int = 8
    v_biattention_id: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    t_biattention_id: Tuple[int, ...] = (6, 7, 8, 9, 10, 11)
    layer_norm_eps: float = 1e-12
    dtype: str = "bfloat16"
    # DIAGNOSTIC (not reference behavior), as in the JAX package: drop the
    # image->text co-attention context of every connection layer
    ablate_img_to_txt: bool = False
    attention: str = "single"  # attention backend (models/common.py:AttentionCore)
    gelu_impl: str = "poly"    # gelu under non-fp32 compute (fp32: exact erf)
    # AttentionCore switches (models/common.py), default off: the plain
    # route's bf16 dq/dk backward, one fused Q/K/V projection
    qk_bf16_grad: bool = False
    fused_qkv: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return to_dtype(self.dtype)


class CrossAttention(nn.Module):
    """Queries from one stream over keys/values of the other, through a
    shared ``bi_hidden`` width (BertBiAttention halves, vilbert.py:715-860):
    plain PyTorch, fp32 scores and softmax, the probabilities in the compute
    dtype before their dropout and the product with V."""

    def __init__(self, q_dim: int, kv_dim: int, num_heads: int, bi_hidden: int,
                 out_dim: int, dtype: torch.dtype = torch.float32, dropout_rate: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.bi_hidden = bi_hidden
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.query = Dense(q_dim, bi_hidden, dtype=dtype)
        self.key = Dense(kv_dim, bi_hidden, dtype=dtype)
        self.value = Dense(kv_dim, bi_hidden, dtype=dtype)
        self.out = Dense(bi_hidden, out_dim, dtype=dtype)

    def forward(self, q_states, kv_states, kv_bias=None, rng: Optional[DropoutRNG] = None):
        head_dim = self.bi_hidden // self.num_heads
        b, lq, _ = q_states.shape
        lk = kv_states.shape[1]

        def split(x, length):
            return x.reshape(b, length, self.num_heads, head_dim).transpose(1, 2)

        q = split(self.query(q_states), lq)
        k = split(self.key(kv_states), lk)
        v = split(self.value(kv_states), lk)
        # products of compute-dtype operands summed in fp32
        # (preferred_element_type=float32), then the scale
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * float(head_dim) ** -0.5
        if kv_bias is not None:
            scores = scores + kv_bias.to(scores.dtype)
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        if rng is not None and self.dropout_rate > 0.0:
            probs = dropout(probs, self.dropout_rate, rng)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, lq, self.bi_hidden)
        return self.out(ctx)


class ConnectionLayer(nn.Module):
    """Bi-attention exchange + per-stream FFN (BertConnectionLayer,
    vilbert.py:876-950)."""

    def __init__(self, cfg: VilBertConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        dtype = cfg.compute_dtype
        eps = cfg.layer_norm_eps
        # image queries attend text; text queries attend image
        self.img_from_txt = CrossAttention(cfg.v_hidden_size, t.hidden_size, cfg.bi_num_heads,
                                           cfg.bi_hidden_size, cfg.v_hidden_size, dtype=dtype)
        self.txt_from_img = CrossAttention(t.hidden_size, cfg.v_hidden_size, cfg.bi_num_heads,
                                           cfg.bi_hidden_size, t.hidden_size, dtype=dtype)
        self.img_ln = LayerNorm(cfg.v_hidden_size, eps, dtype=dtype)
        self.txt_ln = LayerNorm(t.hidden_size, eps, dtype=dtype)
        self.img_ffn_fc1 = Dense(cfg.v_hidden_size, cfg.v_intermediate_size, dtype=dtype)
        self.img_ffn_fc2 = Dense(cfg.v_intermediate_size, cfg.v_hidden_size, dtype=dtype)
        self.img_ffn_ln = LayerNorm(cfg.v_hidden_size, eps, dtype=dtype)
        self.txt_ffn_fc1 = Dense(t.hidden_size, t.intermediate_size, dtype=dtype)
        self.txt_ffn_fc2 = Dense(t.intermediate_size, t.hidden_size, dtype=dtype)
        self.txt_ffn_ln = LayerNorm(t.hidden_size, eps, dtype=dtype)
        self.act = get_activation("gelu", cfg.gelu_impl)

    def _drop(self, h, rng):
        rate = self.cfg.text.hidden_dropout
        if rng is not None and rate > 0.0:
            return dropout(h, rate, rng)
        return h

    def forward(self, img, txt, img_bias, txt_bias, rng: Optional[DropoutRNG] = None):
        img_ctx = self.img_from_txt(img, txt, kv_bias=txt_bias, rng=rng)
        txt_ctx = self.txt_from_img(txt, img, kv_bias=img_bias, rng=rng)
        if self.cfg.ablate_img_to_txt:
            txt_ctx = torch.zeros_like(txt_ctx)
        img = self.img_ln(img + self._drop(img_ctx, rng))
        txt = self.txt_ln(txt + self._drop(txt_ctx, rng))
        h = self.img_ffn_fc2(self.act(self.img_ffn_fc1(img)))
        img = self.img_ffn_ln(img + self._drop(h, rng))
        h = self.txt_ffn_fc2(self.act(self.txt_ffn_fc1(txt)))
        txt = self.txt_ffn_ln(txt + self._drop(h, rng))
        return img, txt


class VilBertForMaskedLM(nn.Module):
    def __init__(self, cfg: VilBertConfig):
        super().__init__()
        self.cfg = cfg
        t = cfg.text
        dtype = cfg.compute_dtype
        eps = cfg.layer_norm_eps
        self.word_embeddings = nn.Parameter(torch.empty(t.vocab_size, t.hidden_size))
        self.mlm_bias = nn.Parameter(torch.empty(t.vocab_size))
        self.text_embeddings = TextEmbeddings(t, dtype)
        self.image_proj = Dense(cfg.v_feature_size, cfg.v_hidden_size, dtype=dtype)
        self.image_ln = LayerNorm(cfg.v_hidden_size, eps, dtype=dtype)
        for i in range(t.num_layers):
            self.add_module(f"t_layer_{i}", AnalogyEncoderLayer(
                t.hidden_size, t.num_heads, t.intermediate_size, hidden_act=t.hidden_act,
                layer_norm_eps=eps, dtype=dtype, hidden_dropout=t.hidden_dropout,
                attention_dropout=t.attention_dropout, backend=cfg.attention,
                gelu_impl=cfg.gelu_impl, **attention_options(cfg),
                row_start=1))  # vilbert.py:452 scales rows 1:idx2
        for i in range(cfg.v_num_layers):
            self.add_module(f"v_layer_{i}", EncoderLayer(
                cfg.v_hidden_size, cfg.v_num_heads, cfg.v_intermediate_size,
                hidden_act="gelu", layer_norm_eps=eps, dtype=dtype,
                hidden_dropout=t.hidden_dropout, attention_dropout=t.attention_dropout,
                backend=cfg.attention, gelu_impl=cfg.gelu_impl, **attention_options(cfg)))
        for i in range(len(cfg.v_biattention_id)):
            self.add_module(f"c_layer_{i}", ConnectionLayer(cfg))
        self.mlm_transform = MLMTransform(t.hidden_size, t.hidden_act, eps, dtype=dtype,
                                          gelu_impl=cfg.gelu_impl)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Random parameters with the Flax initializers' distributions
        (models/common.py:init_flax_defaults; the tables normal(0.02))."""
        init_flax_defaults(self, generator)
        te = self.text_embeddings
        for p in (self.word_embeddings, te.position_embeddings, te.token_type_embeddings):
            p.normal_(0.0, self.cfg.text.initializer_range, generator=generator)
        self.mlm_bias.zero_()

    def forward(self, input_ids, attention_mask, token_type_ids,
                pixel_values,  # (B, 72, 2048) region features
                positions, boundary=None, visual_attention_mask=None,
                image_locs: Optional[torch.Tensor] = None,
                deterministic=True, rng: Optional[DropoutRNG] = None):
        """Transformed hidden states of the text stream at ``positions``
        (B, P, H)."""
        if image_locs is not None:
            raise ValueError(
                "image_locs: the model has no loc_proj parameters (the Flax trees "
                "never materialise them; region boxes are not part of the "
                "framework's region stores)")
        cfg = self.cfg
        rng = training_rng(deterministic, rng)
        txt = self.text_embeddings(input_ids, token_type_ids, self.word_embeddings, rng=rng)
        img = self.image_ln(self.image_proj(pixel_values.to(cfg.compute_dtype)))
        if visual_attention_mask is None:
            visual_attention_mask = attention_mask.new_ones(pixel_values.shape[:2])
        txt_bias = attention_bias(attention_mask, dtype=torch.float32)
        img_bias = attention_bias(visual_attention_mask, dtype=torch.float32)

        def t_layer(idx, x):
            return getattr(self, f"t_layer_{idx}")(x, attn_bias=txt_bias, boundary=boundary,
                                                   rng=rng)

        def v_layer(idx, x):
            return getattr(self, f"v_layer_{idx}")(x, attn_bias=img_bias, rng=rng)

        t_start, v_start = 0, 0
        for count, (v_id, t_id) in enumerate(zip(cfg.v_biattention_id, cfg.t_biattention_id)):
            for idx in range(t_start, t_id):
                txt = t_layer(idx, txt)
            for idx in range(v_start, v_id):
                img = v_layer(idx, img)
            img, txt = getattr(self, f"c_layer_{count}")(img, txt, img_bias, txt_bias, rng=rng)
            t_start, v_start = t_id, v_id
        for idx in range(v_start, cfg.v_num_layers):
            img = v_layer(idx, img)
        for idx in range(t_start, cfg.text.num_layers):
            txt = t_layer(idx, txt)
        return self.mlm_transform(gather_positions(txt, positions))

    def logits(self, trans_hidden, vocab_ids=None, vocab_start=None, vocab_end=None):
        return tied_logits(self.word_embeddings, self.mlm_bias, trans_hidden,
                           self.cfg.compute_dtype, vocab_ids=vocab_ids,
                           vocab_start=vocab_start, vocab_end=vocab_end)
