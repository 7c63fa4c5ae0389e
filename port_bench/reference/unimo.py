"""Plain fp32 MKGformer (UniMo): a CLIP-ViT vision tower and a BERT text
tower run in lockstep (MarT ``models/modeling_unimo.py``).

- vision: two images patch-embedded after one CLS, position rows
  [pos ; pos[1:]], a pre-LN before the layers; pre-LN CLIP layers with
  quick_gelu; from ``fusion_start`` each vision layer attends over [the
  previous text layer's K/V ; its own tokens], the padded text keys masked;
- text: word + position + type embeddings, LayerNorm, dropout; post-LN BERT
  layers whose self-attention scores carry the adaptive analogy multiplier
  (rows from 0, the whole text); from ``fusion_start`` the FFN input adds
  ``fusion_dense`` of a softmax cross-attention of the layer's raw attention
  context over the current vision states; hidden dropout after the
  attention's out projection and after the FFN;
- head: the MLM transform at the five gathered positions [mask, rel_ex,
  rel_q, q_head, a_head] and the tied decoder over the analogy entities.

``param_shapes`` lists the leaves, named as the flat dict the benchmark hands
to both sides.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .layers import (
    AttentionCall, DropoutDraws, Numerics, analogy_multiplier, dropout, gather_positions,
    gelu, layer_norm, mlm_transform, quick_gelu, text_embeddings, tied_logits)


def param_shapes(cfg) -> Dict[str, tuple]:
    h, inner, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    patch, size = cfg["patch_size"], cfg["image_size"]
    shapes = {
        "word_embeddings": (v, h), "mlm_bias": (v,),
        "vision_embeddings.class_embedding": (h,),
        "vision_embeddings.position_embedding": ((size // patch) ** 2 + 1, h),
        "vision_embeddings.patch_embedding.weight": (h, 3, patch, patch),
        "vision_pre_ln.weight": (h,), "vision_pre_ln.bias": (h,),
        "text_embeddings.position_embeddings": (cfg["max_position_embeddings"], h),
        "text_embeddings.token_type_embeddings": (2, h),
        "text_embeddings.ln.weight": (h,), "text_embeddings.ln.bias": (h,),
    }

    def attn(prefix):
        for n in ("query", "key", "value", "out"):
            shapes[f"{prefix}.{n}.weight"] = (h, h)
            shapes[f"{prefix}.{n}.bias"] = (h,)

    for i in range(cfg["num_layers"]):
        vp, tp = f"encoder.vision_{i}", f"encoder.text_{i}"
        shapes[f"{vp}.ln1.weight"] = shapes[f"{vp}.ln1.bias"] = (h,)
        attn(f"{vp}.attn")
        shapes[f"{vp}.ln2.weight"] = shapes[f"{vp}.ln2.bias"] = (h,)
        shapes[f"{vp}.fc1.weight"], shapes[f"{vp}.fc1.bias"] = (inner, h), (inner,)
        shapes[f"{vp}.fc2.weight"], shapes[f"{vp}.fc2.bias"] = (h, inner), (h,)
        shapes[f"{tp}.adaptive_w0"] = shapes[f"{tp}.adaptive_w1"] = (1,)
        attn(f"{tp}.attn")
        shapes[f"{tp}.attn_ln.weight"] = shapes[f"{tp}.attn_ln.bias"] = (h,)
        shapes[f"{tp}.intermediate.weight"] = (inner, h)
        shapes[f"{tp}.intermediate.bias"] = (inner,)
        if i >= cfg["fusion_start"]:
            shapes[f"{tp}.fusion_dense.weight"] = (inner, h)
            shapes[f"{tp}.fusion_dense.bias"] = (inner,)
        shapes[f"{tp}.output.weight"], shapes[f"{tp}.output.bias"] = (h, inner), (h,)
        shapes[f"{tp}.out_ln.weight"] = shapes[f"{tp}.out_ln.bias"] = (h,)
    shapes["mlm_transform.dense.weight"] = (h, h)
    shapes["mlm_transform.dense.bias"] = (h,)
    shapes["mlm_transform.ln.weight"] = shapes["mlm_transform.ln.bias"] = (h,)
    return shapes


def _vision_embeddings(num: Numerics, p, cfg, pixels):
    b, h = pixels.shape[0], cfg["hidden_size"]
    size, patch, n_img = cfg["image_size"], cfg["patch_size"], cfg["num_images"]
    x = pixels.reshape(b * n_img, 3, size, size)
    patches = num.conv_patches(x, p["vision_embeddings.patch_embedding.weight"], None, patch)
    patches = patches.reshape(b, -1, h)
    cls = p["vision_embeddings.class_embedding"].expand(b, 1, h)
    table = p["vision_embeddings.position_embedding"]
    pos = torch.cat([table] + [table[1:]] * (n_img - 1), dim=0)
    return torch.cat([cls, patches], dim=1) + pos[None]


def _linear(num, p, name, x):
    return num.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def encode(params, cfg, batch, pixels, draws: Optional[DropoutDraws] = None,
           num: Optional[Numerics] = None):
    """The text tower's last hidden states (B, L, H)."""
    num = num or Numerics()
    p, heads, route = params, cfg["num_heads"], cfg["attention"]
    eps_t, eps_v = cfg["text_layer_norm_eps"], cfg["vision_layer_norm_eps"]
    h_drop, a_drop = cfg["hidden_dropout"], cfg["attention_dropout"]
    vis = layer_norm(_vision_embeddings(num, p, cfg, pixels),
                     p["vision_pre_ln.weight"], p["vision_pre_ln.bias"], eps_v)
    txt = text_embeddings(p, batch["input_ids"], batch["token_type_ids"], eps_t, h_drop, draws)
    mask = batch["attention_mask"].to(torch.float32)
    b, n = txt.shape[:2]
    vis_mask = torch.ones(b, vis.shape[1], device=txt.device)
    boundary = batch["sep_idx"][:, 2]
    prev_kv = None
    for i in range(cfg["num_layers"]):
        vp, tp = f"encoder.vision_{i}", f"encoder.text_{i}"
        fused = i >= cfg["fusion_start"]
        # vision layer: pre-LN, no dropout
        attn_v = AttentionCall(num, p, f"{vp}.attn", heads, route, 0.0)
        hv, _, _ = attn_v(layer_norm(vis, p[f"{vp}.ln1.weight"], p[f"{vp}.ln1.bias"], eps_v),
                          vis_mask, extra_kv=prev_kv if fused else None,
                          extra_mask=mask if fused else None)
        vis = vis + hv
        ff = layer_norm(vis, p[f"{vp}.ln2.weight"], p[f"{vp}.ln2.bias"], eps_v)
        vis = vis + _linear(num, p, f"{vp}.fc2", quick_gelu(_linear(num, p, f"{vp}.fc1", ff)))
        # text layer: post-LN with the analogy multiplier
        mult = analogy_multiplier(boundary, p[f"{tp}.adaptive_w0"], p[f"{tp}.adaptive_w1"],
                                  n, n, 0, n)
        attn_t = AttentionCall(num, p, f"{tp}.attn", heads, route, a_drop)
        out, prev_kv, ctx = attn_t(txt, mask, draws, mult=mult,
                                   want_kv=i >= cfg["fusion_start"] - 1)
        out = dropout(out, h_drop, draws)
        attn_out = layer_norm(out + txt, p[f"{tp}.attn_ln.weight"], p[f"{tp}.attn_ln.bias"], eps_t)
        hid = _linear(num, p, f"{tp}.intermediate", attn_out)
        if fused:
            probs = torch.softmax(num.mm(ctx, vis.transpose(1, 2)), dim=-1)
            hid = hid + _linear(num, p, f"{tp}.fusion_dense", num.mm(probs, vis))
        hid = dropout(_linear(num, p, f"{tp}.output", gelu(hid)), h_drop, draws)
        txt = layer_norm(hid + attn_out, p[f"{tp}.out_ln.weight"], p[f"{tp}.out_ln.bias"], eps_t)
    return txt


def forward(params, cfg, batch, pixels, positions, draws=None, num=None):
    """The MLM transform of the states at ``positions`` (B, P, H)."""
    num = num or Numerics()
    seq = encode(params, cfg, batch, pixels, draws, num)
    return mlm_transform(num, params, gather_positions(seq, positions), cfg["text_layer_norm_eps"])


def logits(params, hidden, vocab_ids, num=None):
    return tied_logits(num or Numerics(), params, hidden, vocab_ids)
