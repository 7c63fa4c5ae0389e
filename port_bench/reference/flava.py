"""Plain fp32 FLAVA for MarT (``models/modeling_flava.py``): an image tower,
a text tower and a multimodal tower, all pre-LN ViT layers with exact gelu.

- image: two images patch-embedded (conv with bias) after one CLS, positions
  [pos ; pos[:P]] (the tail image reuses the table's head, CLS row
  included), dropout; ``image_layers`` layers without a mask;
- text: word + position + type embeddings, LayerNorm, dropout; layers whose
  scores carry the adaptive analogy multiplier with rows from 1 (the CLS row
  skipped), the padded keys masked;
- multimodal: [its CLS ; image_to_mm(image states) ; text_to_mm(text
  states)] of the towers' states before any final LayerNorm, unmasked,
  ``multimodal_layers`` layers, a LayerNorm; the MLM head reads the text
  slice. Every layer drops after its attention and its FFN and inside its
  attention.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .layers import (
    AttentionCall, DropoutDraws, Numerics, analogy_multiplier, dropout, gather_positions,
    gelu, layer_norm, mlm_transform, text_embeddings, tied_logits)


def param_shapes(cfg) -> Dict[str, tuple]:
    h, inner, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    patch, size = cfg["patch_size"], cfg["image_size"]
    shapes = {
        "word_embeddings": (v, h), "mlm_bias": (v,), "mm_cls_token": (1, 1, h),
        "image_embeddings.cls_token": (1, 1, h),
        "image_embeddings.position_embeddings": ((size // patch) ** 2 + 1, h),
        "image_embeddings.patch_embedding.weight": (h, 3, patch, patch),
        "image_embeddings.patch_embedding.bias": (h,),
        "text_embeddings.position_embeddings": (cfg["max_position_embeddings"], h),
        "text_embeddings.token_type_embeddings": (2, h),
        "text_embeddings.ln.weight": (h,), "text_embeddings.ln.bias": (h,),
    }

    def layer(prefix):
        for n in ("query", "key", "value", "out"):
            shapes[f"{prefix}.attn.{n}.weight"] = (h, h)
            shapes[f"{prefix}.attn.{n}.bias"] = (h,)
        for n in ("ln1", "ln2"):
            shapes[f"{prefix}.{n}.weight"] = shapes[f"{prefix}.{n}.bias"] = (h,)
        shapes[f"{prefix}.fc1.weight"], shapes[f"{prefix}.fc1.bias"] = (inner, h), (inner,)
        shapes[f"{prefix}.fc2.weight"], shapes[f"{prefix}.fc2.bias"] = (h, inner), (h,)

    for i in range(cfg["image_layers"]):
        layer(f"image_{i}")
    for i in range(cfg["num_layers"]):
        shapes[f"text_{i}.adaptive_w0"] = shapes[f"text_{i}.adaptive_w1"] = (1,)
        layer(f"text_{i}.layer")
    for n in ("image_to_mm", "text_to_mm"):
        shapes[f"{n}.weight"], shapes[f"{n}.bias"] = (h, h), (h,)
    for i in range(cfg["multimodal_layers"]):
        layer(f"mm_{i}")
    shapes["mm_ln.weight"] = shapes["mm_ln.bias"] = (h,)
    shapes["mlm_transform.dense.weight"] = (h, h)
    shapes["mlm_transform.dense.bias"] = (h,)
    shapes["mlm_transform.ln.weight"] = shapes["mlm_transform.ln.bias"] = (h,)
    return shapes


def _vit_layer(num, p, prefix, x, mask, cfg, draws, mult=None):
    eps, h_drop = cfg["layer_norm_eps"], cfg["hidden_dropout"]
    attn = AttentionCall(num, p, f"{prefix}.attn", cfg["num_heads"], cfg["attention"],
                         cfg["attention_dropout"])
    h, _, _ = attn(layer_norm(x, p[f"{prefix}.ln1.weight"], p[f"{prefix}.ln1.bias"], eps),
                   mask, draws, mult=mult)
    x = x + dropout(h, h_drop, draws)
    ff = layer_norm(x, p[f"{prefix}.ln2.weight"], p[f"{prefix}.ln2.bias"], eps)
    h = num.linear(gelu(num.linear(ff, p[f"{prefix}.fc1.weight"], p[f"{prefix}.fc1.bias"])),
                   p[f"{prefix}.fc2.weight"], p[f"{prefix}.fc2.bias"])
    return x + dropout(h, h_drop, draws)


def forward(params, cfg, batch, pixels, positions, draws: Optional[DropoutDraws] = None,
            num: Optional[Numerics] = None):
    """The MLM transform of the text slice's states at ``positions``."""
    num = num or Numerics()
    p, h = params, cfg["hidden_size"]
    size, patch = cfg["image_size"], cfg["patch_size"]
    b = pixels.shape[0]
    n_patch = (size // patch) ** 2
    x = pixels.reshape(b * 2, 3, size, size)
    patches = num.conv_patches(x, p["image_embeddings.patch_embedding.weight"],
                               p["image_embeddings.patch_embedding.bias"], patch)
    img = torch.cat([p["image_embeddings.cls_token"].expand(b, 1, h),
                     patches.reshape(b, 2 * n_patch, h)], dim=1)
    pos = p["image_embeddings.position_embeddings"]
    img = dropout(img + torch.cat([pos, pos[:n_patch]], dim=0)[None], cfg["hidden_dropout"],
                  draws)
    ones_img = torch.ones(b, img.shape[1], device=img.device)
    for i in range(cfg["image_layers"]):
        img = _vit_layer(num, p, f"image_{i}", img, ones_img, cfg, draws)

    txt = text_embeddings(p, batch["input_ids"], batch["token_type_ids"],
                          cfg["text_layer_norm_eps"], cfg["hidden_dropout"], draws)
    n = txt.shape[1]
    mask = batch["attention_mask"].to(torch.float32)
    boundary = batch["sep_idx"][:, 2]
    for i in range(cfg["num_layers"]):
        mult = analogy_multiplier(boundary, p[f"text_{i}.adaptive_w0"], p[f"text_{i}.adaptive_w1"],
                                  n, n, 1, n)
        txt = _vit_layer(num, p, f"text_{i}.layer", txt, mask, cfg, draws, mult=mult)

    mm = torch.cat([p["mm_cls_token"].expand(b, 1, h),
                    num.linear(img, p["image_to_mm.weight"], p["image_to_mm.bias"]),
                    num.linear(txt, p["text_to_mm.weight"], p["text_to_mm.bias"])], dim=1)
    ones_mm = torch.ones(b, mm.shape[1], device=mm.device)
    for i in range(cfg["multimodal_layers"]):
        mm = _vit_layer(num, p, f"mm_{i}", mm, ones_mm, cfg, draws)
    mm = layer_norm(mm, p["mm_ln.weight"], p["mm_ln.bias"], cfg["layer_norm_eps"])
    text_seq = mm[:, 1 + img.shape[1]:]
    return mlm_transform(num, p, gather_positions(text_seq, positions), cfg["layer_norm_eps"])


def logits(params, hidden, vocab_ids, num=None):
    return tied_logits(num or Numerics(), params, hidden, vocab_ids)
