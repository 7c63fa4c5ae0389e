"""Plain fp32 Kimi-VL-A3B language model as a MarT backbone
(moonshotai/Kimi-VL-A3B-Instruct, config.json: a DeepSeek-V3-style decoder
of latent attention and sparse experts), MARS's two images entering as
tokens.

- images: each image slot through CLIP-ViT-B/32 on its own (its CLS and 49
  patches, positions 0-49), a pre-LN, 12 pre-LN CLIP layers with
  quick_gelu, a LayerNorm, then Linear(768 -> 2048), gelu, Linear(2048 ->
  2048): 2 x 50 image states before the 128 text states (word rows of the
  embedding), 228 positions, RoPE positions 0-227;
- each decoder layer: ``h = x + MLA(RMSNorm(x))``, ``h + FFN(RMSNorm(h))``;
  MLA: ``q = x W_q`` (16 heads of 128 + 64), ``[c, k_pe] = x W_kva`` (512 +
  64), ``c = RMSNorm(c)`` (eps 1e-6), ``[k_nope, v] = c W_kvb`` (16 heads of
  128 + 128), RoPE on q_pe and on the one shared k_pe (pairs (2i, 2i + 1)
  rotated by p * theta^(-2i / 64)), scores scaled by 192^-1/2, times MarT's
  analogy multiplier over the text rows and answer columns (after the 100
  image positions), plus (1 - mask) * -1e4, keys after the row left out;
  softmax, times v, ``W_o``;
- FFN: layer 0 a SwiGLU of 11,264; the others an expert layer: scores
  ``s = sigmoid(x W_r)`` over all 64 experts, the choice top-6 of ``s + b``
  (b the selection bias), weights ``s_chosen / sum(s_chosen) * 2.446``;
  ``shared(x)`` (one SwiGLU of 2 x 1,408) plus, for each held expert chosen
  by a token, its weight times ``W_down(silu(x W_gate) * x W_up)``;
- head: the final RMSNorm's states at the five gathered positions (offset
  by the image prefix), and the logits of the untied head's rows.

Departures from the published model, as the configuration states them:
MoonViT's tower is replaced by CLIP-ViT-B/32 and a two-layer projector
(the catalog gives no vision config); 14 of the 27 layers, 8 of the 64
experts (0-7) and an eighth of the word rows with MarT's tokens are held,
the share of one card of the stated deployment, so what the absent experts
would add is left out; the selection bias is held fixed (no update rate is
given) and no auxiliary loss is taken (noaux_tc has none).

Each decoder layer is recomputed in the backward (``torch.utils.checkpoint``)
so that one batch fits beside the weights, gradients and AdamW's moments.
``param_shapes`` names the leaves as the flat dict both sides load.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from .layers import (
    NEG_BIAS, AttentionCall, Numerics, analogy_multiplier, gather_positions, gelu, layer_norm,
    quick_gelu)


def _vision(cfg):
    return (cfg["vision_hidden_size"], cfg["vision_layers"], cfg["vision_heads"],
            cfg["vision_intermediate_size"])


def param_shapes(cfg) -> Dict[str, tuple]:
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    heads = cfg["num_attention_heads"]
    nope, pe, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, moe = cfg["kv_lora_rank"], cfg["moe_intermediate_size"]
    vh, vl, _, vi = _vision(cfg)
    patch, size = cfg["patch_size"], cfg["image_size"]
    shapes = {
        "word_embeddings": (v, h), "lm_head": (v, h),
        "vision_embeddings.class_embedding": (vh,),
        "vision_embeddings.position_embedding": ((size // patch) ** 2 + 1, vh),
        "vision_embeddings.patch_embedding.weight": (vh, 3, patch, patch),
        "vision_pre_ln.weight": (vh,), "vision_pre_ln.bias": (vh,),
    }
    for i in range(vl):
        p = f"vision_{i}"
        shapes[f"{p}.ln1.weight"] = shapes[f"{p}.ln1.bias"] = (vh,)
        for n in ("query", "key", "value", "out"):
            shapes[f"{p}.attn.{n}.weight"], shapes[f"{p}.attn.{n}.bias"] = (vh, vh), (vh,)
        shapes[f"{p}.ln2.weight"] = shapes[f"{p}.ln2.bias"] = (vh,)
        shapes[f"{p}.fc1.weight"], shapes[f"{p}.fc1.bias"] = (vi, vh), (vi,)
        shapes[f"{p}.fc2.weight"], shapes[f"{p}.fc2.bias"] = (vh, vi), (vh,)
    shapes["vision_post_ln.weight"] = shapes["vision_post_ln.bias"] = (vh,)
    shapes["projector_fc1.weight"], shapes["projector_fc1.bias"] = (h, vh), (h,)
    shapes["projector_fc2.weight"], shapes["projector_fc2.bias"] = (h, h), (h,)
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers_{i}"
        shapes[f"{p}.adaptive_w0"] = shapes[f"{p}.adaptive_w1"] = (1,)
        shapes[f"{p}.input_ln.weight"] = (h,)
        shapes[f"{p}.attn.q_proj.weight"] = (heads * (nope + pe), h)
        shapes[f"{p}.attn.kv_a_proj.weight"] = (rank + pe, h)
        shapes[f"{p}.attn.kv_a_ln.weight"] = (rank,)
        shapes[f"{p}.attn.kv_b_proj.weight"] = (heads * (nope + vd), rank)
        shapes[f"{p}.attn.o_proj.weight"] = (h, heads * vd)
        shapes[f"{p}.post_attn_ln.weight"] = (h,)
        if i < cfg["first_k_dense_replace"]:
            _swiglu_shapes(shapes, f"{p}.mlp", h, cfg["intermediate_size"])
        else:
            shapes[f"{p}.moe.router.weight"] = (cfg["router_experts"], h)
            shapes[f"{p}.moe.router.bias"] = (cfg["router_experts"],)
            _swiglu_shapes(shapes, f"{p}.moe.shared", h, cfg["n_shared_experts"] * moe)
            shapes[f"{p}.moe.experts.gate_up"] = (cfg["n_routed_experts"], h, 2 * moe)
            shapes[f"{p}.moe.experts.down"] = (cfg["n_routed_experts"], moe, h)
    shapes["final_ln.weight"] = (h,)
    return shapes


def _swiglu_shapes(shapes, prefix, h, inner):
    shapes[f"{prefix}.gate_proj.weight"] = shapes[f"{prefix}.up_proj.weight"] = (inner, h)
    shapes[f"{prefix}.down_proj.weight"] = (h, inner)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def _rope(x, cos, sin):
    even, odd = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([even * c - odd * s, odd * c + even * s], dim=-1).flatten(-2)


def _swiglu(num, p, prefix, x):
    gate = num.linear(x, p[f"{prefix}.gate_proj.weight"])
    up = num.linear(x, p[f"{prefix}.up_proj.weight"])
    return num.linear(torch.nn.functional.silu(gate) * up, p[f"{prefix}.down_proj.weight"])


def images(num, p, cfg, pixels):
    """(B, 2, 3, S, S) -> (B, 100, H): each image's CLIP states, projected."""
    b, n_img = pixels.shape[:2]
    vh, vl, v_heads, _ = _vision(cfg)
    size, patch, eps = cfg["image_size"], cfg["patch_size"], cfg["vision_layer_norm_eps"]
    x = pixels.reshape(b * n_img, 3, size, size)
    patches = num.conv_patches(x, p["vision_embeddings.patch_embedding.weight"], None, patch)
    cls = p["vision_embeddings.class_embedding"].expand(x.shape[0], 1, vh)
    x = torch.cat([cls, patches], dim=1) + p["vision_embeddings.position_embedding"][None]
    x = layer_norm(x, p["vision_pre_ln.weight"], p["vision_pre_ln.bias"], eps)
    ones = torch.ones(x.shape[:2], device=x.device)
    for i in range(vl):
        q = f"vision_{i}"
        attn = AttentionCall(num, p, f"{q}.attn", v_heads, "flash", 0.0)
        x = x + attn(layer_norm(x, p[f"{q}.ln1.weight"], p[f"{q}.ln1.bias"], eps), ones)[0]
        ff = layer_norm(x, p[f"{q}.ln2.weight"], p[f"{q}.ln2.bias"], eps)
        ff = num.linear(quick_gelu(num.linear(ff, p[f"{q}.fc1.weight"], p[f"{q}.fc1.bias"])),
                        p[f"{q}.fc2.weight"], p[f"{q}.fc2.bias"])
        x = x + ff
    x = layer_norm(x, p["vision_post_ln.weight"], p["vision_post_ln.bias"], eps)
    x = gelu(num.linear(x, p["projector_fc1.weight"], p["projector_fc1.bias"]))
    x = num.linear(x, p["projector_fc2.weight"], p["projector_fc2.bias"])
    return x.reshape(b, n_img * x.shape[1], cfg["hidden_size"])


def latent_attention(num, p, cfg, prefix, x, mask, cos, sin, mult):
    b, n, _ = x.shape
    heads = cfg["num_attention_heads"]
    nope, pe, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank = cfg["kv_lora_rank"]
    q = num.linear(x, p[f"{prefix}.q_proj.weight"]).view(b, n, heads, nope + pe)
    c, k_pe = num.linear(x, p[f"{prefix}.kv_a_proj.weight"]).split([rank, pe], dim=-1)
    c = rms_norm(c, p[f"{prefix}.kv_a_ln.weight"], cfg["kv_a_norm_eps"])
    kv = num.linear(c, p[f"{prefix}.kv_b_proj.weight"]).view(b, n, heads, nope + vd)
    k_nope, v = kv.split([nope, vd], dim=-1)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cos, sin)], dim=-1)
    k_pe = _rope(k_pe[:, :, None, :], cos, sin).expand(b, n, heads, pe)
    k = torch.cat([k_nope, k_pe], dim=-1)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = num.mm(qh, kh.transpose(-1, -2)) * (nope + pe) ** -0.5
    if mult is not None:
        s = s * mult
    s = s + ((1.0 - mask) * NEG_BIAS)[:, None, None, :]
    later = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
    s = s.masked_fill(later, float("-inf"))
    ctx = num.mm(torch.softmax(s, dim=-1), vh).transpose(1, 2).reshape(b, n, heads * vd)
    return num.linear(ctx, p[f"{prefix}.o_proj.weight"])


def route(num, p, cfg, prefix, x):
    """(scores (T, E), chosen experts (T, k), their weights (T, k))."""
    scores = torch.sigmoid(num.linear(x, p[f"{prefix}.router.weight"]))
    chosen = torch.topk(scores + p[f"{prefix}.router.bias"].detach(),
                        cfg["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(-1, chosen)
    return scores, chosen, w / w.sum(dim=-1, keepdim=True) * cfg["routed_scaling_factor"]


def expert_layer(num, p, cfg, prefix, x):
    """shared(x) + the held experts' weighted part, over (T, H) rows."""
    _, chosen, w = route(num, p, cfg, prefix, x)
    out = _swiglu(num, p, f"{prefix}.shared", x)
    gate_up, down = p[f"{prefix}.experts.gate_up"], p[f"{prefix}.experts.down"]
    inner = cfg["moe_intermediate_size"]
    for e in range(cfg["n_routed_experts"]):
        hit = chosen == cfg["first_held_expert"] + e                        # (T, k)
        rows = hit.any(dim=-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        h = num.mm(x[rows], gate_up[e])
        y = num.mm(torch.nn.functional.silu(h[:, :inner]) * h[:, inner:], down[e])
        out = out.index_add(0, rows, y * (w * hit)[rows].sum(dim=-1, keepdim=True))
    return out


def decoder_layer(num, p, cfg, i, x, mask, cos, sin, mult):
    prefix, eps = f"layers_{i}", cfg["rms_norm_eps"]
    h = x + latent_attention(num, p, cfg, f"{prefix}.attn",
                             rms_norm(x, p[f"{prefix}.input_ln.weight"], eps), mask, cos, sin,
                             mult)
    f = rms_norm(h, p[f"{prefix}.post_attn_ln.weight"], eps)
    if i < cfg["first_k_dense_replace"]:
        return h + _swiglu(num, p, f"{prefix}.mlp", f)
    b, n, hid = f.shape
    return h + expert_layer(num, p, cfg, f"{prefix}.moe", f.reshape(-1, hid)).view(b, n, hid)


def rope_tables(n, width, theta, device):
    inv = theta ** (-torch.arange(0, width, 2, dtype=torch.float64, device=device) / width)
    angle = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return angle.cos().to(torch.float32), angle.sin().to(torch.float32)


def forward(params, cfg, batch, pixels, positions, draws=None, num=None):
    """The final states at the gathered ``positions`` of the text (B, P, H).
    ``draws`` is unused: the model has no dropout."""
    num = num or Numerics()
    p = params
    img = images(num, p, cfg, pixels)
    txt = p["word_embeddings"][batch["input_ids"].long()]
    x = torch.cat([img, txt], dim=1)
    b, n, _ = x.shape
    prefix = img.shape[1]
    mask = torch.cat([torch.ones(b, prefix, device=x.device),
                      batch["attention_mask"].to(torch.float32)], dim=1)
    cos, sin = rope_tables(n, cfg["qk_rope_head_dim"], cfg["rope_theta"], x.device)
    boundary = batch["sep_idx"][:, 2] + prefix
    for i in range(cfg["num_hidden_layers"]):
        q = f"layers_{i}"
        mult = analogy_multiplier(boundary, p[f"{q}.adaptive_w0"], p[f"{q}.adaptive_w1"], n, n,
                                  prefix, n)
        args = (num, p, cfg, i, x, mask, cos, sin, mult)
        x = (checkpoint(decoder_layer, *args, use_reentrant=False) if torch.is_grad_enabled()
             else decoder_layer(*args))
    x = rms_norm(x, p["final_ln.weight"], cfg["rms_norm_eps"])
    return gather_positions(x, positions.long() + prefix)


def logits(params, hidden, vocab_ids, num=None):
    """The untied head's logits of ``hidden`` (B, H) over its rows ``vocab_ids``."""
    return (num or Numerics()).mm(hidden, params["lm_head"][vocab_ids].t())
