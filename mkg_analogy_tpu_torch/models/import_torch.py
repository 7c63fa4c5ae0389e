"""Reference-format torch state_dicts -> the port's state_dicts
(``mkg_analogy_tpu/models/import_torch.py``).

Two flows, as in the JAX package:
- a *reference-format* MaskedLM state_dict of each family (the layout of
  MarT/models, i.e. the published MKG_Analogy checkpoints) into the port's
  module of the same family: ``*_params_from_reference``;
- the BERT + CLIP "model surgery" of MarT/main.py:90-109 (bert-base-uncased
  and openai/clip-vit-base-patch32 weights into the two towers of
  MKGformer) from local checkpoints: ``unimo_params_from_bert_clip`` (this
  framework never downloads).

Each map builds the Flax param tree of the JAX function of the same name
(Linear ``weight`` (out, in) -> ``kernel`` (in, out), Conv2d ``weight`` (O,
I, kh, kw) -> (kh, kw, I, O), LayerNorm ``weight`` -> ``scale``) and
returns it under the port's ``state_dict()`` names, the mechanical map of
``models/convert.py``, as fp32 tensors for ``load_state_dict(sd,
strict=True)``. Inputs may be torch tensors or numpy arrays; tensors on
the meta device stay there.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

Tensor = torch.Tensor


def _a(x) -> Tensor:
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()  # torch tensors over read-only numpy memory are unsafe
    return torch.as_tensor(x)


def _t(w) -> Tensor:
    return _a(w).T


def _conv(w) -> Tensor:
    return _a(w).permute(2, 3, 1, 0)


def _ln(sd, prefix) -> Dict[str, Tensor]:
    return {"scale": _a(sd[f"{prefix}.weight"]), "bias": _a(sd[f"{prefix}.bias"])}


def _dense(sd, prefix) -> Dict[str, Tensor]:
    out = {"kernel": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = _a(sd[f"{prefix}.bias"])
    return out


def _state_dict(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Tensor]:
    """A Flax param tree -> the port's state_dict names and layouts (the
    torch counterpart of ``convert.params_from_jax``), fp32, contiguous."""
    sd: Dict[str, Tensor] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            sd.update(_state_dict(value, path + "."))
            continue
        value = _a(value)
        head, dot, leaf = path.rpartition(".")
        if leaf == "kernel":
            value = value.T if value.dim() == 2 else value.permute(3, 2, 0, 1)
            path = f"{head}{dot}weight"
        elif leaf == "scale":
            path = f"{head}{dot}weight"
        sd[path] = value.to(torch.float32).contiguous()
    return sd


def _pad_vocab(word: Tensor, bias: Tensor, vocab_rows):
    """The torch rows at the top of a ``vocab_rows`` table, the extra
    (padding) rows zero."""
    if vocab_rows is not None and vocab_rows != word.shape[0]:
        w2 = torch.zeros((vocab_rows, word.shape[1]), dtype=word.dtype, device=word.device)
        w2[: word.shape[0]] = word
        b2 = torch.zeros((vocab_rows,), dtype=bias.dtype, device=bias.device)
        b2[: bias.shape[0]] = bias
        return w2, b2
    return word, bias


def unimo_params_from_reference(sd: Dict[str, Any], num_layers: int = 12,
                                vocab_rows: int = None,
                                fusion_start: int = 8) -> Dict[str, Tensor]:
    """Reference UnimoForMaskedLM state_dict -> the port's UnimoForMaskedLM
    state_dict.

    ``vocab_rows``: target vocab size of the port's table; the torch rows are
    copied into the top and extra (padding) rows stay zero.

    ``fusion_start``: the reference instantiates ``fusion_dense`` in EVERY
    BertIntermediate (modeling_unimo.py:452) but only layers idx >=
    fusion_start ever call it (modeling_unimo.py:609-643); the port's model
    has the params only where used, so the dead pre-fusion copies in the
    checkpoint are deliberately dropped here.
    """
    word, dec_bias = _pad_vocab(_a(sd["unimo.text_embeddings.word_embeddings.weight"]),
                                _a(sd["cls.predictions.bias"]), vocab_rows)
    params: Dict[str, Any] = {
        "word_embeddings": word,
        "mlm_bias": dec_bias,
        "vision_embeddings": {
            "class_embedding": _a(sd["unimo.vision_embeddings.class_embedding"]),
            "patch_embedding": {
                "kernel": _conv(sd["unimo.vision_embeddings.patch_embedding.weight"])},
            "position_embedding": _a(sd["unimo.vision_embeddings.position_embedding.weight"]),
        },
        "vision_pre_ln": _ln(sd, "unimo.vision_pre_layrnorm"),
        "text_embeddings": {
            "position_embeddings": _a(sd["unimo.text_embeddings.position_embeddings.weight"]),
            "token_type_embeddings": _a(
                sd["unimo.text_embeddings.token_type_embeddings.weight"]),
            "ln": _ln(sd, "unimo.text_embeddings.LayerNorm"),
        },
        "mlm_transform": {
            "dense": _dense(sd, "cls.predictions.transform.dense"),
            "ln": _ln(sd, "cls.predictions.transform.LayerNorm"),
        },
        "encoder": {},
    }
    enc = params["encoder"]
    for i in range(num_layers):
        vp = f"unimo.encoder.vision_layers.{i}"
        enc[f"vision_{i}"] = {
            "ln1": _ln(sd, f"{vp}.layer_norm1"),
            "ln2": _ln(sd, f"{vp}.layer_norm2"),
            "attn": {
                "query": _dense(sd, f"{vp}.self_attn.q_proj"),
                "key": _dense(sd, f"{vp}.self_attn.k_proj"),
                "value": _dense(sd, f"{vp}.self_attn.v_proj"),
                "out": _dense(sd, f"{vp}.self_attn.out_proj"),
            },
            "fc1": _dense(sd, f"{vp}.mlp.fc1"),
            "fc2": _dense(sd, f"{vp}.mlp.fc2"),
        }
        tp = f"unimo.encoder.text_layer.{i}"
        enc[f"text_{i}"] = {
            "adaptive_w0": _a(sd[f"{tp}.attention.self.adaptive_weight.0"]),
            "adaptive_w1": _a(sd[f"{tp}.attention.self.adaptive_weight.1"]),
            "attn": {
                "query": _dense(sd, f"{tp}.attention.self.query"),
                "key": _dense(sd, f"{tp}.attention.self.key"),
                "value": _dense(sd, f"{tp}.attention.self.value"),
                "out": _dense(sd, f"{tp}.attention.output.dense"),
            },
            "attn_ln": _ln(sd, f"{tp}.attention.output.LayerNorm"),
            "intermediate": _dense(sd, f"{tp}.intermediate.dense"),
            "output": _dense(sd, f"{tp}.output.dense"),
            "out_ln": _ln(sd, f"{tp}.output.LayerNorm"),
        }
        if i >= fusion_start:
            enc[f"text_{i}"]["fusion_dense"] = _dense(sd, f"{tp}.intermediate.fusion_dense")
    return _state_dict(params)


def unimo_params_from_bert_clip(bert_sd: Dict[str, Any], clip_vision_sd: Dict[str, Any],
                                num_layers: int = 12, vocab_rows: int = None,
                                fusion_start: int = 8) -> Dict[str, Tensor]:
    """BERT encoder + CLIP vision-tower state_dicts -> the port's
    UnimoForMaskedLM state_dict (the MarT/main.py:90-109 surgery, name-mapped
    directly)."""
    merged: Dict[str, Any] = {}
    # re-express both checkpoints in the reference-unimo namespace, then
    # reuse the converter above.
    for k, v in clip_vision_sd.items():
        if k.startswith("embeddings."):
            merged[f"unimo.vision_embeddings.{k[len('embeddings.'):]}"] = v
        elif k.startswith("pre_layrnorm.") or k.startswith("pre_layernorm."):
            merged[f"unimo.vision_pre_layrnorm.{k.split('.', 1)[1]}"] = v
        elif k.startswith("encoder.layers."):
            merged[f"unimo.encoder.vision_layers.{k[len('encoder.layers.'):]}"] = v
    for k, v in bert_sd.items():
        if k.startswith("embeddings."):
            merged[f"unimo.text_embeddings.{k[len('embeddings.'):]}"] = v
        elif k.startswith("encoder.layer."):
            merged[f"unimo.encoder.text_layer.{k[len('encoder.layer.'):]}"] = v

    word = _a(merged["unimo.text_embeddings.word_embeddings.weight"])
    hidden = word.shape[1]

    def f32(*shape, fill=0.0):
        return torch.full(shape, fill, dtype=torch.float32, device=word.device)

    merged.setdefault("cls.predictions.bias", f32(word.shape[0]))
    merged.setdefault("cls.predictions.transform.dense.weight",
                      torch.eye(hidden, dtype=torch.float32, device=word.device))
    merged.setdefault("cls.predictions.transform.dense.bias", f32(hidden))
    merged.setdefault("cls.predictions.transform.LayerNorm.weight", f32(hidden, fill=1.0))
    merged.setdefault("cls.predictions.transform.LayerNorm.bias", f32(hidden))
    for i in range(num_layers):
        tp = f"unimo.encoder.text_layer.{i}"
        merged.setdefault(f"{tp}.attention.self.adaptive_weight.0", f32(1, fill=0.25))
        merged.setdefault(f"{tp}.attention.self.adaptive_weight.1", f32(1, fill=0.5))
        merged.setdefault(f"{tp}.intermediate.fusion_dense.weight",
                          torch.zeros_like(_a(merged[f"{tp}.intermediate.dense.weight"])))
        merged.setdefault(f"{tp}.intermediate.fusion_dense.bias",
                          torch.zeros_like(_a(merged[f"{tp}.intermediate.dense.bias"])))
    return unimo_params_from_reference(merged, num_layers, vocab_rows,
                                       fusion_start=fusion_start)


# --------------------------------------------------------------------------
# Shared transformer-layer converters
# --------------------------------------------------------------------------

def _attn(sd, qkv_prefix, out_prefix) -> Dict[str, Any]:
    return {
        "query": _dense(sd, f"{qkv_prefix}.query"),
        "key": _dense(sd, f"{qkv_prefix}.key"),
        "value": _dense(sd, f"{qkv_prefix}.value"),
        "out": _dense(sd, f"{out_prefix}.dense"),
    }


def _encoder_layer(sd, p, pre_norm: bool, qkv="attention.self") -> Dict[str, Any]:
    """HF BertLayer (post-LN) / ViTLayer (pre-LN) -> EncoderLayer params."""
    out = {
        "attn": _attn(sd, f"{p}.{qkv}", f"{p}.attention.output"),
        "fc1": _dense(sd, f"{p}.intermediate.dense"),
        "fc2": _dense(sd, f"{p}.output.dense"),
    }
    if pre_norm:
        out["ln1"] = _ln(sd, f"{p}.layernorm_before")
        out["ln2"] = _ln(sd, f"{p}.layernorm_after")
    else:
        out["ln1"] = _ln(sd, f"{p}.attention.output.LayerNorm")
        out["ln2"] = _ln(sd, f"{p}.output.LayerNorm")
    return out


def _analogy_layer(sd, p, pre_norm: bool, qkv="attention.self") -> Dict[str, Any]:
    """AnalogyEncoderLayer params: adaptive scalars + nested EncoderLayer."""
    return {
        "adaptive_w0": _a(sd[f"{p}.{qkv}.adaptive_weight.0"]),
        "adaptive_w1": _a(sd[f"{p}.{qkv}.adaptive_weight.1"]),
        "layer": _encoder_layer(sd, p, pre_norm, qkv=qkv),
    }


def _text_embeddings(sd, p) -> Dict[str, Any]:
    """BERT-style embeddings (minus the word table, owned by the LM head)."""
    return {
        "position_embeddings": _a(sd[f"{p}.position_embeddings.weight"]),
        "token_type_embeddings": _a(sd[f"{p}.token_type_embeddings.weight"]),
        "ln": _ln(sd, f"{p}.LayerNorm"),
    }


# --------------------------------------------------------------------------
# VisualBERT (MarT/models/modeling_visual_bert.py; loader main.py:110-113)
# --------------------------------------------------------------------------

def visualbert_params_from_reference(sd: Dict[str, Any], num_layers: int = 12,
                                     vocab_rows: int = None) -> Dict[str, Tensor]:
    """Reference VisualBertForMaskedLM state_dict -> the port's state_dict.

    Dead reference params not mapped: position_ids buffers, the tied
    cls.predictions.decoder.* (equal to the word table / predictions.bias).
    """
    emb = "visual_bert.embeddings"
    word, bias = _pad_vocab(_a(sd[f"{emb}.word_embeddings.weight"]),
                            _a(sd["cls.predictions.bias"]), vocab_rows)
    params: Dict[str, Any] = {
        "word_embeddings": word,
        "mlm_bias": bias,
        "embeddings": {
            "position_embeddings": _a(sd[f"{emb}.position_embeddings.weight"]),
            "token_type_embeddings": _a(sd[f"{emb}.token_type_embeddings.weight"]),
            "visual_position_embeddings": _a(sd[f"{emb}.visual_position_embeddings.weight"]),
            "visual_token_type_embeddings": _a(
                sd[f"{emb}.visual_token_type_embeddings.weight"]),
            "visual_projection": _dense(sd, f"{emb}.visual_projection"),
            "ln": _ln(sd, f"{emb}.LayerNorm"),
        },
        "mlm_transform": {
            "dense": _dense(sd, "cls.predictions.transform.dense"),
            "ln": _ln(sd, "cls.predictions.transform.LayerNorm"),
        },
    }
    for i in range(num_layers):
        params[f"layer_{i}"] = _analogy_layer(sd, f"visual_bert.encoder.layer.{i}",
                                              pre_norm=False)
    return _state_dict(params)


# --------------------------------------------------------------------------
# ViLT (MarT/models/modeling_vilt.py; loader main.py:119-123)
# --------------------------------------------------------------------------

def interpolate_patch_positions(pos, num_patches: int) -> Tensor:
    """Bilinear align_corners=True resize of a (P0+1, H) [CLS ; grid]
    position table to (num_patches+1, H) — the reference's
    nn.functional.interpolate in visual_embed (modeling_vilt.py:123-134),
    used to load non-matching-resolution checkpoints. The arithmetic is the
    JAX package's numpy one, in float64 (its result's dtype)."""
    pos = _a(pos)
    p0 = pos.shape[0] - 1
    if p0 == num_patches:
        return pos
    g0 = int(math.isqrt(p0))
    g1 = int(math.isqrt(num_patches))
    if g0 * g0 != p0 or g1 * g1 != num_patches:
        raise ValueError(f"position grids must be square: {p0} and {num_patches} patches")
    grid = pos[1:].reshape(g0, g0, -1)
    # align_corners=True bilinear: sample at i*(g0-1)/(g1-1)
    coords = (torch.zeros(1, dtype=torch.float64) if g1 == 1 else
              torch.from_numpy(np.arange(g1) * (g0 - 1) / (g1 - 1)))
    i0 = torch.clamp(torch.floor(coords).long(), 0, g0 - 1)
    i1 = torch.clamp(i0 + 1, 0, g0 - 1)
    f = (coords - i0)[:, None]
    rows = grid[i0] * (1 - f[:, None]) + grid[i1] * f[:, None]  # (g1, g0, H)
    out = rows[:, i0] * (1 - f[None]) + rows[:, i1] * f[None]  # (g1, g1, H)
    return torch.cat([pos[:1].to(torch.float64), out.reshape(g1 * g1, -1)], dim=0)


def vilt_params_from_reference(sd: Dict[str, Any], num_layers: int = 12,
                               vocab_rows: int = None,
                               num_patches: int = None) -> Dict[str, Tensor]:
    """Reference ViltForMaskedLM state_dict -> the port's state_dict.

    ``num_patches``: target patches per image; when it differs from the
    checkpoint's grid the position table is bilinearly interpolated
    (align_corners=True) like the reference's visual_embed
    (modeling_vilt.py:123-134). Dead params not mapped: position_ids,
    vilt.pooler.*, the tied mlm_score.decoder.*.
    """
    word, bias = _pad_vocab(_a(sd["vilt.embeddings.text_embeddings.word_embeddings.weight"]),
                            _a(sd["mlm_score.bias"]), vocab_rows)
    pos = _a(sd["vilt.embeddings.position_embeddings"])[0]  # (P+1, H)
    if num_patches is not None:
        pos = interpolate_patch_positions(pos, num_patches)
    params: Dict[str, Any] = {
        "word_embeddings": word,
        "mlm_bias": bias,
        "text_embeddings": _text_embeddings(sd, "vilt.embeddings.text_embeddings"),
        "image_embeddings": {
            "cls_token": _a(sd["vilt.embeddings.cls_token"]),
            "position_embeddings": pos,
            "patch_embedding": {
                "kernel": _conv(sd["vilt.embeddings.patch_embeddings.projection.weight"]),
                "bias": _a(sd["vilt.embeddings.patch_embeddings.projection.bias"]),
            },
        },
        "modal_type_embeddings": _a(sd["vilt.embeddings.token_type_embeddings.weight"]),
        "final_ln": _ln(sd, "vilt.layernorm"),
        "mlm_transform": {
            "dense": _dense(sd, "mlm_score.transform.dense"),
            "ln": _ln(sd, "mlm_score.transform.LayerNorm"),
        },
    }
    for i in range(num_layers):
        params[f"layer_{i}"] = _analogy_layer(sd, f"vilt.encoder.layer.{i}", pre_norm=True,
                                              qkv="attention.attention")
    return _state_dict(params)


# --------------------------------------------------------------------------
# FLAVA (MarT/models/modeling_flava.py; loader main.py:124-125)
# --------------------------------------------------------------------------

def flava_params_from_reference(sd: Dict[str, Any], num_layers: int = 12, mm_layers: int = 6,
                                vocab_rows: int = None) -> Dict[str, Tensor]:
    """Reference FlavaForMaskedLM state_dict -> the port's state_dict.

    Dead reference params not mapped (unused in the MaskedLM path):
    flava.{image,text}_model.layernorm (the multimodal tower consumes
    pre-final-layernorm states, modeling_flava.py:1429-1450), all poolers,
    flava.image_projection / text_projection / logit_scale (contrastive
    head), image mask_token, the image towers' unused adaptive weights, and
    the tied cls.decoder.*.
    """
    word, bias = _pad_vocab(_a(sd["flava.text_model.embeddings.word_embeddings.weight"]),
                            _a(sd["cls.bias"]), vocab_rows)
    pre = "flava.image_model.embeddings"
    params: Dict[str, Any] = {
        "word_embeddings": word,
        "mlm_bias": bias,
        "text_embeddings": _text_embeddings(sd, "flava.text_model.embeddings"),
        "image_embeddings": {
            "cls_token": _a(sd[f"{pre}.cls_token"]),
            "position_embeddings": _a(sd[f"{pre}.position_embeddings"])[0],
            "patch_embedding": {
                "kernel": _conv(sd[f"{pre}.patch_embeddings.projection.weight"]),
                "bias": _a(sd[f"{pre}.patch_embeddings.projection.bias"]),
            },
        },
        "mm_cls_token": _a(sd["flava.multimodal_model.cls_token"]),
        "image_to_mm": _dense(sd, "flava.image_to_mm_projection"),
        "text_to_mm": _dense(sd, "flava.text_to_mm_projection"),
        "mm_ln": _ln(sd, "flava.multimodal_model.layernorm"),
        "mlm_transform": {
            "dense": _dense(sd, "cls.transform.dense"),
            "ln": _ln(sd, "cls.transform.LayerNorm"),
        },
    }
    qkv = "attention.attention"
    for i in range(num_layers):
        params[f"text_{i}"] = _analogy_layer(sd, f"flava.text_model.encoder.layer.{i}",
                                             pre_norm=True, qkv=qkv)
        params[f"image_{i}"] = _encoder_layer(sd, f"flava.image_model.encoder.layer.{i}",
                                              pre_norm=True, qkv=qkv)
    for i in range(mm_layers):
        params[f"mm_{i}"] = _encoder_layer(sd, f"flava.multimodal_model.encoder.layer.{i}",
                                           pre_norm=True, qkv=qkv)
    return _state_dict(params)


# --------------------------------------------------------------------------
# ViLBERT (MarT/models/vilbert.py; loader main.py:114-118)
# --------------------------------------------------------------------------

def vilbert_params_from_reference(sd: Dict[str, Any], num_layers: int = 12,
                                  v_num_layers: int = 6, num_connections: int = 6,
                                  vocab_rows: int = None) -> Dict[str, Tensor]:
    """Reference VilBertForMaskLM state_dict -> the port's state_dict.

    BiAttention regrouping (vilbert.py:715-876): query1/key1/value1 project
    the vision stream, query2/key2/value2 the text stream; context for the
    VISION stream is query1 over key2/value2 through biOutput.dense1, and
    context for the TEXT stream is query2 over key1/value1 through
    biOutput.dense2 — exactly the img_from_txt / txt_from_img split.
    Not mapped: biOutput.q_dense1/q_dense2 (declared but never used in the
    reference forward, vilbert.py:862-874), poolers, the tied decoder, and
    image_location_embeddings: the port's model has no loc_proj (the Flax
    trees never materialise one, and the region stores carry no boxes), so
    the JAX function's ``loc_proj`` entry has nowhere to go.
    """
    word, bias = _pad_vocab(_a(sd["bert.embeddings.word_embeddings.weight"]),
                            _a(sd["cls.predictions.bias"]), vocab_rows)
    params: Dict[str, Any] = {
        "word_embeddings": word,
        "mlm_bias": bias,
        "text_embeddings": _text_embeddings(sd, "bert.embeddings"),
        "image_proj": _dense(sd, "bert.v_embeddings.image_embeddings"),
        "image_ln": _ln(sd, "bert.v_embeddings.LayerNorm"),
        "mlm_transform": {
            "dense": _dense(sd, "cls.predictions.transform.dense"),
            "ln": _ln(sd, "cls.predictions.transform.LayerNorm"),
        },
    }
    for i in range(num_layers):
        params[f"t_layer_{i}"] = _analogy_layer(sd, f"bert.encoder.layer.{i}", pre_norm=False)
    for i in range(v_num_layers):
        params[f"v_layer_{i}"] = _encoder_layer(sd, f"bert.encoder.v_layer.{i}",
                                                pre_norm=False)
    for i in range(num_connections):
        c = f"bert.encoder.c_layer.{i}"
        params[f"c_layer_{i}"] = {
            "img_from_txt": {
                "query": _dense(sd, f"{c}.biattention.query1"),
                "key": _dense(sd, f"{c}.biattention.key2"),
                "value": _dense(sd, f"{c}.biattention.value2"),
                "out": _dense(sd, f"{c}.biOutput.dense1"),
            },
            "txt_from_img": {
                "query": _dense(sd, f"{c}.biattention.query2"),
                "key": _dense(sd, f"{c}.biattention.key1"),
                "value": _dense(sd, f"{c}.biattention.value1"),
                "out": _dense(sd, f"{c}.biOutput.dense2"),
            },
            "img_ln": _ln(sd, f"{c}.biOutput.LayerNorm1"),
            "txt_ln": _ln(sd, f"{c}.biOutput.LayerNorm2"),
            "img_ffn_fc1": _dense(sd, f"{c}.v_intermediate.dense"),
            "img_ffn_fc2": _dense(sd, f"{c}.v_output.dense"),
            "img_ffn_ln": _ln(sd, f"{c}.v_output.LayerNorm"),
            "txt_ffn_fc1": _dense(sd, f"{c}.t_intermediate.dense"),
            "txt_ffn_fc2": _dense(sd, f"{c}.t_output.dense"),
            "txt_ffn_ln": _ln(sd, f"{c}.t_output.LayerNorm"),
        }
    return _state_dict(params)
