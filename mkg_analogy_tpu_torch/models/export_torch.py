"""Export the port's weights to reference-format torch state_dicts
(``mkg_analogy_tpu/models/export_torch.py``).

The inverse of ``import_torch.*_params_from_reference``: a model trained in
this framework loads back into the reference stack (MarT/models: the
MaskedLM classes, key surface as saved by MarT/main.py checkpoints) with
``load_state_dict(sd, strict=False)``; only buffers (position_ids) and, for
some families, modules the MaskedLM path never reads are absent.

Each ``*_params_to_reference`` takes the port's ``state_dict()`` of the
family's module and returns fp32 tensors on the state dict's device (the
meta device included, so a full-size key surface costs no memory);
``state_dict_to_torch`` makes them contiguous CPU tensors for
``torch.save``. The maps are the JAX package's, read off the Flax tree that
``models/convert.py`` maps the port's names from: the port names its
parameters after that tree, so ``_flax_tree`` rebuilds it (a Linear
``weight`` back to a ``kernel`` (in, out), a conv ``weight`` to (kh, kw, I,
O), a LayerNorm ``weight`` to ``scale``) and the maps below follow the JAX
functions line for line.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Tensor = torch.Tensor


def _flax_tree(state_dict: Dict[str, Tensor]) -> Dict[str, Any]:
    """The port's state_dict as the Flax param tree it was named after
    (the inverse of ``convert.params_from_jax``)."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        value = value.detach()
        if leaf == "weight":
            if value.dim() == 2:
                leaf, value = "kernel", value.T
            elif value.dim() == 4:
                leaf, value = "kernel", value.permute(2, 3, 1, 0)
            else:
                leaf = "scale"
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _f32(x: Tensor) -> Tensor:
    return x.float()


def _dense_out(out: Dict[str, Tensor], prefix: str, p: Dict[str, Any]) -> None:
    # flax kernel (in, out) -> torch weight (out, in)
    out[f"{prefix}.weight"] = _f32(p["kernel"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = _f32(p["bias"])


def _ln_out(out: Dict[str, Tensor], prefix: str, p: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _f32(p["scale"])
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _conv_out(kernel: Tensor) -> Tensor:
    # flax conv kernel (H, W, C, O) -> torch (O, C, H, W)
    return _f32(kernel).permute(3, 2, 0, 1)


def _zeros(like: Tensor, *shape) -> Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def _word_and_bias(p, vocab_rows):
    word, bias = _f32(p["word_embeddings"]), _f32(p["mlm_bias"])
    if vocab_rows is not None:
        word, bias = word[:vocab_rows], bias[:vocab_rows]
    return word, bias


def unimo_params_to_reference(state_dict: Dict[str, Tensor], num_layers: int = 12,
                              vocab_rows: int = None) -> Dict[str, Tensor]:
    """The port's UnimoForMaskedLM state_dict -> reference state_dict.

    ``vocab_rows``: rows to keep from the (padded) embedding table — pass
    the torch-side vocab size to strip the alignment padding rows.

    Layers below ``fusion_start`` carry no fusion params (only layers idx >=
    fusion_start ever use them, modeling_unimo.py:609-643), but the
    reference's strict ``load_state_dict`` still expects
    ``intermediate.fusion_dense`` keys at every layer (modeling_unimo.py:452)
    — zeros are emitted for those dead slots.
    """
    p = _flax_tree(state_dict)
    sd: Dict[str, Tensor] = {}

    word, bias = _word_and_bias(p, vocab_rows)
    sd["unimo.text_embeddings.word_embeddings.weight"] = word
    sd["cls.predictions.bias"] = bias
    # tied decoder (reference registers it as its own parameter)
    sd["cls.predictions.decoder.weight"] = word
    sd["cls.predictions.decoder.bias"] = bias

    ve = p["vision_embeddings"]
    sd["unimo.vision_embeddings.class_embedding"] = _f32(ve["class_embedding"])
    sd["unimo.vision_embeddings.patch_embedding.weight"] = _conv_out(
        ve["patch_embedding"]["kernel"])
    sd["unimo.vision_embeddings.position_embedding.weight"] = _f32(ve["position_embedding"])
    _ln_out(sd, "unimo.vision_pre_layrnorm", p["vision_pre_ln"])

    te = p["text_embeddings"]
    sd["unimo.text_embeddings.position_embeddings.weight"] = _f32(te["position_embeddings"])
    sd["unimo.text_embeddings.token_type_embeddings.weight"] = _f32(
        te["token_type_embeddings"])
    _ln_out(sd, "unimo.text_embeddings.LayerNorm", te["ln"])

    _dense_out(sd, "cls.predictions.transform.dense", p["mlm_transform"]["dense"])
    _ln_out(sd, "cls.predictions.transform.LayerNorm", p["mlm_transform"]["ln"])

    # Reference modules that are dead weight on the MLM path (the analogy
    # task never reads the pooled output or the vision post-LN): neutral
    # defaults, so a reference checkpoint consumer sees a complete file.
    cls_emb = sd["unimo.vision_embeddings.class_embedding"]
    h_v, h_t = cls_emb.shape[-1], word.shape[1]
    sd["unimo.vision_post_layernorm.weight"] = _zeros(cls_emb, h_v) + 1.0
    sd["unimo.vision_post_layernorm.bias"] = _zeros(cls_emb, h_v)
    sd["unimo.text_pooler.dense.weight"] = torch.eye(h_t, dtype=torch.float32,
                                                     device=word.device)
    sd["unimo.text_pooler.dense.bias"] = _zeros(word, h_t)

    enc = p["encoder"]
    for i in range(num_layers):
        v = enc[f"vision_{i}"]
        vp = f"unimo.encoder.vision_layers.{i}"
        _ln_out(sd, f"{vp}.layer_norm1", v["ln1"])
        _ln_out(sd, f"{vp}.layer_norm2", v["ln2"])
        _dense_out(sd, f"{vp}.self_attn.q_proj", v["attn"]["query"])
        _dense_out(sd, f"{vp}.self_attn.k_proj", v["attn"]["key"])
        _dense_out(sd, f"{vp}.self_attn.v_proj", v["attn"]["value"])
        _dense_out(sd, f"{vp}.self_attn.out_proj", v["attn"]["out"])
        _dense_out(sd, f"{vp}.mlp.fc1", v["fc1"])
        _dense_out(sd, f"{vp}.mlp.fc2", v["fc2"])

        t = enc[f"text_{i}"]
        tp = f"unimo.encoder.text_layer.{i}"
        sd[f"{tp}.attention.self.adaptive_weight.0"] = _f32(t["adaptive_w0"])
        sd[f"{tp}.attention.self.adaptive_weight.1"] = _f32(t["adaptive_w1"])
        _dense_out(sd, f"{tp}.attention.self.query", t["attn"]["query"])
        _dense_out(sd, f"{tp}.attention.self.key", t["attn"]["key"])
        _dense_out(sd, f"{tp}.attention.self.value", t["attn"]["value"])
        _dense_out(sd, f"{tp}.attention.output.dense", t["attn"]["out"])
        _ln_out(sd, f"{tp}.attention.output.LayerNorm", t["attn_ln"])
        _dense_out(sd, f"{tp}.intermediate.dense", t["intermediate"])
        if "fusion_dense" in t:
            _dense_out(sd, f"{tp}.intermediate.fusion_dense", t["fusion_dense"])
        else:
            # dead pre-fusion slot (i < fusion_start): reference-shaped zeros
            inter_w = t["intermediate"]["kernel"]
            sd[f"{tp}.intermediate.fusion_dense.weight"] = _zeros(
                inter_w, inter_w.shape[1], inter_w.shape[0])
            sd[f"{tp}.intermediate.fusion_dense.bias"] = _zeros(inter_w, inter_w.shape[1])
        _dense_out(sd, f"{tp}.output.dense", t["output"])
        _ln_out(sd, f"{tp}.output.LayerNorm", t["out_ln"])
    return sd


def state_dict_to_torch(sd: Dict[str, Any]) -> Dict[str, Tensor]:
    """A state_dict of tensors (or numpy arrays) -> contiguous fp32 CPU
    tensors, ready for ``torch.save``."""
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float32).contiguous()
            for k, v in sd.items()}


# --------------------------------------------------------------------------
# VisualBERT (inverse of import_torch.visualbert_params_from_reference)
# --------------------------------------------------------------------------

def _attn_out(sd, qkv_prefix: str, out_prefix: str, a: Dict[str, Any]) -> None:
    _dense_out(sd, f"{qkv_prefix}.query", a["query"])
    _dense_out(sd, f"{qkv_prefix}.key", a["key"])
    _dense_out(sd, f"{qkv_prefix}.value", a["value"])
    _dense_out(sd, f"{out_prefix}.dense", a["out"])


def _encoder_layer_out(sd, p: str, lp: Dict[str, Any], pre_norm: bool,
                       qkv: str = "attention.self") -> None:
    _attn_out(sd, f"{p}.{qkv}", f"{p}.attention.output", lp["attn"])
    _dense_out(sd, f"{p}.intermediate.dense", lp["fc1"])
    _dense_out(sd, f"{p}.output.dense", lp["fc2"])
    if pre_norm:
        _ln_out(sd, f"{p}.layernorm_before", lp["ln1"])
        _ln_out(sd, f"{p}.layernorm_after", lp["ln2"])
    else:
        _ln_out(sd, f"{p}.attention.output.LayerNorm", lp["ln1"])
        _ln_out(sd, f"{p}.output.LayerNorm", lp["ln2"])


def _analogy_layer_out(sd, p: str, lp: Dict[str, Any], pre_norm: bool,
                       qkv: str = "attention.self") -> None:
    sd[f"{p}.{qkv}.adaptive_weight.0"] = _f32(lp["adaptive_w0"])
    sd[f"{p}.{qkv}.adaptive_weight.1"] = _f32(lp["adaptive_w1"])
    _encoder_layer_out(sd, p, lp["layer"], pre_norm, qkv=qkv)


def visualbert_params_to_reference(state_dict: Dict[str, Tensor], num_layers: int = 12,
                                   vocab_rows: int = None) -> Dict[str, Tensor]:
    """The port's VisualBertForMaskedLM state_dict -> reference
    VisualBertForMaskedLM state_dict; tied decoder keys are emitted for
    checkpoint-format completeness."""
    p = _flax_tree(state_dict)
    sd: Dict[str, Tensor] = {}
    word, bias = _word_and_bias(p, vocab_rows)
    emb = "visual_bert.embeddings"
    sd[f"{emb}.word_embeddings.weight"] = word
    sd["cls.predictions.bias"] = bias
    sd["cls.predictions.decoder.weight"] = word
    sd["cls.predictions.decoder.bias"] = bias

    e = p["embeddings"]
    sd[f"{emb}.position_embeddings.weight"] = _f32(e["position_embeddings"])
    sd[f"{emb}.token_type_embeddings.weight"] = _f32(e["token_type_embeddings"])
    sd[f"{emb}.visual_position_embeddings.weight"] = _f32(e["visual_position_embeddings"])
    sd[f"{emb}.visual_token_type_embeddings.weight"] = _f32(e["visual_token_type_embeddings"])
    _dense_out(sd, f"{emb}.visual_projection", e["visual_projection"])
    _ln_out(sd, f"{emb}.LayerNorm", e["ln"])

    _dense_out(sd, "cls.predictions.transform.dense", p["mlm_transform"]["dense"])
    _ln_out(sd, "cls.predictions.transform.LayerNorm", p["mlm_transform"]["ln"])

    for i in range(num_layers):
        _analogy_layer_out(sd, f"visual_bert.encoder.layer.{i}", p[f"layer_{i}"],
                           pre_norm=False)
    return sd


def _text_embeddings_out(sd, p: str, e: Dict[str, Any]) -> None:
    sd[f"{p}.position_embeddings.weight"] = _f32(e["position_embeddings"])
    sd[f"{p}.token_type_embeddings.weight"] = _f32(e["token_type_embeddings"])
    _ln_out(sd, f"{p}.LayerNorm", e["ln"])


# --------------------------------------------------------------------------
# ViLT (inverse of import_torch.vilt_params_from_reference)
# --------------------------------------------------------------------------

def vilt_params_to_reference(state_dict: Dict[str, Tensor], num_layers: int = 12,
                             vocab_rows: int = None) -> Dict[str, Tensor]:
    """The port's ViltForMaskedLM state_dict -> reference ViltForMaskedLM
    state_dict."""
    p = _flax_tree(state_dict)
    sd: Dict[str, Tensor] = {}
    word, bias = _word_and_bias(p, vocab_rows)
    sd["vilt.embeddings.text_embeddings.word_embeddings.weight"] = word
    sd["mlm_score.bias"] = bias
    sd["mlm_score.decoder.weight"] = word
    sd["mlm_score.decoder.bias"] = bias
    _text_embeddings_out(sd, "vilt.embeddings.text_embeddings", p["text_embeddings"])
    ie = p["image_embeddings"]
    sd["vilt.embeddings.cls_token"] = _f32(ie["cls_token"])
    sd["vilt.embeddings.position_embeddings"] = _f32(ie["position_embeddings"])[None]
    sd["vilt.embeddings.patch_embeddings.projection.weight"] = _conv_out(
        ie["patch_embedding"]["kernel"])
    sd["vilt.embeddings.patch_embeddings.projection.bias"] = _f32(ie["patch_embedding"]["bias"])
    sd["vilt.embeddings.token_type_embeddings.weight"] = _f32(p["modal_type_embeddings"])
    _ln_out(sd, "vilt.layernorm", p["final_ln"])
    _dense_out(sd, "mlm_score.transform.dense", p["mlm_transform"]["dense"])
    _ln_out(sd, "mlm_score.transform.LayerNorm", p["mlm_transform"]["ln"])
    for i in range(num_layers):
        _analogy_layer_out(sd, f"vilt.encoder.layer.{i}", p[f"layer_{i}"],
                           pre_norm=True, qkv="attention.attention")
    return sd


# --------------------------------------------------------------------------
# FLAVA (inverse of import_torch.flava_params_from_reference)
# --------------------------------------------------------------------------

def flava_params_to_reference(state_dict: Dict[str, Tensor], num_layers: int = 12,
                              mm_layers: int = 6, vocab_rows: int = None) -> Dict[str, Tensor]:
    """The port's FlavaForMaskedLM state_dict -> reference FlavaForMaskedLM
    state_dict.

    Reference params this framework has no counterpart for (unused in the
    MaskedLM path: model-level layernorms, poolers, contrastive projections,
    mask_token, image-tower adaptive weights) are NOT emitted — they stay at
    the consumer's init and are listed in load_state_dict missing_keys.
    """
    p = _flax_tree(state_dict)
    sd: Dict[str, Tensor] = {}
    word, bias = _word_and_bias(p, vocab_rows)
    sd["flava.text_model.embeddings.word_embeddings.weight"] = word
    sd["cls.bias"] = bias
    sd["cls.decoder.weight"] = word
    sd["cls.decoder.bias"] = bias
    _text_embeddings_out(sd, "flava.text_model.embeddings", p["text_embeddings"])
    ie = p["image_embeddings"]
    sd["flava.image_model.embeddings.cls_token"] = _f32(ie["cls_token"])
    sd["flava.image_model.embeddings.position_embeddings"] = _f32(
        ie["position_embeddings"])[None]
    sd["flava.image_model.embeddings.patch_embeddings.projection.weight"] = _conv_out(
        ie["patch_embedding"]["kernel"])
    sd["flava.image_model.embeddings.patch_embeddings.projection.bias"] = _f32(
        ie["patch_embedding"]["bias"])
    sd["flava.multimodal_model.cls_token"] = _f32(p["mm_cls_token"])
    _dense_out(sd, "flava.image_to_mm_projection", p["image_to_mm"])
    _dense_out(sd, "flava.text_to_mm_projection", p["text_to_mm"])
    _ln_out(sd, "flava.multimodal_model.layernorm", p["mm_ln"])
    _dense_out(sd, "cls.transform.dense", p["mlm_transform"]["dense"])
    _ln_out(sd, "cls.transform.LayerNorm", p["mlm_transform"]["ln"])
    qkv = "attention.attention"
    for i in range(num_layers):
        _analogy_layer_out(sd, f"flava.text_model.encoder.layer.{i}", p[f"text_{i}"],
                           pre_norm=True, qkv=qkv)
        _encoder_layer_out(sd, f"flava.image_model.encoder.layer.{i}", p[f"image_{i}"],
                           pre_norm=True, qkv=qkv)
    for i in range(mm_layers):
        _encoder_layer_out(sd, f"flava.multimodal_model.encoder.layer.{i}", p[f"mm_{i}"],
                           pre_norm=True, qkv=qkv)
    return sd


# --------------------------------------------------------------------------
# ViLBERT (inverse of import_torch.vilbert_params_from_reference)
# --------------------------------------------------------------------------

def vilbert_params_to_reference(state_dict: Dict[str, Tensor], num_layers: int = 12,
                                v_num_layers: int = 6, num_connections: int = 6,
                                vocab_rows: int = None) -> Dict[str, Tensor]:
    """The port's VilBertForMaskedLM state_dict -> reference VilBertForMaskLM
    state_dict.

    The reference's never-used biOutput.q_dense1/q_dense2 and poolers are
    not emitted (vilbert.py:862-874). The model has no loc_proj (its Flax
    trees never materialise one), so the reference's
    image_location_embeddings, which its strict load needs, are zeros."""
    p = _flax_tree(state_dict)
    sd: Dict[str, Tensor] = {}
    word, bias = _word_and_bias(p, vocab_rows)
    sd["bert.embeddings.word_embeddings.weight"] = word
    sd["cls.predictions.bias"] = bias
    sd["cls.predictions.decoder.weight"] = word
    sd["cls.predictions.decoder.bias"] = bias
    _text_embeddings_out(sd, "bert.embeddings", p["text_embeddings"])
    _dense_out(sd, "bert.v_embeddings.image_embeddings", p["image_proj"])
    v_kernel = p["image_proj"]["kernel"]
    v_hidden = v_kernel.shape[1]
    sd["bert.v_embeddings.image_location_embeddings.weight"] = _zeros(v_kernel, v_hidden, 5)
    sd["bert.v_embeddings.image_location_embeddings.bias"] = _zeros(v_kernel, v_hidden)
    _ln_out(sd, "bert.v_embeddings.LayerNorm", p["image_ln"])
    _dense_out(sd, "cls.predictions.transform.dense", p["mlm_transform"]["dense"])
    _ln_out(sd, "cls.predictions.transform.LayerNorm", p["mlm_transform"]["ln"])
    for i in range(num_layers):
        _analogy_layer_out(sd, f"bert.encoder.layer.{i}", p[f"t_layer_{i}"], pre_norm=False)
    for i in range(v_num_layers):
        _encoder_layer_out(sd, f"bert.encoder.v_layer.{i}", p[f"v_layer_{i}"], pre_norm=False)
    for i in range(num_connections):
        c = f"bert.encoder.c_layer.{i}"
        cl = p[f"c_layer_{i}"]
        _dense_out(sd, f"{c}.biattention.query1", cl["img_from_txt"]["query"])
        _dense_out(sd, f"{c}.biattention.key2", cl["img_from_txt"]["key"])
        _dense_out(sd, f"{c}.biattention.value2", cl["img_from_txt"]["value"])
        _dense_out(sd, f"{c}.biOutput.dense1", cl["img_from_txt"]["out"])
        _dense_out(sd, f"{c}.biattention.query2", cl["txt_from_img"]["query"])
        _dense_out(sd, f"{c}.biattention.key1", cl["txt_from_img"]["key"])
        _dense_out(sd, f"{c}.biattention.value1", cl["txt_from_img"]["value"])
        _dense_out(sd, f"{c}.biOutput.dense2", cl["txt_from_img"]["out"])
        _ln_out(sd, f"{c}.biOutput.LayerNorm1", cl["img_ln"])
        _ln_out(sd, f"{c}.biOutput.LayerNorm2", cl["txt_ln"])
        _dense_out(sd, f"{c}.v_intermediate.dense", cl["img_ffn_fc1"])
        _dense_out(sd, f"{c}.v_output.dense", cl["img_ffn_fc2"])
        _ln_out(sd, f"{c}.v_output.LayerNorm", cl["img_ffn_ln"])
        _dense_out(sd, f"{c}.t_intermediate.dense", cl["txt_ffn_fc1"])
        _dense_out(sd, f"{c}.t_output.dense", cl["txt_ffn_fc2"])
        _ln_out(sd, f"{c}.t_output.LayerNorm", cl["txt_ffn_ln"])
    return sd
