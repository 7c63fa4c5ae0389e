"""Model registry: reference class names -> constructors
(``mkg_analogy_tpu/models/registry.py``; MarT/models/model.py:7-35).

Each model shares the interface::

    model(input_ids, attention_mask, token_type_ids, pixel_values,
          positions, boundary=None, visual_attention_mask=None)
        -> trans_hidden (B, P, H)
    model.logits(trans_hidden, vocab_ids|vocab_start/end) -> logits

``IMAGE_INPUT`` describes the visual features each family consumes (the
collator contract, data_module.py:121-161): pixels for MKGformerKGC,
ViltKGC, FlavaKGC and KimiVLKGC, detector region features (2 images x 36
regions of 2048) for VisualBertKGC and VilBertKGC.

``KimiVLKGC`` (``models/kimi_vl.py``) has no counterpart in the JAX
package: Kimi-VL-A3B's language model, a decoder of latent attention and
sparse experts, at the published widths, with this card's share of an
expert-parallel deployment (8 of the 64 experts, 14 of the 27 layers, an
eighth of the word rows); the sizes ``create_model`` is not passed are
``KimiVLConfig``'s defaults, as FLAVA's ``image_layers`` are FlavaConfig's.
Its MLA always attends through the causal flash kernels (head width 192,
value width 128); ``attention`` picks its CLIP tower's backend, flash by
default.

``DEFAULT_ATTENTION`` is the attention backend each family takes when the
caller names none (models/common.py:AttentionCore). ViLT attends over L +
290 tokens (418 at L=128) through the single-block kernels in either
dtype, as JAX runs it: they take any key count (the bf16 ones stream their
keys, the fp32 ones hold a head's K and V where it fits a block and stream
it where it does not). FLAVA's multimodal tower attends over 394 + L tokens
(522 at L=128), at the length from which the plain route takes the flash
kernels, so flash is its default, in either dtype. VisualBERT attends over
L + 72 tokens (200 at L=128) and ViLBERT's streams over L and 72 tokens,
the visual one at head_dim 128, which both kernel sets take (every width
from 1 to 256); both keep the single-block kernels.
"""

from __future__ import annotations

from typing import Callable, Dict

from .flava import FlavaConfig, FlavaForMaskedLM
from .kimi_vl import KimiVLConfig, KimiVLForMaskedLM
from .unimo import TextConfig, UnimoConfig, UnimoForMaskedLM, VisionConfig
from .vilbert import VilBertConfig, VilBertForMaskedLM
from .vilt import ViltConfig, ViltForMaskedLM
from .visualbert import VisualBertConfig, VisualBertForMaskedLM

_REGISTRY: Dict[str, Callable] = {}

# visual-input kind per model family: ("pixels", size) or ("regions", None)
IMAGE_INPUT = {
    "MKGformerKGC": ("pixels", 224),
    "ViltKGC": ("pixels", 384),
    "FlavaKGC": ("pixels", 224),
    "VisualBertKGC": ("regions", None),
    "VilBertKGC": ("regions", None),
    "KimiVLKGC": ("pixels", 224),
}

DEFAULT_ATTENTION = {"MKGformerKGC": "single", "ViltKGC": "single", "FlavaKGC": "flash",
                     "VisualBertKGC": "single", "VilBertKGC": "single", "KimiVLKGC": "flash"}


def _text_cfg(vocab_size: int, kw: dict) -> TextConfig:
    """TextConfig with optional size overrides (hidden_size, num_layers,
    num_heads, intermediate_size, max_position_embeddings)."""
    fields = {k: v for k, v in kw.items() if k in (
        "hidden_size", "num_layers", "num_heads", "intermediate_size",
        "max_position_embeddings")}
    return TextConfig(vocab_size=vocab_size, **fields)


def _switches(kw: dict) -> dict:
    """The AttentionCore switches among a constructor's keywords
    (``qk_bf16_grad``, ``fused_qkv``; each config's default where absent)."""
    return {k: bool(kw[k]) for k in ("qk_bf16_grad", "fused_qkv") if k in kw}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


@register("MKGformerKGC")
def _mkgformer(vocab_size: int, dtype: str = "bfloat16",
               attention: str = "single", gelu_impl: str = "poly", **kw):
    text = _text_cfg(vocab_size, kw)
    # lockstep towers: vision mirrors any size overrides
    vision = VisionConfig(
        hidden_size=text.hidden_size, num_layers=text.num_layers,
        num_heads=text.num_heads, intermediate_size=text.intermediate_size,
    )
    fusion_start = max(0, text.num_layers - 4)
    return UnimoForMaskedLM(
        UnimoConfig(text=text, vision=vision, fusion_start=fusion_start,
                    dtype=dtype, attention=attention,
                    gelu_impl=gelu_impl, **_switches(kw))
    )


@register("ViltKGC")
def _vilt(vocab_size: int, dtype: str = "bfloat16", attention: str = "single",
          gelu_impl: str = "poly", **kw):
    return ViltForMaskedLM(
        ViltConfig(text=_text_cfg(vocab_size, kw), dtype=dtype, attention=attention,
                   gelu_impl=gelu_impl, **_switches(kw))
    )


@register("FlavaKGC")
def _flava(vocab_size: int, dtype: str = "bfloat16", attention: str = "flash",
           gelu_impl: str = "poly", **kw):
    return FlavaForMaskedLM(
        FlavaConfig(text=_text_cfg(vocab_size, kw), dtype=dtype, attention=attention,
                    gelu_impl=gelu_impl, **_switches(kw))
    )


@register("VisualBertKGC")
def _visualbert(vocab_size: int, dtype: str = "bfloat16", attention: str = "single",
                gelu_impl: str = "poly", **kw):
    return VisualBertForMaskedLM(
        VisualBertConfig(text=_text_cfg(vocab_size, kw), dtype=dtype, attention=attention,
                         gelu_impl=gelu_impl, **_switches(kw))
    )


@register("VilBertKGC")
def _vilbert(vocab_size: int, dtype: str = "bfloat16", attention: str = "single",
             gelu_impl: str = "poly", **kw):
    text = _text_cfg(vocab_size, kw)
    ablate = bool(kw.get("vilbert_ablate_img_to_txt", False))
    # scale the rendezvous schedule to a reduced depth (tiny/test configs):
    # the default 6-connection schedule indexes text layers 6..11
    # (vilbert.py config bert_base_6layer_6conect)
    n_conn = min(6, text.num_layers // 2, max(1, text.num_layers - 1))
    v_num_layers = max(n_conn, 6 if text.num_layers >= 12 else n_conn)
    t_start = text.num_layers - n_conn
    return VilBertForMaskedLM(
        VilBertConfig(
            text=text, dtype=dtype,
            v_num_layers=v_num_layers,
            v_biattention_id=tuple(range(n_conn)),
            t_biattention_id=tuple(range(t_start, text.num_layers)),
            ablate_img_to_txt=ablate,
            attention=attention, gelu_impl=gelu_impl, **_switches(kw),
        )
    )


@register("KimiVLKGC")
def _kimi_vl(vocab_size: int, dtype: str = "bfloat16", attention: str = "flash",
             gelu_impl: str = "poly", **kw):
    sizes = {k: v for k, v in kw.items()
             if k in ("hidden_size", "num_layers", "num_heads", "intermediate_size")}
    return KimiVLForMaskedLM(KimiVLConfig(vocab_size=vocab_size, dtype=dtype,
                                          attention=attention, gelu_impl=gelu_impl, **sizes))


def create_model(name: str, **kw):
    try:
        ctor = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model_class {name!r}; available: {available_models()}"
        ) from None
    return ctor(**kw)


def available_models():
    return sorted(_REGISTRY)
