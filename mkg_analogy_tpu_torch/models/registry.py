"""Model registry: reference class names -> constructors
(``mkg_analogy_tpu/models/registry.py``; MarT/models/model.py:7-35).

Each model shares the interface::

    model(input_ids, attention_mask, token_type_ids, pixel_values,
          positions, boundary=None, visual_attention_mask=None)
        -> trans_hidden (B, P, H)
    model.logits(trans_hidden, vocab_ids|vocab_start/end) -> logits

``IMAGE_INPUT`` describes the visual features each family consumes (the
collator contract, data_module.py:121-161). The three pixel families are
ported: MKGformerKGC, ViltKGC and FlavaKGC. VisualBertKGC and VilBertKGC
read detector region features and come with a later slice of the port.

``DEFAULT_ATTENTION`` is the attention backend each family takes when the
caller names none (models/common.py:AttentionCore). ViLT attends over L +
290 tokens (418 at L=128), within the single-block kernel's shared memory in
bf16 (717 keys; 400 in fp32, where the kernel's wrapper raises and names
the flash kernels). FLAVA's multimodal tower attends over 394 + L tokens
(522 at L=128), at the length from which the plain route takes the flash
kernels, so flash is its default, in either dtype.
"""

from __future__ import annotations

from typing import Callable, Dict

from .flava import FlavaConfig, FlavaForMaskedLM
from .unimo import TextConfig, UnimoConfig, UnimoForMaskedLM, VisionConfig
from .vilt import ViltConfig, ViltForMaskedLM

_REGISTRY: Dict[str, Callable] = {}

# visual-input kind per model family: ("pixels", size) or ("regions", None)
IMAGE_INPUT = {
    "MKGformerKGC": ("pixels", 224),
    "ViltKGC": ("pixels", 384),
    "FlavaKGC": ("pixels", 224),
    "VisualBertKGC": ("regions", None),
    "VilBertKGC": ("regions", None),
}

DEFAULT_ATTENTION = {"MKGformerKGC": "single", "ViltKGC": "single", "FlavaKGC": "flash"}


def _text_cfg(vocab_size: int, kw: dict) -> TextConfig:
    """TextConfig with optional size overrides (hidden_size, num_layers,
    num_heads, intermediate_size, max_position_embeddings)."""
    fields = {k: v for k, v in kw.items() if k in (
        "hidden_size", "num_layers", "num_heads", "intermediate_size",
        "max_position_embeddings")}
    return TextConfig(vocab_size=vocab_size, **fields)


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
                    gelu_impl=gelu_impl)
    )


@register("ViltKGC")
def _vilt(vocab_size: int, dtype: str = "bfloat16", attention: str = "single",
          gelu_impl: str = "poly", **kw):
    return ViltForMaskedLM(
        ViltConfig(text=_text_cfg(vocab_size, kw), dtype=dtype, attention=attention,
                   gelu_impl=gelu_impl)
    )


@register("FlavaKGC")
def _flava(vocab_size: int, dtype: str = "bfloat16", attention: str = "flash",
           gelu_impl: str = "poly", **kw):
    return FlavaForMaskedLM(
        FlavaConfig(text=_text_cfg(vocab_size, kw), dtype=dtype, attention=attention,
                    gelu_impl=gelu_impl)
    )


def _later_slice(name: str):
    def ctor(**kw):
        raise NotImplementedError(
            f"{name} is not ported to PyTorch yet: the two region-feature "
            "families (models/visualbert.py, models/vilbert.py) and the "
            "region store path come with a later slice (ROADMAP.md, Open "
            "items 1, item 2)"
        )

    return ctor


for _name in ("VisualBertKGC", "VilBertKGC"):
    register(_name)(_later_slice(_name))


def create_model(name: str, **kw):
    try:
        ctor = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model_class {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return ctor(**kw)
