"""Model registry: reference class names -> constructors
(``mkg_analogy_tpu/models/registry.py``; MarT/models/model.py:7-35).

Each model shares the interface::

    model(input_ids, attention_mask, token_type_ids, pixel_values,
          positions, boundary=None, visual_attention_mask=None)
        -> trans_hidden (B, P, H)
    model.logits(trans_hidden, vocab_ids|vocab_start/end) -> logits

``IMAGE_INPUT`` describes the visual features each family consumes (the
collator contract, data_module.py:121-161). Only MKGformerKGC is ported so
far; the other four families come with a later slice of the port.
"""

from __future__ import annotations

from typing import Callable, Dict

from .unimo import TextConfig, UnimoConfig, UnimoForMaskedLM, VisionConfig

_REGISTRY: Dict[str, Callable] = {}

# visual-input kind per model family: ("pixels", size) or ("regions", None)
IMAGE_INPUT = {
    "MKGformerKGC": ("pixels", 224),
    "ViltKGC": ("pixels", 384),
    "FlavaKGC": ("pixels", 224),
    "VisualBertKGC": ("regions", None),
    "VilBertKGC": ("regions", None),
}


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
               fused_attention: bool = True, gelu_impl: str = "poly", **kw):
    text = _text_cfg(vocab_size, kw)
    # lockstep towers: vision mirrors any size overrides
    vision = VisionConfig(
        hidden_size=text.hidden_size, num_layers=text.num_layers,
        num_heads=text.num_heads, intermediate_size=text.intermediate_size,
    )
    fusion_start = max(0, text.num_layers - 4)
    return UnimoForMaskedLM(
        UnimoConfig(text=text, vision=vision, fusion_start=fusion_start,
                    dtype=dtype, fused_attention=fused_attention,
                    gelu_impl=gelu_impl)
    )


def _later_slice(name: str):
    def ctor(**kw):
        raise NotImplementedError(
            f"{name} is not ported to PyTorch yet: the other four MarT "
            "families (models/visualbert.py, vilt.py, flava.py, vilbert.py) "
            "come after the training slice (ROADMAP.md, queue 1)"
        )

    return ctor


for _name in ("VisualBertKGC", "ViltKGC", "FlavaKGC", "VilBertKGC"):
    register(_name)(_later_slice(_name))


def create_model(name: str, **kw):
    try:
        ctor = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model_class {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return ctor(**kw)
