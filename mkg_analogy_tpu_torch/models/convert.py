"""Carry JAX-package weights into the port.

``params_from_jax`` maps a Flax param tree, as nested dicts of numpy arrays
(``jax.device_get`` of the tree), onto the ``state_dict()`` names of the
port's module of the same name: ``UnimoForMaskedLM``, ``ViltForMaskedLM``,
``FlavaForMaskedLM``, ``VisualBertForMaskedLM``, ``VilBertForMaskedLM``,
``VGG16Features``, ``ViTClassifier``, ``ResNet50Features``, and the KGE
models ``IKRLTransE``, ``IKRLAnalogy``, ``TransAETransE``, ``RSMEModel`` and
``CPModel``. The port names its parameters after the Flax tree, so the map
is mechanical (the same transposes as
``mkg_analogy_tpu/models/export_torch.py:37``):

- a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in);
- a Conv or PatchEmbed ``kernel`` (kh, kw, I, O) becomes a Conv2d ``weight``
  (O, I, kh, kw);
- a LayerNorm or BatchNorm ``scale`` becomes ``weight``; a BatchNorm's
  ``mean`` and ``var`` of the ``batch_stats`` collection become
  ``running_mean`` and ``running_var`` beside it;
- the KGE models' ``frozen`` collection (feature tables, the forget gate)
  becomes the buffers of the same names;
- everything else (embeddings, ``mlm_bias``, ``adaptive_w0/w1``, class
  tokens, biases) keeps its name and layout.

``VGG16Features`` flattens its last feature map in the JAX module's (h, w,
c) order, so fc6 needs no permutation here. Pre-fusion UniMo text layers
carry no ``fusion_dense`` in either tree. An orbax checkpoint on disk needs
JAX to read; restore it there, then convert.

A tree of JAX's ``USE_FUSED_QKV`` experiment, whose attention projects with
one ``qkv`` Dense, maps as it stands onto a model built with ``fused_qkv``;
``fuse_qkv`` maps an unfused tree or state dict into that layout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_RENAMED = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + ".")
        else:
            yield path, np.asarray(value)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables (``{"params": ..., "batch_stats": ...}``, ``{"params":
    ..., "frozen": ...}``, or the inner params dict) -> the port's
    state_dict (fp32 tensors), for ``load_state_dict``: ``strict=True`` holds
    for every module but those with BatchNorm, whose ``num_batches_tracked``
    counters Flax does not have."""
    collections = [tree[c] for c in ("params", "batch_stats", "frozen")
                   if c in tree] or [tree]
    sd: Dict[str, torch.Tensor] = {}
    for collection in collections:
        for path, value in _flatten(collection):
            value = value.astype(np.float32)
            head, dot, leaf = path.rpartition(".")
            if leaf == "kernel":
                value = value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
                path = f"{head}{dot}weight"
            elif leaf in _RENAMED:
                path = f"{head}{dot}{_RENAMED[leaf]}"
            sd[path] = torch.from_numpy(np.ascontiguousarray(value))
    return sd


unimo_params_from_jax = params_from_jax  # the name of the first slices


_QKV = ("query", "key", "value")


def _fuse_tree(tree: Dict[str, Any], name: str = "") -> Dict[str, Any]:
    out = {k: _fuse_tree(v, k) if isinstance(v, dict) else v for k, v in tree.items()}
    if name == "attn" and set(_QKV) <= set(out):
        parts = [out.pop(p) for p in _QKV]
        out["qkv"] = {leaf: np.concatenate([np.asarray(p[leaf]) for p in parts], axis=-1)
                      for leaf in parts[0]}
    return out


def fuse_qkv(params: Dict[str, Any]) -> Dict[str, Any]:
    """An unfused parameter set in the layout of ``fused_qkv`` (JAX's
    ``USE_FUSED_QKV``): in every attention core (a module named ``attn``),
    ``query``, ``key`` and ``value`` become one ``qkv`` whose outputs are
    theirs concatenated in that order, as ``jnp.split(qkv, 3)`` and
    ``chunk(3)`` read them back. Takes a Flax tree (nested dicts: a Dense
    ``kernel`` (in, out) and ``bias`` joined on their last axis) or a
    port state dict (flat names: a Linear ``weight`` (out, in) and ``bias``
    joined on their first). ViLBERT's cross-attention keeps its three."""
    if any(isinstance(v, dict) for v in params.values()):
        return _fuse_tree(params)
    out = dict(params)
    for key in params:
        head, _, leaf = key.rpartition(".")
        scope, _, proj = head.rpartition(".")
        if proj == "query" and scope.rpartition(".")[2] == "attn":
            parts = [out.pop(f"{scope}.{p}.{leaf}") for p in _QKV]
            out[f"{scope}.qkv.{leaf}"] = torch.cat(parts, dim=0)
    return out
