"""Carry JAX-package weights into the port.

``unimo_params_from_jax`` maps a Flax ``UnimoForMaskedLM`` param tree, as
nested dicts of numpy arrays (``jax.device_get`` of the tree), onto the
port's ``UnimoForMaskedLM.state_dict()`` names. The port names its
parameters after the Flax tree, so the map is mechanical (the same
transposes as ``mkg_analogy_tpu/models/export_torch.py:37``):

- a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in);
- the PatchEmbed conv ``kernel`` (P, P, C, H) becomes a Conv2d ``weight``
  (H, C, P, P);
- a LayerNorm ``scale`` becomes ``weight``;
- everything else (embeddings, ``mlm_bias``, ``adaptive_w0/w1``, biases)
  keeps its name and layout.

Pre-fusion text layers carry no ``fusion_dense`` in either tree. An orbax
checkpoint on disk needs JAX to read; restore it there, then convert.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + ".")
        else:
            yield path, np.asarray(value)


def unimo_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax UnimoForMaskedLM params (``{"params": ...}`` or the inner dict)
    -> the port's state_dict (fp32 tensors), for ``load_state_dict(strict=
    True)``."""
    params = tree["params"] if "params" in tree else tree
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        value = value.astype(np.float32)
        head, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            value = value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
            path = f"{head}.weight"
        elif leaf == "scale":
            path = f"{head}.weight"
        sd[path] = torch.from_numpy(np.ascontiguousarray(value))
    return sd
