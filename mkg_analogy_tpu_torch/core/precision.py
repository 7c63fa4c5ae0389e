"""Mixed-precision policy.

Parameters in float32, activations and matmuls in the compute dtype
(bfloat16 by default), losses and metrics reduced in float32. Modules keep
their parameters in ``param_dtype`` and cast them to the compute dtype where
they are used, as the JAX package's Flax modules do (``dtype=`` on each
layer).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        """``tree`` (a tensor, or dicts, lists and tuples of them) with
        every floating tensor cast to the compute dtype; other leaves as
        they are."""
        if isinstance(tree, torch.Tensor):
            return tree.to(self.compute_dtype) if tree.is_floating_point() else tree
        if isinstance(tree, dict):
            return {k: self.cast_to_compute(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_to_compute(v) for v in tree)
        return tree


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def to_dtype(name) -> torch.dtype:
    """``"bfloat16"``/``"float32"`` (or a ``torch.dtype``) -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; one of {sorted(DTYPES)}") from None
