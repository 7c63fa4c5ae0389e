"""Sharding rules over the (dp, tp) mesh (``mkg_analogy_tpu/parallel/shardings.py``).

The rules are JAX's: an ordered regex table over ``path/like/this``
parameter names, each to a spec (one mesh axis or None per dim). For this
model family the heavy, shardable dims are

- the tied MLM decoder / word-embedding table (~42k rows)  -> vocab over tp
- attention QKV/out projections (heads)                    -> inner dim over tp
- MLP intermediate (3072)                                  -> inner dim over tp
- batch                                                    -> dp

Everything else (LayerNorms, biases of output projections, scalars) is
replicated. The port matches the rules on the JAX path of each of its
parameters (``jax_path``: ``encoder.text_3.attn.query.weight`` is
``params/encoder/text_3/attn/query/kernel``, the map of
``models/convert.py`` read backwards), and gives each spec in its own layout:
a Dense kernel (in, out) is a Linear weight (out, in), so JAX's
``(None, "tp")`` on it is ``("tp", None)`` here. A rule applies only where
the leaf has the dims (JAX's rank check).

JAX lets GSPMD insert the collectives. Here ``shard_module`` applies the
specs to a model: it slices each split parameter to the rank's part (a
dim of extent n splits into pieces of ceil(n / tp), as XLA pads them),
records its ``Shard`` on it (``p.tp_shard``) and marks the blocks that
compute on it (``models/common.py``: column- and row-parallel ``Dense``,
the rank's heads of an ``AttentionCore``, the vocab-parallel table), which
call the all-reduces of ``parallel/collectives.py``. ``gather_state_dict``
and ``shard_state_dict`` move between a model's parts and whole tensors.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.mesh import AXES, axis_group, axis_rank, axis_size
from .collectives import Shard, shard_of, whole

Spec = Tuple[Optional[str], ...]


def param_sharding_rules() -> List[Tuple[str, Spec]]:
    """The JAX table, specs in JAX's layout (a Dense kernel is (in, out))."""
    return [
        # tied embedding table + decoder bias: shard vocab dim
        (r".*word_embeddings$", ("tp", None)),
        (r".*mlm_bias$", ("tp",)),
        # attention projections: inner (head) dim on tp
        (r".*attn/(query|key|value)/kernel$", (None, "tp")),
        (r".*attn/(query|key|value)/bias$", ("tp",)),
        (r".*attn/out/kernel$", ("tp", None)),
        # MLP: intermediate dim on tp
        (r".*(intermediate|fc1|fusion_dense)/kernel$", (None, "tp")),
        (r".*(intermediate|fc1|fusion_dense)/bias$", ("tp",)),
        (r".*(output|fc2)/kernel$", ("tp", None)),
        # KGE embedding tables: shard entity/relation dim
        (r".*(ent|rel)_.*embedding.*$", ("tp", None)),
    ]


_NORMS = (nn.LayerNorm, nn.BatchNorm2d)


def _params_and_owners(model: nn.Module):
    """(state-dict name, parameter, owning module) of each parameter."""
    for mod_name, module in model.named_modules():
        for leaf, param in module.named_parameters(recurse=False):
            yield (f"{mod_name}.{leaf}" if mod_name else leaf), param, module


def jax_path(name: str, module: nn.Module) -> str:
    """The JAX path of the parameter ``name`` of ``module`` (its owner):
    ``weight`` is a ``kernel`` (Linear, Conv) or a ``scale`` (norms)."""
    head, _, leaf = name.rpartition(".")
    if leaf == "weight":
        leaf = "scale" if isinstance(module, _NORMS) else "kernel"
    return "params/" + "/".join(filter(None, head.split(".") + [leaf]))


def _to_port_layout(spec: Spec, param: torch.Tensor, module: nn.Module, name: str) -> Spec:
    """A spec on JAX's layout of a leaf, on the port's: a Dense kernel
    transposed, a conv kernel (kh, kw, I, O) as (O, I, kh, kw)."""
    if not spec or not name.endswith(".weight") or isinstance(module, _NORMS):
        return spec
    full = tuple(spec) + (None,) * (param.dim() - len(spec))
    if param.dim() == 2:
        return (full[1], full[0])
    if param.dim() == 4:
        return (full[3], full[2], full[0], full[1])
    return spec


def shard_params_spec(model: nn.Module, rules=None) -> Dict[str, Spec]:
    """State-dict name -> the spec of the first rule its JAX path matches
    (in the port's layout), or () (replicated). A rule only applies if the
    leaf has its dims (rank check); otherwise the param is replicated."""
    rules = rules if rules is not None else param_sharding_rules()
    out: Dict[str, Spec] = {}
    for name, param, module in _params_and_owners(model):
        path, spec = jax_path(name, module), ()
        for pat, rule in rules:
            if re.match(pat, path):
                if len(rule) <= param.dim():
                    spec = _to_port_layout(rule, param, module, name)
                break
        out[name] = spec
    return out


def batch_spec(batch: Dict[str, Any]) -> Dict[str, Spec]:
    """Shard every batch array on its leading (batch) dim over dp."""
    return {k: (AXES.dp,) if getattr(v, "ndim", 0) >= 1 else () for k, v in batch.items()}


def _bounds(extent: int, parts: int, index: int) -> Tuple[int, int]:
    """[start, stop) of piece ``index`` of ``extent`` cut in ``parts`` pieces
    of ceil(extent / parts)."""
    size = -(-extent // parts)
    return min(index * size, extent), min((index + 1) * size, extent)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: what a rank holds of a tensor."""

    mesh: Any
    spec: Spec

    def shard(self, shape) -> Optional[Shard]:
        """The rank's ``Shard`` of a tensor of ``shape``, or None where the
        spec splits no dim over an axis of more than one rank. A spec names
        at most one axis."""
        for dim, axis in enumerate(self.spec):
            if axis is not None and axis_size(self.mesh, axis) > 1:
                start, stop = _bounds(shape[dim], axis_size(self.mesh, axis),
                                      axis_rank(self.mesh, axis))
                return Shard(dim, start, stop, shape[dim], axis_group(self.mesh, axis))
        return None

    def local(self, x):
        """The rank's part of ``x`` (a tensor or numpy array)."""
        shard = self.shard(x.shape)
        if shard is None:
            return x
        index = (slice(None),) * shard.dim + (slice(shard.start, shard.stop),)
        return x[index]


def make_shardings(mesh, spec_tree: Dict[str, Spec]) -> Dict[str, NamedSharding]:
    return {k: NamedSharding(mesh, s) for k, s in spec_tree.items()}


def shard_module(model: nn.Module, mesh) -> nn.Module:
    """Split ``model``'s parameters over the mesh's ``tp`` axis by the rules,
    in place, and mark the blocks that compute on them; nothing where tp is
    1. The parameters must be whole: the model as built, initialised or
    loaded (``shard_state_dict`` slices a whole state for a split model)."""
    from ..models.common import AttentionCore, Dense

    group = axis_group(mesh, AXES.tp)
    if group is None:
        return model
    shardings = make_shardings(mesh, shard_params_spec(model))
    for name, param, _ in _params_and_owners(model):
        if shard_of(param) is not None:
            raise ValueError(f"{name} is split already")
        shard = shardings[name].shard(param.shape)
        if shard is None:
            continue
        if shard.stop <= shard.start:
            raise ValueError(f"{name}: {shard.whole} rows leave rank "
                             f"{axis_rank(mesh, AXES.tp)} of tp={axis_size(mesh, AXES.tp)} none")
        with torch.no_grad():
            param.data = param.data.narrow(shard.dim, shard.start,
                                           shard.stop - shard.start).clone()
        param.tp_shard = shard
    for mod_name, module in model.named_modules():
        if isinstance(module, Dense) and shard_of(module.weight) is not None:
            module.tp = ("column" if shard_of(module.weight).dim == 0 else "row", group)
        if isinstance(module, AttentionCore):
            _shard_attention(mod_name, module, group, axis_size(mesh, AXES.tp))
    return model


def _shard_attention(name: str, core, group, tp: int) -> None:
    """Run ``core`` on its rank's heads: Q/K/V split by heads, ``out`` by
    its inputs. A fused ``qkv``, which no rule names, stays whole (as in
    JAX): the core takes its heads' rows of it (models/common.py)."""
    projections = ([core.qkv] if core.fused_qkv else [core.query, core.key, core.value])
    split = [shard_of(p.weight) is not None for p in projections + [core.out]]
    if not any(split):
        return
    if core.fused_qkv:
        if split != [False, True]:
            raise ValueError(f"{name}: fused_qkv under tp keeps qkv whole beside a split "
                             "out projection")
    elif not all(split):
        raise ValueError(f"{name}: the rules split only some of its projections")
    heads = core.num_heads
    if heads % tp:
        raise ValueError(f"{name}: tp={tp} does not divide its {heads} heads")
    shard = shard_of(core.out.weight)  # row-parallel: its inputs are the heads' columns
    width = shard.whole // heads
    core.num_heads = heads // tp
    core.tp = (group, shard.start // width, heads)


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split parameter whole: each rank's
    part written into zeros and summed over tp (a collective: every rank
    calls it)."""
    shards = {n: shard_of(p) for n, p, _ in _params_and_owners(model)}
    return {name: whole(value, shards.get(name))
            for name, value in model.state_dict().items()}


def shard_state_dict(model: nn.Module, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A whole state dict sliced to ``model``'s parts, for its
    ``load_state_dict``."""
    shards = {n: shard_of(p) for n, p, _ in _params_and_owners(model)}
    out = {}
    for name, value in state.items():
        shard = shards.get(name)
        if shard is not None and value.shape[shard.dim] == shard.whole:
            value = value.narrow(shard.dim, shard.start, shard.stop - shard.start)
        out[name] = value
    return out

