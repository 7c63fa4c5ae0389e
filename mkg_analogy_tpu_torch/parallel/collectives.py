"""The collectives of data and tensor parallelism, as autograd functions.

Every collective here is an ``all_reduce`` (gloo on CUDA tensors, which
ranks sharing one card must use, takes only ``broadcast``, ``all_reduce``
and ``barrier``). A group of None is an axis of one rank: each function is
then the identity and calls nothing. Reductions run in fp32 (or the
tensor's dtype where that is wider) and cast back, so a bf16 partial sum is
rounded once.

- ``copy_to(x, group)``: the identity forward, the gradient all-reduced
  (summed) over ``group``. A replicated tensor enters a sharded computation
  through it (the input of a column-parallel layer, the adaptive analogy
  scalars that each rank's heads use), so its gradient sums every rank's
  part.
- ``reduce_from(x, group)``: ``x`` summed over ``group``, the gradient
  passed through. A row-parallel layer's partial products leave through it.
- ``gather_from(x, group, dim, start, whole)``: the whole of a sharded
  tensor on every rank (each rank's slice written into zeros, then summed),
  the gradient sliced back. Exact: each element is one rank's value plus
  zeros.
- ``all_reduce_(t, group, op)``: an in-place reduction outside autograd
  (loss statistics, counts, ranks).

``Shard`` records a parameter's slice of one dim; ``parallel/shardings.py``
sets it on each parameter it splits (``p.tp_shard``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Shard:
    """A rank's contiguous slice ``[start, stop)`` of dim ``dim`` (extent
    ``whole``), over ``group``."""

    dim: int
    start: int
    stop: int
    whole: int
    group: Any


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype in (torch.float32, torch.float64) or not t.is_floating_point() \
        else t.to(torch.float32)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (nothing where group is None);
    returns ``t``."""
    if group is None:
        return t
    wide = _wide(t)
    dist.all_reduce(wide, op=op, group=group)
    if wide is not t:
        t.copy_(wide)
    return t


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    wide = _wide(x).clone()
    dist.all_reduce(wide, group=group)
    return wide.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g.contiguous(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, start, whole):
        ctx.slice = (dim, start, x.shape[dim])
        shape = list(x.shape)
        shape[dim] = whole
        full = x.new_zeros(shape)
        full.narrow(dim, start, x.shape[dim]).copy_(x)
        return _summed(full, group)

    @staticmethod
    def backward(ctx, g):
        dim, start, size = ctx.slice
        return g.narrow(dim, start, size).contiguous(), None, None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; the gradient passed through."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int, start: int, whole: int) -> torch.Tensor:
    """The whole tensor of which ``x`` is the slice ``[start, start +
    x.shape[dim])`` of dim ``dim``; the gradient sliced back."""
    if group is None:
        return x
    return _GatherFrom.apply(x, group, dim % x.dim(), start, whole)


def shard_of(param) -> Optional[Shard]:
    """The ``Shard`` a parameter holds, or None for a whole one."""
    return getattr(param, "tp_shard", None)


def whole(part: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The whole tensor of which ``part`` is a rank's ``shard`` (its slice
    written into zeros and summed over the group; every rank calls it), or
    ``part`` itself where it is whole."""
    if shard is None:
        return part
    shape = list(part.shape)
    shape[shard.dim] = shard.whole
    out = part.new_zeros(shape)
    out.narrow(shard.dim, shard.start, shard.stop - shard.start).copy_(part)
    return all_reduce_(out, shard.group)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a whole table, or for one split by rows
    (vocab-parallel): each rank looks up the ids in its rows, zeros
    elsewhere, and the rows are summed over the group."""
    shard = shard_of(table)
    if shard is None:
        return table[ids.long()]
    local = ids.long() - shard.start
    inside = (local >= 0) & (local < shard.stop - shard.start)
    rows = table[local.clamp(0, shard.stop - shard.start - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    return reduce_from(rows, shard.group)


@dataclass
class ShardedLogits:
    """A rank's columns of (B, C) logits whose classes are split over
    ``group`` (the tied decoder over a vocab-parallel table): ``values``
    (B, C_local), ``cols`` (C_local,) the ascending global column of each,
    ``num_classes`` C. ``ops/losses.py`` and ``ops/ranking.py`` reduce over
    the group what a softmax or a rank needs of the other columns."""

    values: torch.Tensor
    cols: torch.Tensor
    num_classes: int
    group: Any

    @property
    def shape(self):
        return (self.values.shape[0], self.num_classes)

    def split(self, n: int):
        """(the first ``n`` classes, the rest), each a ``ShardedLogits``."""
        first = self.cols < n
        return (ShardedLogits(self.values[:, first], self.cols[first], n, self.group),
                ShardedLogits(self.values[:, ~first], self.cols[~first] - n,
                              self.num_classes - n, self.group))

    def label_values(self, labels: torch.Tensor):
        """((B,) the value at each row's label column where this rank holds
        it, else 0; (B,) bool: whether it does)."""
        n = self.cols.numel()
        labels = labels.long()
        if n == 0:
            return self.values.new_zeros(labels.shape), torch.zeros_like(labels, dtype=torch.bool)
        pos = torch.searchsorted(self.cols, labels).clamp(max=n - 1)
        held = self.cols[pos] == labels
        val = torch.gather(self.values, 1, pos[:, None])[:, 0]
        return torch.where(held, val, torch.zeros((), dtype=val.dtype, device=val.device)), held
