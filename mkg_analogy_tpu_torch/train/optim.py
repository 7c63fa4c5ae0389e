"""Optimizer: AdamW with linear warmup and linear decay, BERT-style no-decay
parameter groups, gradient accumulation and global-norm clipping
(``mkg_analogy_tpu/train/optim.py``).

Parity: MarT/lit_models/transformer.py:224-241 — AdamW(eps=1e-8), weight
decay on everything except biases and LayerNorm scales, a linear schedule
with a ``warm_up_radio`` warmup fraction; ``--accumulate_grad_batches``
averages k micro-batches as ``optax.MultiSteps`` does, with the schedule
counted in optimizer steps (``total_steps // k``); ``max_grad_norm`` is
``optax.clip_by_global_norm``'s formula.

On a (dp, tp) mesh (``mesh``): each rank's loss is its share of the global
batch's mean, so its gradients are summed over ``dp`` (``sync_gradients``,
coalesced into a few all-reduces) before they are accumulated or clipped.
A parameter split over ``tp`` (``p.tp_shard``) holds the whole gradient of
its part; a replicated one holds the whole gradient on every rank (the
blocks route the gradients of replicated leaves that sharded activations
feed, the adaptive analogy scalars, through ``copy_to``, which sums them).
So the global norm sums the squares of the split leaves over ``tp`` and
counts each replicated leaf once, and AdamW, elementwise, runs on the parts.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..core.mesh import AXES, axis_group
from ..kernels.adamw import AdamW
from ..parallel.collectives import all_reduce_, shard_of

# elements of one coalesced gradient all-reduce (256 MB of fp32)
_BUCKET = 64 * 1024 * 1024


def linear_warmup_linear_decay(lr: float, total_steps: int,
                               warmup_ratio: float = 0.1) -> Callable[[int], float]:
    """The optax join of ``linear_schedule(0, lr, warmup)`` and
    ``linear_schedule(lr, 0, total - warmup)``: count -> learning rate, 0 at
    count 0."""
    warmup_steps = max(1, int(total_steps * warmup_ratio))
    decay_steps = max(1, total_steps - warmup_steps)

    def linear(init: float, end: float, steps: int, count: int) -> float:
        count = min(max(count, 0), steps)
        return (init - end) * (1.0 - count / steps) + end

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return linear(0.0, lr, warmup_steps, count)
        return linear(lr, 0.0, decay_steps, count - warmup_steps)

    return schedule


def no_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies: everything except
    leaves named ``bias`` and LayerNorm (and RMSNorm) scales. The JAX
    package decides by the Flax leaf names ``bias`` and ``scale``; here a
    LayerNorm scale is ``<ln>.weight``, so it is found by module type, not
    by name. So ``mlm_bias``, ``adaptive_w0/w1`` and the embeddings decay,
    as in JAX."""
    ln_scales = {id(m.weight) for m in model.modules()
                 if isinstance(m, (nn.LayerNorm, nn.RMSNorm))}
    return {name: not (name.rpartition(".")[2] == "bias" or id(p) in ln_scales)
            for name, p in model.named_parameters()}


class Optimizer:
    """AdamW over two parameter groups (decay, no decay) with a ``LambdaLR``
    on the schedule; ``step`` is called after every micro-batch's backward
    and updates the parameters every ``accumulate``-th call, on the mean of
    the accumulated gradients, clipped to ``max_grad_norm``. The update is
    ``kernels/adamw.py:AdamW``: one kernel launch on a card, PyTorch's
    foreach update on the CPU; a leaf without a gradient steps on zeros. No
    call syncs with the device."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 weight_decay: float, eps: float = 1e-8, accumulate: int = 1,
                 max_grad_norm: Optional[float] = None, betas=(0.9, 0.999), mesh=None):
        decay = no_decay_mask(model)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        groups = [
            {"params": [p for n, p in named if decay[n]], "weight_decay": weight_decay},
            {"params": [p for n, p in named if not decay[n]], "weight_decay": 0.0},
        ]
        # base lr 1.0: LambdaLR's factor is the learning rate itself
        self.adamw = AdamW(groups, lr=1.0, betas=betas, eps=eps)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule)
        self.params = [p for _, p in named]
        self.accumulate = max(1, int(accumulate))
        self.max_grad_norm = max_grad_norm
        self.mini_step = 0
        self._acc = None
        self.dp_group = axis_group(mesh, AXES.dp)
        self._synced = False

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def sync_gradients(self) -> None:
        """Sum this micro-batch's gradients over dp (once; nothing without
        dp). A parameter without a gradient takes zeros, so every rank
        reduces the same buffers."""
        if self.dp_group is None or self._synced:
            return
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        i = 0
        while i < len(grads):
            bucket, n = [], 0
            while i < len(grads) and (not bucket or n + grads[i].numel() <= _BUCKET):
                bucket.append(grads[i])
                n += grads[i].numel()
                i += 1
            flat = all_reduce_(torch.cat([g.reshape(-1).to(torch.float32) for g in bucket]),
                               self.dp_group)
            for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(part.view_as(g))
        self._synced = True

    def grad_norm(self, grads=None) -> torch.Tensor:
        """The global norm of ``grads`` (default: the parameters' own),
        each split leaf's part counted on its rank, summed over tp."""
        grads = [p.grad for p in self.params] if grads is None else grads
        grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, self.params)]
        return global_norm(grads, shards=[shard_of(p) for p in self.params])

    def _clip(self, grads) -> None:
        """optax.clip_by_global_norm: g / norm * max_norm where the global
        norm reaches max_norm, in place and on the device (a gradient of
        None counts as zeros and stays None)."""
        norm = self.grad_norm(grads)
        trigger = norm < self.max_grad_norm
        for g in grads:
            if g is not None:
                g.copy_(torch.where(trigger, g, g / norm * self.max_grad_norm))

    def step(self) -> bool:
        """Take this micro-batch's gradients (``.grad``, then cleared);
        return True where the parameters were updated."""
        self.sync_gradients()
        self._synced = False
        if self.accumulate > 1:
            # optax.MultiSteps' running mean: acc += (g - acc) / (n + 1)
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            for acc, g in zip(self._acc, grads):
                acc.add_((g - acc) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.accumulate:
                self.zero_grad()
                return False
            self.mini_step = 0
            for p, acc in zip(self.params, self._acc):
                p.grad = acc
        if self.max_grad_norm:
            self._clip([p.grad for p in self.params])
        self.adamw.step()
        self.schedule.step()
        self.zero_grad()
        if self._acc is not None:
            for acc in self._acc:
                acc.zero_()
        return True


def global_norm(tensors, shards=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), as a
    0-d fp32 tensor on the tensors' device. ``shards``: the ``Shard`` (or
    None) of each tensor, where some are a rank's part of a split leaf: the
    parts' squares are summed over their group, the others counted once."""
    squares = [torch.sum(t.to(torch.float32) ** 2) for t in tensors]
    if shards is None or all(s is None for s in shards):
        return torch.sqrt(sum(squares))
    whole = sum(q for q, s in zip(squares, shards) if s is None)
    parts = sum(q for q, s in zip(squares, shards) if s is not None)
    group = next(s.group for s in shards if s is not None)
    return torch.sqrt(whole + all_reduce_(parts.clone(), group))


def fused_adamw(model: nn.Module, schedule: Callable[[int], float], b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.01,
                accumulate: int = 1, max_grad_norm: Optional[float] = None,
                mesh=None) -> Optimizer:
    """The JAX ``fused_adamw`` (``--fused_adamw``): optax.adamw's numbers
    with the small leaves' moments batched into one vector, to save the
    TPU's per-leaf dispatches. ``make_optimizer``'s ``Optimizer`` already
    updates every leaf in one pass of one kernel launch on the card
    (``kernels/adamw.py``), so this is that ``Optimizer``, the same update."""
    return Optimizer(model, schedule, weight_decay, eps=eps, accumulate=accumulate,
                     max_grad_norm=max_grad_norm, betas=(b1, b2), mesh=mesh)


def make_optimizer(
    model: nn.Module,
    lr: float,
    total_steps: int,
    warmup_ratio: float = 0.1,
    weight_decay: float = 0.01,
    eps: float = 1e-8,
    grad_accum_steps: int = 1,
    max_grad_norm: Optional[float] = None,
    fused: bool = False,
    mesh=None,
) -> Optimizer:
    """The JAX ``make_optimizer``. The schedule horizon is optimizer steps,
    like the reference's num_training_steps // accumulate_grad_batches
    (base.py:90). ``fused`` (``--fused_adamw``) builds it through
    ``fused_adamw``, which gives the same update."""
    schedule = linear_warmup_linear_decay(
        lr, max(1, total_steps // max(1, grad_accum_steps)), warmup_ratio)
    if fused:
        return fused_adamw(model, schedule, eps=eps, weight_decay=weight_decay,
                           accumulate=grad_accum_steps, max_grad_norm=max_grad_norm,
                           mesh=mesh)
    return Optimizer(model, schedule, weight_decay, eps=eps,
                     accumulate=grad_accum_steps, max_grad_norm=max_grad_norm, mesh=mesh)


def torch_adagrad(params, lr: float, eps: float = 1e-10,
                  initial_accumulator_value: float = 0.0) -> torch.optim.Adagrad:
    """The JAX package's ``torch_adagrad`` (RSME, and ``KGETrainer``'s
    ``adagrad``): ``p -= lr * g / (sqrt(acc) + eps)`` with ``acc += g * g``
    first, eps OUTSIDE the sqrt and a zero accumulator. That is exactly what
    ``torch.optim.Adagrad(lr, lr_decay=0, eps=1e-10,
    initial_accumulator_value=0)`` computes, which this returns. Its first
    step is ``lr * g / (|g| + eps)``: ``lr * sign(g)`` wherever |g| is well
    above eps."""
    return torch.optim.Adagrad(params, lr=lr, eps=eps,
                               initial_accumulator_value=initial_accumulator_value)
