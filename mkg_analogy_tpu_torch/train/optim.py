"""Optimizer: AdamW with linear warmup and linear decay, BERT-style no-decay
parameter groups, gradient accumulation and global-norm clipping
(``mkg_analogy_tpu/train/optim.py``).

Parity: MarT/lit_models/transformer.py:224-241 — AdamW(eps=1e-8), weight
decay on everything except biases and LayerNorm scales, a linear schedule
with a ``warm_up_radio`` warmup fraction; ``--accumulate_grad_batches``
averages k micro-batches as ``optax.MultiSteps`` does, with the schedule
counted in optimizer steps (``total_steps // k``); ``max_grad_norm`` is
``optax.clip_by_global_norm``'s formula.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn


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
    leaves named ``bias`` and LayerNorm scales. The JAX package decides by
    the Flax leaf names ``bias`` and ``scale``; here a LayerNorm scale is
    ``<ln>.weight``, so it is found by module type, not by name. So
    ``mlm_bias``, ``adaptive_w0/w1`` and the embeddings decay, as in JAX."""
    ln_scales = {id(m.weight) for m in model.modules() if isinstance(m, nn.LayerNorm)}
    return {name: not (name.rpartition(".")[2] == "bias" or id(p) in ln_scales)
            for name, p in model.named_parameters()}


class Optimizer:
    """AdamW over two parameter groups (decay, no decay) with a ``LambdaLR``
    on the schedule; ``step`` is called after every micro-batch's backward
    and updates the parameters every ``accumulate``-th call, on the mean of
    the accumulated gradients, clipped to ``max_grad_norm``. No call syncs
    with the device."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 weight_decay: float, eps: float = 1e-8, accumulate: int = 1,
                 max_grad_norm: Optional[float] = None):
        decay = no_decay_mask(model)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        groups = [
            {"params": [p for n, p in named if decay[n]], "weight_decay": weight_decay},
            {"params": [p for n, p in named if not decay[n]], "weight_decay": 0.0},
        ]
        # base lr 1.0: LambdaLR's factor is the learning rate itself
        self.adamw = torch.optim.AdamW(groups, lr=1.0, betas=(0.9, 0.999), eps=eps)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule)
        self.params = [p for _, p in named]
        self.accumulate = max(1, int(accumulate))
        self.max_grad_norm = max_grad_norm
        self.mini_step = 0
        self._acc = None

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def _clip(self, grads) -> None:
        """optax.clip_by_global_norm: g / norm * max_norm where the global
        norm reaches max_norm, in place and on the device."""
        norm = global_norm(grads)
        trigger = norm < self.max_grad_norm
        for g in grads:
            g.copy_(torch.where(trigger, g, g / norm * self.max_grad_norm))

    def step(self) -> bool:
        """Take this micro-batch's gradients (``.grad``, then cleared);
        return True where the parameters were updated."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.accumulate > 1:
            # optax.MultiSteps' running mean: acc += (g - acc) / (n + 1)
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
            grads = self._acc
        if self.max_grad_norm:
            self._clip(grads)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.step()
        self.schedule.step()
        self.zero_grad()
        if self._acc is not None:
            for acc in self._acc:
                acc.zero_()
        return True


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), as a
    0-d fp32 tensor on the tensors' device."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tensors))


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
) -> Optimizer:
    """The JAX ``make_optimizer``. The schedule horizon is optimizer steps,
    like the reference's num_training_steps // accumulate_grad_batches
    (base.py:90). ``fused`` (``--fused_adamw``) is accepted and changes
    nothing: the JAX package's fused AdamW is optax.adamw's numbers with its
    small leaves batched into one vector, and PyTorch's AdamW already updates
    every leaf in one multi-tensor pass on the card."""
    del fused
    schedule = linear_warmup_linear_decay(
        lr, max(1, total_steps // max(1, grad_accum_steps)), warmup_ratio)
    return Optimizer(model, schedule, weight_decay, eps=eps,
                     accumulate=grad_accum_steps, max_grad_norm=max_grad_norm)
