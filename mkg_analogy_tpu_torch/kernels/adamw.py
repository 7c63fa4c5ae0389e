"""AdamW's update: its CUDA kernel, the optimizer that launches it and the
plain PyTorch version.

The port of ``optax.adamw`` (the JAX package's ``train/optim.py``) with
PyTorch's numbers: decoupled weight decay, bias-corrected moments, eps
outside the square root. JAX's update is plain ``jnp``, which XLA fuses; it
has no Pallas kernel.

- ``AdamW`` is a ``torch.optim.Optimizer`` (``param_groups`` with ``lr``,
  ``betas``, ``eps`` and ``weight_decay``, so ``LambdaLR`` drives it;
  ``state[p]`` with ``exp_avg``, ``exp_avg_sq`` and ``step``, created at the
  first step). On a card its ``step`` is one launch of the hand-written
  kernel (``csrc/adamw.cu``, built at first use by ``kernels/build.py``) for
  every ``MAX_TENSORS`` parameters: one pass that reads p, g, m and v and
  writes p, m and v, 28 bytes a parameter, in place of PyTorch's eight
  foreach passes (~80). Parameters on the CPU take the plain version.
  Nothing falls back from one to the other: on CUDA every parameter is a
  contiguous fp32 tensor of one device, and every gradient contiguous, or
  ``step`` raises. A parameter without a gradient steps on zeros, as a zero
  gradient would, so every leaf steps every time and all share one ``step``
  count. No call syncs with the device.
- ``adamw_reference`` is the plain version: PyTorch's foreach AdamW
  (``torch.optim.adam._multi_tensor_adam`` with decoupled weight decay, no
  amsgrad, not capturable), op for op. On the CPU it gives
  ``torch.optim.AdamW``'s numbers; on a card it runs PyTorch's eight
  multi-tensor kernels, and the hand-written one gives its numbers bit for
  bit (the operations, their order and their fused multiply-adds are
  PyTorch's).
- ``LAUNCHES_ADAMW`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

CHUNK = 16384        # elements a block updates at a time (a multiple of 4)
MAX_TENSORS = 3072   # parameters a launch takes (csrc/adamw.cu: kMaxTensors)
MAX_GROUPS = 4       # parameter groups (kMaxGroups)

LAUNCHES_ADAMW = 0  # kernel launches since import (or a caller's reset)


def adamw_reference(params, grads, exp_avgs, exp_avg_sqs, *, step: float, lr: float, betas,
                    eps: float, weight_decay: float) -> None:
    """One group's AdamW step in place, as ``torch.optim.AdamW(foreach=True)``
    takes it at the count ``step`` (already advanced): a gradient of None is
    zeros."""
    if not params:
        return
    beta1, beta2 = betas
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    if weight_decay != 0:
        torch._foreach_mul_(params, 1 - lr * weight_decay)
    torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
    torch._foreach_mul_(exp_avg_sqs, beta2)
    torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
    n = len(params)
    step_size = [(lr / (1 - beta1 ** step)) * -1] * n
    bias_correction2_sqrt = [(1 - beta2 ** step) ** 0.5] * n
    denom = torch._foreach_sqrt(exp_avg_sqs)
    torch._foreach_div_(denom, bias_correction2_sqrt)
    torch._foreach_add_(denom, eps)
    torch._foreach_addcdiv_(params, exp_avgs, denom, step_size)


def plan(numels, chunk: int = CHUNK, max_tensors: int = MAX_TENSORS):
    """The kernel's walk over tensors of ``numels`` elements: the chunk table
    (an (n, 2) int32 array of tensor index and chunk index in the tensor,
    tensor by tensor) and the launches, each (first tensor, end tensor,
    first chunk, end chunk) over at most ``max_tensors`` tensors."""
    counts = -(-np.asarray(numels, np.int64) // chunk)
    first = np.concatenate([[0], np.cumsum(counts)])
    tensor = np.repeat(np.arange(len(counts)), counts)
    table = np.stack([tensor, np.arange(first[-1]) - first[tensor]], axis=1).astype(np.int32)
    launches = [(t, min(t + max_tensors, len(counts)), int(first[t]),
                 int(first[min(t + max_tensors, len(counts))]))
                for t in range(0, len(counts), max_tensors)]
    return table, launches


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("adamw")
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # rows chunks chunk_begin chunk_end tensor_begin n_tensors chunk grads groups n_groups stream
    lib.mkg_adamw_step.argtypes = [p, p, i, i, i, i, n, p, p, i, p]
    lib.mkg_adamw_step.restype = ctypes.c_int
    lib.mkg_cuda_error_string.argtypes = [i]
    lib.mkg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _group_scalars(group, step: float):
    """The 8 floats of a group for the kernel (csrc/adamw.cu: Group), each
    the double PyTorch's foreach step computes on the host."""
    lr, (beta1, beta2), wd = group["lr"], group["betas"], group["weight_decay"]
    return [1 - lr * wd if wd != 0 else 1.0, 1 - beta1, beta2, 1 - beta2,
            (lr / (1 - beta1 ** step)) * -1, (1 - beta2 ** step) ** 0.5, group["eps"], 0.0]


class _Tables:
    """The kernel's device tables of one optimizer: a row a parameter (p, m,
    v, numel, group as int64) and the chunk table, and the launches."""

    def __init__(self, params, state, group_of, device):
        bad = [tuple(p.shape) for p in params
               if p.device != device or p.dtype != torch.float32 or not p.is_contiguous()]
        if bad:
            raise ValueError(
                "the AdamW kernel takes contiguous float32 parameters on one CUDA device "
                f"({device}); {len(bad)} are not, shapes {bad[:4]}: adamw_reference is the "
                "plain version for CPU tensors")
        rows = torch.tensor([[p.data_ptr(), state[p]["exp_avg"].data_ptr(),
                              state[p]["exp_avg_sq"].data_ptr(), p.numel(), g]
                             for p, g in zip(params, group_of)], dtype=torch.int64)
        chunks, self.launches = plan([p.numel() for p in params], CHUNK)
        # pinned and asynchronous: no sync with the device; the caching host
        # allocator keeps the pinned buffers until the copies have run
        self.rows = rows.pin_memory().to(device, non_blocking=True)
        self.chunks = torch.from_numpy(chunks).pin_memory().to(device, non_blocking=True)
        self.device = device


class AdamW(torch.optim.Optimizer):
    """``torch.optim.AdamW``'s update (decoupled weight decay; no amsgrad,
    maximize or capturable) in one kernel launch a step on a card: see the
    module's docstring. The parameters' and the moments' addresses are read
    when ``step`` first runs, and read again whenever a parameter's storage
    has moved or ``load_state_dict`` replaced the moments."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self._count = torch.tensor(0.0)  # every leaf's ``step`` (they all step together)
        self._addresses = None
        self._tables = None

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        self._addresses = None

    def _prepare(self, params, addresses) -> None:
        """Every leaf's moments (zeros where they are new), one shared step
        count, and on CUDA the kernel's tables."""
        if len(self.param_groups) > MAX_GROUPS:
            raise ValueError(f"the AdamW kernel takes at most {MAX_GROUPS} parameter groups, "
                             f"got {len(self.param_groups)}")
        self._count = self.state[params[0]].get("step", self._count)
        for p in params:
            state = self.state[p]
            if "exp_avg" not in state:
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["step"] = self._count
        self._tables = None
        if params[0].device.type == "cuda":
            group_of = [k for k, group in enumerate(self.param_groups) for _ in group["params"]]
            self._tables = _Tables(params, self.state, group_of, params[0].device)
        self._addresses = addresses

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for group in self.param_groups for p in group["params"]]
        if not params:
            return loss
        addresses = [p.data_ptr() for p in params]
        if addresses != self._addresses:
            self._prepare(params, addresses)
        self._count += 1
        step = self._count.item()
        if self._tables is None:
            for group in self.param_groups:
                ps = group["params"]
                adamw_reference(ps, [p.grad for p in ps],
                                [self.state[p]["exp_avg"] for p in ps],
                                [self.state[p]["exp_avg_sq"] for p in ps], step=step,
                                lr=group["lr"], betas=group["betas"], eps=group["eps"],
                                weight_decay=group["weight_decay"])
        else:
            self._launch(params, step)
        return loss

    def _launch(self, params, step: float) -> None:
        global LAUNCHES_ADAMW
        grads = [p.grad for p in params]
        if not all(g is None or g.is_contiguous() for g in grads):
            raise ValueError("the AdamW kernel takes contiguous gradients")
        pointers = (ctypes.c_uint64 * len(grads))(*(0 if g is None else g.data_ptr()
                                                     for g in grads))
        scalars = [x for group in self.param_groups for x in _group_scalars(group, step)]
        groups = (ctypes.c_float * len(scalars))(*scalars)
        tables, lib = self._tables, _lib()
        base = ctypes.addressof(pointers)
        with torch.cuda.device(tables.device):
            stream = torch.cuda.current_stream(tables.device).cuda_stream
            for t0, t1, c0, c1 in tables.launches:
                if c1 == c0:
                    continue
                err = lib.mkg_adamw_step(tables.rows.data_ptr(), tables.chunks.data_ptr(), c0,
                                         c1, t0, t1 - t0, CHUNK, base + 8 * t0, groups,
                                         len(self.param_groups), stream)
                if err != 0:
                    raise RuntimeError("adamw launch failed: "
                                       + lib.mkg_cuda_error_string(err).decode())
                LAUNCHES_ADAMW += 1
