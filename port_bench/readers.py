"""The arithmetic of the per-layer metrics, shared by their readers.

Each ``port_bench/metrics/<metric>.py`` names its layer and the end-to-end
metric it moves, and reads its number through one of these functions for
its phase: "finetune" (a unit is a training step) or "evaluate" (a unit is
a pass; per-batch numbers count every batch of a pass, the padded tail's
included). A function returns None where the run holds nothing to read: no
profiled slice, another phase, no matching kernel, or no device.
"""

from __future__ import annotations

import re

from port_bench.bounds import PEAK_FLOPS_PER_S, attention_bound_s

# the port's attention kernels, rows 1-5 (kernels/attention.py, flash_attention.py)
ATTENTION_KERNEL = re.compile(r"\b(fwd|dkv|dq)(_resident|_streaming)?_kernel\b")
ELEMENTWISE = ("at::native",)  # PyTorch's own elementwise, reduction and copy kernels


def _traced(run, phase):
    return run.slice is not None and run.phase == phase


def _batches_a_pass(run):
    return -(-run.traffic["examples"] // run.batch)


def mfu(run, phase):
    """Model FLOP utilisation of the unprofiled window: the forward's matrix
    FLOPs (``port_bench/flops/``) an example, three times over for a
    training step, times the examples of the window, over its wall time and
    the peak of the configuration's dtype."""
    if run.phase != phase or run.device.type != "cuda":
        return None
    passes = 3 if phase == "finetune" else 1
    flops = passes * run.flops.forward_flops(run.config, run.seq_len) * run.window["examples"]
    return 100.0 * flops / run.window["seconds"] / PEAK_FLOPS_PER_S[run.dtype]


def launches(run, phase):
    """Kernel launches (the CUDA runtime's and driver's launch calls) a
    training step or an evaluation batch in the profiled slice."""
    if not _traced(run, phase) or run.slice.launches == 0:
        return None
    units = run.slice.units * (_batches_a_pass(run) if phase == "evaluate" else 1)
    return run.slice.launches / units


def elementwise_share(run, phase):
    """Share of the profiled slice's device time in PyTorch's own
    elementwise, reduction, normalisation and copy kernels (their names
    carry ``at::native``): where the model layer's unfused chains run."""
    if not _traced(run, phase) or run.slice.device_s == 0:
        return None
    share = run.slice.kernel_time(lambda n: any(p in n for p in ELEMENTWISE))
    return 100.0 * share / run.slice.device_s


def attention_roofline(run, phase):
    """The summed bound of the slice's attention calls, from the shapes the
    configuration sends (``port_bench/flops/``, ``port_bench/bounds.py``;
    forward and backward in training), over the device time of the port's
    attention kernels."""
    if not _traced(run, phase):
        return None
    spent = run.slice.kernel_time(
        lambda n: "at::native" not in n and ATTENTION_KERNEL.search(n))
    if spent == 0:
        return None
    calls = run.flops.attention_calls(run.config, run.batch, run.seq_len)
    training = phase == "finetune"
    units = run.slice.units * (1 if training else _batches_a_pass(run))
    return 100.0 * attention_bound_s(calls, run.dtype, backward=training) * units / spent


def device_idle_share(run, phase):
    """1 - the device's busy time a unit (the union of kernel, copy and set
    intervals in the profiled slice, over its units) over the wall time a
    unit of the unprofiled window: the profiler slows a host-bound loop, so
    the slice's own wall time would overstate the idle share."""
    if not _traced(run, phase) or run.slice.busy_s == 0:
        return None
    busy = run.slice.busy_s / run.slice.units
    units = run.window["steps"] if phase == "finetune" else run.window["passes"]
    return 100.0 * (1.0 - busy / (run.window["seconds"] / units))


def peak_mem_gb(run, phase):
    """The device memory the window allocated at its peak
    (``torch.cuda.max_memory_allocated`` over the window), in GB."""
    if run.phase != phase or run.device.type != "cuda":
        return None
    return run.window_peak / 1e9
