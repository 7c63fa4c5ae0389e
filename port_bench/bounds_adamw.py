"""The bound of an AdamW step on one NVIDIA H100 SXM (``port_bench/bounds.py``'s
HBM rate) and its share in the training slice.

One update reads each trainable parameter's value, gradient and two moments
and writes the value and the moments, all fp32: 28 bytes a parameter, each
once. The share is that bound over the device time of every operation
launched inside ``step.optimizer`` spans (the update, the gradients' clip or
running mean where the recipe has them, and the moments' zeros at a fit's
first step), a step.
"""

from __future__ import annotations

from port_bench import spans
from port_bench.bounds import HBM_BYTES_PER_S

ADAMW_BYTES = 28  # p, g, m and v read, p, m and v written, fp32


def optimizer_roofline(run):
    """The share in % of the training slice; None where the program records
    no ``step.optimizer`` span or launched nothing inside one."""
    j = spans.joined(run, "finetune")
    if j is None:
        return None
    spent = 1e-9 * sum(v for sid, v in j.device.items()
                       if sid is not None and j.within(sid, ("step.optimizer",)))
    if spent == 0:
        return None
    trainable = sum(p.numel() for p in run.trainer.model.parameters() if p.requires_grad)
    return 100.0 * ADAMW_BYTES * trainable / HBM_BYTES_PER_S * j.units / spent
