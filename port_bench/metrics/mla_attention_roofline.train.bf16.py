"""The flash kernels (rows 3-5: forward, dK/dV and dQ) of a latent-attention
configuration against their roofline in the training slice: the bound of
every attention call the configuration sends (``port_bench/flops/``,
``port_bench/bounds_mla.py``), latent attention's causal calls with values
narrower than their queries and keys and the image tower's plain ones, over
the device time of every instance of those kernels; it moves
``train_examples_per_s.bf16``. None where the configuration sends no causal
call or the slice ran none of the kernels."""

from port_bench import bounds_mla
from port_bench.readers import ATTENTION_KERNEL

LAYER = "kernels"
MOVES = "train_examples_per_s.bf16"


def read(run):
    if run.slice is None or run.phase != "finetune":
        return None
    calls = run.flops.attention_calls(run.config, run.batch, run.seq_len)
    spent = run.slice.kernel_time(lambda n: "at::native" not in n and ATTENTION_KERNEL.search(n))
    if not any(c.get("causal") for c in calls) or spent == 0:
        return None
    bound = sum(c["count"] * bounds_mla.call_bound_s(c, run.dtype, backward=True)
                for c in calls)
    return 100.0 * bound * run.slice.units / spent
