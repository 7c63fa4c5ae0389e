"""The attention calls' summed bound over the device time of every operation
launched inside ``attention.fwd`` and ``attention.bwd`` spans
(``spans.attention_call_roofline``): the whole call, the wrappers' own
operations included; it moves ``train_examples_per_s.bf16``."""

from port_bench import spans

LAYER = "kernels"
MOVES = "train_examples_per_s.bf16"


def read(run):
    return spans.attention_call_roofline(run, "finetune")
