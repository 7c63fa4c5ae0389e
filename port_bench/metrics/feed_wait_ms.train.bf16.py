"""The loop's time blocked on the prefetch queue a training step in the span
slice (``step.wait`` spans, ``spans.feed_wait_ms``): how long work waited on
the feed; it moves ``train_examples_per_s.bf16``."""

from port_bench import spans

LAYER = "host loop"
MOVES = "train_examples_per_s.bf16"


def read(run):
    return spans.feed_wait_ms(run, "finetune")
