"""Share of the span slice's device idle time put down to the loop's thread
outside ``step.forward``, ``step.backward`` and ``step.optimizer``
(``spans.loop_idle_share``): the trainer's own code between model calls; it
moves ``train_examples_per_s.bf16``."""

from port_bench import spans

LAYER = "host loop"
MOVES = "train_examples_per_s.bf16"


def read(run):
    return spans.loop_idle_share(run, "finetune")
