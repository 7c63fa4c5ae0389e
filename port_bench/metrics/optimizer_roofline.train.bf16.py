"""AdamW's share of its roofline in the training slice: 28 bytes a trainable
parameter over the HBM rate against the device time of the operations
launched inside ``step.optimizer`` spans (``port_bench/bounds_adamw.py``);
it moves ``train_examples_per_s.bf16``. None where the program records no
such spans."""

from port_bench import bounds_adamw

LAYER = "host loop"
MOVES = "train_examples_per_s.bf16"


def read(run):
    return bounds_adamw.optimizer_roofline(run)
