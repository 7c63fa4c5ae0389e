"""The port's attention kernels (rows 1-5, forward and backward) against their
roofline in the training slice (``readers.attention_roofline``); it moves
``train_examples_per_s``."""

from port_bench import readers

LAYER = "kernels"
MOVES = "train_examples_per_s"


def read(run):
    return readers.attention_roofline(run, "finetune")
