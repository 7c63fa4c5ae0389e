"""Kernel launches a training step in the profiled slice: the host loop's cost,
which CUDA graphs or fused kernels cut (``readers.launches``); it moves
``train_examples_per_s``."""

from port_bench import readers

LAYER = "host loop"
MOVES = "train_examples_per_s"


def read(run):
    return readers.launches(run, "finetune")
