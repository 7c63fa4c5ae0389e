"""Share of the profiled training steps' device time in PyTorch's own
elementwise kernels: where the model layer's unfused chains, gelu_poly among
them, run (``readers.elementwise_share``); it moves
``train_examples_per_s``."""

from port_bench import readers

LAYER = "model"
MOVES = "train_examples_per_s"


def read(run):
    return readers.elementwise_share(run, "finetune")
