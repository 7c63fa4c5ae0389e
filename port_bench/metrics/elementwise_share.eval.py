"""Share of the profiled evaluation passes' device time in PyTorch's own
elementwise kernels: where the model layer's unfused chains, gelu_poly among
them, run (``readers.elementwise_share``); it moves ``eval_examples_per_s``."""

from port_bench import readers

LAYER = "model"
MOVES = "eval_examples_per_s"


def read(run):
    return readers.elementwise_share(run, "evaluate")
