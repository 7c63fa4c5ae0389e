"""The port's attention kernels (rows 1 and 3, forward) against their roofline
in the evaluation slice (``readers.attention_roofline``); it moves
``eval_examples_per_s``."""

from port_bench import readers

LAYER = "kernels"
MOVES = "eval_examples_per_s"


def read(run):
    return readers.attention_roofline(run, "evaluate")
