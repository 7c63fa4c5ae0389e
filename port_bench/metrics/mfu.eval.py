"""Model FLOP utilisation of the evaluation window (``readers.mfu``); it moves
``eval_examples_per_s``."""

from port_bench import readers

LAYER = "whole step"
MOVES = "eval_examples_per_s"


def read(run):
    return readers.mfu(run, "evaluate")
