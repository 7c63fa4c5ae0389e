"""Kernel launches an evaluation batch in the profiled slice
(``readers.launches``); it moves ``eval_examples_per_s``."""

from port_bench import readers

LAYER = "host loop"
MOVES = "eval_examples_per_s"


def read(run):
    return readers.launches(run, "evaluate")
