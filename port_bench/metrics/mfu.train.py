"""Model FLOP utilisation of the training window (``readers.mfu``); it moves
``train_examples_per_s``."""

from port_bench import readers

LAYER = "whole step"
MOVES = "train_examples_per_s"


def read(run):
    return readers.mfu(run, "finetune")
