"""Model FLOP utilisation of the training window (``readers.mfu``); it moves
``train_examples_per_s.bf16``."""

from port_bench import readers

LAYER = "whole step"
MOVES = "train_examples_per_s.bf16"


def read(run):
    return readers.mfu(run, "finetune")
