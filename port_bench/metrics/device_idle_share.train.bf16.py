"""Share of a training step's wall time in which the device ran nothing
(``readers.device_idle_share``); it moves
``train_examples_per_s.bf16``."""

from port_bench import readers

LAYER = "device"
MOVES = "train_examples_per_s.bf16"


def read(run):
    return readers.device_idle_share(run, "finetune")
