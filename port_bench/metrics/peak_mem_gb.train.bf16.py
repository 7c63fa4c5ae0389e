"""The device memory the training window allocated at its peak, in GB: a lower
peak lets a recipe leave remat off or take a larger batch
(``readers.peak_mem_gb``); it moves ``train_examples_per_s.bf16``."""

from port_bench import readers

LAYER = "device"
MOVES = "train_examples_per_s.bf16"


def read(run):
    return readers.peak_mem_gb(run, "finetune")
