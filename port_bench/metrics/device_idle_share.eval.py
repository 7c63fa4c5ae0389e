"""Share of an evaluation pass's wall time in which the device ran nothing
(``readers.device_idle_share``); it moves ``eval_examples_per_s``."""

from port_bench import readers

LAYER = "device"
MOVES = "eval_examples_per_s"


def read(run):
    return readers.device_idle_share(run, "evaluate")
