"""Share of the span slice's device idle time put down to the loop's thread
outside ``eval.forward`` (``spans.loop_idle_share``): the trainer's own code
between model calls; it moves ``eval_examples_per_s``."""

from port_bench import spans

LAYER = "host loop"
MOVES = "eval_examples_per_s"


def read(run):
    return spans.loop_idle_share(run, "evaluate")
