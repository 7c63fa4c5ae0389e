"""The loop's time blocked on the prefetch queue a evaluation batch in the span
slice (``eval.wait`` spans, ``spans.feed_wait_ms``): how long work waited on
the feed; it moves ``eval_examples_per_s``."""

from port_bench import spans

LAYER = "host loop"
MOVES = "eval_examples_per_s"


def read(run):
    return spans.feed_wait_ms(run, "evaluate")
