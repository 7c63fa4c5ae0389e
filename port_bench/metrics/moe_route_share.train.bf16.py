"""Share of the training slice's device time in the expert layers' routing:
the operations launched inside ``moe.route``, ``moe.dispatch`` and
``moe.combine`` spans (scores, choice, sort and gather of the held experts'
rows, weighting and the sum back into the tokens) over every operation's
device time in the span slice; it moves ``train_examples_per_s.bf16``. None
where the program records no such spans."""

from port_bench import spans

LAYER = "model"
MOVES = "train_examples_per_s.bf16"
ROUTE_SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    j = spans.joined(run, "finetune")
    if j is None:
        return None
    total = sum(j.device.values())
    routed = sum(v for sid, v in j.device.items()
                 if sid is not None and j.within(sid, ROUTE_SPANS))
    if total == 0 or routed == 0:
        return None
    return 100.0 * routed / total
