"""The held experts' grouped products against their roofline in the training
slice: the bound of each expert layer's six grouped products, forward and
backward (``port_bench/flops/``, ``port_bench/bounds_mla.py``: FLOPs at the
bf16 peak or bytes at the HBM rate, whichever is larger), at the rows the
traffic gives a layer, each step's tokens (images and padded text) times
the expected held slots of a token, as the FLOP count of ``mfu`` takes
them; over the device time of every operation launched inside
``moe.experts`` spans; it moves ``train_examples_per_s.bf16``. None where
the program records no such spans."""

from port_bench import bounds_mla, spans

LAYER = "kernels"
MOVES = "train_examples_per_s.bf16"


def read(run):
    j = spans.joined(run, "finetune")
    if j is None:
        return None
    spent = 1e-9 * sum(v for sid, v in j.device.items()
                       if sid is not None and j.within(sid, ("moe.experts",)))
    if spent == 0:
        return None
    cfg, fl = run.config, run.flops
    rows = run.batch * (fl.image_tokens(cfg) + run.seq_len) * fl.held_slots_per_token(cfg)
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    bound = layers * bounds_mla.grouped_bound_s(fl.expert_products(cfg, rows),
                                                cfg["n_routed_experts"], run.dtype)
    return 100.0 * bound * j.units / spent
