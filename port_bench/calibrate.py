"""The readings that the limits of a cell's correctness checks are set
from: sound runs of the program, the control and the planted faults, on
many seeds in one process (no measured window).

    python3 port_bench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--fault <name>]

One JSON line a seed. Fine-tune cells: ``sound`` (the program's checked
steps against the reference), ``control`` (the reference in the precision
below the configuration's, in the program's place: float8 products for
bfloat16, TF32 for float32), ``half`` (the reference on the first half of
each batch, the mean over those rows), ``label`` (one row's label
altered), ``unchanged`` (no parameter moved: change_gap reads 1 by its
measure), ``mode0_image`` (mode 0's image left blank) and ``rounded`` (the
reference with its products' operands rounded to the configuration's
precision: what rounding alone reads); each with the numbers of
``checks.FINETUNE_NUMBERS``. Evaluation
cells: the rank-gap numbers of ``sound``, ``control`` and ``answer`` (one
rank altered to 1). With ``--fault``, a fault of ``port_bench/faults.py``
is planted in the program first, and the line holds its readings alone
(under ``program_<name>``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _halve(batch, pixels, positions):
    n = pixels.shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}, pixels[:n], positions[:n]


def _relabel(entities):
    def alter(batch, pixels, positions):
        label = batch["label"].clone()
        label[0] = (label[0] + 1) % entities
        return {**batch, "label": label}, pixels, positions
    return alter


KEEP = ("grad_leaf", "change_leaf")


def faulty_program_readings(run, checks, fault):
    want = checks.reference_finetune(run)
    r = checks.finetune_readings(run, run.readings, want)
    return {f"program_{fault}": {k: r[k] for k in checks.FINETUNE_NUMBERS + KEEP}}


def _blank_mode0_images(batch, pixels, positions):
    """Mode 0's image (a fifth to two fifths of a batch) left blank."""
    return batch, pixels * (batch["mode"] != 0)[:, None, None, None, None], positions


def finetune_readings(run, checks, Numerics):
    want = checks.reference_finetune(run)
    bf16 = run.dtype == "bfloat16"
    control = (checks.reference_finetune(run, num=Numerics("fp8")) if bf16
               else checks.reference_finetune(run, tf32=True))
    half = checks.reference_finetune(run, alter=_halve)
    label = checks.reference_finetune(run, alter=_relabel(run.config["analogy_entities"]))
    # a witness: the reference with its products' operands rounded to the
    # configuration's own precision, what rounding alone reads
    rounded = (checks.reference_finetune(run, num=Numerics("bf16")) if bf16
               else checks.reference_finetune(run))
    mode0 = checks.reference_finetune(run, alter=_blank_mode0_images)
    unchanged = dict(want, change_norms={n: 0.0 for n in want["change_norms"]})
    label = dict(label, states=want["states"])  # the forward saw the true labels
    keep = checks.FINETUNE_NUMBERS + KEEP
    out = {}
    for name, got in (("sound", run.readings), ("control", control), ("half", half),
                      ("label", label), ("unchanged", unchanged), ("rounded", rounded),
                      ("mode0_image", mode0)):
        r = checks.finetune_readings(run, got, want)
        out[name] = {k: r[k] for k in keep}
    return out


def evaluate_readings(run, checks, Numerics):
    import torch

    path = run.tmp / "ranks_0.npz"
    run.trainer.evaluate(run.features, dump_path=str(path))
    run.free_program()
    import numpy as np
    with np.load(path) as z:
        got = z["ranks"]
    labels = run.features["label"]
    want = checks.reference_logits(run)
    bf16 = run.dtype == "bfloat16"
    low = (checks.reference_logits(run, num=Numerics("fp8")) if bf16
           else checks.reference_logits(run, tf32=True))
    answer = got.copy()
    answer[0] = 1
    out = {}
    for name, ranks in (("sound", got), ("control", checks.control_ranks(low, labels)),
                        ("answer", answer)):
        out[name] = checks.eval_readings(checks.rank_gap(ranks, want, labels),
                                         run.cell["unexplained_std"])
    del low, want
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import shutil
    import tempfile

    import torch

    from port_bench import checks, faults
    from port_bench.harness import Bench, Run
    from port_bench.reference.layers import Numerics

    bench = Bench(ROOT)
    if args.fault:
        getattr(faults, args.fault)(setattr)
    for seed in args.seeds:
        t0 = time.perf_counter()
        tmp = Path(tempfile.mkdtemp(prefix="port_bench_cal_"))
        try:
            run = Run(bench, args.workload, seed, 0.0, False, args.device, t0, tmp)
            run.setup(size_window=False)
            if run.phase == "finetune":
                run.free_program()
                out = (faulty_program_readings(run, checks, args.fault) if args.fault
                       else finetune_readings(run, checks, Numerics))
            else:
                out = evaluate_readings(run, checks, Numerics)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del run
        if args.device == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}), flush=True)


if __name__ == "__main__":
    main()
