"""The checks that decide ``correct`` fail what they must.

- The control: the reference in the program's place, computed in the
  precision below the configuration's (float8 products for the bfloat16
  cells, TF32 for the float32 cell), fails one of the cell's limits, at
  the cell's own size on the card (marked ``cuda``; run with ``python -m
  pytest -m cuda port_bench/tests`` there). ``port_bench/calibrate.py``
  reads the same on a dozen seeds.
- The faults (``port_bench/faults.py``): a run of the harness with the
  program broken underneath (a step that leaves the parameters unchanged,
  half of each batch left out with the mean over the rest, a label or an
  answer altered where it is produced, the attention backward's dq left at zero)
  reads ``correct`` false, where the same run unbroken reads true. The cells run on one chip, so no exchange between chips can be
  left out. These run in fp32 at tiny widths on the CPU, where a sound
  run's gaps are round-off, under the cells' own limits.
"""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from port_bench import checks, faults
from port_bench.harness import Bench, Run, run_cell
from port_bench.reference.layers import Numerics

SEED = 2 ** 31 + 101


def limits(cell):
    return json.loads((ROOT / "port_bench" / "workloads" / f"{cell}.json").read_text())["limits"]


def _readings_run(root, cell, device, seed=SEED):
    run = Run(Bench(root), cell, seed, 0.0, False, device, 0.0, root)
    run.setup(size_window=False)
    return run


def _fails(readings, cell):
    lim = limits(cell)
    return any(readings[k] > lim[k] for k in lim if k in readings)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mkgformer_finetune_bf16", "flava_finetune_fp32",
                                  "mkgformer_eval_bf16", "flava_finetune_bf16"])
def test_the_control_fails_each_cell_at_its_own_size(tmp_path, cell):
    """On the card, at the cell's own size, on three seeds: the control
    fails one of the cell's limits where the program's own readings pass."""
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size, on a CUDA device")
    for seed in (2 ** 31 + 7, 2 ** 31 + 8, 2 ** 31 + 9):
        run = _readings_run(ROOT, cell, "cuda", seed)
        if run.phase == "finetune":
            run.free_program()
            want = checks.reference_finetune(run)
            control = (checks.reference_finetune(run, num=Numerics("fp8"))
                       if run.dtype == "bfloat16" else checks.reference_finetune(run, tf32=True))
            sound = checks.finetune_readings(run, run.readings, want)
            low = checks.finetune_readings(run, control, want)
        else:
            path = tmp_path / f"ranks_{seed}.npz"
            run.trainer.evaluate(run.features, dump_path=str(path))
            run.free_program()
            with np.load(path) as z:
                got = z["ranks"]
            want = checks.reference_logits(run)
            labels = run.features["label"]
            low_logits = checks.reference_logits(run, num=Numerics("fp8"))
            tau = run.cell["unexplained_std"]
            sound = checks.eval_readings(checks.rank_gap(got, want, labels), tau)
            low = checks.eval_readings(
                checks.rank_gap(checks.control_ranks(low_logits, labels), want, labels), tau)
        assert not _fails(sound, cell), (seed, sound)
        assert _fails(low, cell), (seed, low)
        del run
        torch.cuda.empty_cache()


FAULTS = [(cell, fault) for cell in ("mkgformer_finetune_bf16", "flava_finetune_fp32",
                                     "flava_finetune_bf16")
          for fault in (None, faults.unchanged, faults.half_batch, faults.label,
                        faults.dq_zeroed)]
FAULTS += [("mkgformer_eval_bf16", fault)
           for fault in (None, faults.answer, faults.eval_half_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__ if f else 'sound'}" for c, f in FAULTS])
def test_a_fault_underneath_reads_not_correct(tiny_root_fp32, monkeypatch, cell, fault):
    if fault is not None:
        fault(monkeypatch.setattr)
    line = run_cell(Bench(tiny_root_fp32), cell, SEED, 0.2, False, device="cpu")
    assert line["correct"] is (fault is None), line["checks"]
