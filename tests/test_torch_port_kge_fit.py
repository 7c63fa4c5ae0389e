"""The port's KGE CLIs fit from scratch on the CPU (``--device cpu``) and
their losses fall; tools/analyze_ranks.py reads the port's rank dump
unchanged."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from mkg_analogy_tpu_torch.cli import ikrl as pikrl_cli
from mkg_analogy_tpu_torch.cli import rsme as prsme_cli
from tests.test_torch_port_kge_cli import dataset  # noqa: F401  (the fixture)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _loss_falls(log_dir, name, key):
    with open(os.path.join(log_dir, f"{name}_metrics.jsonl")) as f:
        losses = [r[key] for r in map(json.loads, f) if key in r]
    assert len(losses) >= 2 and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


def test_fits_from_scratch_on_the_cpu(dataset, tmp_path):
    """Both CLIs fit from scratch with --device cpu, and the loss falls:
    IKRL TransE (pre-train, margin; triple classification after it) then
    its fine-tune, TransAE, and RSME ComplEx; then the analyze_ranks tool
    reads the IKRL fine-tune's dump unchanged."""
    root, markg_dir, mars_dir = dataset
    logs = str(tmp_path / "logs")
    base = ["--data_dir", mars_dir, "--pretrain_path", markg_dir, "--device", "cpu",
            "--log_dir", logs, "--neg_ent", "5", "--neg_rel", "5"]
    m = pikrl_cli.main(base + ["--dim", "16", "--nbatches", "4", "--train_times", "8",
                               "--triple_classification",
                               "--output_dir", str(tmp_path / "ikrl")])
    assert 0 < m["mrr"] <= 1
    with open(os.path.join(logs, "ikrl_metrics.jsonl")) as fh:
        acc = [r for r in map(json.loads, fh) if "triple_classification/acc" in r]
    assert len(acc) == 1 and 0.5 <= acc[0]["triple_classification/acc"] <= 1
    _loss_falls(logs, "ikrl", "kge_pretrain/epoch_loss")
    dump = tmp_path / "ikrl_ranks.npz"
    m = pikrl_cli.main(base + ["--dim", "16", "--finetune", "--finetune_epochs", "12",
                               "--finetune_bsz", "8", "--finetune_lr", "0.05",
                               "--ckpt", str(tmp_path / "ikrl" / "ckpt"),
                               "--output_dir", str(tmp_path / "ikrl_ft"),
                               "--dump_ranks", str(dump)])
    assert 0 < m["mrr"] <= 1
    m = pikrl_cli.main(base + ["--transae", "--dim", "16", "--nbatches", "4",
                               "--train_times", "1", "--output_dir", str(tmp_path / "tae")])
    assert 0 < m["mrr"] <= 1
    m = prsme_cli.main(base[:8] + ["--rank", "8", "--max_epochs", "6", "--valid", "3",
                               "--batch_size", "64", "--learning_rate", "0.1",
                               "--output_dir", str(tmp_path / "rsme")])
    assert 0 < m["mrr"] <= 1
    _loss_falls(logs, "rsme", "rsme_train/loss")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "analyze_ranks.py"),
                          str(dump), "--mars_dir", mars_dir],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "n=" in out.stdout and "per mode:" in out.stdout
