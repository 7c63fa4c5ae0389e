"""Metric logging: stdout + JSONL (+ a wandb-offline-style run directory
behind ``--wandb``). The port's copy of ``mkg_analogy_tpu/utils/logging.py``
without its TensorBoard sink, which came from Flax.

Metric names match the reference exactly ("Eval_entity/hits10", …,
lit_models/transformer.py:185-193) so downstream tooling reads the same
keys.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class WandbRunWriter:
    """Minimal wandb-compatible offline sink (reference: main.py:136-139
    attaches a pl WandbLogger behind ``--wandb``).

    The real wandb client cannot run here (zero egress, package not
    installed), so this writes the documented *files* layout of an offline
    run — ``wandb/offline-run-<ts>-<id>/files/`` with ``config.yaml``,
    ``wandb-history.jsonl`` (one JSON per log call, with ``_step`` /
    ``_timestamp`` keys as wandb emits) and a running ``wandb-summary.json``
    holding the latest value per metric. Tools that read wandb export
    directories consume these files directly.
    """

    def __init__(self, root: str = "wandb", config: Optional[dict] = None,
                 run_id: Optional[str] = None):
        ts = time.strftime("%Y%m%d_%H%M%S")
        run_id = run_id or hex(int(time.time() * 1e6) % 16**8)[2:].zfill(8)
        self.dir = os.path.join(root, f"offline-run-{ts}-{run_id}", "files")
        os.makedirs(self.dir, exist_ok=True)
        self._summary: Dict[str, float] = {}
        self._history = open(os.path.join(self.dir, "wandb-history.jsonl"), "a")
        if config is not None:
            with open(os.path.join(self.dir, "config.yaml"), "w") as f:
                f.write("wandb_version: 1\n\n")
                for k in sorted(config):
                    f.write(f"{k}:\n  value: {json.dumps(config[k])}\n")

    def log(self, step: int, record: Dict[str, float]) -> None:
        row = dict(record)
        row["_step"] = step
        row["_timestamp"] = time.time()
        self._history.write(json.dumps(row) + "\n")
        self._history.flush()
        self._summary.update(record)
        with open(os.path.join(self.dir, "wandb-summary.json"), "w") as f:
            json.dump(self._summary, f)

    def close(self) -> None:
        self._history.close()


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "train",
                 wandb: bool = False, config: Optional[dict] = None):
        self.log_dir = log_dir
        self._file = None
        self._wandb = None
        if wandb:
            self._wandb = WandbRunWriter(
                root=os.path.join(log_dir, "wandb") if log_dir else "wandb",
                config=config,
            )
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, f"{name}_metrics.jsonl"), "a")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        record = {("%s%s" % (prefix, k)): float(v) for k, v in metrics.items()}
        record["step"] = step
        record["time"] = time.time()
        line = " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items()
            if k != "time"
        )
        print(f"[metrics] {line}", flush=True)
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(
                step, {k: v for k, v in record.items() if k not in ("step", "time")}
            )

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._wandb:
            self._wandb.close()
