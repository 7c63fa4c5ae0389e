"""Checkpointing (``mkg_analogy_tpu/train/checkpoint.py``).

Parity: pl.ModelCheckpoint(monitor="Eval_entity/hits10",
save_weights_only) and the strict=False partial restore of
pretrain->finetune transfer (MarT/main.py:133-148). The format is
``torch.save`` of the model's state dict, ``step_<n>.pt``, with
``metrics_<n>.json`` beside it; it needs neither JAX nor orbax to read.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
from typing import Dict, List, Optional

import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}.pt")


def list_steps(directory: str) -> List[int]:
    """The steps of the checkpoints in ``directory``, ascending."""
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(directory))
                  if m)


def load(directory: str, step: Optional[int] = None,
         map_location=None) -> Dict[str, torch.Tensor]:
    """The state dict saved in ``directory`` at ``step`` (default: the
    latest); FileNotFoundError where there is none."""
    if step is None:
        steps = list_steps(directory) if os.path.isdir(directory) else []
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {directory}")
        step = steps[-1]
    return torch.load(_step_path(directory, step), map_location=map_location,
                      weights_only=True)


class Checkpointer:
    """Best-checkpoint writer with the write moved off the training loop.

    ``save`` snapshots the state dict on the device (a copy of each tensor,
    queued on the current stream, so later in-place optimizer updates do not
    reach it) and returns; a worker thread copies the snapshot to the host
    and writes it. One save is in flight at a time: a pending save is
    drained before the next save, before a restore, and in ``close``. At most ``max_to_keep`` steps stay on disk (the newest).
    """

    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pending: "queue.Queue" = queue.Queue(maxsize=1)
        self._errors: List[BaseException] = []
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()
        # Steps saved through this instance (pl.ModelCheckpoint tracks
        # best_model_path per fit; a stale directory from an earlier run
        # must not be restored as this run's best).
        self.saved_steps: List[int] = []

    def _delete(self, step: int) -> None:
        for path in (_step_path(self.directory, step),
                     os.path.join(self.directory, f"metrics_{step}.json")):
            if os.path.exists(path):
                os.remove(path)

    def _write(self, step: int, state: Dict[str, torch.Tensor],
               metrics: Optional[Dict]) -> None:
        # A reused output directory can hold this step or a later one from
        # an earlier run; within one fit steps only increase, so every
        # existing step >= the incoming one is stale: delete it first.
        for stale in list_steps(self.directory):
            if stale >= step:
                self._delete(stale)
        host = {k: v.cpu() for k, v in state.items()}
        path = _step_path(self.directory, step)
        torch.save(host, path + ".tmp")
        os.replace(path + ".tmp", path)
        if metrics is not None:
            with open(os.path.join(self.directory, f"metrics_{step}.json"), "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f)
        for old in list_steps(self.directory)[:-self.max_to_keep]:
            self._delete(old)

    def _drain(self) -> None:
        while True:
            item = self._pending.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except Exception as e:  # surfaced on the next save / flush
                self._errors.append(e)
            finally:
                self._pending.task_done()

    def flush(self) -> None:
        """Block until the enqueued save, if any, is on disk; raise its
        error if it failed."""
        self._pending.join()
        if self._errors:
            raise self._errors.pop()

    def save(self, step: int, state: Dict[str, torch.Tensor],
             metrics: Optional[Dict] = None) -> None:
        self.flush()  # one save in flight; also surfaces errors
        snapshot = {k: v.detach().clone() for k, v in state.items()}
        self._pending.put((step, snapshot, metrics))
        self.saved_steps.append(step)

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Dict[str, torch.Tensor]:
        """The state dict saved at ``step`` (default: the latest)."""
        self.flush()
        return load(self.directory, step, map_location=map_location)

    def close(self) -> None:
        if self._worker.is_alive():
            self.flush()
            self._pending.put(None)
            self._worker.join(timeout=60)


def partial_restore(state: Dict[str, torch.Tensor],
                    restored: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """strict=False-style restore: take each entry present in both with the
    same shape from ``restored``, keep ``state``'s elsewhere (main.py:134)."""
    return {k: (restored[k] if k in restored and restored[k].shape == v.shape else v)
            for k, v in state.items()}
