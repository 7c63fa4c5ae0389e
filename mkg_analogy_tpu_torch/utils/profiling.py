"""Profiling hooks (``mkg_analogy_tpu/utils/profiling.py``).

- ``trace(log_dir)`` — context manager around ``torch.profiler``: host and,
  on a card, device activity of the enclosed steps, written to
  ``log_dir/trace.json`` (Chrome / Perfetto format).
- ``StepTimer`` — per-step wall-clock stats (p50/p95) with no device
  synchronisation beyond what the caller already does.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    def __init__(self, window: int = 200):
        self.window = window
        self.samples: List[float] = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self.samples.append(time.perf_counter() - self._t0)
            self._t0 = None
            if len(self.samples) > self.window:
                del self.samples[: -self.window]

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "step_ms_p50": 1000 * s[n // 2],
            "step_ms_p95": 1000 * s[min(n - 1, int(n * 0.95))],
            "steps_per_sec": 1.0 / (sum(s) / n),
        }
