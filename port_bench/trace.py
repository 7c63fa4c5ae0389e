"""The profiled slice of a traced run: ``torch.profiler`` over a fixed amount
of work, its Chrome trace written under the run's temporary directory and
read back into what the per-layer metrics need.

- ``kernels``: device time by kernel name (the trace's ``kernel`` events);
- ``busy_s``: the union of every device interval (kernels, copies, sets);
- ``window_s``: the slice's wall time on the host clock, ending in a sync;
- ``launches``: the CUDA runtime's and driver's kernel-launch calls;
- ``breakdown``: the ten device operations that took most time, and the
  device's longest idle gaps summed by what the host was doing at their
  middle: the CUDA call in flight, or, between calls, the kernel the gap
  follows.

Only the device is traced (CUPTI's kernel, copy and runtime records): host
operations recorded too would slow a host-bound step by half and make the
device look idle.
"""

from __future__ import annotations

import bisect
import collections
import json
import time
from pathlib import Path

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
GAPS_ATTRIBUTED = 2000  # the longest idle gaps given a host operation


class Slice:
    def __init__(self, events, window_s: float, units: int):
        self.window_s, self.units = window_s, units
        device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES and "dur" in e]
        self.kernels = collections.Counter()
        for e in device:
            if e["cat"] == "kernel":
                self.kernels[e["name"]] += e["dur"] * 1e-6
        self.launches = sum(1 for e in events
                            if e.get("cat") in ("cuda_runtime", "cuda_driver")
                            and e.get("name") in LAUNCH_CALLS)
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
        merged = []
        for s, t in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_s = sum(t - s for s, t in merged) * 1e-6
        self.device_s = sum(self.kernels.values())
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)[:GAPS_ATTRIBUTED]
        calls = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                       if e.get("cat") in ("cuda_runtime", "cuda_driver") and "dur" in e)
        call_starts = [c[0] for c in calls]
        kernels = sorted((e["ts"] + e["dur"], e["name"]) for e in device)
        kernel_ends = [k[0] for k in kernels]
        by_host = collections.Counter()
        for length, s, t in gaps:
            mid = 0.5 * (s + t)
            i = bisect.bisect_right(call_starts, mid)
            if i and calls[i - 1][1] >= mid:
                what = f"in {calls[i - 1][2]}"
            else:
                j = bisect.bisect_right(kernel_ends, s) - 1
                what = f"host between CUDA calls, after {kernels[j][1][:70]}"
            by_host[what] += length * 1e-6
        self.breakdown = {
            "device_ops": [[n[:120], s] for n, s in self.kernels.most_common(10)],
            "idle_gaps": [[n[:120], s] for n, s in by_host.most_common(10)]}

    def kernel_time(self, match) -> float:
        """Seconds of the kernels whose name ``match`` accepts."""
        return sum(s for n, s in self.kernels.items() if match(n))


def profile_slice(work, units: int, device, tmp: Path) -> Slice:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        work()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    path = Path(tmp) / "slice_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return Slice(events, window_s, units)
