"""The program's spans joined with the device trace: a traced run's second
profiled slice, over the same work as the first (``harness.Run._profile``),
with the spans of ``mkg_analogy_tpu_torch.utils.profiling`` recorded and
mapped onto the trace's clock (``clock_offset``).

- Each device idle gap, from the recording's start to the last operation,
  goes to the innermost span open at its middle on the thread whose launch
  call started the operation that ends it: the trace's ``correlation``
  links the operation to its runtime call, whose ``tid`` is CUPTI's id of
  the calling thread. Where that thread has no span open (the autograd
  engine's device thread between attention calls), the loop's innermost
  span takes it; where no launch is found, or neither thread has a span
  open, the gap is unattributed.
- Each device operation goes likewise to the innermost span open at its
  launch call.

The readers of ``feed_wait_ms.*``, ``loop_idle_share.*`` and
``attention_call_roofline.*`` share the slice, recorded at the first call
and kept on the run; it also prints, to stderr, the idle and device time of
each span a unit and the checks of the mapping. A program without spans
records none, and those readers return None.
"""

from __future__ import annotations

import bisect
import collections
import json
import sys
import time

import torch

from port_bench import readers
from port_bench.bounds import attention_bound_s
from port_bench.trace import DEVICE_CATEGORIES, LAUNCH_CALLS

RUNTIME = ("cuda_runtime", "cuda_driver")
MODEL_SPANS = ("step.forward", "step.backward", "step.optimizer", "eval.forward")
ATTENTION_SPANS = ("attention.fwd", "attention.bwd")
UNIT_SPAN = {"finetune": "step", "evaluate": "eval.batch"}
WAIT_SPAN = {"finetune": "step.wait", "evaluate": "eval.wait"}


class _Timeline:
    """The innermost span open at each moment on one thread, on the trace's
    clock."""

    def __init__(self, spans, offset_ns: int):
        marks = sorted(m for s in spans for m in ((s.start + offset_ns, 1, s.id),
                                                  (s.end + offset_ns, 0, s.id)))
        self.times, self.ids, stack = [], [], []
        for t, opens, sid in marks:
            if opens:
                stack.append(sid)
            else:
                stack.remove(sid)
            self.times.append(t)
            self.ids.append(stack[-1] if stack else None)

    def at(self, t: int):
        i = bisect.bisect_right(self.times, t) - 1
        return self.ids[i] if i >= 0 else None


_NO_SPANS = _Timeline((), 0)


class Joined:
    """The spans of ``rec`` (a ``profiling.Recording``) on the timeline of
    ``doc`` (a loaded Chrome trace) through ``offset``: ``idle`` and
    ``device`` (ns by span id, None for unattributed), ``idle_ns``, and
    ``attention_launches`` (launches of the port's attention kernels,
    those inside an attention span of the launching thread)."""

    def __init__(self, doc: dict, rec, offset, window_s: float = 0.0, units: int = 1):
        self.rec, self.offset, self.window_s, self.units = rec, offset, window_s, units
        self.spans = {s.id: s for s in rec.spans}
        base = int(doc.get("baseTimeNanoseconds", 0))

        def ns(ts):
            return base + round(ts * 1000)

        events = doc["traceEvents"]
        calls = {}
        for e in events:
            if e.get("cat") in RUNTIME and "dur" in e:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    calls[corr] = (e["tid"], ns(e["ts"]), e["name"])
        start = rec.anchors[0][-1][1] + offset.ns
        ops = sorted((ns(e["ts"]), ns(e["ts"] + e["dur"]), e.get("args", {}).get("correlation"),
                      e["cat"], e["name"]) for e in events
                     if e.get("cat") in DEVICE_CATEGORIES and "dur" in e)
        ops = [op for op in ops if op[0] >= start]
        self.threads = {}  # a runtime record's or a host record's thread id -> native id
        for native, cupti in rec.threads.items():
            self.threads.update({native: native, cupti: native})
        by_thread = collections.defaultdict(list)
        for s in rec.spans:
            by_thread[s.tid].append(s)
        self.lines = {tid: _Timeline(spans, offset.ns) for tid, spans in by_thread.items()}

        self.device = collections.Counter()
        self.copies = collections.Counter()  # (copy kind, span name) -> ns
        in_span = total = 0
        for s, t, corr, cat, name in ops:
            call = calls.get(corr)
            owner = self.owner(*call[:2]) if call else None
            self.device[owner] += t - s
            if cat == "gpu_memcpy":
                self.copies[(name, self.name(owner))] += t - s
            if (cat == "kernel" and "at::native" not in name and call
                    and call[2] in LAUNCH_CALLS and readers.ATTENTION_KERNEL.search(name)):
                total += 1
                own = self._line(call[0]).at(call[1])
                in_span += own is not None and self.within(own, ATTENTION_SPANS)
        self.attention_launches = (in_span, total)

        self.idle = collections.Counter()
        end = start
        for s, t, corr, _, _ in ops:  # sorted by start: each gap ends with the op after it
            if s > end:
                call = calls.get(corr)
                self.idle[self.owner(call[0], (s + end) // 2) if call else None] += s - end
            end = max(end, t)
        self.idle_ns = sum(self.idle.values())

    def _line(self, trace_tid):
        return self.lines.get(self.threads.get(trace_tid), _NO_SPANS)

    def owner(self, trace_tid, t: int):
        """The innermost span open at ``t`` on the thread ``trace_tid``,
        else on the loop's thread; None where neither has one."""
        sid = self._line(trace_tid).at(t)
        if sid is None:
            sid = self._line(self.rec.loop_tid).at(t)
        return sid

    def within(self, sid, names) -> bool:
        """Whether span ``sid`` or one of its parents is named in ``names``."""
        while sid is not None and sid in self.spans:
            if self.spans[sid].name in names:
                return True
            sid = self.spans[sid].parent
        return False

    def name(self, sid) -> str:
        return "unattributed" if sid is None else self.spans[sid].name

    def _thread_labels(self):
        """Each thread's label: "loop", "worker" (it ran ``stage``) or
        "device" (the autograd engine's)."""
        workers = {s.tid for s in self.rec.spans if s.name == "stage"}
        return {tid: "loop" if tid == self.rec.loop_tid else
                "worker" if tid in workers else "device" for tid in self.lines}

    def loop_idle_ns(self) -> int:
        """Idle put down to the loop's thread outside the model's spans."""
        return sum(v for sid, v in self.idle.items()
                   if sid is not None and self.spans[sid].tid == self.rec.loop_tid
                   and not self.within(sid, MODEL_SPANS))

    def attention_ns(self) -> int:
        return sum(v for sid, v in self.device.items()
                   if sid is not None and self.within(sid, ATTENTION_SPANS))

    def report(self, label: str, window_off_s=None, file=sys.stderr) -> None:
        """The per-span table (a unit's count, wall, idle and device ms) and
        the mapping's checks."""
        u = self.units
        inside, launched = self.attention_launches
        off = "not measured" if window_off_s is None else f"{window_off_s!r} s"
        print(f"spans {label}: offset uncertainty {self.offset.uncertainty_ns / 1e3!r} us, "
              f"anchors agree within {self.offset.agreement_ns / 1e3!r} us; {len(self.spans)} "
              f"spans, {self.rec.dropped} dropped; slice {self.window_s!r} s with spans, {off} "
              f"without; attention launches in attention spans {inside} of {launched}; "
              f"unattributed idle {self.idle[None] / 1e6!r} ms of {self.idle_ns / 1e6!r} ms",
              file=file)
        labels = self._thread_labels()

        def key(sid):
            return (self.name(sid), "-" if sid is None else labels[self.spans[sid].tid])

        rows = collections.defaultdict(lambda: [0, 0, 0, 0])
        for s in self.rec.spans:
            row = rows[key(s.id)]
            row[0] += 1
            row[1] += s.end - s.start
        for counter, col in ((self.idle, 2), (self.device, 3)):
            for sid, v in counter.items():
                rows[key(sid)][col] += v
        print("  span | thread | count/unit | ms/unit | idle ms/unit | device ms/unit", file=file)
        for (name, thread), (n, wall, idle, dev) in sorted(rows.items(), key=lambda r: -r[1][2]):
            print(f"  {name} | {thread} | {n / u:.6g} | {wall / u / 1e6:.6g} | "
                  f"{idle / u / 1e6:.6g} | {dev / u / 1e6:.6g}", file=file)
        first = {}
        for s in self.rec.spans:
            if s.name in ("fit.setup", "step") and s.name not in first:
                first[s.name] = s.end - s.start
        if first and self.window_s:
            print("  share of the slice: " + ", ".join(
                f"{k} {100 * v / 1e9 / self.window_s:.4g}%" for k, v in first.items()), file=file)
        for (kind, name), v in self.copies.most_common(8):
            print(f"  copy {kind} from {name}: {v / u / 1e6:.6g} ms/unit", file=file)


def _record(run):
    """Profile the slice's work again with the spans on; the ``Joined``
    result, or None where the program records no spans."""
    try:
        from mkg_analogy_tpu_torch.utils.profiling import clock_offset, recording
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile

    cuda = run.device.type == "cuda"
    if run.phase == "finetune":
        units = run.cell["profile_steps"]

        def work():
            run._fit(units)
    else:
        units = run.cell["profile_passes"]

        def work():
            for _ in range(units):
                run.trainer.evaluate(run.features)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        with recording() as rec:
            t0 = time.perf_counter()
            work()
            if cuda:
                torch.cuda.synchronize(run.device)
            window_s = time.perf_counter() - t0
    path = run.tmp / "span_trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    path.unlink()
    offset = clock_offset(doc, rec.anchors)
    if offset is None or not rec.spans:
        return None
    joined = Joined(doc, rec, offset, window_s, units)
    joined.report(run.cell_name, run.slice.window_s)
    return joined


def joined(run, phase):
    """The run's span slice in ``phase``, recorded at the first call; None
    untraced, in another phase, or where the program records no spans."""
    if run.slice is None or run.phase != phase:
        return None
    if not hasattr(run, "span_slice"):
        run.span_slice = _record(run)
    return run.span_slice


def feed_wait_ms(run, phase):
    """The loop's time blocked on the prefetch queue (``step.wait`` or
    ``eval.wait``) a training step or evaluation batch, in ms."""
    j = joined(run, phase)
    if j is None:
        return None
    units = sum(1 for s in j.rec.spans if s.name == UNIT_SPAN[phase])
    waits = sum(s.end - s.start for s in j.rec.spans
                if s.name == WAIT_SPAN[phase] and s.tid == j.rec.loop_tid)
    return waits / units / 1e6 if units else None


def loop_idle_share(run, phase):
    """The share of the slice's device idle time put down to the loop's
    thread outside the model's spans (``step.forward``, ``step.backward``,
    ``step.optimizer``; ``eval.forward``): the trainer's own code between
    model calls."""
    j = joined(run, phase)
    if j is None or j.idle_ns == 0:
        return None
    return 100.0 * j.loop_idle_ns() / j.idle_ns


def attention_call_roofline(run, phase):
    """``readers.attention_roofline``'s summed bound over the device time of
    every operation launched inside an ``attention.fwd`` or
    ``attention.bwd`` span: the whole call, the wrapper's own operations
    included."""
    j = joined(run, phase)
    spent = j.attention_ns() * 1e-9 if j is not None else 0
    if spent == 0:
        return None
    training = phase == "finetune"
    calls = run.flops.attention_calls(run.config, run.batch, run.seq_len)
    units = j.units * (1 if training else readers._batches_a_pass(run))
    return 100.0 * attention_bound_s(calls, run.dtype, backward=training) * units / spent
