"""Profiling hooks (``mkg_analogy_tpu/utils/profiling.py``) and the port's
spans.

- ``span(name, step=None, **attrs)`` — a named interval of the program on
  the host clock (``time.perf_counter_ns``): its thread, its parent (the span
  open on the same thread when it began), the step or batch it serves and
  small attributes. Off by default, and then one shared no-op context.
- ``set_step(step)`` — the id the loop thread gives the spans that follow,
  on every thread, until the next call; a span's ``step`` overrides it (the
  prefetch worker serves steps ahead of the loop).
- ``recording()`` — turns the spans on for its block and hands back a
  ``Recording``: the spans, each thread's id as a device trace gives it, and
  two clock anchors, at its start and at its end, each a few
  synchronisations back to back (host clock, ``torch.cuda.synchronize()``,
  host clock).
- ``clock_offset(trace, anchors)`` — the offset that maps the host clock
  onto a Chrome trace's timeline (``baseTimeNanoseconds`` plus ``ts``), from
  the trace's records of the anchors, with its uncertainty.
- ``trace(log_dir)`` — ``torch.profiler`` over the enclosed steps, host and,
  on a card, device activity, with the spans recorded over the same window
  on its timeline, to ``log_dir/trace.json`` (Chrome / Perfetto format).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

MAX_SPANS = 200_000  # a recording's bound; spans past it are counted in ``dropped``
ANCHOR = "span.anchor"  # the anchor's record in a trace of host activity (no card)
ANCHOR_CALL = "cudaDeviceSynchronize"  # its record in a trace of device activity
ANCHOR_REPEATS = 4  # synchronisations an anchor: the offset lies in each one's bracket


def cupti_thread_id() -> int:
    """The calling thread's id in a device trace's runtime records: the low
    32 bits of its pthread id read as a signed int, made positive (seen
    with CUDA 12.8 and PyTorch 2.11)."""
    low = threading.get_ident() & 0xFFFFFFFF
    return low if low < 2 ** 31 else 2 ** 32 - low


class Span(NamedTuple):
    name: str
    start: int  # ns, time.perf_counter_ns
    end: int
    tid: int  # threading.get_native_id()
    id: int
    parent: Optional[int]  # the id of the span open on the same thread
    step: Optional[int]
    attrs: Optional[dict]


class Offset(NamedTuple):
    """Host ns + ``ns`` = the trace's ns (``baseTimeNanoseconds`` + ``ts``)."""
    ns: int
    uncertainty_ns: int  # the half-width the anchors leave, plus half their disagreement
    agreement_ns: int  # |offset from the start anchor - offset from the end anchor|


class Recording:
    """What ``recording()`` gathers: ``spans`` in the order they closed,
    ``dropped`` (spans past ``capacity``), both complete once the recording
    has ended; ``threads`` (each native thread id -> its
    ``cupti_thread_id``), ``loop_tid`` (the thread that recorded) and
    ``anchors``, the start's and the end's host intervals (ns), one around
    each synchronisation.

    A span costs no system call and takes no lock: each thread's stack of
    open spans is found by ``threading.get_ident()``, and the list's append
    and the counters' ``next`` are atomic under the interpreter lock."""

    def __init__(self, capacity: int = MAX_SPANS):
        self.capacity = capacity
        self.spans: List[Span] = []
        self.dropped = 0
        self.threads: Dict[int, int] = {}
        self.loop_tid = threading.get_native_id()
        self.anchors: List[List[Tuple[int, int]]] = []
        self.step: Optional[int] = None
        self.open = True
        self._records: List[tuple] = []
        self._ids = itertools.count()
        self._closed = itertools.count()
        self._stacks: Dict[int, Tuple[int, list]] = {}  # get_ident() -> (native id, stack)

    def _thread(self) -> Tuple[int, list]:
        entry = self._stacks.get(threading.get_ident())
        if entry is None:
            native = threading.get_native_id()
            entry = self._stacks[threading.get_ident()] = (native, [])
            self.threads[native] = cupti_thread_id()
        return entry

    def _close(self) -> None:
        self.open = False
        closed = next(self._closed)
        self.spans = [Span(*r) for r in self._records]
        self.dropped = closed - len(self.spans)


class _Span:
    __slots__ = ("rec", "name", "step", "attrs", "start", "id", "parent", "tid", "stack")

    def __init__(self, rec: Recording, name: str, step, attrs):
        self.rec, self.name, self.step, self.attrs = rec, name, step, attrs

    def __enter__(self):
        rec = self.rec
        self.tid, stack = rec._thread()
        self.parent = stack[-1] if stack else None
        self.id = next(rec._ids)
        stack.append(self.id)
        self.stack = stack
        if self.step is None:
            self.step = rec.step
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        rec = self.rec
        # a span that closes after its recording ended is left out
        if rec.open and next(rec._closed) < rec.capacity:
            rec._records.append((self.name, self.start, end, self.tid, self.id, self.parent,
                                 self.step, self.attrs))
        return False


_OFF = contextlib.nullcontext()
_recording: Optional[Recording] = None


def span(name: str, step: Optional[int] = None, **attrs):
    """A context manager that records ``name`` over its block while a
    ``recording()`` is open, and does nothing otherwise."""
    rec = _recording
    if rec is None:
        return _OFF
    return _Span(rec, name, step, attrs or None)


def active() -> bool:
    """Whether spans are being recorded: a caller whose attributes cost
    something to compute asks first."""
    return _recording is not None


def set_step(step: int) -> None:
    rec = _recording
    if rec is not None:
        rec.step = step


def _anchor() -> List[Tuple[int, int]]:
    """(host ns, host ns) around each of ``ANCHOR_REPEATS``
    ``torch.cuda.synchronize()`` calls, after the current stream is drained,
    so the bracketed calls are short; without a card, around as many
    ``record_function`` blocks, for a trace of host activity."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.current_stream().synchronize()
    brackets = []
    for _ in range(ANCHOR_REPEATS):
        t0 = time.perf_counter_ns()
        if cuda:
            torch.cuda.synchronize()
        else:
            with torch.profiler.record_function(ANCHOR):
                pass
        brackets.append((t0, time.perf_counter_ns()))
    return brackets


@contextlib.contextmanager
def recording(capacity: int = MAX_SPANS):
    """Record spans over the block; yields the ``Recording``, complete
    once the block has closed. Recordings do not nest."""
    global _recording
    if _recording is not None:
        raise RuntimeError("spans are already being recorded")
    rec = Recording(capacity)
    rec.anchors.append(_anchor())
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None
        rec.anchors.append(_anchor())
        rec._close()


def _trace_ns(base: int, ts_us: float) -> int:
    return base + round(ts_us * 1000)


def _bounds(calls, brackets):
    """(lo, hi): the offsets under which each call lies inside its host
    bracket; lo > hi where the calls do not fit the brackets."""
    lo = max(c1 - b1 for (_, c1), (_, b1) in zip(calls, brackets))
    hi = min(c0 - b0 for (c0, _), (b0, _) in zip(calls, brackets))
    return lo, hi


def clock_offset(trace: dict, anchors) -> Optional[Offset]:
    """The offset from the host clock to the timeline of ``trace`` (a loaded
    Chrome trace), from the records of the first and last of ``anchors``:
    the ``ANCHOR`` annotations of a run without a card, else the trace's
    ``cudaDeviceSynchronize`` calls. Each anchor's calls are consecutive
    records, each inside its host bracket, which bounds the offset; of the
    runs of records, the pair that fits the two anchors best gives the
    middle of the two anchors' bounds. None where the trace holds no such
    pair."""
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace["traceEvents"]
    start, end = anchors[0], anchors[-1]
    marks = [e for e in events if e.get("name") == ANCHOR and "dur" in e]
    if len(marks) < len(start) + len(end):
        marks = [e for e in events if e.get("name") == ANCHOR_CALL and "dur" in e]
    calls = sorted((_trace_ns(base, e["ts"]), _trace_ns(base, e["ts"] + e["dur"]))
                   for e in marks)
    k = len(start)
    runs = [calls[i:i + k] for i in range(len(calls) - k + 1)]
    best = None
    for i, first in enumerate(runs):
        lo_a, hi_a = _bounds(first, start)
        for last in runs[i + k:]:
            lo_b, hi_b = _bounds(last, end)
            mid_a, mid_b = (lo_a + hi_a) // 2, (lo_b + hi_b) // 2
            gap = abs(mid_a - mid_b)
            misfit = max(lo_a - hi_a, 0) + max(lo_b - hi_b, 0)
            if best is None or gap + misfit < best[0]:
                width = max(abs(hi_a - lo_a), abs(hi_b - lo_b)) // 2
                best = (gap + misfit, Offset((mid_a + mid_b) // 2, width + gap // 2, gap))
    return None if best is None else best[1]


def span_events(rec: Recording, trace: dict, offset: Offset) -> List[dict]:
    """``rec``'s spans as Chrome trace events on ``trace``'s timeline, on
    the rows of their threads' host activity."""
    base, pid = int(trace.get("baseTimeNanoseconds", 0)), os.getpid()
    out = []
    for s in rec.spans:
        args = {"step": s.step, **{k: str(v) for k, v in (s.attrs or {}).items()}}
        out.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.tid,
                    "ts": (s.start + offset.ns - base) / 1e3, "dur": (s.end - s.start) / 1e3,
                    "args": args})
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with recording() as rec:
            yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    offset = clock_offset(doc, rec.anchors)
    if offset is not None:
        doc["traceEvents"].extend(span_events(rec, doc, offset))
        with open(path, "w") as f:
            json.dump(doc, f)
