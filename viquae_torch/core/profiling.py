"""The port's in-program tracer: named stages, spans, counters and device
traces (counterpart of viquae_tpu/core/profiling.py).

Tracing is on exactly while a ``torch.profiler`` profile is active anywhere
in the process (:func:`tracing`): an operator's :func:`trace` of a server or
a training job, or any other profiled run. While it is on:

- :func:`span` records an interval on the profiler's own clock
  (``time.time_ns()``, the epoch scale of its events) with its thread, its
  parent (the span open in that thread when it started) and attributes;
- :func:`device_span` adds the device time of the work enqueued inside it,
  from a pair of CUDA events resolved when the recorder is read;
- :func:`count` adds to a named counter;
- the collector's pauses add up in the ``gc.pause_s`` counter, and each
  full collection is a ``python.gc`` span.

:func:`recorded` hands back what was recorded since tracing last turned on.
With tracing off a span costs one flag read: it records nothing, reads no
clock and creates no event. Spans are the recorder's own, never
``record_function`` ranges, so they add nothing to the profiler's events;
:func:`trace` writes them into the Chrome trace file beside those events.
A finished span is kept as one flat tuple of numbers and strings, which
the collector stops tracking at its first pass over it (at its second where
an attribute is itself a tuple, such as a dispatch's request ids): a
window's thousands of spans add nothing to the walk of a full collection.

:class:`StageTimer` accumulates per-stage totals and counts into a report
(host wall clock); each stage is also a span named ``<timer>.<stage>``.
:func:`annotate` names a ``record_function`` range inside a trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import os
import platform
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler


def tracing() -> bool:
    """Whether a torch profiler is active anywhere in the process. The flag
    read here is process-wide: every thread sees it while a profile runs
    (``torch._C._autograd._profiler_enabled()`` is true only in the thread
    that started the profile)."""
    return _profiler._is_profiler_enabled


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded interval. ``start_ns`` / ``end_ns`` are on the
    profiler's clock; ``thread`` is the native thread id (the ``tid`` of
    the profiler's events); ``device_s`` is a device span's time on the
    device, None for a host span or where no device work was timed."""
    id: int
    name: str
    start_ns: int
    end_ns: Optional[int]
    thread: int
    parent: Optional[int]
    attrs: Dict[str, Any]
    device_s: Optional[float] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class Recording:
    """What :func:`recorded` returns: finished spans in the order they
    ended, and the counters."""
    spans: List[Span]
    counters: Dict[str, float]

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
# finished spans as flat rows (id, name, start_ns, end_ns, thread, parent,
# key, value, key, value, ...), which the collector stops tracking
_rows: List[tuple] = []
# a device span's id -> its CUDA events, until recorded() reads them
_events: Dict[int, tuple] = {}
_counters: Dict[str, float] = {}
# the state the recorder last saw, to notice tracing turning on and off
_was_on = False
# whether tracing was ever on, so that the collector was hooked
_started = False
# written by the collector's hook alone (collections never overlap)
_gc_rows: List[tuple] = []
_gc_pause_ns = 0
_gc_started: Optional[int] = None


def _on() -> bool:
    """``tracing()``, acting on a turn: on from off starts a new recording
    and hooks the collector, off from on unhooks it."""
    on = _profiler._is_profiler_enabled
    if on != _was_on:
        _turn(on)
    return on


def _turn(on: bool, restart: bool = False) -> None:
    global _was_on, _started, _gc_pause_ns, _gc_started
    with _lock:
        if on == _was_on and not restart:
            return
        _was_on = on
        if on:
            _started = True
            _rows.clear()
            _events.clear()
            _counters.clear()
            _gc_rows.clear()
            _gc_pause_ns, _gc_started = 0, None
            if _gc_hook not in gc.callbacks:
                gc.callbacks.append(_gc_hook)
        elif _gc_hook in gc.callbacks:
            gc.callbacks.remove(_gc_hook)


def _gc_hook(phase: str, info: dict) -> None:
    global _gc_pause_ns, _gc_started
    if not _profiler._is_profiler_enabled:
        # tracing went off: inert until the next span unhooks it
        _gc_started = None
        return
    if phase == "start":
        _gc_started = time.time_ns()
        return
    if _gc_started is None:     # hooked in the middle of a collection
        return
    end = time.time_ns()
    _gc_pause_ns += end - _gc_started
    if info["generation"] == 2:
        stack = getattr(_local, "stack", None)
        _gc_rows.append((next(_ids), "python.gc", _gc_started, end,
                         threading.get_native_id(),
                         stack[-1] if stack else None,
                         "collected", info["collected"]))
    _gc_started = None


def _open(name: str, attrs: dict) -> Span:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    s = Span(next(_ids), name, 0, None, threading.get_native_id(),
             stack[-1] if stack else None, attrs)
    stack.append(s.id)
    s.start_ns = time.time_ns()
    return s


def _close(s: Span, events: Optional[tuple] = None) -> None:
    s.end_ns = time.time_ns()
    _local.stack.pop()
    row = (s.id, s.name, s.start_ns, s.end_ns, s.thread, s.parent,
           *itertools.chain.from_iterable(s.attrs.items()))
    with _lock:
        _rows.append(row)
        if events is not None:
            _events[s.id] = events


class span:
    """``with span(name, **attrs) as s:`` records the block as a span while
    tracing is on; ``s`` is its :class:`Span` (its ``id``, ``start_ns`` and
    ``attrs`` may be read and added to inside the block), or None with
    tracing off."""

    __slots__ = ("name", "attrs", "record")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.record: Optional[Span] = None

    def __enter__(self) -> Optional[Span]:
        if _on():
            self.record = _open(self.name, self.attrs)
        return self.record

    def __exit__(self, *exc) -> None:
        if self.record is not None:
            _close(self.record)


class device_span(span):
    """A :class:`span` that also times the device work enqueued inside it on
    the current CUDA stream of ``device`` (the current device by default),
    between two CUDA events. The host never waits for them here: the time
    is resolved when :func:`recorded` reads the span. ``device_s`` stays
    None where no CUDA device is in use."""

    __slots__ = ("device", "stream", "start")

    def __init__(self, name: str, device=None, **attrs):
        super().__init__(name, **attrs)
        self.device = device

    def __enter__(self) -> Optional[Span]:
        if not _on():
            return None
        self.stream = None
        device = self.device
        if torch.cuda.is_initialized() and (
                device is None or torch.device(device).type == "cuda"):
            self.stream = torch.cuda.current_stream(device)
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.record = _open(self.name, self.attrs)
        return self.record

    def __exit__(self, *exc) -> None:
        s = self.record
        if s is None:
            return
        events = None
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            events = (self.start, end)
        _close(s, events)


def interval(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Records a span whose ends were read before (on ``time.time_ns()``),
    such as a request's wait from its arrival in one thread to its
    dispatch in another; nothing with tracing off."""
    if _on():
        with _lock:
            _rows.append((next(_ids), name, start_ns, end_ns,
                          threading.get_native_id(), None,
                          *itertools.chain.from_iterable(attrs.items())))


def count(name: str, n: float = 1) -> None:
    """Adds ``n`` to the counter ``name`` while tracing is on."""
    if _on():
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def count_canvas(prefix: str, segment_ids: np.ndarray) -> None:
    """A packed canvas's fill: its real tokens (non-zero segment ids) into
    ``<prefix>.canvas_tokens`` and its slots (rows x row length) into
    ``<prefix>.canvas_slots``, while tracing is on."""
    if _on():
        count(f"{prefix}.canvas_tokens", int(np.count_nonzero(segment_ids)))
        count(f"{prefix}.canvas_slots", int(segment_ids.size))


def recorded() -> Recording:
    """The spans and counters recorded since tracing last turned on (the
    traced window, read during it or after it). Device spans get their
    device time here, waiting for their end events where needed."""
    _on()
    with _lock:
        rows = _rows + _gc_rows
        events = dict(_events)
        counters = dict(_counters)
    if _started:
        counters["gc.pause_s"] = _gc_pause_ns / 1e9
    spans = []
    for i, name, start_ns, end_ns, thread, parent, *attrs in rows:
        s = Span(i, name, start_ns, end_ns, thread, parent,
                 dict(zip(attrs[::2], attrs[1::2])))
        if i in events:
            start, end = events[i]
            end.synchronize()
            s.device_s = start.elapsed_time(end) / 1e3
        spans.append(s)
    spans.sort(key=lambda s: s.end_ns)
    return Recording(spans, counters)


class StageTimer:
    """Named stages of a pipeline: host wall-clock totals and counts for
    :meth:`report`, each stage also a span ``<name>.<stage>``. Stages may
    run in several threads at once (a prefetch producer, a server's
    workers): the totals are kept under a lock."""

    def __init__(self, name: str = "pipeline"):
        self.name = name
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, stage_name: str):
        start = time.perf_counter()
        try:
            with span(f"{self.name}.{stage_name}"):
                yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                self.totals[stage_name] += elapsed
                self.counts[stage_name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            rows = [(stage, self.totals[stage], self.counts[stage])
                    for stage in self.totals]
        return {
            stage: {
                "total_s": round(total, 4),
                "count": n,
                "mean_s": round(total / n, 6),
            }
            for stage, total, n in rows
        }

    def __str__(self):
        lines = [f"[{self.name}]"]
        for stage, row in sorted(
            self.report().items(), key=lambda kv: -kv[1]["total_s"]
        ):
            lines.append(
                f"  {stage:<30} {row['total_s']:>9.3f}s total "
                f"({row['count']}x, {row['mean_s'] * 1e3:.2f} ms/call)"
            )
        return "\n".join(lines)


def _chrome_events(rec: Recording, base_ns: int) -> List[dict]:
    """The recording as Chrome trace events on the profiler's timeline:
    complete events for the spans (in the thread that ran them), and each
    counter's total at the end of the trace."""
    pid = os.getpid()
    events = []
    for s in rec.spans:
        args = dict(s.attrs, id=s.id, parent=s.parent)
        if s.device_s is not None:
            args["device_ms"] = s.device_s * 1e3
        events.append({"ph": "X", "cat": "viquae", "name": s.name,
                       "pid": pid, "tid": s.thread,
                       "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    if rec.counters and rec.spans:
        end = max(s.end_ns for s in rec.spans)
        for name, value in sorted(rec.counters.items()):
            events.append({"ph": "C", "cat": "viquae", "name": name,
                           "pid": pid, "tid": 0,
                           "ts": (end - base_ns) / 1e3,
                           "args": {"value": value}})
    return events


@contextlib.contextmanager
def trace(log_dir):
    """A ``torch.profiler`` trace of everything inside the context, in every
    thread (host ops, and CUDA kernels when a GPU is present), written on
    exit to ``log_dir/<host>.<pid>.pt.trace.json``: the Chrome trace format
    that TensorBoard's profile plugin and Perfetto read. The file also
    holds the spans and counters recorded meanwhile (category
    ``viquae``), on the same timeline, so that each idle gap of the device
    lies beside the batcher, embedder, reader or collator span that was
    open. Yields the profiler."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    # every thread's ranges, not only those of the thread that starts it
    all_threads = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities,
                 experimental_config=all_threads) as prof:
        _turn(True, restart=True)
        yield prof
    rec = recorded()
    path = log_dir / f"{platform.node()}.{os.getpid()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    data["traceEvents"].extend(_chrome_events(
        rec, int(data.get("baseTimeNanoseconds", 0))))
    path.write_text(json.dumps(data, default=str))


def annotate(name: str):
    """A named range inside a trace (a ``record_function`` range: it shows
    on the host timeline and over the kernels it launches)."""
    return torch.profiler.record_function(name)
