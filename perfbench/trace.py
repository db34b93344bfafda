"""The device trace of a window: ``torch.profiler`` (CPU and CUDA
activities) kept in memory, never written out.

Busy time is the union of the device's kernel, copy and fill intervals on
the profiler's timeline, clipped to the harness's ``perfbench.window``
range (the idea of ``chip_smoke.traced_device_busy``, l. 676, which summed
device times and so counted overlapping copies twice). Idle gaps are
labelled by the harness's own ``perfbench.*`` ranges that were open on the
host while the device waited.
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"
# gaps shorter than this are launch gaps and are not labelled one by one
LABEL_GAP_S = 50e-6


def _ns(ev, which: str) -> int:
    fn = getattr(ev, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{which}_us")()) * 1000


def _events(prof):
    """(name, device, start_ns, end_ns) of every event of the trace."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        dur = _ns(ev, "duration")
        out.append((ev.name(), ev.device_type() == torch.autograd.DeviceType.
                    CUDA, start, start + dur))
    return out


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    return merged


def summarize(events, top: int = 10) -> Optional[dict]:
    """Window length, busy seconds, device time by name and idle time by
    the harness's range that was open; None without a window range."""
    windows = [(s, e) for name, dev, s, e in events
               if not dev and name == WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0]
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    spans = []
    device = []
    for name, dev, s, e in events:
        if dev:
            lo, hi = max(s, w0), min(e, w1)
            if hi > lo:
                device.append((lo, hi))
                by_name[name][0] += 1
                by_name[name][1] += (hi - lo) / 1e9
        elif name.startswith("perfbench.") and name != WINDOW:
            spans.append((s, e, name))
    busy = union(device)
    busy_s = sum(hi - lo for lo, hi in busy) / 1e9
    gaps, at = [], w0
    for lo, hi in busy:
        if lo > at:
            gaps.append((at, lo))
        at = max(at, hi)
    if w1 > at:
        gaps.append((at, w1))
    idle: Dict[str, float] = defaultdict(float)
    spans.sort()
    starts = [s for s, _, _ in spans]
    for lo, hi in gaps:
        length = (hi - lo) / 1e9
        if length < LABEL_GAP_S:
            idle[f"gaps under {int(LABEL_GAP_S * 1e6)} us"] += length
            continue
        mid = (lo + hi) // 2
        label, best = "no perfbench range open", None
        j = bisect.bisect_right(starts, mid)
        for s, e, name in spans[max(0, j - 64): j]:
            if s <= mid <= e and (best is None or e - s < best):
                label, best = name, e - s
        idle[label] += length
    ops = sorted(((n, v[1]) for n, v in by_name.items()),
                 key=lambda t: -t[1])
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_s,
            "kernels": {n: (v[0], v[1]) for n, v in by_name.items()},
            "breakdown": {
                "device_ops": [[n[:160], s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in sorted(
                    idle.items(), key=lambda t: -t[1])[:top]]}}


class Tracer:
    """``with tracer.window():`` profiles the block when tracing is on;
    ``summary`` holds :func:`summarize`'s result afterwards."""

    def __init__(self, on: bool):
        self.on = on
        self.summary: Optional[dict] = None

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            with torch.profiler.record_function(WINDOW):
                yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self.summary = summarize(_events(prof))


def span(name: str):
    """A harness range on the host timeline (``perfbench.<name>``)."""
    return torch.profiler.record_function("perfbench." + name)
