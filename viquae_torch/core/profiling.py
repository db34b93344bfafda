"""Named wall-clock stages and device traces (counterpart of
viquae_tpu/core/profiling.py).

:class:`StageTimer` accumulates per-stage totals and counts into a report
and can append each stage to a JSONL log. A stage given a CUDA tensor to
sync on waits for the device first, so its time covers the device work and
not only the enqueue. :func:`trace` records a ``torch.profiler`` trace of
a block (host ops and, on a GPU, its CUDA kernels) into a directory;
:func:`annotate` names a range inside it.
"""
from __future__ import annotations

import contextlib
import json
import os
import platform
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch


def device_sync(x=None):
    """Wait for pending device work when ``x`` (a tensor, or a tuple, list
    or dict of them) holds a CUDA tensor; returns ``x``."""
    if x is None:
        return None
    if isinstance(x, dict):
        leaves = list(x.values())
    elif isinstance(x, (tuple, list)):
        leaves = list(x)
    else:
        leaves = [x]
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            break
    return x


class StageTimer:
    def __init__(self, name: str = "pipeline", log_path: Optional[str] = None):
        self.name = name
        self.log_path = Path(log_path) if log_path else None
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, stage_name: str, sync_output=None):
        start = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            device_sync(holder.get("out", sync_output))
            elapsed = time.perf_counter() - start
            self.totals[stage_name] += elapsed
            self.counts[stage_name] += 1
            if self.log_path:
                self.log_path.parent.mkdir(parents=True, exist_ok=True)
                with open(self.log_path, "a") as f:
                    f.write(json.dumps({
                        "timer": self.name, "stage": stage_name,
                        "elapsed_s": round(elapsed, 6),
                    }) + "\n")

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            stage: {
                "total_s": round(self.totals[stage], 4),
                "count": self.counts[stage],
                "mean_s": round(self.totals[stage] / self.counts[stage], 6),
            }
            for stage in self.totals
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


@contextlib.contextmanager
def trace(log_dir):
    """A ``torch.profiler`` trace of everything inside the context (host
    ops, and CUDA kernels when a GPU is present), written on exit to
    ``log_dir/<host>.<pid>.pt.trace.json``: the Chrome trace format that
    TensorBoard's profile plugin and Perfetto read. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(
        log_dir / f"{platform.node()}.{os.getpid()}.pt.trace.json"))


def annotate(name: str):
    """A named range inside a trace (a ``record_function`` range: it shows
    on the host timeline and over the kernels it launches)."""
    return torch.profiler.record_function(name)
