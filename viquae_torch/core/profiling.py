"""Named wall-clock stages (counterpart of viquae_tpu/core/profiling.py).

:class:`StageTimer` accumulates per-stage totals and counts into a report
and can append each stage to a JSONL log. A stage given a CUDA tensor to
sync on waits for the device first, so its time covers the device work and
not only the enqueue.
"""
from __future__ import annotations

import contextlib
import json
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
