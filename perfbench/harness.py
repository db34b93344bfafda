"""The harness: finds a cell's configuration, traffic mix, limits and
per-layer metrics by name, runs the cell's entry, judges it and prints the
result line.

Everything that belongs to one configuration, mix, cell or metric is a
file of its own, found by the names in ``BENCHMARK.json``:
``perfbench/configs/<config>.json`` (the ``file`` of the entry),
``perfbench/traffic/<traffic>.json`` (its ``entry`` names the driver: a
key of ``ENTRIES`` in ``perfbench/entries.py`` or a file
``perfbench/drivers/<entry>.py``), ``perfbench/limits/<workload>.json``
and ``perfbench/metrics/<kind>.py``, the kind being a per-layer metric's
name up to its first dot (a ``read(run)`` that returns a number or None).

A cell on several chips runs the same steps on every rank
(``perfbench/ranks.py``); rank 0 alone judges and returns the result.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "viquae_tpu")


def process_start_epoch() -> float:
    """The wall-clock time this process started (Linux /proc), so that
    set-up counts the interpreter's start and every import."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return time.time() - uptime + ticks / hz
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    root: Path
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    per_layer: List[dict]
    end_to_end: List[dict]
    # (stage, wall-clock time) of the set-up, for the result's notes
    marks: List[tuple] = dataclasses.field(default_factory=list)

    def mark(self, stage: str) -> None:
        self.marks.append((stage, time.time()))


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; the cells are "
                         f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (root / "perfbench" / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(root, w, config, traffic, limits, per_layer, e2e)


def metric_reader(root: Path, name: str) -> Callable:
    """The ``read`` of ``perfbench/metrics/<kind>.py``, the kind being the
    metric's name up to its first dot: ``mfu.retrieve`` and
    ``mfu.answer`` share ``mfu.py``."""
    kind = name.split(".", 1)[0]
    path = root / "perfbench" / "metrics" / f"{kind}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + kind.replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Run:
    """What a per-layer metric's ``read`` gets."""
    cell: Cell
    facts: Dict[str, Any]
    trace: Optional[dict]


def device_info(device, count: int, peak: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak)}


def peak_memory(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


class CollectorWatch:
    """Python's garbage collections of the window: the count of each
    generation's, the full (generation 2) ones' longest pause, and the
    objects the collector tracked when the window opened."""

    def __init__(self):
        self.pauses: Dict[int, List[float]] = {0: [], 1: [], 2: []}
        self._t0 = 0.0

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses[info["generation"]].append(
                time.perf_counter() - self._t0)

    def __enter__(self):
        self.tracked = len(gc.get_objects())
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def notes(self) -> dict:
        full = self.pauses[2]
        return {"tracked_objects": self.tracked,
                "collections": [len(self.pauses[g]) for g in range(3)],
                "full_pause_max_ms": 1e3 * max(full, default=0.0),
                "pause_total_ms": 1e3 * sum(sum(p) for p in
                                            self.pauses.values())}


def judge(compared: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, dict]:
    """Each compared number beside its limit; a number without a limit,
    or a limit without a number, is a fault of the harness."""
    if set(compared) != set(limits):
        raise RuntimeError(f"compared {sorted(compared)} but the limits "
                           f"name {sorted(limits)}")
    return {name: {"value": compared[name], "limit": limits[name]}
            for name in sorted(compared)}


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device, started: float) -> Optional[dict]:
    """Run the cell and return the result object (the last line); on a
    rank other than 0, None. Every rank traces its own window; ``busy_s``
    is their mean, the rest of the trace rank 0's."""
    from perfbench import entries, ranks
    from perfbench.trace import Tracer

    cell = load_cell(root, name)
    cell.mark("harness loaded")
    tracer = Tracer(trace)
    entry = entries.entry_class(cell.traffic["entry"], root)(cell, seed,
                                                              device)
    entry.build()
    start = time.time()
    with CollectorWatch() as watch, tracer.window():
        out = entry.window(seconds)
    rank, count = ranks.rank(), ranks.size()
    peaks = ranks.gather(peak_memory(device))
    summary = tracer.summary
    busy = ranks.gather(summary and summary["busy_s"])
    entry.release()
    entries.free(device)
    ranks.leave()
    if rank != 0:
        return None
    checks = judge(entry.judge(), cell.limits["limits"])
    setup_s = start - started
    correct = (out.attempted > 0 and out.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    dev = device_info(device, count, max(peaks))
    metrics: Dict[str, dict] = {}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed}
    notes = {}
    if count > 1:
        notes["memory_peak_bytes_by_rank"] = peaks
    if trace:
        run = Run(cell, out.facts, summary)
        for m in cell.per_layer:
            value = metric_reader(root, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            traced = [b for b in busy if b is not None]
            dev["busy_s"] = sum(traced) / len(traced)
            dev["window_s"] = summary["window_s"]
            result["breakdown"] = summary["breakdown"]
            notes["busy_s_with_annotations"] = summary[
                "busy_s_with_annotations"]
            if count > 1:
                notes["busy_s_by_rank"] = busy
    else:
        values = dict(out.values, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    stages, at = {}, started
    for stage, t in cell.marks:
        stages[stage] = t - at
        at = t
    stages["warm-up"] = start - at
    result["notes"] = dict(out.notes, setup_s=setup_s, setup_stages=stages,
                           gc=watch.notes(), **notes)
    result["limits"] = checks
    return result


def print_result(result: dict) -> None:
    for name, c in result["limits"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
