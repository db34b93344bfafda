"""The per-layer metrics that read the program's own spans and counters
(``viquae_torch.core.profiling.recorded()``): each cell at a tiny size,
traced, on the CPU. The host-side ones read a number; the device times
(``reader_device_ms.answer``, ``step_device_ms.train``) read nothing on the
CPU and are left out of the line."""
from __future__ import annotations

import math

import pytest
import torch

from perfbench.tests import tiny

HOST_SIDE = {
    "retrieve-batch": {"gc_share.retrieve", "tokenize_ms.retrieve"},
    "answer-batch": {"canvas_fill.answer"},
    "search-online": {"queue_wait_ms.search", "gc_share.search"},
    "train-dpr": {"canvas_fill.train", "step_host_ms.train"},
}
DEVICE_SIDE = {"reader_device_ms.answer", "step_device_ms.train"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", sorted(HOST_SIDE))
def test_program_metrics_read_the_traced_window(root, name):
    out = tiny.run(root, name, seed=2**34 + 11, trace=True)
    assert out["correct"] is True, out["limits"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert HOST_SIDE[name] <= set(got), sorted(got)
    assert not DEVICE_SIDE & set(got)
    for key in HOST_SIDE[name]:
        assert math.isfinite(got[key]) and got[key] >= 0, (key, got[key])
    if name == "retrieve-batch":
        assert 0 < got["tokenize_ms.retrieve"] \
            <= got["host_ms_per_batch.retrieve"]
    if name == "search-online":
        assert got["queue_wait_ms.search"] > 0
    for key in ("canvas_fill.answer", "canvas_fill.train"):
        if key in got:
            assert 0 < got[key] <= 100


def test_untraced_lines_hold_no_program_metric(root):
    out = tiny.run(root, "search-online", seed=2**34 + 12, trace=False)
    assert set(out["metrics"]) == {"search_p50_ms", "setup_s"}


@pytest.mark.parametrize("counters, fill", [
    ({"reader.canvas_tokens": 30, "reader.canvas_slots": 40}, 75.0),
    ({"any.canvas_tokens": 9, "any.canvas_slots": 10}, 90.0),
    ({"a.canvas_tokens": 1, "a.canvas_slots": 2,
      "b.canvas_tokens": 1, "b.canvas_slots": 4}, None),
    ({"gc.pause_s": 0.5}, None),
])
def test_canvas_fill_takes_its_counters_from_the_recording(
        monkeypatch, counters, fill):
    """The canvas reader finds the window's one ``<prefix>.canvas_*`` pair
    by itself: a new cell's canvas needs no edit of the reader."""
    from types import SimpleNamespace

    from perfbench.metrics import canvas_fill

    monkeypatch.setattr(canvas_fill, "recording",
                        lambda: SimpleNamespace(counters=counters))
    assert canvas_fill.read(None) == fill
