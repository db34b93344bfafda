"""``trace.summarize`` on made-up events: GPU user annotations count neither
in busy time nor among the device operations, and NCCL's time and its
exposed share read as the intervals say; the readers of NCCL time on the
summary."""
from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.tests import tiny
from perfbench.trace import ANNOTATION, DEVICE, HOST, WINDOW, summarize

MS = 1_000_000  # ns


def events(*device):
    """A window of 100 ms, the harness's step range over it, its GPU
    annotation, and ``device``: (name, start ms, end ms)."""
    return [(WINDOW, HOST, 0, 100 * MS),
            ("perfbench.fit_step", HOST, 0, 100 * MS),
            ("perfbench.fit_step", ANNOTATION, 0, 100 * MS)] + [
        (name, DEVICE, lo * MS, hi * MS) for name, lo, hi in device]


def read(name, summary, steps):
    run = harness.Run(None, {"steps": steps}, summary)
    return harness.metric_reader(tiny.REPO, name)(run)


def test_annotations_are_no_device_work():
    s = summarize(events(("sgemm", 10, 30), ("sgemm", 50, 60)))
    assert s["busy_s"] == pytest.approx(0.030)
    assert s["busy_s_with_annotations"] == pytest.approx(0.100)
    assert [n for n, _ in s["breakdown"]["device_ops"]] == ["sgemm"]
    assert "perfbench.fit_step" not in s["kernels"]
    # the idle time lies inside the step's range, as the host saw it
    assert dict(s["breakdown"]["idle_gaps"]) == {
        "perfbench.fit_step": pytest.approx(0.070)}
    assert s["nccl_s"] == 0 and s["nccl_exposed_s"] == 0
    assert read("nccl_ms.train4", s, 2) is None
    assert read("nccl_exposed.train4", s, 2) is None


def test_nccl_time_and_its_exposed_share():
    s = summarize(events(
        ("sgemm", 10, 30), ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 25, 45),
        ("ncclKernel_AllGather_RING_LL_Sum_int8_t", 40, 50),
        ("sgemm", 48, 70), ("ncclDevKernel_ReduceScatter", 90, 120)))
    # NCCL: 25-50 and 90-100 (clipped to the window): 35 ms; nothing else
    # runs over 30-48 and 90-100: 28 ms exposed
    assert s["nccl_s"] == pytest.approx(0.035)
    assert s["nccl_exposed_s"] == pytest.approx(0.028)
    assert s["busy_s"] == pytest.approx(0.070)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["sgemm"] == pytest.approx(0.042)
    assert ops["ncclDevKernel_AllReduce_Sum_f32_RING_LL"] == pytest.approx(
        0.020)
    assert read("nccl_ms.train4", s, 5) == pytest.approx(7.0)
    assert read("nccl_exposed.train4", s, 5) == pytest.approx(80.0)


def test_nccl_under_other_kernels_is_not_exposed():
    s = summarize(events(("sgemm", 0, 80), ("ncclDevKernel_AllReduce", 20,
                                            40)))
    assert s["nccl_s"] == pytest.approx(0.020)
    assert s["nccl_exposed_s"] == pytest.approx(0.0)
    assert read("nccl_exposed.train4", s, 1) == pytest.approx(0.0)


def test_no_window_no_summary():
    assert summarize([("sgemm", DEVICE, 0, MS)]) is None
