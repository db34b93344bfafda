"""Every cell of BENCHMARK.json end to end through the harness at a tiny
size on the CPU: the last line in the contract's shape, with and without
the trace, and the reference agreeing with the port."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def expected_metrics(name: str, trace: bool) -> set:
    if not trace:
        return {m["name"] for m in BENCH["end_to_end"]
                if name in m.get("workloads", [name])}
    return {m["name"] for m in BENCH["per_layer"] if name in m["workloads"]}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(root, name, trace):
    out = tiny.run(root, name, seed=2**33 + 5, trace=trace)
    assert list(out)[-1] == "limits"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True, out["limits"]
    assert out["attempted"] > 0 and out["failed"] == 0
    got = set(out["metrics"])
    want = expected_metrics(name, trace)
    if trace:
        # on the CPU the readers of device time find nothing to read
        assert got <= want and got
        assert "busy_s" in out["device"] and "window_s" in out["device"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want
        assert out["metrics"]["setup_s"]["value"] > 0
    for m in out["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    for c in out["limits"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)
