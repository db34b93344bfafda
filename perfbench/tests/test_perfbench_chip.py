"""On a machine with an NVIDIA GPU: every cell through ``run.py`` for a
short window, traced and not, correct and in the contract's shape; and
the control at the cells' own size failing the limits the port passes.
Skips elsewhere (the decision is made inside the fixture)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench.tests import tiny

REPO = tiny.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name, trace):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        name, "--seed", str(2**32 + 101), "--seconds", "3",
                        "--trace", str(trace)], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    out = last_json(p.stdout)
    assert out["correct"] is True, out["limits"]
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert out["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card_fails(card, name):
    p = subprocess.run([sys.executable, "perfbench/control.py",
                        "--workload", name, "--seeds", str(2**32 + 102)],
                       cwd=REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    got = last_json(p.stdout)
    limits = json.loads((REPO / "perfbench" / "limits" / f"{name}.json")
                        .read_text())["limits"]
    assert any(not got[k] <= v for k, v in limits.items() if k in got)
