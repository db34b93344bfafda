"""The control at a size a test run holds: the plain reference put in the
program's place in fp8 fails the comparison that the port passes."""
from __future__ import annotations

import math

import pytest
import torch

from perfbench import control, harness
from perfbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", ["retrieve-batch", "answer-batch",
                                  "search-online"])
def test_fp8_control_fails_where_the_port_passes(root, name):
    cell = harness.load_cell(root, name)
    limits = cell.limits["limits"]
    got = control.control(cell, 2**32 + 7, torch.device("cpu"))
    failed = [k for k, v in got.items() if not v <= limits[k]]
    assert failed, (got, limits)
    port = tiny.run(root, name, seed=2**32 + 7)
    assert port["correct"] is True, port["limits"]
    for k in failed:
        assert port["limits"][k]["value"] < got[k] or math.isinf(got[k])
