"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric by new files and new entries in BENCHMARK.json alone;
the harness finds each by its name."""
from __future__ import annotations

import json

import torch

from perfbench.tests import tiny


def test_a_cell_added_by_files_alone(tmp_path):
    torch.set_num_threads(2)
    root = tiny.make_root(tmp_path)
    pb = root / "perfbench"
    conf = json.loads((pb / "configs" / "dpr-bert-base.json").read_text())
    conf.update(name="dpr-three-layers", num_hidden_layers=3)
    (pb / "configs" / "dpr-three-layers.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "questions-batch.json").read_text())
    mix.update(batch=32, batches_per_call=1,
               questions={"kind": "lognormal", "median": 30, "sigma": 0.2,
                          "lo": 8, "hi": 64})
    (pb / "traffic" / "long-questions.json").write_text(json.dumps(mix))
    (pb / "limits" / "retrieve-long.json").write_text(
        (pb / "limits" / "retrieve-batch.json").read_text())
    (pb / "metrics" / "calls.py").write_text(
        "def read(run):\n    return run.facts.get('wall_s') and 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dpr-three-layers",
                             "source": "https://example.org/config",
                             "file": "perfbench/configs/"
                                     "dpr-three-layers.json",
                             "reduced": ["num_hidden_layers"],
                             "why": "a test configuration"})
    bench["workloads"].append({"name": "retrieve-long",
                               "config": "dpr-three-layers",
                               "traffic": "long-questions", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "queries_per_s":
            m["workloads"].append("retrieve-long")
    bench["per_layer"].append({
        "name": "calls.long", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "model step",
        "moves": "queries_per_s", "workloads": ["retrieve-long"]})
    bench["per_layer"].append({
        "name": "mfu.long", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "model step",
        "moves": "queries_per_s", "workloads": ["retrieve-long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = tiny.run(root, "retrieve-long")
    assert plain["correct"] is True, plain["limits"]
    assert set(plain["metrics"]) == {"queries_per_s", "setup_s"}
    traced = tiny.run(root, "retrieve-long", trace=True)
    assert traced["metrics"]["calls.long"]["value"] == 1.0
    # a metric of a kind whose reader is there needs no file of its own
    assert traced["metrics"]["mfu.long"]["value"] > 0
    assert traced["attempted"] % 32 == 0
