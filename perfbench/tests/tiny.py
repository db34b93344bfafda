"""A checkout of the benchmark at a tiny size, for the CPU tests: the
repository's BENCHMARK.json, traffic mixes, limits and metrics, with every
configuration cut to 2 layers of width 32 and a KB of 4,096 rows, and the
mixes to a few small calls."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# random encoders this narrow map every question to nearly one vector at
# BERT's 0.02; a wider draw keeps the questions apart, as 0.02 does at 768
TINY_BERT = {"hidden_size": 32, "num_hidden_layers": 2,
             "num_attention_heads": 4, "intermediate_size": 64,
             "initializer_range": 0.2}
TINY_KB = {"kb_rows": 4096}
TINY_PORT = {"kb_dim": 32}
TINY_TRAFFIC = {"batch": 64, "batches_per_call": 2, "pool_calls": 2,
                "questions_per_call": 32, "retrieval_batch": 64,
                "pool": 256, "rate_per_s": 200, "max_batch": 16,
                "fixed_rows": 16}
TINY_CHECK = {"questions": 24}

# A cell whose files are in the repository but whose entries are held back
# from BENCHMARK.json (its rate spreads too far for ``train_items_per_s``'s
# bound): the entries a later benchmark PR appends, the cell's name going
# into the ``workloads`` of the end-to-end metric it reports.
HELD_BACK = {
    "workload": {
        "name": "train-dpr-ddp4", "config": "dpr-bert-base",
        "traffic": "dpr-train-job-ddp4", "chips": 4,
        "why": "train-dpr's recipe on 4 NCCL ranks, global 256 (64 a rank), "
               "global negatives: all-reduce, all-gather, rank skew, "
               "collation on every rank, each rank on its own CPUs"},
    "reports": "train_items_per_s",
    "per_layer": [
        {"name": "mfu.train4", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "model step"},
        {"name": "device_idle.train4", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device"},
        {"name": "collate_ms.train4", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "host collator"},
        {"name": "nccl_ms.train4", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "collectives (NCCL)"},
        {"name": "nccl_exposed.train4", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "collectives (NCCL)"}],
}


def with_held_back(data: dict) -> dict:
    """``data`` (a BENCHMARK.json) with the held-back cell appended as a
    later PR would."""
    data = json.loads(json.dumps(data))
    name = HELD_BACK["workload"]["name"]
    data["workloads"].append(dict(HELD_BACK["workload"]))
    for m in data["end_to_end"]:
        if m["name"] == HELD_BACK["reports"]:
            m["workloads"].append(name)
    data["per_layer"] += [dict(m, moves=HELD_BACK["reports"],
                               workloads=[name])
                          for m in HELD_BACK["per_layer"]]
    return data


def bench() -> dict:
    """The repository's BENCHMARK.json with the held-back cell."""
    return with_held_back(json.loads((REPO / "BENCHMARK.json").read_text()))


def tiny_config(conf: dict) -> dict:
    conf = dict(conf, **TINY_BERT,
                **{k: v for k, v in TINY_KB.items() if k in conf})
    conf["port"] = dict(conf["port"])
    for key in TINY_PORT:
        if key in conf["port"]:
            conf["port"][key] = TINY_PORT[key]
    if "retriever" in conf:
        conf["retriever"] = tiny_config(conf["retriever"])
    return conf


def make_root(tmp: Path, shrink: bool = True) -> Path:
    """A checkout under ``tmp`` whose files are the tiny copies (or, not
    ``shrink``, the repository's), with the held-back cell."""
    data = bench()
    (tmp / "perfbench").mkdir(parents=True)
    for sub in ("traffic", "limits", "metrics", "configs", "drivers"):
        shutil.copytree(REPO / "perfbench" / sub, tmp / "perfbench" / sub)
    (tmp / "BENCHMARK.json").write_text(json.dumps(data))
    if not shrink:
        return tmp
    for c in data["configs"]:
        path = tmp / c["file"]
        path.write_text(json.dumps(tiny_config(json.loads(path.read_text()))))
    for path in (tmp / "perfbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update({k: v for k, v in TINY_TRAFFIC.items() if k in t})
        t["check"] = dict(t.get("check", {}), **TINY_CHECK)
        path.write_text(json.dumps(t))
    return tmp


def run(root: Path, workload: str, seed: int = 12345678901,
        seconds: float = 1.0, trace: bool = False) -> dict:
    import time

    import torch

    from perfbench import harness

    return harness.run_cell(root, workload, seed, seconds, trace,
                            torch.device("cpu"), time.time())
