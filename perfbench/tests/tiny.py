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


def make_root(tmp: Path) -> Path:
    """A checkout under ``tmp`` whose files are the tiny copies."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "perfbench").mkdir(parents=True)
    for sub in ("traffic", "limits", "metrics", "configs"):
        shutil.copytree(REPO / "perfbench" / sub, tmp / "perfbench" / sub)
    for c in bench["configs"]:
        path = tmp / c["file"]
        path.write_text(json.dumps(tiny_config(json.loads(path.read_text()))))
    for path in (tmp / "perfbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update({k: v for k, v in TINY_TRAFFIC.items() if k in t})
        t["check"] = dict(t.get("check", {}), **TINY_CHECK)
        path.write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run(root: Path, workload: str, seed: int = 12345678901,
        seconds: float = 1.0, trace: bool = False) -> dict:
    import time

    import torch

    from perfbench import harness

    return harness.run_cell(root, workload, seed, seconds, trace,
                            torch.device("cpu"), time.time())
