"""What the benchmark may load, and when it must refuse to run.

No module that a run imports, nor any that the reference imports, has the
top-level name ``jax``, ``jaxlib``, ``flax`` or ``viquae_tpu``; the
reference imports nothing of ``viquae_torch`` either. Names are compared
whole, by the part before the first dot: ``viquae_torch`` begins with
``viquae_t`` and is not ``viquae_tpu``."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

from perfbench.tests import tiny

REPO = tiny.REPO


def child(code: str, cwd=REPO) -> subprocess.CompletedProcess:
    env = {"PATH": "/usr/bin:/bin", "HOME": str(cwd), "USE_FLAX": "0",
           "PYTHONPATH": str(REPO), "TMPDIR": tempfile.gettempdir()}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_forbidden_names_are_compared_whole():
    from perfbench.harness import forbidden_modules

    assert forbidden_modules(["viquae_torch.ir", "jaxtyping", "flaxen",
                              "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "viquae_tpu", "flax.linen",
                              "jaxlib"]) == ["flax", "jax", "jaxlib",
                                             "viquae_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    root = tiny.make_root(tmp_path / "bench")
    code = f"""
import json, sys, time, torch
torch.set_num_threads(2)
from pathlib import Path
from perfbench import harness, run
for name in ("retrieve-batch", "answer-batch", "search-online",
             "train-dpr", "train-dpr-ddp4"):
    out = harness.run_cell(Path({str(root)!r}), name, 99, 0.5, True,
                           torch.device("cpu"), time.time())
    assert out["correct"], out["limits"]
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                  "program": "viquae_torch" in sys.modules}}))
"""
    p = child(code)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "program": True}


def test_the_reference_loads_nothing_of_the_program():
    code = """
import json, sys, torch
from perfbench import gen, weights
from perfbench.reference import bert, reader, retrieval
b = dict(vocab_size=30522, hidden_size=16, num_hidden_layers=1,
         num_attention_heads=2, intermediate_size=32,
         max_position_embeddings=64, type_vocab_size=2, hidden_act="gelu",
         layer_norm_eps=1e-12)
w = weights.draw(weights.reader_shapes(b), 1, "cpu", torch.bfloat16)
q = retrieval.embed({k[5:]: v for k, v in w.items() if k.startswith("bert.")},
                    b, gen.tokenizer(), ["w1000 w1001"], 64, "cpu")
kb = gen.LazyPassages(16, 1, {"kind": "normal", "mean": 20, "sd": 2,
                              "lo": 10, "hi": 30})
rows = reader.pair_rows(gen.tokenizer(), ["w1000"], [[0, 1]], kb, 2, 64)
reader.logits(w, b, *rows, "cpu")
tops = {n.split(".")[0] for n in sys.modules}
print(json.dumps(sorted(tops & {"jax", "jaxlib", "flax", "viquae_tpu",
                                "viquae_torch"})))
"""
    p = child(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_run_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: run.py would run the cell")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "retrieve-batch", "--seed", str(2**33), "--seconds",
                        "1", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
    assert "CUDA" in p.stderr


def test_run_refuses_without_the_program(tmp_path):
    (tmp_path / "perfbench").mkdir()
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    for path in (REPO / "perfbench").rglob("*"):
        rel = path.relative_to(REPO)
        if path.is_file() and ".cache" not in rel.parts \
                and "__pycache__" not in rel.parts:
            (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(path, tmp_path / rel)
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "retrieve-batch", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin",
                            "TMPDIR": tempfile.gettempdir()})
    assert p.returncode != 0 and not p.stdout.strip()
