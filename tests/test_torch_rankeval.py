"""The port's host-only rankeval (viquae_torch/rankeval/) is a textual copy
of viquae_tpu/rankeval/ with only the package name changed, and computes
the same metrics and fusions."""
from pathlib import Path

import numpy as np
import pytest
import torch

import viquae_torch.rankeval as trank
import viquae_tpu.rankeval as jrank

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FILES = ("__init__", "data", "metrics", "compare", "fusion")


@pytest.mark.parametrize("name", FILES)
def test_copy_equals_reference_but_for_the_package_name(name):
    ours = (ROOT / "viquae_torch/rankeval" / f"{name}.py").read_text()
    ref = (ROOT / "viquae_tpu/rankeval" / f"{name}.py").read_text()
    assert ours == ref.replace("viquae_tpu", "viquae_torch")


def _runs(pkg, seed=0, n_q=12, n_docs=40, k=10):
    rng = np.random.default_rng(seed)
    qrels = pkg.Qrels({str(q): {str(d): 1 for d in rng.choice(n_docs, 3,
                                                              replace=False)}
                       for q in range(n_q)})
    runs = []
    for r in range(3):
        runs.append(pkg.Run({
            str(q): {str(d): float(s) for d, s in zip(
                rng.choice(n_docs, k, replace=False), rng.normal(size=k))}
            for q in range(n_q)}, name=f"run{r}"))
    return qrels, runs


def test_evaluate_and_fuse_agree_with_reference():
    metrics = ["mrr@10", "precision@5", "hits@10", "ndcg@10", "map@10"]
    qrels_t, runs_t = _runs(trank)
    qrels_j, runs_j = _runs(jrank)
    for run_t, run_j in zip(runs_t, runs_j):
        assert (trank.evaluate(qrels_t, run_t, metrics)
                == jrank.evaluate(qrels_j, run_j, metrics))
    for norm in ("gzmuv", "zmuv", "min-max"):
        fused_t = trank.fuse(
            [trank.normalize_run(r, norm)
             for r in trank.default_minimum(runs_t)],
            norm=None, method="wsum", params={"weights": [0.5, 0.3, 0.2]})
        fused_j = jrank.fuse(
            [jrank.normalize_run(r, norm)
             for r in jrank.default_minimum(runs_j)],
            norm=None, method="wsum", params={"weights": [0.5, 0.3, 0.2]})
        assert fused_t.to_dict() == fused_j.to_dict()
