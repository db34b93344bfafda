"""Statistical comparison of runs (ranx.compare parity).

Used by the reference at meerqat/ir/search.py:501-505 and
ir/metrics.py:277-313 to report metric tables with paired significance
tests. Default test is the two-sided paired Fisher randomization test (the
ranx default), with a paired Student t-test alternative.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from viquae_torch.rankeval.data import Qrels, Run
from viquae_torch.rankeval.metrics import DEFAULT_METRICS, per_query_scores


def _fisher_randomization(a: np.ndarray, b: np.ndarray, n_permutations: int,
                          rng: np.random.Generator) -> float:
    """Two-sided paired randomization test p-value."""
    delta = a - b
    observed = abs(delta.mean())
    signs = rng.integers(0, 2, size=(n_permutations, len(delta))) * 2 - 1
    permuted = np.abs((signs * delta).mean(axis=1))
    return float((permuted >= observed - 1e-12).mean())


def _paired_ttest(a: np.ndarray, b: np.ndarray) -> float:
    from scipy import stats

    if np.allclose(a, b):
        return 1.0
    return float(stats.ttest_rel(a, b).pvalue)


@dataclasses.dataclass
class Report:
    model_names: List[str]
    metrics: List[str]
    scores: Dict[str, Dict[str, float]]          # run -> metric -> mean
    per_query: Dict[str, Dict[str, np.ndarray]]  # run -> metric -> (Q,)
    comparisons: Dict[str, Dict[str, List[int]]]  # run -> metric -> indices of runs it significantly beats
    max_p: float

    def to_dict(self) -> dict:
        reserved = {"metrics", "model_names", "max_p"}
        clash = reserved & set(self.model_names)
        if clash:
            # a run named "metrics" etc. would silently clobber the key
            raise ValueError(
                f"run name(s) {sorted(clash)} collide with reserved "
                "report keys; rename the run(s)")
        return {
            "metrics": self.metrics,
            "model_names": self.model_names,
            "max_p": self.max_p,
            **{
                name: {
                    "scores": self.scores[name],
                    "comparisons": self.comparisons[name],
                }
                for name in self.model_names
            },
        }

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def to_table(self) -> str:
        header = "| model | " + " | ".join(self.metrics) + " |"
        sep = "|---" * (len(self.metrics) + 1) + "|"
        rows = []
        for i, name in enumerate(self.model_names):
            cells = []
            for m in self.metrics:
                sups = "".join(
                    chr(ord("a") + j) for j in self.comparisons[name][m]
                )
                cells.append(f"{self.scores[name][m]:.4f}{('^' + sups) if sups else ''}")
            rows.append(f"| {chr(ord('a') + i)}. {name} | " + " | ".join(cells) + " |")
        return "\n".join([header, sep] + rows)

    def __str__(self):
        return self.to_table()


def compare(
    qrels: Qrels,
    runs: Sequence[Run],
    metrics: Sequence[str] = DEFAULT_METRICS,
    max_p: float = 0.01,
    stat_test: str = "fisher",
    n_permutations: int = 1000,
    seed: int = 42,
) -> Report:
    """Evaluate all runs on all metrics + pairwise significance.

    `comparisons[run][metric]` lists the indices of runs that `run`
    significantly outperforms (p <= max_p), matching ranx's superscripts.
    """
    q_ids = list(qrels.keys())
    names = [r.name or f"run_{i}" for i, r in enumerate(runs)]
    if len(set(names)) != len(names):
        # every dict below keys by run name — duplicates (trivially
        # produced by Run.from_file on same-named files in different
        # dirs) would silently collapse into one row
        raise ValueError(
            f"duplicate run names {names}; set distinct Run.name values"
        )
    rng = np.random.default_rng(seed)
    per_query = {
        name: {m: per_query_scores(qrels, run, m, q_ids=q_ids) for m in metrics}
        for name, run in zip(names, runs)
    }
    scores = {
        name: {m: float(v.mean()) for m, v in by_metric.items()}
        for name, by_metric in per_query.items()
    }
    comparisons: Dict[str, Dict[str, List[int]]] = {n: {m: [] for m in metrics} for n in names}
    for i, ni in enumerate(names):
        for j, nj in enumerate(names):
            if i == j:
                continue
            for m in metrics:
                a, b = per_query[ni][m], per_query[nj][m]
                if a.mean() <= b.mean():
                    continue
                if stat_test == "fisher":
                    p = _fisher_randomization(a, b, n_permutations, rng)
                else:
                    p = _paired_ttest(a, b)
                if p <= max_p:
                    comparisons[ni][m].append(j)
    return Report(
        model_names=names,
        metrics=list(metrics),
        scores=scores,
        per_query=per_query,
        comparisons=comparisons,
        max_p=max_p,
    )
