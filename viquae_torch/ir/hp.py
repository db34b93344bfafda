"""Hyperparameter search for retrieval (parity meerqat/ir/hp.py).

The reference grid-searches BM25's b/k1 with optuna's GridSampler against a
live Elasticsearch index, closing/retuning/reopening it per trial
(ir/hp.py:125-220), with sqlite trial storage (:254-313). Here the search is
an in-repo deterministic grid driver: BM25 b/k1 retuning is O(1) on the
in-memory index (ops.bm25.set_hyperparameters — no index rebuild), fusion
weights reuse rankeval.optimize_fusion, results persist to JSON (resumable:
completed trials are skipped on reload).
"""
from __future__ import annotations

import itertools
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from viquae_torch.rankeval import Qrels, Run, evaluate


class GridSearch:
    """Deterministic grid search with JSON trial storage (optuna-sqlite
    replacement)."""

    def __init__(self, param_grid: Dict[str, Sequence], storage: Optional[str] = None):
        self.param_grid = dict(param_grid)
        self.storage = Path(storage) if storage else None
        self.trials: Dict[str, float] = {}
        if self.storage and self.storage.exists():
            self.trials = json.loads(self.storage.read_text())

    def _key(self, params: dict) -> str:
        return json.dumps(params, sort_keys=True)

    def run(self, objective: Callable[[dict], float]) -> dict:
        names = list(self.param_grid)
        grid_keys = []
        for combo in itertools.product(*(self.param_grid[n] for n in names)):
            params = dict(zip(names, combo))
            key = self._key(params)
            grid_keys.append(key)
            if key in self.trials:
                continue  # resume: skip completed trials
            self.trials[key] = float(objective(params))
            if self.storage:
                self.storage.parent.mkdir(parents=True, exist_ok=True)
                self.storage.write_text(json.dumps(self.trials, indent=2))
        # argmax over the CURRENT grid only — a reused storage file can
        # carry stale trials from a different grid/metric — and NaN-safe
        # (evaluate over empty qrels yields NaN, which poisons max())
        finite = [k for k in grid_keys
                  if not np.isnan(self.trials.get(k, np.nan))]
        if not finite:
            raise ValueError(
                "no finite objective value in the current grid "
                "(all trials NaN or missing)"
            )
        best_key = max(finite, key=self.trials.get)
        return {
            "best_params": json.loads(best_key),
            "best_value": self.trials[best_key],
            "trials": self.trials,
        }


class BM25Objective:
    """Retune b/k1 on an in-memory BM25 index and re-evaluate
    (replaces ir/hp.py:125-220's ES close/put-settings/reopen dance)."""

    def __init__(self, index, queries: Dict[str, str], qrels: Qrels,
                 k: int = 100, metric: str = "mrr@100",
                 judge_fn: Optional[Callable] = None):
        self.index = index
        self.queries = queries          # q_id -> query text
        self.qrels = qrels
        self.k = k
        self.metric = metric
        self.judge_fn = judge_fn        # optional on-the-fly qrels extension

    def search(self) -> Run:
        run = {}
        q_ids = list(self.queries)
        scores, indices = self.index.search_batch(
            [self.queries[q] for q in q_ids], k=self.k
        )
        for q_id, s, i in zip(q_ids, scores, indices):
            run[q_id] = {str(d): float(v) for d, v in zip(i, s)}
        return Run(run, name=f"bm25_b{self.index.b}_k1{self.index.k1}")

    def __call__(self, params: dict) -> float:
        self.index.set_hyperparameters(
            k1=params.get("k1"), b=params.get("b")
        )
        run = self.search()
        if self.judge_fn is not None:
            self.judge_fn(run, self.qrels)
        return evaluate(self.qrels, run, self.metric)


def hyperparameter_search(
    objective: Callable[[dict], float],
    param_grid: Dict[str, Sequence],
    storage: Optional[str] = None,
    test_objective: Optional[Callable[[dict], Dict[str, float]]] = None,
) -> dict:
    """Fit on dev grid, optionally evaluate best params on test
    (parity ir/hp.py:254-313)."""
    search = GridSearch(param_grid, storage=storage)
    result = search.run(objective)
    if test_objective is not None:
        result["test_metrics"] = test_objective(result["best_params"])
    return result


DEFAULT_BM25_GRID = {
    # the reference's tuned optimum was b=0.3, k1=0.5 (EXPERIMENTS.rst:437)
    "b": [round(b, 2) for b in np.arange(0.0, 1.01, 0.1)],
    "k1": [round(k, 2) for k in np.arange(0.0, 3.01, 0.25)],
}
