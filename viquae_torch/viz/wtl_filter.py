"""Win/tie/loss dataset filtering between two runs
(parity meerqat/viz/wtl_filter.py).

"A wins" = A has a relevant result in its top-kA while B has none in its
top-kB. Filters: win, loose, intersection (both win), union (either wins),
nunion (both loose), nintersection (one looses).
"""
from __future__ import annotations

from typing import Optional, Set

from viquae_torch.rankeval import Qrels, Run
from viquae_torch.rankeval.metrics import per_query_scores


def get_wins(qrels: Qrels, run: Run, topk: int = 1) -> Set[str]:
    q_ids = list(qrels.keys())
    scores = per_query_scores(qrels, run, f"hit_rate@{topk}", q_ids=q_ids)
    return {q for q, s in zip(q_ids, scores) if s > 0}


def select_ids(qrels: Qrels, run_a: Run, run_b: Optional[Run] = None,
               filter: str = "win", k_a: int = 1, k_b: int = 1) -> Set[str]:
    all_ids = set(qrels.keys())
    wins_a = get_wins(qrels, run_a, k_a)
    wins_b = get_wins(qrels, run_b, k_b) if run_b is not None else set()
    choices = {
        "win": wins_a - wins_b,
        # two-run "loose" keeps the COMPLEMENT of (B strictly beats A) —
        # ties and A-wins included (reference switch_filter:
        # meerqat/viz/wtl_filter.py:59 `id_ not in runB_wins-runA_wins`;
        # its docstring says otherwise, the code is the contract)
        "loose": (all_ids - (wins_b - wins_a)
                  if run_b is not None else all_ids - wins_a),
        "intersection": wins_a & wins_b,
        "union": wins_a | wins_b,
        "nunion": all_ids - (wins_a | wins_b),
        "nintersection": all_ids - (wins_a & wins_b),
    }
    if filter not in choices:
        raise ValueError(f"Unknown filter {filter!r}; choose from {list(choices)}")
    return choices[filter]


def filter_dataset(dataset, qrels: Qrels, run_a: Run,
                   run_b: Optional[Run] = None, filter: str = "win",
                   k_a: int = 1, k_b: int = 1):
    keep = select_ids(qrels, run_a, run_b, filter=filter, k_a=k_a, k_b=k_b)
    # qrels/run keys are always strings; datasets may carry int ids
    return dataset.filter(lambda item: str(item["id"]) in keep)
