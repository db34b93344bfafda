"""Vectorized IR metrics over padded relevance matrices.

Replaces ranx.evaluate (used at meerqat/ir/search.py:497, ir/fuse.py:233).
Default metric set follows meerqat/ir/search.py:397:
mrr@100, precision@1, precision@20, hit_rate@20.

Core representation: for Q queries and a rank cutoff K, ``rel[(Q, K)]`` holds
the relevance grade of the document at each rank (0 for non-relevant or
padding). All metrics are closed-form numpy reductions over that matrix.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from viquae_torch.rankeval.data import Qrels, Run

DEFAULT_METRICS = ("mrr@100", "precision@1", "precision@20", "hit_rate@20")

# name may carry digits ("f1") — '@' is the unambiguous cutoff separator
_METRIC_RE = re.compile(r"^(?P<name>[a-z][a-z0-9_]*)(?:@(?P<k>\d+))?$")


def parse_metric(metric: str):
    m = _METRIC_RE.match(metric)
    if m is None:
        raise ValueError(f"Cannot parse metric {metric!r}")
    k = m.group("k")
    if k is not None and int(k) < 1:
        raise ValueError(f"Metric cutoff must be >= 1, got {metric!r}")
    return m.group("name"), (int(k) if k else None)


def relevance_matrix(qrels: Qrels, run: Run, k: int,
                     q_ids: Optional[Sequence[str]] = None):
    """(Q, k) graded relevance at each rank, per-query total relevant count,
    and the IDEAL top-k grades per query (from ALL qrels judgments, not just
    the retrieved ones — the NDCG denominator)."""
    if q_ids is None:
        q_ids = list(qrels.keys())
    _, doc_mat, _ = run.to_padded(q_ids, k=k)
    rel = np.zeros(doc_mat.shape, dtype=np.float64)
    n_rel = np.zeros(len(q_ids), dtype=np.float64)
    ideal = np.zeros((len(q_ids), k), dtype=np.float64)
    for row, q in enumerate(q_ids):
        judgments = qrels.to_dict().get(str(q), {})
        n_rel[row] = sum(1 for g in judgments.values() if g > 0)
        grades = sorted(judgments.values(), reverse=True)[:k]
        ideal[row, : len(grades)] = grades
        if judgments:
            for col in range(doc_mat.shape[1]):
                d = doc_mat[row, col]
                if d != "":
                    rel[row, col] = judgments.get(d, 0.0)
    return rel, n_rel, ideal


def _scores_from_rel(name: str, rel: np.ndarray, n_rel: np.ndarray, k: int,
                     ideal: Optional[np.ndarray] = None,
                     k_vec: Optional[np.ndarray] = None) -> np.ndarray:
    binary = (rel > 0).astype(np.float64)
    hits = binary.sum(axis=1)
    # cutoff-less metrics divide by each query's OWN retrieved count
    # (ranx semantics) — the padded-matrix width is a global max that
    # under-scores every query with a shorter (ragged) run
    denom = k if k_vec is None else np.maximum(k_vec, 1)
    if name in ("hits",):
        return hits
    if name in ("hit_rate", "success"):
        return (hits > 0).astype(np.float64)
    if name in ("precision", "p"):
        return hits / denom
    if name in ("recall", "r"):
        return np.where(n_rel > 0, hits / np.maximum(n_rel, 1), 0.0)
    if name == "f1":
        p = hits / denom
        r = np.where(n_rel > 0, hits / np.maximum(n_rel, 1), 0.0)
        return np.where(p + r > 0, 2 * p * r / np.maximum(p + r, 1e-12), 0.0)
    ranks = np.arange(1, rel.shape[1] + 1, dtype=np.float64)
    if name in ("mrr", "reciprocal_rank"):
        first = np.where(binary.any(axis=1), binary.argmax(axis=1) + 1, np.inf)
        return np.where(np.isfinite(first), 1.0 / first, 0.0)
    if name in ("map", "average_precision", "ap"):
        # trec_eval/ranx convention: AP@k sums precision at the relevant
        # retrieved ranks but divides by the TOTAL judged-relevant count
        # (not min(n_rel, k)) — dividing by the capped count inflates
        # map@k whenever n_rel > k
        cum_prec = np.cumsum(binary, axis=1) / ranks
        ap = (cum_prec * binary).sum(axis=1) / np.maximum(n_rel, 1)
        return np.where(n_rel > 0, ap, 0.0)
    if name == "ndcg":
        # Jarvelin formulation (ranx default): gain/log2(rank+1); IDCG from
        # the full qrels' grade multiset (NOT just retrieved docs)
        assert ideal is not None
        discounts = 1.0 / np.log2(ranks + 1)
        dcg = (rel * discounts).sum(axis=1)
        idcg = (ideal * discounts).sum(axis=1)
        return np.where(idcg > 0, dcg / np.maximum(idcg, 1e-12), 0.0)
    raise ValueError(f"Unknown metric {name!r}")


def per_query_scores(qrels: Qrels, run: Run, metric: str,
                     q_ids: Optional[Sequence[str]] = None) -> np.ndarray:
    name, k = parse_metric(metric)
    k_vec = None
    if k is None:
        k = max((len(r) for r in run.values()), default=0) or 1
        ids = list(qrels.keys()) if q_ids is None else q_ids
        run_d = run.to_dict()
        k_vec = np.asarray(
            [len(run_d.get(str(q), {})) for q in ids], np.float64)
    rel, n_rel, ideal = relevance_matrix(qrels, run, k, q_ids=q_ids)
    return _scores_from_rel(name, rel, n_rel, k, ideal=ideal, k_vec=k_vec)


def evaluate(
    qrels: Qrels,
    run: Run,
    metrics: Union[str, Iterable[str]] = DEFAULT_METRICS,
    q_ids: Optional[Sequence[str]] = None,
) -> Union[float, Dict[str, float]]:
    """Mean metric value(s) over the qrels' queries (ranx.evaluate parity).

    The padded (Q, k) relevance matrix is built ONCE at the largest
    requested cutoff and column-sliced per metric — the O(Q*k) python
    judgment-lookup loop dominates on this 1-core VM and is identical
    across metrics (rows are rank-ordered, so rel[:, :k] at a smaller k
    equals a fresh build at that k)."""
    single = isinstance(metrics, str)
    metric_list: List[str] = [metrics] if single else list(metrics)
    if q_ids is None:
        q_ids = list(qrels.keys())
    k_full = k_vec = None
    parsed = []
    for m in metric_list:
        name, k = parse_metric(m)
        if k is None:
            # cutoff-less: each query's OWN retrieved count (ranx)
            if k_full is None:
                k_full = max((len(r) for r in run.values()),
                             default=0) or 1
                run_d = run.to_dict()
                k_vec = np.asarray(
                    [len(run_d.get(str(q), {})) for q in q_ids],
                    np.float64)
            parsed.append((m, name, k_full, k_vec))
        else:
            parsed.append((m, name, k, None))
    k_max = max(p[2] for p in parsed)
    rel, n_rel, ideal = relevance_matrix(qrels, run, k_max, q_ids=q_ids)
    out = {
        m: float(_scores_from_rel(
            name, rel[:, :k_eff], n_rel, k_eff,
            ideal=ideal[:, :k_eff], k_vec=kv).mean())
        for m, name, k_eff, kv in parsed
    }
    return out[metric_list[0]] if single else out
