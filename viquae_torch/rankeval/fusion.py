"""Score normalization + late fusion + weight optimization.

Replaces ranx.fuse / ranx.optimize_fusion plus the custom numba gzmuv norm of
meerqat/ir/fuse.py:86-129 and its default-minimum imputation
(ir/fuse.py:132-149). The numba dict-kernels become flat vectorized numpy:
each run is flattened to (doc_count,) score vectors with per-query segment
ids, so norms are segment reductions.

Norms: min-max, max, sum, zmuv (per query), gzmuv (global over the run,
the reference's custom norm), rank, borda. Methods: wsum, sum (wsum with
equal weights), max, min, mnz, rrf.
"""
from __future__ import annotations

import itertools
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from viquae_torch.rankeval.data import Qrels, Run
from viquae_torch.rankeval.metrics import evaluate


# --------------------------------------------------------------------------
# flat representation: one run -> (q_index[], scores[]) + per-query slices
# --------------------------------------------------------------------------
class _FlatRun:
    def __init__(self, run: Run):
        self.name = run.name
        self.q_ids: List[str] = []
        self.doc_ids: List[str] = []
        offsets = [0]
        scores = []
        for q, results in run.items():
            self.q_ids.append(q)
            for d, s in results.items():
                self.doc_ids.append(d)
                scores.append(s)
            offsets.append(len(scores))
        self.scores = np.asarray(scores, dtype=np.float64)
        self.offsets = np.asarray(offsets, dtype=np.int64)

    def to_run(self) -> Run:
        data = {}
        for i, q in enumerate(self.q_ids):
            lo, hi = self.offsets[i], self.offsets[i + 1]
            data[q] = dict(zip(self.doc_ids[lo:hi], self.scores[lo:hi].tolist()))
        return Run(data, name=self.name)

    def segment_apply(self, fn):
        """Apply fn(scores_segment) -> scores_segment per query."""
        out = self.scores.copy()
        for i in range(len(self.q_ids)):
            lo, hi = self.offsets[i], self.offsets[i + 1]
            if hi > lo:
                out[lo:hi] = fn(self.scores[lo:hi])
        self.scores = out


def _rankdata_desc(seg: np.ndarray) -> np.ndarray:
    """1-based rank of each score, best (highest) = 1, stable ties."""
    order = np.argsort(-seg, kind="stable")
    ranks = np.empty_like(order)
    ranks[order] = np.arange(1, len(seg) + 1)
    return ranks.astype(np.float64)


def normalize_run(run: Run, norm: Optional[str]) -> Run:
    """Return a normalized copy of `run`."""
    if norm is None:
        return Run({q: dict(r) for q, r in run.items()}, name=run.name)
    flat = _FlatRun(run)
    if norm == "min-max":
        flat.segment_apply(
            lambda s: (s - s.min()) / max(s.max() - s.min(), 1e-9)
        )
    elif norm == "max":
        # SIGNED max (ranx parity): abs() flipped normalized magnitudes
        # for queries whose scores are all negative (e.g. negated L2
        # distances), diverging from ranx for every such query
        flat.segment_apply(
            lambda s: s / (s.max() if abs(s.max()) > 1e-9 else 1e-9))
    elif norm == "sum":
        def _sum(s):
            shifted = s - s.min()
            return shifted / max(shifted.sum(), 1e-9)
        flat.segment_apply(_sum)
    elif norm == "zmuv":
        flat.segment_apply(lambda s: (s - s.mean()) / max(s.std(), 1e-9))
    elif norm == "gzmuv":
        # the reference's custom norm (ir/fuse.py:86-129): ZMUV with mean/std
        # computed GLOBALLY over every score of the run, not per query
        mean, std = flat.scores.mean(), flat.scores.std()
        flat.scores = (flat.scores - mean) / max(std, 1e-9)
    elif norm == "rank":
        flat.segment_apply(lambda s: 1.0 / _rankdata_desc(s))
    elif norm == "borda":
        def _borda(s):
            n = len(s)
            return (n + 1 - _rankdata_desc(s)) / (n + 1)
        flat.segment_apply(_borda)
    else:
        raise ValueError(f"Unknown norm {norm!r}")
    return flat.to_run()


def default_minimum(runs: Sequence[Run]) -> List[Run]:
    """Impute each run's per-query minimum for docs it did not retrieve.

    Parity with meerqat/ir/fuse.py:132-149: union doc ids per query across
    runs; per run+query, missing docs get that query's minimum score. Queries
    with empty results stay empty.
    """
    union: Dict[str, set] = {}
    for run in runs:
        for q, results in run.items():
            union.setdefault(q, set()).update(results.keys())
    out = []
    for run in runs:
        data = {}
        for q, results in run.items():
            results = dict(results)
            if results:
                m = min(results.values())
                for d in union[q]:
                    results.setdefault(d, m)
            data[q] = results
        out.append(Run(data, name=run.name))
    return out


def fuse(
    runs: Sequence[Run],
    norm: Optional[str] = "min-max",
    method: str = "wsum",
    params: Optional[dict] = None,
    name: Optional[str] = None,
) -> Run:
    """Combine runs into one (ranx.fuse parity for the methods we support)."""
    params = params or {}
    normed = [normalize_run(r, norm) for r in runs]
    if method in ("wsum", "sum", "max", "min", "mnz"):
        weights = params.get("weights")
        if method != "wsum" or weights is None:
            weights = [1.0] * len(runs)
        elif len(weights) != len(runs):
            # zip would silently drop runs (or weights) — e.g. reusing a
            # best_params fit over a different run set
            raise ValueError(
                f"fuse(method='wsum') got {len(weights)} weights for "
                f"{len(runs)} runs"
            )
        combined: Dict[str, Dict[str, float]] = {}
        counts: Dict[str, Dict[str, int]] = {}
        for w, run in zip(weights, normed):
            for q, results in run.items():
                cq = combined.setdefault(q, {})
                nq = counts.setdefault(q, {})
                for d, s in results.items():
                    nq[d] = nq.get(d, 0) + 1
                    if method in ("wsum", "sum", "mnz"):
                        cq[d] = cq.get(d, 0.0) + w * s
                    elif method == "max":
                        cq[d] = max(cq.get(d, -np.inf), s)
                    elif method == "min":
                        cq[d] = min(cq.get(d, np.inf), s)
        if method == "mnz":
            for q in combined:
                for d in combined[q]:
                    combined[q][d] *= counts[q][d]
    elif method == "rrf":
        k = params.get("k", 60)
        combined = {}
        for run in normed:
            for q, results in run.items():
                docs = list(results.keys())
                scores = np.asarray(list(results.values()))
                ranks = _rankdata_desc(scores)
                cq = combined.setdefault(q, {})
                for d, r in zip(docs, ranks):
                    cq[d] = cq.get(d, 0.0) + 1.0 / (k + r)
    else:
        raise ValueError(f"Unknown fusion method {method!r}")
    return Run(combined, name=name or "+".join(filter(None, (r.name or "?" for r in runs))))


def _weight_grid(n_runs: int, step: float) -> List[Tuple[float, ...]]:
    """All weight vectors on the unit simplex with the given step (ranx-style)."""
    ticks = int(round(1.0 / step))
    grid = []
    for combo in itertools.product(range(ticks + 1), repeat=n_runs - 1):
        if sum(combo) <= ticks:
            last = ticks - sum(combo)
            grid.append(tuple(c * step for c in combo) + (last * step,))
    return grid


def optimize_fusion(
    qrels: Qrels,
    runs: Sequence[Run],
    norm: Optional[str] = "min-max",
    method: str = "wsum",
    metric: str = "mrr@100",
    step: float = 0.1,
    return_optimization_report: bool = False,
):
    """Grid-search fusion params maximizing `metric` (ranx parity: wsum
    searches weights on the simplex with `step`; rrf searches k)."""
    normed = [normalize_run(r, norm) for r in runs]
    report = {}
    if method == "wsum":
        candidates = [{"weights": w} for w in _weight_grid(len(runs), step)]
    elif method == "rrf":
        candidates = [{"k": k} for k in range(10, 101, 10)]
    else:
        candidates = [{}]
    best_params, best_score = None, -np.inf
    for params in candidates:
        combined = fuse(normed, norm=None, method=method, params=params)
        score = evaluate(qrels, combined, metric)
        report[json.dumps(params, sort_keys=True)] = score
        if score > best_score:
            best_score, best_params = score, params
    if return_optimization_report:
        return best_params, report
    return best_params
