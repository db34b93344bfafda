"""rankeval — in-repo ranking evaluation/fusion (ranx-compatible).

The reference delegates run/qrels handling, IR metrics, statistical
comparison and late fusion to the `ranx` library (meerqat/ir/search.py:485-512,
ir/fuse.py, ir/metrics.py:237-313). ranx is not part of this framework's
environment, so rankeval reimplements the needed surface from scratch with a
vectorized numpy core (padded (Q, K) score/relevance matrices) instead of
ranx's numba dict-of-dict kernels:

- :class:`Qrels` / :class:`Run` — dict-of-dicts containers, JSON + TREC io,
  file-format compatible with ranx.
- :func:`evaluate` — mrr, precision, recall, hit_rate, hits, map, ndcg @k.
- :func:`compare` — paired Fisher randomization / t-test significance report.
- :func:`fuse` / :func:`optimize_fusion` — score norms (min-max, max, sum,
  zmuv, gzmuv, rank, borda) + wsum/rrf/max/min/sum fusion with simplex grid
  search (replaces both ranx fusion and the numba gzmuv kernels of
  ir/fuse.py:86-129).
"""
from viquae_torch.rankeval.data import Qrels, Run
from viquae_torch.rankeval.metrics import evaluate
from viquae_torch.rankeval.compare import compare, Report
from viquae_torch.rankeval.fusion import fuse, optimize_fusion, normalize_run, default_minimum

__all__ = [
    "Qrels",
    "Run",
    "evaluate",
    "compare",
    "Report",
    "fuse",
    "optimize_fusion",
    "normalize_run",
    "default_minimum",
]
