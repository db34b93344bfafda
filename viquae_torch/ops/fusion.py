"""Late fusion on the device: impute + normalize + weighted sum + top-k
(counterpart of viquae_tpu/ops/fusion.py).

The reference's best retrieval configurations are LATE FUSIONS of several
indexes (DPR + ArcFace + CLIP + ImageNet, weights [0.3, 0.2, 0.2, 0.2],
gzmuv norm, default-minimum imputation). Given each index's top-k'
(scores, ids) on the device, :func:`fuse_topk` fuses them into one ranking
without a host round-trip. Its semantics are the host pipeline
``rankeval.default_minimum -> normalize_run -> fuse(wsum)``: imputation
runs FIRST, so the gzmuv/zmuv statistics are taken over the IMPUTED
multiset, in closed form with U_q = |union of doc ids of query q|, and each
doc's fused score decomposes as

    fused(d) = sum_i w_i * norm_i(m_iq)                      [baseline_q]
             + sum_{i : d in run_i} w_i * (s_i(d) - m_iq) / sigma_i

(min-max analogous). The union merge therefore only sums per-retrieval
CONTRIBUTIONS: all (doc id, contribution) pairs are sorted by id (stable)
and each run of equal ids is summed left to right — a doc appears at most
once per index, so a run has at most ``len(indexes)`` entries, summed by a
fixed loop (a cumsum difference would cancel). The batch plays the role of
the run for gzmuv's global statistics.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from viquae_torch.ops import mips

_NORMS = ("gzmuv", "zmuv", "min-max", "raw", None)


def fuse_topk(
    scores_list: Sequence[torch.Tensor],
    idx_list: Sequence[torch.Tensor],
    weights: Sequence[float],
    k: int,
    norm: Optional[str] = "gzmuv",
    valid_queries: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted-sum late fusion of per-index top-k' results, on device.

    scores_list[i]: (Q, k_i) scores of index i (any float dtype);
    idx_list[i]: (Q, k_i) doc ids in ONE id space shared by all indexes.
    Padded entries carry id INT32_MAX with score -inf; they are ignored.
    A doc appears at most once in each index's row (a top-k result).

    norm: "gzmuv" | "zmuv" | "min-max" | None, matching
    ``rankeval.fusion.normalize_run`` applied AFTER default-minimum
    imputation. "raw" skips both normalization and imputation: a doc
    absent from an index contributes 0.

    valid_queries: rows >= it are PADDING (a batch smaller than the
    canvas); they are left out of gzmuv's global statistics.

    Returns (fused f32 scores, int32 doc ids) of shape (Q, k), ranked
    descending, ties by ascending doc id, padded with -inf / INT32_MAX.
    """
    if not (len(scores_list) == len(idx_list) == len(weights)):
        raise ValueError("scores_list, idx_list and weights lengths differ")
    if norm not in _NORMS:
        raise ValueError(f"unknown device-fusion norm {norm!r}; "
                         "expected gzmuv|zmuv|min-max|raw|None")

    # ---- per-query union size U_q: the ids sorted once (stable) ----------
    all_idx = torch.cat([i.long() for i in idx_list], dim=1)
    order = torch.argsort(all_idx, dim=1, stable=True)
    idx_sorted = torch.gather(all_idx, 1, order)
    q_count, width = idx_sorted.shape
    dev = idx_sorted.device
    starts = torch.cat([
        torch.ones((q_count, 1), dtype=torch.bool, device=dev),
        idx_sorted[:, 1:] != idx_sorted[:, :-1]], dim=1)
    distinct = starts & (idx_sorted != mips.INT32_MAX)
    u_q = distinct.sum(dim=1, keepdim=True).float()
    row_mask = torch.ones((q_count, 1), device=dev)
    if valid_queries is not None:
        row_mask = (torch.arange(q_count, device=dev)[:, None]
                    < valid_queries).float()

    # ---- per index: imputed-run statistics (closed form), contributions -
    contribs = []
    baseline = torch.zeros((q_count, 1), device=dev)
    for s_raw, ids, w in zip(scores_list, idx_list, weights):
        s_raw = s_raw.float()
        valid = ids != mips.INT32_MAX
        s = torch.where(valid, s_raw, 0.0)
        p = valid.sum(dim=1, keepdim=True).float()  # present count
        # a query with NO results in this run contributes nothing at all
        # (host default_minimum: queries with empty results stay empty)
        row_has = valid.any(dim=1, keepdim=True)
        m = torch.where(valid, s_raw, float("inf")).amin(dim=1, keepdim=True)
        m = torch.where(row_has, m, 0.0)
        n_imp = torch.where(row_has, torch.clamp(u_q - p, min=0.0), 0.0)
        if norm in ("gzmuv", "zmuv"):
            s1 = s.sum(dim=1, keepdim=True) + n_imp * m
            s2 = (s * s).sum(dim=1, keepdim=True) + n_imp * m * m
            stat_mask = row_mask * row_has  # this run's real, in-batch rows
            if norm == "gzmuv":
                count = torch.clamp((u_q * stat_mask).sum(), min=1.0)
                mean = (s1 * stat_mask).sum() / count
                var = (s2 * stat_mask).sum() / count - mean * mean
            else:
                count = torch.clamp(u_q, min=1.0)
                mean = s1 / count
                var = s2 / count - mean * mean
            sigma = torch.clamp(torch.sqrt(torch.clamp(var, min=0.0)),
                                min=1e-9)
            contrib = w * (s_raw - m) / sigma
            baseline = baseline + torch.where(row_has,
                                              w * (m - mean) / sigma, 0.0)
        elif norm == "raw":
            contrib = w * s_raw
        elif norm == "min-max":
            # duplicated minima change neither the per-query min nor max
            hi = torch.where(valid, s_raw, mips.NEG_INF).amax(dim=1,
                                                              keepdim=True)
            hi = torch.where(torch.isfinite(hi), hi, 0.0)
            span = torch.clamp(hi - m, min=1e-9)
            contrib = w * (s_raw - m) / span  # the normalized minimum is 0
        else:  # norm is None
            contrib = w * (s_raw - m)
            baseline = baseline + w * m
        contribs.append(torch.where(valid, contrib, 0.0))

    # ---- union merge: each run of equal ids summed left to right ---------
    c_sorted = torch.gather(torch.cat(contribs, dim=1), 1, order)
    pos = torch.arange(width, device=dev).expand(q_count, width)
    run_start = torch.cummax(torch.where(starts, pos, 0), dim=1).values
    totals = torch.zeros_like(c_sorted)
    for offset in range(len(idx_list)):
        lane = run_start + offset
        totals = totals + torch.where(
            lane <= pos, torch.gather(c_sorted, 1, lane.clamp(max=width - 1)),
            0.0)
    ends = torch.cat([
        idx_sorted[:, :-1] != idx_sorted[:, 1:],
        torch.ones((q_count, 1), dtype=torch.bool, device=dev)], dim=1)
    keep = ends & (idx_sorted != mips.INT32_MAX)
    fused = torch.where(keep, totals, mips.NEG_INF)
    # duplicate (non-end) lanes carry real ids with -inf scores: blank them
    # so -inf output slots never leak a doc id
    idx_sorted = torch.where(keep, idx_sorted, mips.INT32_MAX)

    top, pos_k = mips.top_k(fused, min(k, width))
    top, top_idx = mips.sort_by_score_then_id(
        top, torch.gather(idx_sorted, 1, pos_k))
    # add the per-query baseline back so ABSOLUTE scores match the host
    # fusion, not just the ranking; padded slots stay -inf
    top = torch.where(torch.isfinite(top), top + baseline, top)
    top, top_idx = mips._pad_to_k(top, top_idx, k)
    return top, top_idx.to(torch.int32)
