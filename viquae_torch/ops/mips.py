"""Exact maximum-inner-product search (counterpart of viquae_tpu/ops/mips.py).

Tie contract (FAISS IndexFlatIP parity): equal scores rank by ascending KB
id. ``torch.topk`` gives no order for ties on the GPU, so every selection
here is a STABLE descending sort (ties keep the lower position, as
``lax.top_k`` does) and the final (-score, id) order is restored with two
stable sorts, least-significant key first.

Only ``DenseIndex(mode="fused")`` on one device is ported; the other modes,
``add``/``save``/``load``/``reconstruct_batch`` and multi-GPU sharding are
listed in ROADMAP.md.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from viquae_torch.core.device import resolve_device

NEG_INF = float("-inf")
INT32_MAX = 2 ** 31 - 1
_SEG = 128


def exact_topk_numpy(queries: np.ndarray, kb: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k by full argsort; ties broken by ascending index
    (FAISS IndexFlatIP contract)."""
    scores = queries.astype(np.float32) @ kb.astype(np.float32).T
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-L2 norm."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def sort_by_score_then_id(scores: torch.Tensor, ids: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order each row by (-score, ascending id): a stable sort on the id,
    then a stable descending sort on the score."""
    order = torch.argsort(ids, dim=-1, stable=True)
    scores = torch.gather(scores, -1, order)
    ids = torch.gather(ids, -1, order)
    order = torch.argsort(scores, dim=-1, descending=True, stable=True)
    return torch.gather(scores, -1, order), torch.gather(ids, -1, order)


def finalize_topk(cand: torch.Tensor, cand_idx: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate pool (Q, P) -> final (Q, k) under the repo-wide contract:
    top-k over the pool (ties keep the lower pool position), -inf lanes
    blanked to the INT32_MAX pad id BEFORE the tie-order restore (so they
    sort last), then -inf / INT32_MAX padding out to k when the pool is
    narrower than k. Scores keep the pool's dtype; ids are int32."""
    q_count, pool = cand.shape
    kk = min(k, pool)
    top_scores, pos = torch.sort(cand, dim=1, descending=True, stable=True)
    top_scores, pos = top_scores[:, :kk], pos[:, :kk]
    top_idx = torch.gather(cand_idx.long(), 1, pos)
    top_idx = torch.where(top_scores <= NEG_INF,
                          torch.full_like(top_idx, INT32_MAX), top_idx)
    scores_out, idx_out = sort_by_score_then_id(top_scores, top_idx)
    if kk < k:
        scores_out = torch.cat([
            scores_out, torch.full((q_count, k - kk), NEG_INF,
                                   dtype=scores_out.dtype,
                                   device=scores_out.device)], dim=1)
        idx_out = torch.cat([
            idx_out, torch.full((q_count, k - kk), INT32_MAX,
                                dtype=idx_out.dtype, device=idx_out.device)],
            dim=1)
    return scores_out, idx_out.to(torch.int32)


class DenseIndex:
    """A device-resident flat MIPS index over one embedding column.

    Built from an (N, d) array (numpy or a tensor, e.g. generated on the
    GPU), optionally L2-normalizing both sides (the reference's
    "L2norm,Flat" factory), searched in batches. ``mode="fused"`` stores the
    KB in bf16, row-major (N, d) with zero rows up to a multiple of 128, and
    searches with the hand-written score+segmax kernel
    (ops/mips_fused.py).
    """

    def __init__(self, vectors, do_l2norm: bool = False, mode: str = "fused",
                 device=None):
        if mode != "fused":
            raise NotImplementedError(
                f"DenseIndex mode {mode!r} is not ported yet; only 'fused' "
                "is (see ROADMAP.md)")
        from viquae_torch.ops.mips_fused import to_kernel_layout

        self.device = resolve_device(device)
        self.mode = mode
        self.do_l2norm = do_l2norm
        self.dtype = torch.bfloat16
        src = torch.as_tensor(vectors, device=self.device)
        if src.ndim != 2:
            raise ValueError(f"expected (N, d) vectors, got {tuple(src.shape)}")
        if do_l2norm:
            src = l2_normalize(src.float())
        self.n, self.d = src.shape
        self.matrix = to_kernel_layout(src.to(self.dtype))

    def snapshot(self) -> Tuple[int, torch.Tensor]:
        """(row count, matrix), read COUNT first: a live add binds the
        matrix first and the count last, so this order can only lag —
        never score alignment padding as valid rows."""
        n = self.n
        return n, self.matrix

    def search_device(self, queries: torch.Tensor, n: int,
                      matrix: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fused exact search of device queries against a ``snapshot``:
        L2-normalized in f32 (if ``do_l2norm``) BEFORE the bf16 cast.
        Returns f32 scores and int32 ids, left on the device."""
        from viquae_torch.ops.mips_fused import topk_fused

        q = queries.float()
        if self.do_l2norm:
            q = l2_normalize(q)
        return topk_fused(q.to(self.dtype), matrix, min(k, n), valid_rows=n)

    def search_batch(self, queries, k: int = 100, sync: bool = True):
        """(scores, indices) of the top-k KB rows per query; scores f32,
        ids int32. A tensor stays on its device; anything else is uploaded.
        With ``sync=False`` the results stay device tensors and the call
        returns as soon as the work is enqueued."""
        q = torch.as_tensor(queries, device=self.device)
        scores, idx = self.search_device(q, *self.snapshot(), k)
        if not sync:
            return scores, idx
        return scores.cpu().numpy(), idx.cpu().numpy()
