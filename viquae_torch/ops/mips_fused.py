"""Fused exact MIPS: one pass over the KB writes the bf16 scores AND each
128-column segment's maximum; selection then runs once, globally.

Counterpart of viquae_tpu/ops/mips_pallas.py (``to_kernel_layout``,
``fused_score_segmax_qmajor``, ``_topk_fused_single``, ``topk_fused``).
The KB is kept row-major (N, d), zero-padded to a multiple of 128 rows, so
both operands of ``q · kbᵀ`` are K-major, and the segment maxima come out
as (Q, N/128). The Pallas (d, N) layout, 3-D segmax and tile=512 were
forced by the TPU compiler and are not part of the contract.

``fused_score_segmax`` launches the hand-written Hopper kernel
(csrc/score_segmax.cu) for CUDA tensors and runs
``fused_score_segmax_plain`` — the same math in plain PyTorch — only for
CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from viquae_torch.ops import mips

SEG = 128


def to_kernel_layout(kb: torch.Tensor) -> torch.Tensor:
    """(N, d) KB -> (N_pad, d) with zero rows up to a multiple of 128 (mask
    the padding with ``valid_rows=N``). Rows are padded, never transposed."""
    pad = (-kb.shape[0]) % SEG
    if pad:
        kb = torch.cat([kb, kb.new_zeros((pad, kb.shape[1]))])
    return kb.contiguous()


def fused_score_segmax_plain(q: torch.Tensor, kb: torch.Tensor,
                             valid_rows: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with its rounding points:
    f32 scores, columns >= ``valid_rows`` set to -inf on the f32 values,
    one rounding to bf16, then the max of each 128 ROUNDED scores.
    (Q, d) x (N, d) -> scores (Q, N) bf16, segmax (Q, N/128) bf16."""
    q_count, n = q.shape[0], kb.shape[0]
    s = q.float() @ kb.float().T
    col = torch.arange(n, device=s.device)
    s = s.masked_fill_(col >= valid_rows, mips.NEG_INF).to(torch.bfloat16)
    return s, s.view(q_count, n // SEG, SEG).amax(dim=-1)


def _check_kernel_args(q, kb, valid_rows):
    if not (q.is_cuda and kb.is_cuda) or q.device != kb.device:
        raise ValueError(f"q and kb must share one CUDA device, got "
                         f"{q.device} and {kb.device}")
    if q.dtype != torch.bfloat16 or kb.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 inputs, got {q.dtype} and "
                        f"{kb.dtype}")
    if q.ndim != 2 or kb.ndim != 2 or q.shape[1] != kb.shape[1]:
        raise ValueError(f"expected q (Q, d) and kb (N, d), got "
                         f"{tuple(q.shape)} and {tuple(kb.shape)}")
    if not (q.is_contiguous() and kb.is_contiguous()):
        raise ValueError("q and kb must be contiguous")
    if kb.shape[0] % SEG:
        raise ValueError(f"kb rows ({kb.shape[0]}) must be a multiple of "
                         f"{SEG}: pad with to_kernel_layout")
    if q.shape[1] % 8:
        raise ValueError(f"d ({q.shape[1]}) must be a multiple of 8")
    if q.data_ptr() % 16 or kb.data_ptr() % 16:
        # the kernel reads both operands as 16-byte vectors
        raise ValueError("q and kb must start on a 16-byte boundary")
    if not 0 <= valid_rows <= kb.shape[0]:
        raise ValueError(f"valid_rows={valid_rows} outside [0, "
                         f"{kb.shape[0]}]")


def fused_score_segmax(q: torch.Tensor, kb: torch.Tensor, valid_rows: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, d) x (N, d) -> scores (Q, N) bf16 + segmax (Q, N/128) bf16.

    ``kb`` is row-major with N % 128 == 0; ``valid_rows`` is a host int,
    read at call time: columns >= it score -inf. CUDA tensors go to the
    Hopper kernel (and nowhere else); CPU tensors to the plain version.
    ``fused_score_segmax.launches`` counts kernel launches.
    """
    valid_rows = int(valid_rows)
    if not q.is_cuda and not kb.is_cuda:
        return fused_score_segmax_plain(q, kb, valid_rows)
    _check_kernel_args(q, kb, valid_rows)
    from viquae_torch.kernels.build import load

    q_count, n = q.shape[0], kb.shape[0]
    scores = torch.empty((q_count, n), dtype=torch.bfloat16, device=q.device)
    segmax = torch.empty((q_count, n // SEG), dtype=torch.bfloat16,
                         device=q.device)
    lib = load("score_segmax")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.score_segmax_launch(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(kb.data_ptr()),
            ctypes.c_void_p(scores.data_ptr()),
            ctypes.c_void_p(segmax.data_ptr()),
            q_count, n, q.shape[1], valid_rows, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            "score_segmax kernel launch failed: "
            f"{lib.score_segmax_error_string(err).decode()} (code {err})")
    fused_score_segmax.launches += 1
    return scores, segmax


fused_score_segmax.launches = 0


def segment_topk(scores: torch.Tensor, segmax: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selection tail over the kernel's outputs: the top-p segments by
    their maxima (p = min(#segments, k); ties keep the lower segment), a
    gather of their 128 candidates each, then :func:`mips.finalize_topk`.
    Candidates stay bf16 until the final sort; returns f32 scores and
    int32 ids."""
    q_count, n_seg = segmax.shape
    p = min(n_seg, k)
    order = torch.sort(segmax, dim=1, descending=True, stable=True)[1]
    seg_idx = order[:, :p]
    seg = scores.view(q_count, n_seg, SEG)
    cand = torch.gather(seg, 1, seg_idx[:, :, None].expand(q_count, p, SEG))
    cand = cand.reshape(q_count, p * SEG)
    cand_idx = (seg_idx[:, :, None] * SEG
                + torch.arange(SEG, device=seg_idx.device)
                ).reshape(q_count, p * SEG)
    out_s, out_i = mips.finalize_topk(cand, cand_idx, k)
    return out_s.float(), out_i


def _topk_fused_single(q, kb, k: int, valid_rows: int):
    """One fused-kernel pass + selection tail over the whole (N, d) slab."""
    return segment_topk(*fused_score_segmax(q, kb, valid_rows), k)


def topk_fused(
    queries: torch.Tensor,
    kb: torch.Tensor,
    k: int,
    valid_rows: Optional[int] = None,
    chunks: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact bf16 MIPS top-k over a row-major (N, d) KB, N % 128 == 0.

    ``valid_rows=None`` means every row is real: pass ``valid_rows=n``
    whenever the KB came from :func:`to_kernel_layout` (zero pad rows score
    0.0 and would beat negative scores). ``chunks > 1`` scores the KB in
    that many row slabs (each a multiple of 128 rows) and merges the
    per-slab top-k by (-score, global id), shrinking the (Q, N) bf16 score
    buffer to (Q, N/chunks); the result equals ``chunks=1``, tie order
    included. Returns f32 scores and int32 ids (INT32_MAX pads).
    """
    n = kb.shape[0]
    nv = n if valid_rows is None else int(valid_rows)
    if chunks <= 1:
        return _topk_fused_single(queries, kb, k, nv)
    per = -(-(n // SEG) // chunks) * SEG  # slab width, a segment multiple
    parts_s, parts_i = [], []
    for c in range(chunks):
        lo = c * per
        if lo >= n:
            break
        width = min(per, n - lo)
        local_valid = min(max(nv - lo, 0), width)
        s, i = _topk_fused_single(queries, kb[lo: lo + width], k,
                                  local_valid)
        # shift local ids to global; keep the pad sentinel unshifted
        i = torch.where(i == mips.INT32_MAX, i, i + lo)
        parts_s.append(s)
        parts_i.append(i)
    all_s, all_i = mips.sort_by_score_then_id(torch.cat(parts_s, dim=1),
                                              torch.cat(parts_i, dim=1))
    return all_s[:, :k], all_i[:, :k]
