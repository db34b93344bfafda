"""Fused exact MIPS: one pass over the KB writes the scores AND each
128-row segment's maximum; selection then runs once, globally.

Counterpart of viquae_tpu/ops/mips_pallas.py, with the same names:

- q-major (kernel B1, the production exact path): ``to_kernel_layout``,
  ``fused_score_segmax_qmajor``, ``_topk_fused_single``, ``topk_fused``.
  The KB is kept row-major (N, d), zero-padded to a multiple of 128 rows,
  so both operands of ``q · kbᵀ`` are K-major, and the segment maxima come
  out as (Q, N/128). The Pallas (d, N) layout, 3-D segmax and tile=512
  were forced by the TPU compiler and are not part of the contract.
- kb-major (kernel B2, the documented experiment): ``fused_score_segmax``
  and ``topk_pallas``. Scores come out transposed, (N, Q), in the input
  dtype; the maxima are (N/128, Q) f32 of the UNROUNDED sums, unmasked.

Each kernel wrapper launches its hand-written Hopper kernel
(csrc/score_segmax.cu, csrc/score_segmax_kbmajor.cu) for CUDA tensors and
runs its ``*_plain`` version — the same math in plain PyTorch — only for
CPU tensors. A CUDA tensor goes to the kernel or raises.
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


def _check_operands(q, kb, dtypes, name):
    """What both kernels need of their operands: one CUDA device, one of
    ``dtypes`` on both sides, (Q, d) and (N, d) contiguous with
    N % 128 == 0, d a multiple of one 16-byte vector, 16-byte aligned."""
    if not (q.is_cuda and kb.is_cuda) or q.device != kb.device:
        raise ValueError(f"q and kb must share one CUDA device, got "
                         f"{q.device} and {kb.device}")
    if q.dtype != kb.dtype or q.dtype not in dtypes:
        raise TypeError(f"{name} takes q and kb of one dtype in "
                        f"{[str(t) for t in dtypes]}, got {q.dtype} and "
                        f"{kb.dtype}")
    if q.ndim != 2 or kb.ndim != 2 or q.shape[1] != kb.shape[1]:
        raise ValueError(f"expected q (Q, d) and kb (N, d), got "
                         f"{tuple(q.shape)} and {tuple(kb.shape)}")
    if not (q.is_contiguous() and kb.is_contiguous()):
        raise ValueError("q and kb must be contiguous")
    if kb.shape[0] % SEG:
        raise ValueError(f"kb rows ({kb.shape[0]}) must be a multiple of "
                         f"{SEG}: pad with to_kernel_layout")
    vec = 16 // q.element_size()
    if q.shape[1] % vec:
        raise ValueError(f"d ({q.shape[1]}) must be a multiple of {vec}")
    if q.data_ptr() % 16 or kb.data_ptr() % 16:
        # the kernels read both operands as 16-byte vectors
        raise ValueError("q and kb must start on a 16-byte boundary")


def _launch(name, fn, *args):
    """Call the C entry ``fn`` of library ``name`` on the current stream of
    the first tensor's device; raise on a non-zero cudaGetLastError()."""
    from viquae_torch.kernels.build import load

    lib = load(name)
    dev = args[0].device
    ptrs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else a for a in args]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*ptrs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{getattr(lib, name + '_error_string')(err).decode()} "
            f"(code {err})")


# ---- kernel B1: q-major, masked, rounded maxima ---------------------------
def fused_score_segmax_qmajor_plain(q: torch.Tensor, kb: torch.Tensor,
                                    valid_rows: int
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B1, with its rounding points:
    f32 scores, columns >= ``valid_rows`` set to -inf on the f32 values,
    one rounding to bf16, then the max of each 128 ROUNDED scores.
    (Q, d) x (N, d) -> scores (Q, N) bf16, segmax (Q, N/128) bf16."""
    q_count, n = q.shape[0], kb.shape[0]
    s = q.float() @ kb.float().T
    col = torch.arange(n, device=s.device)
    s = s.masked_fill_(col >= valid_rows, mips.NEG_INF).to(torch.bfloat16)
    return s, s.view(q_count, n // SEG, SEG).amax(dim=-1)


def fused_score_segmax_qmajor(q: torch.Tensor, kb: torch.Tensor,
                              valid_rows: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, d) x (N, d) -> scores (Q, N) bf16 + segmax (Q, N/128) bf16.

    ``kb`` is row-major with N % 128 == 0; ``valid_rows`` is a host int,
    read at call time: columns >= it score -inf. CUDA tensors go to the
    Hopper kernel (and nowhere else); CPU tensors to the plain version.
    ``fused_score_segmax_qmajor.launches`` counts kernel launches.
    """
    valid_rows = int(valid_rows)
    if not q.is_cuda and not kb.is_cuda:
        return fused_score_segmax_qmajor_plain(q, kb, valid_rows)
    _check_operands(q, kb, (torch.bfloat16,), "the q-major kernel")
    if not 0 <= valid_rows <= kb.shape[0]:
        raise ValueError(f"valid_rows={valid_rows} outside [0, "
                         f"{kb.shape[0]}]")
    q_count, n = q.shape[0], kb.shape[0]
    scores = torch.empty((q_count, n), dtype=torch.bfloat16, device=q.device)
    segmax = torch.empty((q_count, n // SEG), dtype=torch.bfloat16,
                         device=q.device)
    _launch("score_segmax", "score_segmax_launch", q, kb, scores, segmax,
            q_count, n, q.shape[1], valid_rows)
    fused_score_segmax_qmajor.launches += 1
    return scores, segmax


fused_score_segmax_qmajor.launches = 0


def segment_topk(scores: torch.Tensor, segmax: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selection tail over B1's outputs: the top-p segments by their
    maxima (p = min(#segments, k); ties keep the lower segment), a gather
    of their 128 candidates each, then :func:`mips.finalize_topk`.
    Candidates stay bf16 until the final sort; returns f32 scores and
    int32 ids."""
    q_count, n_seg = segmax.shape
    p = min(n_seg, k)
    seg_idx = mips.top_k(segmax, p)[1]
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
    return segment_topk(*fused_score_segmax_qmajor(q, kb, valid_rows), k)


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


# ---- kernel B2: kb-major, unmasked, unrounded maxima ----------------------
def fused_score_segmax_plain(q: torch.Tensor, kb: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B2, with its rounding points: f32
    scores ``kb · qᵀ``, the max of each 128 rows taken on the UNROUNDED
    f32 values, then one cast of the scores to the input dtype. Nothing is
    masked. (Q, d) x (N, d) -> scores_t (N, Q) in q's dtype,
    segmax_t (N/128, Q) f32."""
    n, q_count = kb.shape[0], q.shape[0]
    s = kb.float() @ q.float().T
    segmax = s.view(n // SEG, SEG, q_count).amax(dim=1)
    return s.to(q.dtype), segmax


def fused_score_segmax(q: torch.Tensor, kb: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, d) x (N, d) -> scores_t (N, Q) + segmax_t (N/128, Q) f32.

    ``q`` and ``kb`` are both bf16 or both f32 (scores in that dtype),
    row-major, N % 128 == 0, any Q. CUDA tensors go to the Hopper kernel
    (and nowhere else); CPU tensors to the plain version.
    ``fused_score_segmax.launches`` counts kernel launches.
    """
    if not q.is_cuda and not kb.is_cuda:
        return fused_score_segmax_plain(q, kb)
    _check_operands(q, kb, (torch.bfloat16, torch.float32),
                    "the kb-major kernel")
    n, q_count = kb.shape[0], q.shape[0]
    scores_t = torch.empty((n, q_count), dtype=q.dtype, device=q.device)
    segmax_t = torch.empty((n // SEG, q_count), dtype=torch.float32,
                           device=q.device)
    _launch("score_segmax_kbmajor", "score_segmax_kbmajor_launch", q, kb,
            scores_t, segmax_t, q_count, n, q.shape[1],
            int(q.dtype == torch.float32))
    fused_score_segmax.launches += 1
    return scores_t, segmax_t


fused_score_segmax.launches = 0


def topk_pallas(queries: torch.Tensor, kb: torch.Tensor, k: int,
                valid_rows: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full MIPS top-k via kernel B2 + one global selection.

    Same contract as ``mips.topk_single(mode="fast")``: KB rows beyond
    ``valid_rows`` are masked out (``None`` means the ORIGINAL row count,
    so the internal padding never scores), results pad to k with -inf /
    INT32_MAX when k exceeds the valid pool, and any query count is
    accepted. Rows are padded to the kernel's 128 (the TPU's tile of 1,024
    is not needed; pad rows are masked either way, so the results are the
    same), queries are not padded. Returns f32 scores and int32 ids.
    """
    n_real, dim = kb.shape
    pad = (-n_real) % SEG
    if pad:
        kb = torch.cat([kb, kb.new_zeros((pad, dim))])
    n = n_real + pad
    # the default masks the INTERNAL padding added above: zero pad rows
    # score 0.0 and would out-rank real negative scores
    nv = n_real if valid_rows is None else int(valid_rows)
    q_count = queries.shape[0]
    scores_t, segmax_t = fused_score_segmax(queries, kb)
    dev = scores_t.device

    # mask invalid segments out of the (unrounded) maxima; the boundary
    # segment that nv cuts needs its max recomputed over valid rows only,
    # from the ROUNDED scores, as the reference does — a high-scoring
    # invalid row would otherwise inflate it and displace a fully-valid
    # segment holding a true top-k element
    n_seg = n // SEG
    seg_ids = torch.arange(n_seg, device=dev)
    segmax = segmax_t.T.masked_fill(seg_ids * SEG >= nv, mips.NEG_INF)
    boundary = nv // SEG  # == n_seg (no segment) when nv == n
    bstart = min(boundary * SEG, n - SEG)
    brows = bstart + torch.arange(SEG, device=dev)[:, None]
    bmax = scores_t[bstart: bstart + SEG].float().masked_fill(
        brows >= nv, mips.NEG_INF).amax(dim=0)
    segmax = torch.where(seg_ids == boundary, bmax[:, None], segmax)

    # top segments via the two-level scheme (exact modulo equal-score ties)
    seg_idx = mips._select_topk(segmax, min(k, n_seg), "fast")[1]
    gather_cols = (seg_idx[:, :, None] * SEG
                   + torch.arange(SEG, device=dev)).reshape(q_count, -1)
    # the kb-major gather: out[q, j] = scores_t[gather_cols[q, j], q]
    cand = torch.gather(scores_t, 0, gather_cols.T).T
    cand = cand.float().masked_fill(gather_cols >= nv, mips.NEG_INF)
    return mips.finalize_topk(cand, gather_cols, k)
