"""Maximum-inner-product search on one device (counterpart of
viquae_tpu/ops/mips.py; the multi-device ``topk_sharded`` and every mesh
argument are left for the multi-GPU slice).

Tie contract (FAISS IndexFlatIP parity): equal scores rank by ascending KB
id. ``torch.topk`` gives no order for ties on the GPU, so every selection
here is a STABLE descending sort (ties keep the lower position, as
``lax.top_k`` does) and the final (-score, id) order is restored with two
stable sorts, least-significant key first.

Products: f32 operands take ``torch.matmul`` in full f32 (TF32 is off,
core/device.py), the counterpart of ``precision=HIGHEST``; bf16 operands
take ``models.layers._dot_f32`` (f32 accumulation and result), and are
cast afterwards where the reference casts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from viquae_torch.core.device import resolve_device
from viquae_torch.models.layers import _dot_f32

NEG_INF = float("-inf")
INT32_MAX = 2 ** 31 - 1
_SEG = 128
_MODES = ("exact", "fast", "global", "approx", "fused")
# rows of one stable sort in top_k; wider rows are cut into column blocks
_TOPK_BLOCK = 1 << 16
# mode "fast" takes the single pass while the (Q, N) scores fit in this
# many bytes, as the reference's search_batch does (kept for parity)
_SINGLE_PASS_BYTES = 4 * 2 ** 30


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


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, descending, equal
    values in ascending position; positions int64. One stable sort; a row
    wider than _TOPK_BLOCK is cut into column blocks whose own top-k are
    merged by (-value, position), which is the same order."""
    width = x.shape[-1]
    if width <= _TOPK_BLOCK:
        values, pos = torch.sort(x, dim=-1, descending=True, stable=True)
        return values[..., :k], pos[..., :k]
    parts_v, parts_p = [], []
    for lo in range(0, width, _TOPK_BLOCK):
        v, p = top_k(x[..., lo: lo + _TOPK_BLOCK], k)
        parts_v.append(v)
        parts_p.append(p + lo)
    v, p = sort_by_score_then_id(torch.cat(parts_v, -1),
                                 torch.cat(parts_p, -1))
    return v[..., :k], p[..., :k]


def _merge_topk(scores_a, idx_a, scores_b, idx_b, k: int):
    """Merge two candidate sets into top-k, ties by ascending global id."""
    scores, idx = sort_by_score_then_id(torch.cat([scores_a, scores_b], -1),
                                        torch.cat([idx_a, idx_b], -1))
    return scores[..., :k], idx[..., :k]


def _pad_to_k(scores, idx, k: int):
    """Pad (Q, kk) results to (Q, k) with -inf / INT32_MAX."""
    q_count, kk = scores.shape
    if kk >= k:
        return scores, idx
    return (torch.cat([scores, scores.new_full((q_count, k - kk), NEG_INF)],
                      1),
            torch.cat([idx, idx.new_full((q_count, k - kk), INT32_MAX)], 1))


def finalize_topk(cand: torch.Tensor, cand_idx: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate pool (Q, P) -> final (Q, k) under the repo-wide contract:
    top-k over the pool (ties keep the lower pool position), -inf lanes
    blanked to the INT32_MAX pad id BEFORE the tie-order restore (so they
    sort last), then -inf / INT32_MAX padding out to k when the pool is
    narrower than k. Scores keep the pool's dtype; ids are int32."""
    top_scores, pos = top_k(cand, min(k, cand.shape[1]))
    top_idx = torch.gather(cand_idx.long(), 1, pos)
    top_idx = torch.where(top_scores <= NEG_INF,
                          torch.full_like(top_idx, INT32_MAX), top_idx)
    scores_out, idx_out = _pad_to_k(
        *sort_by_score_then_id(top_scores, top_idx), k)
    return scores_out, idx_out.to(torch.int32)


def _select_topk(scores: torch.Tensor, k: int, mode: str):
    """Top-k over the last axis of (Q, C) scores; ids int64.

    mode="exact": ``lax.top_k`` order (stable descending sort).
    mode="fast": two-level segmented selection — each 128-wide segment's
        max, the top-k segments, then top-k over their k*128 candidates,
        re-sorted by (-score, index). It provably holds the true top-k;
        only exact ties straddling the k-th segment/candidate boundary may
        keep another tied duplicate than "exact".
    mode="approx": the reference's ``lax.approx_max_k`` (TPU
        PartialReduce). The card has no PartialReduce, and on the CPU the
        reference's approx_max_k is exact, so here it is the exact stable
        selection: recall 1.0, equal to the reference's CPU results.
    mode="global" is an alias of "fast" (it names the topk_global engine).
    """
    if mode == "global":
        mode = "fast"
    if mode not in ("exact", "fast", "approx"):
        raise ValueError(f"unknown top-k mode {mode!r}; "
                         "expected exact|fast|global|approx")
    q_count, width = scores.shape
    if mode != "fast" or width < 2 * _SEG:
        return top_k(scores, k)
    pad = (-width) % _SEG
    if pad:
        scores = torch.cat([scores, scores.new_full((q_count, pad), NEG_INF)],
                           1)
    n_seg = (width + pad) // _SEG
    seg = scores.reshape(q_count, n_seg, _SEG)
    p = min(n_seg, k)
    seg_idx = top_k(seg.amax(dim=2), p)[1]
    cand = torch.gather(seg, 1, seg_idx[:, :, None].expand(q_count, p, _SEG))
    cand_idx = (seg_idx[:, :, None] * _SEG
                + torch.arange(_SEG, device=scores.device))
    top_scores, pos = top_k(cand.reshape(q_count, p * _SEG), k)
    top_idx = torch.gather(cand_idx.reshape(q_count, p * _SEG), 1, pos)
    # candidates were ordered by segment rank, not index: restore tie order
    return sort_by_score_then_id(top_scores, top_idx)


def _scores_f32(q: torch.Tensor, kb: torch.Tensor, compute_dtype
                ) -> torch.Tensor:
    """q · kbᵀ on operands cast to ``compute_dtype``, f32 accumulation and
    an f32 result (the reference's preferred_element_type=float32)."""
    q, kb = q.to(compute_dtype), kb.to(compute_dtype)
    if compute_dtype == torch.float32:
        return torch.matmul(q, kb.T)
    return _dot_f32(q, kb)


def _chunk_topk(q, chunk, base: int, k: int, valid_rows: int, compute_dtype,
                mode: str):
    """Top-k of q · chunkᵀ with global ids; rows >= valid_rows masked."""
    scores = _scores_f32(q, chunk, compute_dtype)
    col = torch.arange(chunk.shape[0], device=scores.device)
    scores.masked_fill_(col >= valid_rows, NEG_INF)
    top_scores, top_idx = _select_topk(scores, k, mode)
    return top_scores, top_idx + base


def topk_single(
    queries: torch.Tensor,
    kb: torch.Tensor,
    k: int,
    chunk_size: int = 262144,
    valid_rows: Optional[int] = None,
    compute_dtype=torch.float32,
    mode: str = "fast",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device chunked MIPS: each chunk of ``chunk_size`` KB rows is
    scored (f32 scores) and selected, then merged into a running top-k by
    (-score, id). ``kb`` (N, d) may include padding rows; ``valid_rows``
    counts the real ones (default N). The tail chunk is zero-padded to the
    common width, as the reference's scan is. Returns f32 scores and int32
    ids (INT32_MAX where the score is -inf)."""
    n = kb.shape[0]
    nv = n if valid_rows is None else int(valid_rows)
    chunk_size = min(chunk_size, n)
    q_count = queries.shape[0]
    scores = torch.full((q_count, k), NEG_INF, dtype=torch.float32,
                        device=queries.device)
    idx = torch.full((q_count, k), INT32_MAX, dtype=torch.int64,
                     device=queries.device)
    for base in range(0, n, chunk_size):
        chunk = kb[base: base + chunk_size]
        if chunk.shape[0] < chunk_size:
            chunk = torch.cat([chunk, chunk.new_zeros(
                (chunk_size - chunk.shape[0], chunk.shape[1]))])
        c_scores, c_idx = _chunk_topk(queries, chunk, base,
                                      min(k, chunk_size), nv - base,
                                      compute_dtype, mode)
        scores, idx = _merge_topk(scores, idx, c_scores, c_idx, k)
    # lanes masked to -inf carry real-but-invalid ids: blank them to the
    # INT32_MAX pad convention fuse_topk keys on
    idx = torch.where(scores <= NEG_INF, torch.full_like(idx, INT32_MAX),
                      idx)
    return scores, idx.to(torch.int32)


def topk_global(
    queries: torch.Tensor,
    kb: torch.Tensor,
    k: int,
    valid_rows: Optional[int] = None,
    compute_dtype=torch.bfloat16,
    mode: str = "exact",
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-pass MIPS: ALL (Q, N) scores at once (rounded to bf16 for a
    non-f32 compute dtype, after the f32 product, then masked), then ONE
    global two-level segmented selection. ``kb`` is row-major (N, d); a KB
    that is not 128-row aligned is padded here (a full copy:
    ``DenseIndex`` stores it aligned). mode="approx" selects exactly (see
    :func:`_select_topk`), so ``recall_target`` has nothing to trade and
    is accepted for the reference's signature. Returns f32 scores and
    int32 ids."""
    if mode not in ("exact", "approx"):
        raise ValueError(f"unknown topk_global mode {mode!r}; "
                         "expected exact|approx")
    n = kb.shape[0]
    nv = n if valid_rows is None else int(valid_rows)
    pad = (-n) % _SEG
    if pad:
        kb = torch.cat([kb, kb.new_zeros((pad, kb.shape[1]))])
        n += pad
    scores = _scores_f32(queries, kb, compute_dtype)
    if compute_dtype != torch.float32:
        scores = scores.to(torch.bfloat16)
    scores.masked_fill_(torch.arange(n, device=scores.device) >= nv, NEG_INF)
    if mode == "approx":
        top_scores, top_idx = top_k(scores, min(k, n))
        return finalize_topk(top_scores.float(), top_idx, k)
    q_count, n_seg = queries.shape[0], n // _SEG
    seg = scores.view(q_count, n_seg, _SEG)
    p = min(n_seg, k)
    # segments selected with the two-level scheme (n_seg itself is wide)
    seg_idx = _select_topk(seg.amax(dim=2).float(), p, "fast")[1]
    cand = torch.gather(seg, 1, seg_idx[:, :, None].expand(q_count, p, _SEG))
    cand_idx = (seg_idx[:, :, None] * _SEG
                + torch.arange(_SEG, device=scores.device))
    return finalize_topk(cand.reshape(q_count, p * _SEG).float(),
                         cand_idx.reshape(q_count, p * _SEG), k)


def _aligned_rows(n: int) -> int:
    return n + (-n) % _SEG


_STORE_ROWS = 1 << 17  # rows normalized at a time: bounds the f32 copies


def _store_rows(matrix: torch.Tensor, start: int, src: torch.Tensor,
                do_l2norm: bool) -> None:
    """matrix[start: start + len(src)] = src (L2-normalized in f32 first if
    ``do_l2norm``), in row blocks, so that normalizing a wide bf16 KB never
    holds an f32 copy of all of it."""
    for lo in range(0, src.shape[0], _STORE_ROWS):
        block = src[lo: lo + _STORE_ROWS]
        if do_l2norm:
            block = l2_normalize(block.float())
        matrix[start + lo: start + lo + block.shape[0]] = block


def _as_rows(vectors, device) -> torch.Tensor:
    """(N, d) vectors (numpy or a tensor) as a float tensor on ``device``:
    bf16 and f32 stay as they are, any other type becomes f32 first (the
    reference stores through f32)."""
    src = torch.as_tensor(vectors, device=device)
    if src.dtype not in (torch.float32, torch.bfloat16):
        src = src.float()
    return src


class DenseIndex:
    """A device-resident flat MIPS index over one embedding column.

    Built from an (N, d) array (numpy or a tensor, e.g. generated on the
    GPU), optionally L2-normalizing both sides in f32 (the reference's
    "L2norm,Flat" factory), searched in batches, grown with :meth:`add`,
    save/load-able. The KB is stored row-major (N_pad, d) in ``dtype``
    (bf16 for mode "fused"), zero rows up to a multiple of 128 that every
    search masks. Modes route as the reference's ``search_batch`` does:
    "fused" -> the B1 kernel (ops/mips_fused.topk_fused); "global",
    "approx", and "fast" while the (Q, N) scores take <= 4 GiB ->
    :func:`topk_global`; else :func:`topk_single`.
    """

    def __init__(self, vectors, do_l2norm: bool = False,
                 dtype=torch.float32, chunk_size: int = 262144,
                 mode: str = "fast", approx_recall_target: float = 0.99,
                 device=None):
        if mode not in _MODES:
            raise ValueError(f"unknown top-k mode {mode!r}; "
                             "expected exact|fast|global|approx|fused")
        self.device = resolve_device(device)
        self.do_l2norm = do_l2norm
        self.chunk_size = chunk_size
        self.mode = mode
        self.approx_recall_target = approx_recall_target
        # the B1 kernel is bf16-only (the f32 contract lives on the others)
        self.dtype = torch.bfloat16 if mode == "fused" else dtype
        src = _as_rows(vectors, self.device)
        if src.ndim != 2:
            raise ValueError(
                f"expected (N, d) vectors, got {tuple(src.shape)}")
        n, self.d = src.shape
        self.matrix = torch.zeros((_aligned_rows(n), self.d),
                                  dtype=self.dtype, device=self.device)
        _store_rows(self.matrix, 0, src, do_l2norm)
        self.n = n

    def snapshot(self) -> Tuple[int, torch.Tensor]:
        """(row count, matrix), read COUNT first: a live add binds the
        matrix first and the count last, so this order can only lag —
        never score alignment padding as valid rows."""
        n = self.n
        return n, self.matrix

    def _queries(self, queries) -> torch.Tensor:
        """Queries on the index's device in f32, L2-normalized (in f32,
        before any cast) if ``do_l2norm``."""
        q = torch.as_tensor(queries, device=self.device).float()
        return l2_normalize(q) if self.do_l2norm else q

    def search_device(self, queries: torch.Tensor, n: int,
                      matrix: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Single-pass search of device queries against a ``snapshot``,
        routed as the reference's serving ``_device_search``: "fused" ->
        the B1 kernel, every other mode -> :func:`topk_global`. Returns f32
        scores and int32 ids, left on the device."""
        return self._single_pass(self._queries(queries), n, matrix, k)

    def _single_pass(self, q, n, matrix, k):
        from viquae_torch.ops.mips_fused import topk_fused

        q = q.to(self.dtype)
        k = min(k, n)
        if self.mode == "fused":
            return topk_fused(q, matrix, k, valid_rows=n)
        return topk_global(
            q, matrix, k, valid_rows=n, compute_dtype=self.dtype,
            mode="approx" if self.mode == "approx" else "exact",
            recall_target=self.approx_recall_target)

    def search_batch(self, queries, k: int = 100, sync: bool = True):
        """(scores, indices) of the top-k KB rows per query; scores f32,
        ids int32. A tensor stays on its device; anything else is uploaded.
        With ``sync=False`` the results stay device tensors and the call
        returns as soon as the work is enqueued."""
        q = self._queries(queries)
        n, matrix = self.snapshot()
        k = min(k, n)
        score_bytes = 4 if self.dtype == torch.float32 else 2
        if self.mode in ("fused", "global", "approx") or (
                self.mode == "fast"
                and q.shape[0] * matrix.shape[0] * score_bytes
                <= _SINGLE_PASS_BYTES):
            # single pass while the (Q, N) scores fit comfortably
            scores, idx = self._single_pass(q, n, matrix, k)
        else:
            scores, idx = topk_single(
                q, matrix, k, chunk_size=self.chunk_size, valid_rows=n,
                compute_dtype=self.dtype, mode=self.mode)
        if not sync:
            return scores, idx
        return scores.cpu().numpy(), idx.cpu().numpy()

    def add(self, vectors) -> None:
        """Append rows with ids [n, n + m) (FAISS IndexFlat.add).

        Rows that fit in the alignment padding are written IN PLACE: a
        search that holds the old count masks those rows, so it never sees
        them half written. Growth beyond the padding builds a new aligned
        matrix. Either way the matrix is bound first and the count last
        (``snapshot`` reads the count first)."""
        v = _as_rows(vectors, self.device)
        if v.ndim != 2 or v.shape[1] != self.d:
            raise ValueError(
                f"expected (m, {self.d}) vectors, got {tuple(v.shape)}")
        m = v.shape[0]
        if m == 0:
            return
        n, new_n = self.n, self.n + m
        mat = self.matrix
        if new_n > mat.shape[0]:
            grown = torch.zeros((_aligned_rows(new_n), self.d),
                                dtype=self.dtype, device=self.device)
            grown[:n] = mat[:n]
            mat = grown
        _store_rows(mat, n, v, self.do_l2norm)
        self.matrix = mat
        self.n = new_n

    def reconstruct_batch(self, ids) -> np.ndarray:
        """The STORED vectors for ``ids`` as f32 (FAISS ``reconstruct``):
        an L2norm index returns the normalized rows it searches, a bf16
        index the bf16-quantized values."""
        ids = np.asarray(ids)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n):
            raise IndexError(f"ids outside [0, {self.n})")
        if not ids.size:
            return np.zeros(ids.shape + (self.d,), np.float32)
        rows = torch.as_tensor(ids.astype(np.int64), device=self.device)
        return self.matrix[rows].float().cpu().numpy()

    def save(self, path) -> None:
        """Persist the vectors THIS index searches, as the reference's
        ``.npz`` (``vectors`` f32 (N, d), ``do_l2norm``, ``source_dtype``):
        the files load in either package. A bf16 index persists its
        bf16-quantized values."""
        np.savez(
            path,
            vectors=self.matrix[: self.n].float().cpu().numpy(),
            do_l2norm=self.do_l2norm,
            source_dtype=np.str_(str(self.dtype).removeprefix("torch.")),
        )

    @classmethod
    def load(cls, path, **kwargs):
        with np.load(path if str(path).endswith(".npz")
                     else f"{path}.npz") as data:
            # saved vectors are already normalized if do_l2norm was set
            index = cls(data["vectors"], do_l2norm=False, **kwargs)
            index.do_l2norm = bool(data["do_l2norm"])
        return index


class StreamingDenseIndex:
    """Host-resident flat MIPS index streamed through the card, for KBs
    beyond device memory (counterpart of the reference's
    ``StreamingDenseIndex``; same ``search_batch`` contract and tie order
    as :class:`DenseIndex`).

    The vectors live on the host in ``chunk_rows``-row chunks of ``dtype``
    (PINNED when the device is a GPU: a ``non_blocking`` copy from
    pageable memory is silently synchronous), the tail chunk zero-padded
    to the common shape. A search uploads chunk c+1 on a side stream while
    chunk c is scored: an event orders each copy before the compute that
    reads it, and another the compute before the copy that overwrites its
    buffer. The row count is snapshotted once per search.
    """

    def __init__(self, vectors, chunk_rows: int = 262144,
                 do_l2norm: bool = False, dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        src = _as_rows(vectors, None)
        self.n, self.d = 0, src.shape[1]
        self.do_l2norm = do_l2norm
        self.dtype = dtype
        self.mode = "streaming"  # a chunked engine: FusedRetrievalPipeline
        # rejects it, the base RetrievalPipeline serves it
        self.chunk_rows = int(chunk_rows)
        self._pin = self.device.type == "cuda"
        self._chunks = []
        for lo in range(0, src.shape[0], self.chunk_rows):
            self._append(src[lo: lo + self.chunk_rows])

    def _append(self, rows: torch.Tensor) -> None:
        """Write rows at ids [n, n + m) on the host (in place in the tail
        chunk's padding, new chunks as needed), then bind the count."""
        if self.do_l2norm:
            rows = l2_normalize(rows.float())
        rows = rows.to(self.dtype).cpu()
        done = 0
        while done < len(rows):
            ci, off = divmod(self.n + done, self.chunk_rows)
            if ci == len(self._chunks):
                self._chunks.append(torch.zeros(
                    (self.chunk_rows, self.d), dtype=self.dtype,
                    pin_memory=self._pin))
            take = min(self.chunk_rows - off, len(rows) - done)
            self._chunks[ci][off: off + take] = rows[done: done + take]
            done += take
        self.n += len(rows)

    def add(self, vectors) -> None:
        """Append rows (FAISS IndexFlat.add contract, the same id semantics
        as DenseIndex.add). A search that holds the old count masks the
        padding rows written here."""
        v = _as_rows(vectors, None)
        if v.ndim != 2 or v.shape[1] != self.d:
            raise ValueError(
                f"expected (m, {self.d}) vectors, got {tuple(v.shape)}")
        if len(v):
            self._append(v)

    def _device_chunks(self, n_chunks: int):
        """Yield chunks 0..n_chunks-1 on the device. On a GPU, chunk c+1's
        upload is enqueued on a side stream before chunk c is yielded, into
        the other of two buffers; the caller enqueues chunk c's work on the
        current stream before asking for the next."""
        chunks = self._chunks[:n_chunks]
        if self.device.type != "cuda":
            yield from chunks
            return
        compute = torch.cuda.current_stream(self.device)
        copy = torch.cuda.Stream(self.device)
        bufs = [torch.empty((self.chunk_rows, self.d), dtype=self.dtype,
                            device=self.device)
                for _ in range(min(2, n_chunks))]
        copied = [torch.cuda.Event() for _ in bufs]
        scored = [None] * len(bufs)

        def upload(c):
            b = c % 2
            with torch.cuda.stream(copy):
                if scored[b] is not None:
                    # the compute that read this buffer must finish first
                    copy.wait_event(scored[b])
                bufs[b].copy_(chunks[c], non_blocking=True)
                copied[b].record(copy)

        upload(0)
        for c in range(n_chunks):
            if c + 1 < n_chunks:
                upload(c + 1)
            b = c % 2
            compute.wait_event(copied[b])
            yield bufs[b]
            scored[b] = torch.cuda.Event()
            scored[b].record(compute)

    def _step(self, q, chunk, carry_s, carry_i, base: int, valid: int,
              k: int):
        """Score one chunk (bf16 scores for a bf16 index, masked past
        ``valid``), select its top-k and merge it into the carry."""
        scores = _scores_f32(q, chunk, chunk.dtype)
        if chunk.dtype != torch.float32:
            scores = scores.to(torch.bfloat16)
        col = torch.arange(chunk.shape[0], device=scores.device)
        scores.masked_fill_(col >= valid, NEG_INF)
        kk = min(k, self.chunk_rows)
        s, i = _select_topk(scores.float(), kk, "fast")
        i = torch.where(s <= NEG_INF, torch.full_like(i, INT32_MAX), i + base)
        return _merge_topk(carry_s, carry_i, *_pad_to_k(s, i, k), k)

    def search_batch(self, queries, k: int = 100, sync: bool = True):
        q = torch.as_tensor(queries, device=self.device).float()
        if self.do_l2norm:
            q = l2_normalize(q)
        q = q.to(self.dtype)
        q_count = q.shape[0]
        # the count ONCE: a concurrent add() can only lag this search
        n = self.n
        k_eff = min(k, n)
        scores = torch.full((q_count, k_eff), NEG_INF, dtype=torch.float32,
                            device=self.device)
        idx = torch.full((q_count, k_eff), INT32_MAX, dtype=torch.int64,
                         device=self.device)
        n_chunks = -(-n // self.chunk_rows)
        for c, chunk in enumerate(self._device_chunks(n_chunks)):
            base = c * self.chunk_rows
            scores, idx = self._step(q, chunk, scores, idx, base,
                                     min(self.chunk_rows, n - base), k_eff)
        scores, idx = _pad_to_k(scores, idx.to(torch.int32), k)
        if not sync:
            return scores, idx
        return scores.cpu().numpy(), idx.cpu().numpy()
