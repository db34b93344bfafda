"""Sequence packing for the query-embedding hot path.

Counterpart of viquae_tpu/ops/packing.py (host-only numpy plus the C++
first-fit-decreasing packer in ``native/packer.cpp``); the port owns this
copy so that it never imports the JAX package. Many short questions share
each row of one fixed (rows, row_len) canvas; attention is block-diagonal
via segment ids, position ids restart per segment, and each question's
[CLS] hidden state is gathered afterwards.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PackedBatch:
    """Fixed-shape packed canvas + bookkeeping to unpack results.

    input_ids / segment_ids / position_ids: (rows, row_len) int32.
    segment_ids are 1-based per row; 0 marks padding.
    cls_rows / cls_cols: (n_cls,) int32 — position of sequence i's first
    token (its [CLS]) in the canvas, in the ORIGINAL input order. Entries
    beyond ``n_seqs`` point at (0, 0) and must be sliced off / ignored.
    """

    input_ids: np.ndarray
    segment_ids: np.ndarray
    position_ids: np.ndarray
    cls_rows: np.ndarray
    cls_cols: np.ndarray
    n_seqs: int

    @property
    def rows(self) -> int:
        return self.input_ids.shape[0]

    @property
    def row_len(self) -> int:
        return self.input_ids.shape[1]


def pack_token_sequences(
    seqs: Sequence[np.ndarray],
    row_len: int,
    n_rows: Optional[int] = None,
    n_cls: Optional[int] = None,
    pad_rows_to: int = 8,
    pad_token_id: int = 0,
) -> PackedBatch:
    """Pack variable-length token sequences into a (rows, row_len) canvas.

    Greedy first-fit-decreasing bin packing (deterministic). Sequences
    longer than ``row_len`` are truncated. ``n_rows``/``n_cls`` fix the
    output shapes; rows grow in multiples of ``pad_rows_to`` when unset.
    Raises if a fixed ``n_rows`` can't hold everything.
    """
    lengths = np.array([min(len(s), row_len) for s in seqs], dtype=np.int64)
    if (lengths == 0).any():
        # a zero-length sequence writes no segment id but still claims a
        # CLS pointer, which would alias another segment
        bad = int(np.nonzero(lengths == 0)[0][0])
        raise ValueError(
            f"pack_token_sequences got an empty sequence at position "
            f"{bad}; every sequence needs at least one token"
        )
    n = len(seqs)
    if n > 0:
        native = _native_pack(seqs, lengths, row_len, n_rows, n_cls,
                              pad_rows_to, pad_token_id)
        if native is not None:
            return native
    order = np.argsort(-lengths, kind="stable")  # longest first

    # first-fit-decreasing over per-row remaining capacity
    row_free: List[int] = []
    placement = np.empty((n, 2), dtype=np.int64)  # (row, col) per seq
    for i in order:
        li = int(lengths[i])
        for r, free in enumerate(row_free):
            if free >= li:
                placement[i] = (r, row_len - free)
                row_free[r] = free - li
                break
        else:
            placement[i] = (len(row_free), 0)
            row_free.append(row_len - li)

    rows_used = max(len(row_free), 1)
    if n_rows is None:
        n_rows = -(-rows_used // pad_rows_to) * pad_rows_to
    elif rows_used > n_rows:
        raise ValueError(
            f"packing needs {rows_used} rows of {row_len}, but n_rows={n_rows}"
        )
    if n_cls is None:
        n_cls = n
    elif n > n_cls:
        raise ValueError(f"{n} sequences but n_cls={n_cls}")

    input_ids = np.full((n_rows, row_len), pad_token_id, dtype=np.int32)
    segment_ids = np.zeros((n_rows, row_len), dtype=np.int32)
    position_ids = np.zeros((n_rows, row_len), dtype=np.int32)
    seg_counter = np.zeros(n_rows, dtype=np.int32)
    cls_rows = np.zeros(n_cls, dtype=np.int32)
    cls_cols = np.zeros(n_cls, dtype=np.int32)

    # fill in original order so ties keep input order within each row
    for i in range(n):
        r, c = int(placement[i, 0]), int(placement[i, 1])
        li = int(lengths[i])
        seg_counter[r] += 1
        input_ids[r, c: c + li] = np.asarray(seqs[i][:li], dtype=np.int32)
        segment_ids[r, c: c + li] = seg_counter[r]
        position_ids[r, c: c + li] = np.arange(li, dtype=np.int32)
        cls_rows[i] = r
        cls_cols[i] = c

    return PackedBatch(
        input_ids=input_ids,
        segment_ids=segment_ids,
        position_ids=position_ids,
        cls_rows=cls_rows,
        cls_cols=cls_cols,
        n_seqs=n,
    )


def _native_pack(seqs, lengths, row_len, n_rows, n_cls, pad_rows_to,
                 pad_token_id) -> Optional[PackedBatch]:
    """C++ FFD packer fast path (native/packer.cpp) — bit-identical to the
    Python algorithm; returns None when the native lib is absent
    (VIQUAE_NO_NATIVE=1 or g++ unavailable)."""
    from viquae_torch.native.build import load_packer

    fn = load_packer()
    if fn is None:
        return None
    n = len(seqs)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    tokens = np.empty(int(offsets[-1]), np.int32)
    for i, s in enumerate(seqs):
        tokens[offsets[i]: offsets[i + 1]] = np.asarray(
            s[: int(lengths[i])], np.int32
        )
    max_rows = n  # worst case: one sequence per row
    input_ids = np.full((max_rows, row_len), pad_token_id, np.int32)
    segment_ids = np.zeros((max_rows, row_len), np.int32)
    position_ids = np.zeros((max_rows, row_len), np.int32)
    cls_rows = np.zeros(max(n_cls or n, n), np.int32)
    cls_cols = np.zeros(max(n_cls or n, n), np.int32)
    rows_used = np.zeros(1, np.int64)
    status = fn(tokens, offsets, n, row_len, max_rows,
                input_ids, segment_ids, position_ids,
                cls_rows, cls_cols, rows_used)
    if status != 0:  # max_rows == n always holds everything
        raise RuntimeError(f"native packer failed with status {status}")
    used = int(rows_used[0])
    if n_rows is None:
        n_rows = -(-used // pad_rows_to) * pad_rows_to
    elif used > n_rows:
        raise ValueError(
            f"packing needs {used} rows of {row_len}, but n_rows={n_rows}"
        )
    if n_cls is None:
        n_cls = n
    elif n > n_cls:
        raise ValueError(f"{n} sequences but n_cls={n_cls}")

    def fit(canvas, fill):
        if n_rows <= max_rows:
            return np.ascontiguousarray(canvas[:n_rows])
        return np.concatenate([
            canvas,
            np.full((n_rows - max_rows, row_len), fill, np.int32),
        ])

    return PackedBatch(
        input_ids=fit(input_ids, pad_token_id),
        segment_ids=fit(segment_ids, 0),
        position_ids=fit(position_ids, 0),
        cls_rows=cls_rows[:n_cls].copy(),
        cls_cols=cls_cols[:n_cls].copy(),
        n_seqs=n,
    )


def packing_efficiency(packed: PackedBatch) -> float:
    """Fraction of canvas tokens that are real (non-padding)."""
    return float((packed.segment_ids > 0).mean())


def pad_packed_rows(packed: PackedBatch, n_rows: int,
                    pad_token_id: int = 0) -> PackedBatch:
    """Grow a canvas to ``n_rows`` by appending all-padding rows
    (segment_id 0 -> inert under packed attention), so callers can pin a
    stable row budget across batches. Existing cls pointers stay valid —
    rows are appended, never reordered."""
    extra = n_rows - packed.rows
    if extra < 0:
        raise ValueError(
            f"pad_packed_rows: canvas already has {packed.rows} rows > "
            f"requested {n_rows}"
        )
    if extra == 0:
        return packed
    pad = ((0, extra), (0, 0))
    return PackedBatch(
        input_ids=np.pad(packed.input_ids, pad,
                         constant_values=pad_token_id),
        segment_ids=np.pad(packed.segment_ids, pad),
        position_ids=np.pad(packed.position_ids, pad),
        cls_rows=packed.cls_rows,
        cls_cols=packed.cls_cols,
        n_seqs=packed.n_seqs,
    )


def pack_parallel(packed: PackedBatch, seqs: Sequence[np.ndarray],
                  pad_value: int = 0) -> np.ndarray:
    """Lay a parallel per-token feature (e.g. token_type_ids) onto an
    existing canvas: seqs[i] must align with the input_ids sequence i was
    packed from."""
    out = np.full_like(packed.input_ids, pad_value)
    row_len = packed.row_len
    for i in range(packed.n_seqs):
        r, c = int(packed.cls_rows[i]), int(packed.cls_cols[i])
        li = int((packed.segment_ids[r] == packed.segment_ids[r, c]).sum())
        out[r, c: c + li] = np.asarray(seqs[i][:li], out.dtype)
    return out


def gather_indices(packed: PackedBatch, out_len: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat canvas indices to UNPACK per-sequence token features.

    Returns (idx, mask), both (n_cls, out_len): idx[i, t] is the flat
    (row * row_len + col) position of sequence i's t-th token; mask marks
    real tokens (False entries point at (0, 0) — mask before use). The
    packed reader uses this to lift canvas logits back to the reference's
    (N*M, L) layout (models/qa.reader_apply_packed)."""
    n_cls = len(packed.cls_rows)
    row_len = packed.row_len
    idx = np.zeros((n_cls, out_len), np.int32)
    mask = np.zeros((n_cls, out_len), bool)
    for i in range(packed.n_seqs):
        r, c = int(packed.cls_rows[i]), int(packed.cls_cols[i])
        li = min(int((packed.segment_ids[r] == packed.segment_ids[r, c]).sum()),
                 out_len)
        idx[i, :li] = r * row_len + c + np.arange(li, dtype=np.int32)
        mask[i, :li] = True
    return idx, mask


def pack_with_reserved(
    seqs: Sequence[np.ndarray],
    n_reserved: int,
    row_len: int,
    n_rows: Optional[int] = None,
    n_cls: Optional[int] = None,
    pad_rows_to: int = 8,
    pad_token_id: int = 0,
) -> Tuple[PackedBatch, np.ndarray, np.ndarray]:
    """Pack sequences with ``n_reserved`` extra canvas slots per sequence.

    The reserved slots sit right after each sequence's tokens inside its
    segment — the multimodal (ECA) packed path scatters face/image tokens
    there (models/mm.eca_apply_packed). Returns (packed, res_rows,
    res_cols) with the reserved positions as (n_cls, n_reserved) int32 in
    ORIGINAL input order; entries past ``n_seqs`` point OUT OF BOUNDS
    (rows, 0) so a scatter that drops out-of-range entries ignores them.

    Sequences longer than row_len - n_reserved are truncated so the
    reserved slots always fit.
    """
    max_text = row_len - n_reserved
    assert max_text > 0, (row_len, n_reserved)
    trimmed = [s[:max_text] for s in seqs]
    ext = [
        np.concatenate([s, np.full(n_reserved, pad_token_id, s.dtype)])
        for s in trimmed
    ]
    p = pack_token_sequences(
        ext, row_len, n_rows=n_rows, n_cls=n_cls,
        pad_rows_to=pad_rows_to, pad_token_id=pad_token_id,
    )
    n_out = len(p.cls_rows)
    res_rows = np.full((n_out, n_reserved), p.rows, np.int32)  # OOB default
    res_cols = np.zeros((n_out, n_reserved), np.int32)
    lens = np.array([len(s) for s in trimmed], np.int32)
    offs = np.arange(n_reserved, dtype=np.int32)[None, :]
    k = p.n_seqs
    res_rows[:k] = p.cls_rows[:k, None]
    res_cols[:k] = p.cls_cols[:k, None] + lens[:k, None] + offs
    return p, res_rows, res_cols
