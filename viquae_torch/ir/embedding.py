"""Packed-canvas query embedding (counterpart of the PackedTextEmbedder in
viquae_tpu/ir/embedding.py).

Tokenizes WITHOUT padding, packs the batch into one (rows, row_len) canvas
(ops/packing.py) and runs a block-diagonal forward — ~3x fewer encoder
FLOPs than padding questions to max length. Canvas row counts round up to
ROWS_GRANULARITY so a stable query-length distribution gives few shapes.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from viquae_torch.core.device import resolve_device
from viquae_torch.ops import packing


class PackedTextEmbedder:
    """packed_apply_fn(params, input_ids, segment_ids, position_ids,
    cls_rows, cls_cols, compute_dtype=...) -> (n_cls, D); e.g.
    ``models.dpr.make_packed_apply(cfg)``. ``tokenizer`` is any callable
    with the HF call contract ``tok(texts, truncation=True,
    max_length=...)["input_ids"]`` -> one list of token ids per text."""

    ROWS_GRANULARITY = 32

    def __init__(
        self,
        packed_apply_fn: Callable,
        params,
        tokenizer,
        row_len: int = 64,
        batch_size: int = 1280,
        compute_dtype=torch.bfloat16,
        device=None,
    ):
        self.packed_apply_fn = packed_apply_fn
        self.params = params
        self.tokenizer = tokenizer
        self.row_len = row_len
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)

    def pack(self, texts) -> packing.PackedBatch:
        """Host side only: tokenize without padding + pack into a canvas
        rounded to ROWS_GRANULARITY rows."""
        if len(texts) > self.batch_size:
            raise ValueError(f"{len(texts)} texts > batch_size "
                             f"{self.batch_size}")
        enc = self.tokenizer(
            list(texts), truncation=True, max_length=self.row_len,
        )["input_ids"]
        seqs = [np.asarray(s, np.int32) for s in enc]
        return packing.pack_token_sequences(
            seqs, self.row_len, n_rows=None,
            pad_rows_to=self.ROWS_GRANULARITY, n_cls=self.batch_size,
        )

    def upload(self, p: packing.PackedBatch):
        """The canvas arrays as tensors on the embedder's device."""
        return tuple(
            torch.from_numpy(a).to(self.device)
            for a in (p.input_ids, p.segment_ids, p.position_ids,
                      p.cls_rows, p.cls_cols))

    @torch.no_grad()
    def forward(self, ids, seg, pos, cr, cc) -> torch.Tensor:
        """The packed forward on uploaded canvas tensors -> (n_cls, D) f32.
        Grad mode is off here, not around the caller: it is per thread, and
        the serving loop calls this from its prefetch thread."""
        return self.packed_apply_fn(self.params, ids, seg, pos, cr, cc,
                                    compute_dtype=self.compute_dtype)

    def embed_texts(self, texts) -> torch.Tensor:
        """(batch_size, D) on the device; rows past len(texts) are garbage
        (pad pointers) — callers slice. Nothing waits for the device here,
        so the next batch's tokenization overlaps this one's compute."""
        return self.forward(*self.upload(self.pack(texts)))

    def __call__(self, texts):
        return self.embed_texts(texts)
