"""Streaming retrieval service (counterpart of viquae_tpu/ir/serving.py).

Built so the GPU is the only critical path:

- host tokenization + packing and the enqueueing of each batch's GPU work
  run in a prefetch thread (PyTorch returns before the GPU finishes, so
  batch i+1 is packed while batch i computes);
- embeddings stay on the GPU between embed and search;
- results are drained LAGGED: batch i's device->host copies start as soon
  as its work is enqueued, into pinned buffers, and the host reads them
  (after waiting on an event) while the GPU computes batch i+1;
- per-stage wall times come from core.profiling.StageTimer.

Ported: ``drain_lagged``, the ``run_arrays`` core of ``RetrievalPipeline``
and ``FusedRetrievalPipeline`` over a ``DenseIndex(mode="fused")``; the
fused branch of the JAX ``_device_search`` is ``DenseIndex.search_device``
(ops/mips.py), which ``search_batch`` shares. The rankeval ``Run`` output
and the compact upload dtypes are listed in ROADMAP.md.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from viquae_torch.core.profiling import StageTimer
from viquae_torch.utils.prefetch import PrefetchIterable


def drain_lagged(stream, drain_one):
    """Consume a prefetched stream keeping one batch pending: the host
    read of batch i runs while the device computes batch i+1."""
    pending: deque = deque()
    for item in PrefetchIterable(stream, buffer_size=2):
        pending.append(item)
        if len(pending) > 1:
            drain_one(pending.popleft())
    while pending:
        drain_one(pending.popleft())


class _HostCopy:
    """Device->host copies started now, read later.

    CUDA tensors are copied with ``non_blocking=True`` into PINNED buffers
    (into pageable memory such a copy is silently synchronous), and an
    event is recorded after the copies; :meth:`result` waits on the event,
    because pinned memory read before the copy has landed holds garbage.
    CPU tensors pass through."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if not tensors[0].is_cuda:
            self.host = tensors
            return
        self.host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in tensors)
        for h, t in zip(self.host, tensors):
            h.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(tensors[0].device))

    def result(self) -> Tuple[torch.Tensor, ...]:
        if self.event is not None:
            self.event.synchronize()
        return self.host


class RetrievalPipeline:
    """embed -> MIPS search, pipelined over a query stream.

    embed_fn: callable(list[str]) -> (B, d) tensor on the device — typically
        an ir.embedding.PackedTextEmbedder.
    index: ops.mips.DenseIndex (or anything with ``n`` and search_batch).
    """

    def __init__(self, embed_fn: Callable, index, batch_size: int = 1280,
                 k: int = 100, timer: Optional[StageTimer] = None):
        self.embed_fn = embed_fn
        self.index = index
        self.batch_size = batch_size
        # search_batch clamps k to the index size; clamp here too so the
        # output arrays match what the index can return
        self.k = min(k, index.n) if hasattr(index, "n") else k
        self.timer = timer or StageTimer("retrieval")

    def _batches(self, queries: List[str]):
        for start in range(0, len(queries), self.batch_size):
            yield start, queries[start: start + self.batch_size]

    def _drain_arrays(self, stream, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Drain a (start, n_real, scores, ids) stream of device tensors
        into (n, k) host arrays: f32 scores, int64 ids, input order."""
        scores_out = np.empty((n, self.k), np.float32)
        idx_out = np.empty((n, self.k), np.int64)

        def copies():
            for start, n_real, scores, idx in stream:
                yield start, n_real, _HostCopy(scores, idx)

        def drain_one(item):
            start, n_real, copy = item
            with self.timer.stage("drain_to_host"):
                scores, idx = copy.result()
                scores_out[start: start + n_real] = (
                    scores[:n_real].float().numpy())
                idx_out[start: start + n_real] = idx[:n_real].numpy()

        drain_lagged(copies(), drain_one)
        return scores_out, idx_out

    def run_arrays(self, queries: List[str]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores, indices) numpy arrays of shape (len(queries), k) in
        input order."""
        def stream():
            for start, chunk in self._batches(queries):
                with self.timer.stage("tokenize+embed_dispatch"):
                    embeddings = self.embed_fn(list(chunk))
                with self.timer.stage("search_dispatch"):
                    scores, idx = self.index.search_batch(
                        embeddings, k=self.k, sync=False)
                yield start, len(chunk), scores, idx

        return self._drain_arrays(stream(), len(queries))

    def report(self) -> dict:
        return self.timer.report()


class FusedRetrievalPipeline(RetrievalPipeline):
    """Tokenize+pack on the host, then one chain of device work per batch:
    packed embed -> (optional L2norm) -> fused exact search -> bf16 scores
    and int32 ids, so each batch costs one upload of the canvas and one
    download of the results.

    embedder: ir.embedding.PackedTextEmbedder; index: ops.mips.DenseIndex
    with mode 'fused'.
    """

    def __init__(self, embedder, index, batch_size: int = 1280,
                 k: int = 100, timer: Optional[StageTimer] = None):
        if index.mode != "fused":
            raise ValueError(
                f"FusedRetrievalPipeline requires a single-pass index mode "
                f"('fused'), got {index.mode!r}")
        super().__init__(embedder, index, batch_size=batch_size, k=k,
                         timer=timer)

    def _canvas_stream(self, queries):
        emb = self.embed_fn
        for start, chunk in self._batches(queries):
            with self.timer.stage("tokenize+pack+dispatch"):
                canvas = emb.upload(emb.pack(list(chunk)))
                scores, idx = self.index.search_device(
                    emb.forward(*canvas), *self.index.snapshot(), self.k)
            # bf16 scores are exact: the kernel rounded them
            yield start, len(chunk), scores.to(torch.bfloat16), idx

    def run_device(self, queries: List[str]
                   ) -> List[Tuple[int, torch.Tensor, torch.Tensor]]:
        """[(start, scores_bf16, ids_int32)] per batch, left on the device
        — for a consumer that stays on the GPU. Rows past the batch's real
        query count are padding. Host tokenize+pack runs in a prefetch
        thread."""
        return [
            (start, scores, idx)
            for start, _, scores, idx in PrefetchIterable(
                self._canvas_stream(queries), buffer_size=2)
        ]

    def run_arrays(self, queries: List[str]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        return self._drain_arrays(self._canvas_stream(queries), len(queries))
