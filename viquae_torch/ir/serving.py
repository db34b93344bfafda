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

Ported: ``drain_lagged``, ``RetrievalPipeline`` (``run_arrays`` and the
rankeval ``Run`` output), ``FusedRetrievalPipeline`` over a "global",
"approx" or "fused" ``DenseIndex``, and ``MultiIndexRetrievalPipeline``
(late fusion) with precomputed query features. The reference's
``_device_search`` is ``DenseIndex.search_device`` (ops/mips.py). The
compact int8/int16 upload dtypes and the online image and face legs of the
multi-index pipeline are listed in ROADMAP.md.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from viquae_torch.core.profiling import StageTimer
from viquae_torch.ops import mips
from viquae_torch.ops.fusion import fuse_topk
from viquae_torch.rankeval import Run
from viquae_torch.utils.prefetch import PrefetchIterable

_SINGLE_PASS = ("global", "approx", "fused")


def _build_run(scores, indices, query_ids, name):
    results: Dict[str, Dict[str, float]] = {}
    score_rows = scores.tolist()   # bulk-convert: much faster than
    idx_rows = indices.tolist()    # per-element float()/str()
    for row, q_id in enumerate(query_ids):
        results[q_id] = dict(zip(map(str, idx_rows[row]), score_rows[row]))
    return Run(results, name=name)


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

    def run(self, query_ids: List[str], queries: List[str]) -> Run:
        """Retrieve for all queries; returns a rankeval Run."""
        assert len(query_ids) == len(queries)
        scores, indices = self.run_arrays(queries)
        with self.timer.stage("build_run"):
            return _build_run(scores, indices, query_ids, "serving")

    def report(self) -> dict:
        return self.timer.report()


class FusedRetrievalPipeline(RetrievalPipeline):
    """Tokenize+pack on the host, then one chain of device work per batch:
    packed embed -> (optional L2norm) -> single-pass search -> bf16 scores
    and int32 ids, so each batch costs one upload of the canvas and one
    download of the results. The scores are rounded to bf16 for every
    index, an f32 one included, as the reference's wire format is.

    embedder: ir.embedding.PackedTextEmbedder; index: ops.mips.DenseIndex
    with mode 'global', 'approx' or 'fused' (chunked 'fast'/'exact'
    indexes go through the base RetrievalPipeline).
    """

    def __init__(self, embedder, index, batch_size: int = 1280,
                 k: int = 100, timer: Optional[StageTimer] = None):
        if index.mode not in _SINGLE_PASS:
            raise ValueError(
                f"FusedRetrievalPipeline requires a single-pass index mode "
                f"('global'/'approx'/'fused'), got {index.mode!r} — use "
                "RetrievalPipeline for chunked modes")
        super().__init__(embedder, index, batch_size=batch_size, k=k,
                         timer=timer)

    def _canvas_stream(self, queries):
        emb = self.embed_fn
        for start, chunk in self._batches(queries):
            with self.timer.stage("tokenize+pack+dispatch"):
                canvas = emb.upload(emb.pack(list(chunk)))
                scores, idx = self.index.search_device(
                    emb.forward(*canvas), *self.index.snapshot(), self.k)
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


class MultiIndexRetrievalPipeline(FusedRetrievalPipeline):
    """Late-fusion serving: the reference's best retrieval configurations
    (e.g. DPR + ImageNet + CLIP + ArcFace, wsum [0.3, 0.2, 0.2, 0.2], gzmuv,
    default minimum) as one chain of device work per batch:

        packed text embed -> per-index single-pass search -> fuse_topk

    The text index is searched with the packed DPR tower; every other index
    with PRECOMPUTED per-query features passed to ``run_arrays`` (the
    reference embeds query images and faces in offline stages). A feature
    row with a NaN is that query's "no image / no face": the query is
    absent from that index's run (-inf scores, INT32_MAX ids), which the
    default-minimum imputation of fuse_topk then skips. Features for a
    bf16 index are rounded to bf16 before the f32 L2 norm, as the
    reference's default compact upload does; an f32 index gets them in
    f32. All indexes share one doc-id space. gzmuv's global statistics are
    per serving batch (the batch plays the role of the run), over the
    batch's real queries only.

    indexes: {name: DenseIndex} (insertion order = fusion order), each in
    a single-pass mode; weights: {name: float}; text_index: the name
    searched with the query TEXT. k is clamped to the smallest index.
    """

    def __init__(self, embedder, indexes, weights, text_index: str,
                 batch_size: int = 1280, k: int = 100,
                 norm: str = "gzmuv", timer: Optional[StageTimer] = None,
                 image_encoders=None, face_encoders=None):
        if image_encoders or face_encoders:
            raise NotImplementedError(
                "the online image and face legs (image_encoders, "
                "face_encoders) are not ported yet (ROADMAP.md A14): pass "
                "precomputed query_features")
        if text_index not in indexes:
            raise ValueError(f"text_index {text_index!r} not in indexes "
                             f"{list(indexes)}")
        bad = [n for n, ix in indexes.items() if ix.mode not in _SINGLE_PASS]
        if bad:
            raise ValueError(
                f"MultiIndexRetrievalPipeline requires single-pass index "
                f"modes ('global'/'approx'/'fused'); got chunked modes for "
                f"{bad}")
        if set(weights) != set(indexes):
            raise ValueError("weights keys must match indexes keys")
        super().__init__(embedder, indexes[text_index],
                         batch_size=batch_size,
                         k=min([k] + [ix.n for ix in indexes.values()]),
                         timer=timer)
        self.indexes = dict(indexes)
        self.names = list(indexes)
        self.text_index = text_index
        self.norm = norm
        self.weights = tuple(float(weights[n]) for n in self.names)

    def _features(self, name: str, features, start: int, count: int
                  ) -> torch.Tensor:
        """One batch of an index's query features on the device, padded
        with zero rows to the canvas's batch_size CLS slots (fuse_topk's
        valid_queries keeps the pad rows out of the gzmuv statistics)."""
        rows = np.asarray(features[start: start + count], np.float32)
        if len(rows) < self.batch_size:
            rows = np.concatenate([rows, np.zeros(
                (self.batch_size - len(rows),) + rows.shape[1:], np.float32)])
        index = self.indexes[name]
        dtype = (torch.bfloat16 if index.dtype == torch.bfloat16
                 else torch.float32)
        return torch.from_numpy(rows).to(index.device).to(dtype)

    def _canvas_stream(self, queries, query_features):
        emb = self.embed_fn
        for start, chunk in self._batches(queries):
            with self.timer.stage("tokenize+pack+dispatch"):
                # each index's count read before its matrix (snapshot)
                snaps = {n: ix.snapshot() for n, ix in self.indexes.items()}
                q_text = emb.forward(*emb.upload(emb.pack(list(chunk))))
                scores_list, idx_list = [], []
                for name in self.names:
                    ok = None
                    if name == self.text_index:
                        q = q_text
                    else:
                        q = self._features(name, query_features[name],
                                           start, len(chunk))
                        ok = torch.isfinite(q).all(dim=1, keepdim=True)
                        q = torch.where(ok, q, 0.0)
                    s, i = self.indexes[name].search_device(
                        q, *snaps[name], self.k)
                    if ok is not None:
                        # the query is absent from this index's run
                        s = torch.where(ok, s, mips.NEG_INF)
                        i = torch.where(ok, i, mips.INT32_MAX)
                    scores_list.append(s)
                    idx_list.append(i)
                fused, fused_idx = fuse_topk(
                    scores_list, idx_list, self.weights, self.k,
                    norm=self.norm, valid_queries=len(chunk))
            yield start, len(chunk), fused.to(torch.bfloat16), fused_idx

    def _validate_inputs(self, queries, query_features, query_images):
        if query_images:
            raise ValueError(
                f"query_images keys {sorted(query_images)} must match "
                f"image_encoders + face_encoders []")
        missing = set(self.names) - {self.text_index} - set(query_features)
        if missing:
            raise ValueError(f"missing query_features for indexes "
                             f"{sorted(missing)}")
        unknown = set(query_features) - set(self.names)
        if unknown:
            raise ValueError(
                f"query_features keys {sorted(unknown)} are not index "
                f"names {sorted(self.names)}")
        n = len(queries)
        for name, f in query_features.items():
            if len(f) != n:
                raise ValueError(
                    f"query_features[{name!r}] has {len(f)} rows for "
                    f"{n} queries")

    def run_arrays(self, queries, query_features=None, query_images=None):
        query_features = query_features or {}
        self._validate_inputs(queries, query_features, query_images)
        return self._drain_arrays(
            self._canvas_stream(queries, query_features), len(queries))

    def run(self, query_ids, queries, query_features=None,
            query_images=None):
        assert len(query_ids) == len(queries)
        scores, indices = self.run_arrays(queries, query_features,
                                          query_images)
        with self.timer.stage("build_run"):
            return _build_run(scores, indices, query_ids, "serving-fusion")

    def run_device(self, queries, query_features=None, query_images=None):
        """[(start, scores_bf16, ids_int32)] per batch, left on the
        device; rows past the batch's real query count are padding."""
        query_features = query_features or {}
        self._validate_inputs(queries, query_features, query_images)
        return [
            (start, scores, idx)
            for start, _, scores, idx in PrefetchIterable(
                self._canvas_stream(queries, query_features), buffer_size=2)
        ]
