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
"approx" or "fused" ``DenseIndex``, ``MultiIndexRetrievalPipeline``
(late fusion) with online image and face legs or precomputed query
features, and ``HybridRetrievalPipeline`` (BM25 on the host or the device +
dense). The
reference's ``_device_search`` is ``DenseIndex.search_device``
(ops/mips.py). ``compact_transfer`` chooses the dtype of uploaded query
features as in the reference; the integer canvas always goes up as int32
(the reference's int8/int16 wire dtypes buy nothing on PCIe). Every upload
goes through pinned staging buffers (core/device.py ``upload``), so no
dispatch waits for the device; the one read back inside a batch is the
online face leg's (once per sub-batch, as in the reference).

On a mesh (core/mesh.py) the pipelines take a kb-sharded index through
``DenseIndex.search_device`` and a ``ShardedDeviceBM25`` unchanged, and a
packed embedder splits each batch over ``data``: every rank of the mesh
runs the same stream and returns the same arrays.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from viquae_torch.core.device import HostCopy as _HostCopy, upload
from viquae_torch.core.profiling import StageTimer
from viquae_torch.ops import mips
from viquae_torch.ops.fusion import fuse_topk
from viquae_torch.rankeval import Run
from viquae_torch.train.prefetch import PrefetchIterable

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
                 k: int = 100, timer: Optional[StageTimer] = None,
                 compact_transfer: bool = True):
        if index.mode not in _SINGLE_PASS:
            raise ValueError(
                f"FusedRetrievalPipeline requires a single-pass index mode "
                f"('global'/'approx'/'fused'), got {index.mode!r} — use "
                "RetrievalPipeline for chunked modes")
        super().__init__(embedder, index, batch_size=batch_size, k=k,
                         timer=timer)
        self.compact = compact_transfer

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

    The text index is searched with the packed DPR tower. An index named in
    ``image_encoders`` (``image.embedding.ImageEmbedder``) is searched with
    an embedding computed in the same chain of device work from the raw
    query-image canvas: host decode, one uint8 upload, device preprocess
    and tower. An index named in ``face_encoders``
    (``image.face_recognition.FaceQueryEncoder``) gets the online face leg
    (pixels -> MTCNN -> align -> ArcFace), run per batch on the host side
    of the stream (it reads its results back once per sub-batch) and fed
    through the same path as precomputed features. Every other index takes
    PRECOMPUTED per-query features passed to ``run_arrays``. A query
    without an image, or a feature row with a NaN (no image / no face), is
    absent from that index's run (-inf scores, INT32_MAX ids), which the
    default-minimum imputation of fuse_topk then skips. With
    ``compact_transfer`` (the default) features for a bf16 index are
    rounded to bf16 before the f32 L2 norm, as the reference's compact
    upload does; without it, and for an f32 index, they go up in f32 and
    are normalised before the cast. All indexes share one doc-id space.
    gzmuv's global statistics are per serving batch (the batch plays the
    role of the run), over the batch's real queries only.

    indexes: {name: DenseIndex} (insertion order = fusion order), each in
    a single-pass mode; weights: {name: float}; text_index: the name
    searched with the query TEXT; query_images: {name: [PIL.Image | None]
    * n_queries} for the names with an image or face encoder. k is clamped
    to the smallest index.
    """

    def __init__(self, embedder, indexes, weights, text_index: str,
                 batch_size: int = 1280, k: int = 100,
                 norm: str = "gzmuv", timer: Optional[StageTimer] = None,
                 compact_transfer: bool = True,
                 image_encoders=None, face_encoders=None):
        if text_index not in indexes:
            raise ValueError(f"text_index {text_index!r} not in indexes "
                             f"{list(indexes)}")
        face_encoders = dict(face_encoders or {})
        bad_face = ((set(face_encoders) - set(indexes))
                    | (set(face_encoders) & set(image_encoders or {}))
                    | ({text_index} & set(face_encoders)))
        if bad_face:
            raise ValueError(
                f"face_encoders must name non-text indexes distinct from "
                f"image_encoders; offending: {sorted(bad_face)}")
        bad = [n for n, ix in indexes.items() if ix.mode not in _SINGLE_PASS]
        if bad:
            raise ValueError(
                f"MultiIndexRetrievalPipeline requires single-pass index "
                f"modes ('global'/'approx'/'fused'); got chunked modes for "
                f"{bad}")
        if set(weights) != set(indexes):
            raise ValueError("weights keys must match indexes keys")
        image_encoders = dict(image_encoders or {})
        unknown = set(image_encoders) - set(indexes)
        if unknown or text_index in image_encoders:
            raise ValueError(
                f"image_encoders must name non-text indexes; got "
                f"{sorted(image_encoders)} vs indexes {list(indexes)} "
                f"(text: {text_index!r})")
        super().__init__(embedder, indexes[text_index],
                         batch_size=batch_size,
                         k=min([k] + [ix.n for ix in indexes.values()]),
                         timer=timer, compact_transfer=compact_transfer)
        self.indexes = dict(indexes)
        self.names = list(indexes)
        self.text_index = text_index
        self.norm = norm
        self.weights = tuple(float(weights[n]) for n in self.names)
        self.image_encoders = image_encoders
        self.face_encoders = face_encoders

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
        dtype = (torch.bfloat16
                 if self.compact and index.dtype == torch.bfloat16
                 else torch.float32)
        return upload(rows, index.device).to(dtype)

    def _canvas_stream(self, queries, query_features, query_images):
        from viquae_torch.image.embedding import decode_image_batch

        emb = self.embed_fn
        for start, chunk in self._batches(queries):
            stop = start + len(chunk)
            with self.timer.stage("face_legs"):
                # the face leg reads back once per sub-batch: run it before
                # this batch's device work is enqueued
                faces = {n: enc(query_images[n][start: stop])
                         for n, enc in self.face_encoders.items()}
            with self.timer.stage("tokenize+pack+dispatch"):
                # each index's count read before its matrix (snapshot)
                snaps = {n: ix.snapshot() for n, ix in self.indexes.items()}
                q_text = emb.forward(*emb.upload(emb.pack(list(chunk))))
                scores_list, idx_list = [], []
                for name in self.names:
                    ok = None
                    if name == self.text_index:
                        q = q_text
                    elif name in self.image_encoders:
                        # raw uint8 canvas -> preprocess + tower, enqueued
                        # with the rest of the batch
                        enc = self.image_encoders[name]
                        canvas, present = decode_image_batch(
                            query_images[name][start: stop], enc.raw_size,
                            self.batch_size)
                        q = enc._forward(enc.params,
                                         upload(canvas, enc.device))
                        ok = upload(present, q.device)[:, None]
                    else:
                        # a face leg's rows are this batch's alone
                        rows, at = ((faces[name], 0) if name in faces
                                    else (query_features[name], start))
                        q = self._features(name, rows, at, len(chunk))
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
        online = set(self.image_encoders) | set(self.face_encoders)
        if set(query_images) != online:
            raise ValueError(
                f"query_images keys {sorted(query_images)} must match "
                f"image_encoders + face_encoders {sorted(online)}")
        missing = (set(self.names) - {self.text_index}
                   - set(query_features) - online)
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
        for name, imgs in query_images.items():
            if len(imgs) != n:
                raise ValueError(
                    f"query_images[{name!r}] has {len(imgs)} entries for "
                    f"{n} queries")

    def _stream(self, queries, query_features, query_images):
        query_features = query_features or {}
        query_images = query_images or {}
        self._validate_inputs(queries, query_features, query_images)
        return self._canvas_stream(queries, query_features, query_images)

    def run_arrays(self, queries, query_features=None, query_images=None):
        return self._drain_arrays(
            self._stream(queries, query_features, query_images),
            len(queries))

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
        return [
            (start, scores, idx)
            for start, _, scores, idx in PrefetchIterable(
                self._stream(queries, query_features, query_images),
                buffer_size=2)
        ]


class HybridRetrievalPipeline(FusedRetrievalPipeline):
    """Hybrid sparse+dense serving: BM25 (the host C++ scorer over the CSR
    inverted index, ops/bm25.py + native/bm25_scorer.cpp, or the device
    scorer, ops/bm25_device.py) interpolated with dense MIPS on the
    device, fused into one ranking per batch.

    Both legs retrieve top-k' candidates over the SAME passage id space
    and are combined by weighted sum. Two interpolation semantics:

    - norm="gzmuv" (default) — the Fusion semantics (gzmuv normalisation +
      default-minimum imputation, ir/fuse.py), computed on the device by
      ops.fusion.fuse_topk;
    - norm="raw" + stats — the committed legacy config semantics
      (`normalization` {mean, std} + `interpolation_weight`): each leg's
      scores are pre-normalised (s - mean)/std with CORPUS-level
      statistics and summed with the weights; absent docs contribute 0.

    The schedule overlaps the two legs: the dense leg is enqueued BEFORE
    the sparse leg runs, so host BM25 scoring (or the device scorer's host
    planning) hides behind device compute; the fuse is enqueued last.

    bm25_index: anything with ``n_docs`` and ``search_batch``; a backend
    that also has ``search_batch_device`` keeps its results on the device.
    weights: (dense_weight, bm25_weight) — the reference's tuned BM25
    interpolation weight is 0.3 (bm25 leg), i.e. weights=(0.7, 0.3).
    """

    def __init__(self, embedder, index, bm25_index, weights=(0.7, 0.3),
                 batch_size: int = 1280, k: int = 100,
                 k_bm25: Optional[int] = None, norm: str = "gzmuv",
                 stats=None, timer: Optional[StageTimer] = None,
                 compact_transfer: bool = True):
        super().__init__(embedder, index, batch_size=batch_size, k=k,
                         timer=timer, compact_transfer=compact_transfer)
        if stats is not None and norm != "raw":
            raise ValueError(
                "fixed (mean, std) stats are the legacy interpolation "
                "semantics; use norm='raw' with them")
        if norm == "raw" and stats is None:
            raise ValueError(
                "norm='raw' interpolates unnormalized scores; pass "
                "stats=((dense_mean, dense_std), (bm25_mean, bm25_std)) "
                "(the committed configs' `normalization` block), or use "
                "norm='gzmuv'")
        self.bm25 = bm25_index
        self.k_bm25 = min(k_bm25 or self.k, bm25_index.n_docs)
        self.weights = (float(weights[0]), float(weights[1]))
        self.norm = norm
        self.stats = stats

    @torch.no_grad()
    def _fuse(self, d_scores, d_idx, b_scores, b_idx, n_valid: int):
        d_s, b_s = d_scores.float(), b_scores.float()
        if self.stats is not None:
            (d_mean, d_std), (b_mean, b_std) = self.stats
            d_s = torch.where(d_idx != mips.INT32_MAX,
                              (d_s - d_mean) / d_std, 0.0)
            b_s = torch.where(b_idx != mips.INT32_MAX,
                              (b_s - b_mean) / b_std, 0.0)
        fused, fused_idx = fuse_topk(
            (d_s, b_s), (d_idx.to(torch.int32), b_idx), self.weights,
            self.k, norm=self.norm, valid_queries=n_valid)
        return fused.to(torch.bfloat16), fused_idx

    def _bm25_arrays(self, chunk):
        """Host scoring -> fixed-shape (batch_size, k_bm25) arrays in the
        framework pad convention (id INT32_MAX, score -inf)."""
        scores_b, idx_b = self.bm25.search_batch(list(chunk), k=self.k_bm25)
        s = np.full((self.batch_size, self.k_bm25), -np.inf, np.float32)
        i = np.full((self.batch_size, self.k_bm25),
                    np.iinfo(np.int32).max, np.int32)
        for row, (ss, ii) in enumerate(zip(scores_b, idx_b)):
            s[row, : len(ss)] = ss
            i[row, : len(ii)] = ii
        return s, i

    def _canvas_stream(self, queries):
        emb = self.embed_fn
        device = self.index.device
        for start, chunk in self._batches(queries):
            with self.timer.stage("tokenize+pack+dense_dispatch"):
                snap = self.index.snapshot()  # n before matrix
                canvas = emb.upload(emb.pack(list(chunk)))
                d_scores, d_idx = self.index.search_device(
                    emb.forward(*canvas), *snap, self.k)
            # the dense leg is now enqueued. Sparse leg: a device backend
            # keeps its results ON the device (no pull-pad-reupload); the
            # host scorer overlaps device compute instead
            if hasattr(self.bm25, "search_batch_device"):
                with self.timer.stage("bm25_device"):
                    b_s, b_i = self.bm25.search_batch_device(
                        list(chunk), k=self.k_bm25)
                    b_s, b_i = b_s[: self.batch_size], b_i[: self.batch_size]
                    if b_s.shape[0] < self.batch_size:  # q_block < batch
                        pad = self.batch_size - b_s.shape[0]
                        b_s = torch.cat([b_s, b_s.new_full(
                            (pad, b_s.shape[1]), mips.NEG_INF)])
                        b_i = torch.cat([b_i, b_i.new_full(
                            (pad, b_i.shape[1]), mips.INT32_MAX)])
            else:
                with self.timer.stage("bm25_host"):
                    b_s_np, b_i_np = self._bm25_arrays(chunk)
                    b_s, b_i = upload(b_s_np, device), upload(b_i_np, device)
            with self.timer.stage("fuse_dispatch"):
                scores, idx = self._fuse(d_scores, d_idx, b_s, b_i,
                                         len(chunk))
            yield start, len(chunk), scores, idx
