"""Dataset -> embedding columns and the packed-canvas query embedder
(counterpart of viquae_tpu/ir/embedding.py).

``TextEmbedder`` pads every batch to (batch_size, max_length) and runs one
no-grad forward on the embedder's device; ``PackedTextEmbedder`` tokenizes
WITHOUT padding, packs the batch into one (rows, row_len) canvas
(ops/packing.py) and runs a block-diagonal forward — ~3x fewer encoder
FLOPs than padding questions to max length; ``PackedColumnEmbedder`` is its
``dataset.map`` adapter for corpus columns. Canvas row counts round up to
ROWS_GRANULARITY so a stable query-length distribution gives few shapes.
While a profile runs, ``PackedTextEmbedder.pack`` records its WordPiece call
and its packing as the spans ``embed.tokenize`` and ``embed.pack``
(core/profiling.py).

Multimodal seams kept from the reference: ``map_passage_to_kb`` joins
precomputed image features from the article KB through ``batch['index']``
and ``expand_query`` appends the top-1 entity name of a visual run to the
text query. ``MMEmbedder`` embeds the multimodal ECA / ILF encoders'
inputs: text + precomputed face/image features, padded or packed.

The ``data`` axis: on a mesh (``mesh_ctx``, default ``core.mesh.current()``)
whose ``data`` axis has more than one rank, every embedder splits each
batch's rows over it (a batch that does not divide evenly is padded), each
rank encodes its rows, and the outputs are gathered back in order on every
rank — what the reference computes by sharding the batch over ``data``
with replicated outputs. Every rank of the axis must then embed the same
batches, in the same order. ``TextEmbedder`` and the padded
``MMEmbedder`` split the batch's items; each forward runs marked as this
rank's block of the batch (``core.mesh.row_block``), so that MoE layers
group the global batch's tokens. The packed embedders pack the whole batch
into one canvas, as one device does (every rank tokenizes every text), and
split the canvas's rows over ``data`` (``train.data_parallel.packed_read``:
each rank reads the CLS vectors that lie in its rows, summed over
``data``), so that the global canvas, and so the MoE groups, are one
device's; a canvas whose rows do not divide by the axis runs whole on
every rank.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from viquae_torch.core import mesh as meshlib
from viquae_torch.core import profiling
from viquae_torch.core.device import resolve_device, upload
from viquae_torch.ops import packing
from viquae_torch.train import data_parallel


def _mesh_device(mesh_ctx, device):
    """(mesh, device) of an embedder: the ambient mesh by default, and its
    device unless the caller names one."""
    ctx = mesh_ctx or meshlib.current()
    return ctx, resolve_device(device if device is not None else ctx.device)


def _packed_forward(ctx, apply_fn, params, canvas, pointers, *visual, **kw):
    """A packed forward on one canvas: as it is on a world of one, over
    this rank's canvas rows on a ``data`` axis of several ranks (module
    docstring)."""
    if ctx.size(meshlib.DATA_AXIS) == 1:
        return apply_fn(params, *canvas, *pointers, *visual, **kw)
    return data_parallel.packed_read(apply_fn, params, canvas, pointers,
                                     *visual, ctx=ctx, **kw)[0]


def pad_batch(arrays: Dict[str, np.ndarray], batch_size: int
              ) -> tuple[Dict[str, np.ndarray], int]:
    """Pad leading dim to batch_size; returns (padded, n_real)."""
    n = len(next(iter(arrays.values())))
    if n == batch_size:
        return arrays, n
    out = {}
    for k, v in arrays.items():
        pad_width = [(0, batch_size - n)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad_width)
    return out, n


class TextEmbedder:
    """Embeds a text column with a (params, apply) tower.

    apply_fn(params, input_ids=, attention_mask=, token_type_ids=,
    compute_dtype=) must return a dict; ``output_key`` selects the
    embedding (default "pooler_output"). With ``layers`` the call also gets
    ``output_hidden_states=True`` and the [CLS] state of each listed layer
    is saved as ``{save_as}_layer_{i}`` instead of the pooled output.
    """

    def __init__(
        self,
        apply_fn: Callable,
        params,
        tokenizer,
        key: str = "passage",
        save_as: str = "embedding",
        output_key: str = "pooler_output",
        max_length: int = 256,
        batch_size: int = 128,
        compute_dtype=torch.float32,
        extra_input_fn: Optional[Callable] = None,
        layers: Optional[list] = None,
        device=None,
        mesh_ctx=None,
    ):
        self.apply_fn = apply_fn
        self.params = params
        self.tokenizer = tokenizer
        self.key = key
        self.save_as = save_as
        self.output_key = output_key
        self.max_length = max_length
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.extra_input_fn = extra_input_fn
        self.layers = layers
        self.mesh_ctx, self.device = _mesh_device(mesh_ctx, device)

    @torch.no_grad()
    def _forward(self, input_ids, attention_mask, token_type_ids):
        out = self.apply_fn(
            self.params,
            input_ids=input_ids,
            attention_mask=attention_mask,
            token_type_ids=token_type_ids,
            compute_dtype=self.compute_dtype,
            **({"output_hidden_states": True} if self.layers else {}),
        )
        if self.layers:
            return tuple(
                out["hidden_states"][layer][:, 0] for layer in self.layers
            )
        return out[self.output_key]

    def tokenize(self, texts) -> Dict[str, np.ndarray]:
        enc = self.tokenizer(
            list(texts),
            padding="max_length",
            truncation=True,
            max_length=self.max_length,
            return_tensors="np",
        )
        out = {
            "input_ids": enc["input_ids"].astype(np.int32),
            "attention_mask": enc["attention_mask"].astype(np.int32),
            "token_type_ids": enc.get(
                "token_type_ids",
                np.zeros_like(enc["input_ids"]),
            ).astype(np.int32),
        }
        return out

    def __call__(self, batch: dict) -> dict:
        """dataset.map(batched=True) entry — writes the `save_as` column(s)."""
        texts = batch[self.key]
        if self.extra_input_fn is not None:
            texts = self.extra_input_fn(batch, texts)
        embeddings = self.embed_texts(texts)
        if self.layers:
            for layer, emb in zip(self.layers, embeddings):
                batch[f"{self.save_as}_layer_{layer}"] = emb
        else:
            batch[self.save_as] = embeddings
        return batch

    def embed_texts(self, texts):
        """(len(texts), D) float32 numpy (a list of them with ``layers``)."""
        if len(texts) == 0:
            # np.concatenate([]) raises on an empty dataset.map batch;
            # probe the tower once for the output width (same guard as
            # PackedColumnEmbedder)
            probe = self.embed_texts([""])
            width = (probe[0].shape[-1] if self.layers
                     else probe.shape[-1])
            empty = np.zeros((0, width), np.float32)
            return [empty] * len(self.layers) if self.layers else empty
        chunks = []
        for start in range(0, len(texts), self.batch_size):
            sub = texts[start: start + self.batch_size]
            enc, n_real = pad_batch(self.tokenize(sub), self.batch_size)
            with meshlib.rows_scope(self.mesh_ctx, self.batch_size):
                out = self._forward(*(
                    upload(meshlib.split_rows(self.mesh_ctx, enc[name]),
                           self.device)
                    for name in ("input_ids", "attention_mask",
                                 "token_type_ids")))
            rows = [meshlib.gather_rows(self.mesh_ctx, o, n_real).float(
                ).cpu().numpy() for o in (out if self.layers else (out,))]
            chunks.append(rows if self.layers else rows[0])
        if self.layers:
            return [
                np.concatenate([c[i] for c in chunks], axis=0)
                for i in range(len(self.layers))
            ]
        return np.concatenate(chunks, axis=0)


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
        fixed_rows: Optional[int] = None,
        device=None,
        mesh_ctx=None,
    ):
        """``fixed_rows`` pins the canvas height to ONE shape (size it at
        the stream's p99 token budget); the ROWS_GRANULARITY ladder is the
        adaptive default. A batch that overflows the pinned canvas is
        packed on the ladder instead. On a ``data`` axis of more than one
        rank the canvas is still the whole batch's, as on one device, and
        :meth:`forward` splits its rows (module docstring)."""
        self.packed_apply_fn = packed_apply_fn
        self.params = params
        self.tokenizer = tokenizer
        self.row_len = row_len
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.fixed_rows = fixed_rows
        self.mesh_ctx, self.device = _mesh_device(mesh_ctx, device)

    def pack(self, texts) -> packing.PackedBatch:
        """Host side only: tokenize without padding + pack the whole batch
        into a canvas rounded to ROWS_GRANULARITY rows (or the pinned
        ``fixed_rows``)."""
        if len(texts) > self.batch_size:
            raise ValueError(f"{len(texts)} texts > batch_size "
                             f"{self.batch_size}")
        texts = list(texts)
        with profiling.span("embed.tokenize", texts=len(texts)):
            # a tokenizer may refuse an empty list
            enc = self.tokenizer(
                texts, truncation=True, max_length=self.row_len,
            )["input_ids"] if texts else []
        with profiling.span("embed.pack"):
            seqs = [np.asarray(s, np.int32) for s in enc]
            if self.fixed_rows is not None:
                try:
                    return packing.pack_token_sequences(
                        seqs, self.row_len, n_rows=self.fixed_rows,
                        n_cls=self.batch_size,
                    )
                except ValueError:  # batch overflows the pinned canvas
                    pass
            return packing.pack_token_sequences(
                seqs, self.row_len, n_rows=None,
                pad_rows_to=self.ROWS_GRANULARITY, n_cls=self.batch_size,
            )

    def upload(self, p: packing.PackedBatch):
        """The canvas arrays as tensors on the embedder's device (pinned
        staging on a CUDA device: the call does not wait for the card)."""
        return tuple(
            upload(a, self.device)
            for a in (p.input_ids, p.segment_ids, p.position_ids,
                      p.cls_rows, p.cls_cols))

    @torch.no_grad()
    def forward(self, ids, seg, pos, cr, cc) -> torch.Tensor:
        """The packed forward on uploaded canvas tensors -> (n_cls, D) f32.
        Grad mode is off here, not around the caller: it is per thread, and
        the serving loop calls this from its prefetch thread."""
        return _packed_forward(self.mesh_ctx, self.packed_apply_fn,
                               self.params, (ids, seg, pos), (cr, cc),
                               compute_dtype=self.compute_dtype)

    def embed_texts(self, texts) -> torch.Tensor:
        """(batch_size, D) on the device; rows past len(texts) are garbage
        (pad pointers) — callers slice. Nothing waits for the device here,
        so the next batch's tokenization overlaps this one's compute."""
        return self.forward(*self.upload(self.pack(texts)))

    def __call__(self, texts):
        return self.embed_texts(texts)


class PackedColumnEmbedder(PackedTextEmbedder):
    """dataset.map(batched=True) column adapter over the PACKED tower —
    the corpus-embedding counterpart of PackedTextEmbedder.

    The reference embeds every passage padded to max_length although
    `uniform_passages` makes them ~100 tokens: >2x of the encoder FLOPs are
    padding. This packs passages at their real lengths instead; CLS pooling
    only (no per-layer extraction).
    """

    def __init__(self, *args, key: str = "passage",
                 save_as: str = "embedding",
                 extra_input_fn: Optional[Callable] = None, **kwargs):
        # corpus embeddings default to f32 like TextEmbedder — flipping
        # "packed" on must change PACKING, not the numeric contract (the
        # serving-oriented parent defaults to bf16)
        kwargs.setdefault("compute_dtype", torch.float32)
        super().__init__(*args, **kwargs)
        self.key = key
        self.save_as = save_as
        self.extra_input_fn = extra_input_fn

    def _embed_numpy(self, texts) -> np.ndarray:
        return self.embed_texts(texts)[: len(texts)].float().cpu().numpy()

    def __call__(self, batch: dict) -> dict:  # type: ignore[override]
        texts = batch[self.key]
        if self.extra_input_fn is not None:
            texts = self.extra_input_fn(batch, texts)
        if len(texts) == 0:
            # np.concatenate([]) raises on an empty dataset.map batch;
            # probe the tower once for the output width instead
            if not hasattr(self, "_dim"):
                self._dim = int(self._embed_numpy([""]).shape[-1])
            batch[self.save_as] = np.zeros((0, self._dim), np.float32)
            return batch
        chunks = []
        for start in range(0, len(texts), self.batch_size):
            sub = list(texts[start: start + self.batch_size])
            chunks.append(self._embed_numpy(sub))
        batch[self.save_as] = np.concatenate(chunks, axis=0)
        self._dim = int(batch[self.save_as].shape[-1])
        return batch


class MMEmbedder:
    """Multimodal query/passage embedding (ECA / ILF encoders): tokenized
    text + precomputed face/image feature columns -> embedding column.

    ``apply_fn(params, text_inputs=, face_inputs=, image_inputs=,
    compute_dtype=)`` is a bundle's ``apply_fn``; ``image_features`` a
    ``train.data.PreComputedImageFeatures``. With ``kb`` and
    ``kb_features`` the feature columns of each passage's article are
    joined through ``batch['index']`` first. ``packed_bundle`` (an
    ``ECAEncoder`` / ``IntermediateLinearFusion``) embeds the text at its
    real lengths on a packed canvas (ECA's visual tokens in reserved
    slots) instead of padding every text to ``max_length``. Every chunk is
    padded to ``batch_size`` items with empty texts, as the JAX package
    does. :meth:`prepare` is the host side of a chunk, :meth:`forward` the
    device side."""

    def __init__(self, apply_fn, params, tokenizer, image_features,
                 key: str = "input", save_as: str = "mm_embedding",
                 max_length: int = 256, batch_size: int = 64,
                 compute_dtype=torch.float32, kb=None, kb_features=None,
                 packed_bundle=None, device=None, mesh_ctx=None):
        self.apply_fn = apply_fn
        self.params = params
        self.tokenizer = tokenizer
        self.features = image_features
        self.key = key
        self.save_as = save_as
        self.max_length = max_length
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.kb = kb                    # article KB for passage joins
        self.kb_features = kb_features  # feature column names to join
        self.packed_bundle = packed_bundle
        self._needs_vis = bool(
            getattr(packed_bundle, "PACKED_NEEDS_VIS", False))
        self.mesh_ctx, self.device = _mesh_device(mesh_ctx, device)

    def _row_budget(self, rows: int) -> int:
        """Sticky monotone canvas row budget (few canvas shapes)."""
        pinned = getattr(self, "_rows_pinned", 0)
        if rows > pinned:
            self._rows_pinned = pinned = rows
        return pinned

    def prepare(self, chunk) -> dict:
        """Host side of one chunk of item dicts: pad to ``batch_size``,
        tokenize, format the features, pack (packed mode). numpy only. On
        a ``data`` axis the padded mode prepares this rank's block of the
        items; the packed mode packs every item into one canvas, whose
        rows :meth:`forward` splits (module docstring)."""
        from viquae_torch.train.data import (mm_visual_mask,
                                             pack_mm_text_inputs)

        chunk, size = list(chunk), self.batch_size
        if self.packed_bundle is None:
            start, size = meshlib.row_share(self.mesh_ctx, self.batch_size)
            chunk = chunk[start: start + size]
        chunk += [{self.key: ""}] * (size - len(chunk))
        enc = self.tokenizer(
            [item.get(self.key, "") for item in chunk],
            padding="max_length", truncation=True,
            max_length=self.max_length, return_tensors="np",
        )
        text = {"input_ids": enc["input_ids"].astype(np.int32),
                "attention_mask": enc["attention_mask"].astype(np.int32)}
        face = self.features.get_face_inputs(chunk)
        image = self.features.get_image_inputs(chunk)
        out = {"face_inputs": face, "image_inputs": image}
        if self.packed_bundle is None:
            out["text_inputs"] = text
            return out
        t_vis = (mm_visual_mask(face, image).shape[1]
                 if self._needs_vis else 0)
        c = pack_mm_text_inputs(
            {"text_inputs": text, "face_inputs": face,
             "image_inputs": image},
            self.max_length + t_vis,
            self.packed_bundle.cfg.face_and_image_are_exclusive,
            needs_vis=self._needs_vis, row_budget=self._row_budget)
        names = ["input_ids", "segment_ids", "position_ids", "cls_rows",
                 "cls_cols"] + (["vis_rows", "vis_cols"]
                                if self._needs_vis else [])
        out["canvas"] = [c[f"canvas_{name}"] for name in names]
        return out

    @torch.no_grad()
    def forward(self, host: dict) -> torch.Tensor:
        """Device side: (batch_size, D) f32 on the embedder's device
        (every rank's rows, gathered over ``data``)."""
        def put(tree):
            if isinstance(tree, dict):
                return {k: put(v) for k, v in tree.items()}
            return upload(tree, self.device)

        face, image = put(host["face_inputs"]), put(host["image_inputs"])
        if "canvas" in host:
            canvas = [upload(a, self.device) for a in host["canvas"]]
            return _packed_forward(
                self.mesh_ctx, self.packed_bundle.packed_apply_fn,
                self.params, canvas[:3], canvas[3:], face, image,
                compute_dtype=self.compute_dtype)
        with meshlib.rows_scope(self.mesh_ctx, self.batch_size):
            out = self.apply_fn(self.params,
                                text_inputs=put(host["text_inputs"]),
                                face_inputs=face, image_inputs=image,
                                compute_dtype=self.compute_dtype)
        out = out.pooler_output if hasattr(out, "pooler_output") else out
        return meshlib.gather_rows(self.mesh_ctx, out, self.batch_size)

    def embed_items(self, items) -> np.ndarray:
        """(len(items), D) float32 numpy."""
        chunks = []
        for start in range(0, len(items), self.batch_size):
            chunk = items[start: start + self.batch_size]
            out = self.forward(self.prepare(chunk))
            chunks.append(out[: len(chunk)].float().cpu().numpy())
        return np.concatenate(chunks, axis=0)

    def __call__(self, batch: dict) -> dict:
        """dataset.map(batched=True) entry — writes the ``save_as`` column."""
        items = [{k: batch[k][i] for k in batch}
                 for i in range(len(batch[self.key]))]
        if len(items) == 0:
            # empty dataset.map batch: probe the encoder ONCE with a
            # padding-only item for the width (no article to join)
            if not hasattr(self, "_dim"):
                self._dim = int(self.embed_items([{self.key: ""}]).shape[-1])
            batch[self.save_as] = np.zeros((0, self._dim), np.float32)
            return batch
        if self.kb is not None and self.kb_features:
            joined = map_passage_to_kb(batch, self.kb, self.kb_features)
            for i, item in enumerate(items):
                for f in self.kb_features:
                    item[f] = joined[f][i]
        batch[self.save_as] = self.embed_items(items)
        return batch


def map_passage_to_kb(batch: dict, kb, features) -> Dict[str, list]:
    """Join per-article `features` columns onto a passage batch via
    batch['index']."""
    out: Dict[str, list] = {f: [] for f in features}
    for article_index in batch["index"]:
        article = kb[int(article_index)]
        for f in features:
            out[f].append(article[f])
    return out


def expand_query(batch: dict, visual_run, kb, key: str = "input",
                 reference_key: str = "wikipedia_title") -> list:
    """Append the top-1 entity name from a visual run to each query."""
    expanded = []
    for q_id, text in zip(batch["id"], batch[key]):
        results = visual_run[q_id] if q_id in visual_run else {}
        if results:
            top = max(results.items(), key=lambda kv: kv[1])[0]
            entity = kb[int(top)][reference_key]
            expanded.append(f"{text} {entity}")
        else:
            expanded.append(text)
    return expanded


def dataset_embed(dataset_path, embedder, output_path=None,
                  map_kwargs: Optional[dict] = None):
    """Load dataset, map the embedder over it, save back."""
    if isinstance(dataset_path, (str, Path)):
        from datasets import load_from_disk

        dataset = load_from_disk(str(dataset_path))
    else:
        dataset = dataset_path
    dataset = dataset.map(
        embedder, batched=True,
        batch_size=embedder.batch_size,
        **(map_kwargs or {}),
    )
    if output_path is not None:
        dataset.save_to_disk(str(output_path))
    elif isinstance(dataset_path, (str, Path)):
        save_in_place(dataset, dataset_path)
    return dataset


def save_in_place(dataset, path):
    """Overwrite a dataset with itself: Arrow forbids writing onto the
    memory-mapped source dir, so write next to it and swap.

    Crash recovery: a leftover `.tmp_old` from a prior crash means the
    previous swap didn't finish — the original data may live ONLY there,
    so restore it before proceeding; a leftover `.tmp_save` is a partial
    write and is discarded."""
    import shutil

    path = Path(path)
    tmp = path.with_name(path.name + ".tmp_save")
    old = path.with_name(path.name + ".tmp_old")
    if old.exists():
        if not path.exists():
            old.rename(path)  # crashed mid-swap: .tmp_old IS the data
        else:
            shutil.rmtree(old)
    if tmp.exists():
        shutil.rmtree(tmp)  # partial write from a prior crash
    dataset.save_to_disk(str(tmp))
    path.rename(old)
    tmp.rename(path)
    shutil.rmtree(old)
