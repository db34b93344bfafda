"""Host-side batch formatting for the multimodal encoders (counterpart of
the part of viquae_tpu/train/data.py that evaluation needs), pure numpy:

- :class:`PreComputedImageFeatures`: pad/trim faces to n_faces, square
  (B, 1, n_faces, dim) tensors, zero-mask for missing features;
- :class:`ImageFormatter`: tokenized text + face/image features;
- :func:`tokenize`: fixed-shape HF tokenization;
- :func:`pack_text_inputs`, :func:`mm_visual_mask`,
  :func:`pack_mm_text_inputs`: packed canvases for the packed DPR / ILF /
  ECA forwards (ops/packing.py), with ECA's reserved visual slots.

Each function and class is the JAX package's, line for line but for the
package name (tests/test_torch_host_copies.py); the collators and
``QADataModule`` come with training (ROADMAP A16).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PreComputedImageFeatures:
    n_faces: int = 4
    face_dim: int = 512
    bbox_dim: int = 7
    image_dims: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"clip-RN50": 1024, "imagenet-RN50": 2048}
    )

    def get_face_inputs(self, items: Sequence[dict]) -> Dict[str, np.ndarray]:
        n = len(items)
        faces = np.zeros((n, 1, self.n_faces, self.face_dim), np.float32)
        boxes = np.zeros((n, 1, self.n_faces, self.bbox_dim), np.float32)
        mask = np.zeros((n, 1, self.n_faces), np.int32)
        if self.n_faces > 0:
            for i, item in enumerate(items):
                emb = item.get("face_embedding")
                if emb is None:
                    continue
                k = min(self.n_faces, len(emb))
                faces[i, 0, :k] = np.asarray(emb[:k], np.float32)
                box = item.get("face_box") or item.get("scaled_face_box")
                if box is not None:
                    boxes[i, 0, :k] = np.asarray(box[:k], np.float32)
                mask[i, 0, :k] = 1
        return {"face": faces, "bbox": boxes, "attention_mask": mask}

    def get_image_inputs(self, items: Sequence[dict]
                         ) -> Dict[str, Dict[str, np.ndarray]]:
        out = {}
        for name, dim in self.image_dims.items():
            features = np.zeros((len(items), 1, dim), np.float32)
            mask = np.zeros((len(items), 1), np.int32)
            for i, item in enumerate(items):
                feat = item.get(name)
                if feat is None:
                    continue
                feat = np.asarray(feat, np.float32)
                if np.isnan(feat).all():
                    continue  # NaN rows mark missing embeddings
                features[i, 0] = feat
                mask[i, 0] = 1
            out[name] = {"input": features, "attention_mask": mask}
        return out


class ImageFormatter:
    """Merges tokenized text with face/image features
    (parity train/data.py:180-289, precomputed-features mode)."""

    def __init__(self, features: Optional[PreComputedImageFeatures] = None):
        self.features = features
        self.precomputed = features is not None

    def format_batch(self, text_inputs: Dict[str, np.ndarray],
                     items: Sequence[dict],
                     passage_items: Optional[Sequence[dict]] = None) -> dict:
        if self.features is None:
            return dict(text_inputs)
        face = self.features.get_face_inputs(items)
        image = self.features.get_image_inputs(items)
        if passage_items is not None:
            # question+passage pairs: the reference CONCATENATES question
            # and passage features along the n_images dim (train/data.py:
            # 252-283 torch.cat dim=1) — a round-3 review caught this
            # substituting passage features for the question's
            assert len(passage_items) == len(items), (
                "passage_items must align 1:1 with (repeated) items")
            p_face = self.features.get_face_inputs(passage_items)
            p_image = self.features.get_image_inputs(passage_items)
            face = {k: np.concatenate([face[k], p_face[k]], axis=1)
                    for k in face}
            image = {
                name: {k: np.concatenate([image[name][k], v], axis=1)
                       for k, v in d.items()}
                for name, d in p_image.items()
            }
        return {
            "text_inputs": dict(text_inputs),
            "face_inputs": face,
            "image_inputs": image,
        }


def tokenize(tokenizer, texts, pairs=None, max_length: int = 256
             ) -> Dict[str, np.ndarray]:
    enc = tokenizer(
        list(texts), *(list(pairs),) if pairs is not None else (),
        padding="max_length", truncation=True, max_length=max_length,
        return_tensors="np",
    )
    out = {
        "input_ids": enc["input_ids"].astype(np.int32),
        "attention_mask": enc["attention_mask"].astype(np.int32),
    }
    if "token_type_ids" in enc:
        out["token_type_ids"] = enc["token_type_ids"].astype(np.int32)
    return out


def pack_text_inputs(inputs: Dict[str, np.ndarray], row_len: int,
                     row_budget=None) -> dict:
    """Canvas fields for CLS-pooled packed encoding (dpr.apply_packed):
    strip padding from tokenized {input_ids, attention_mask} and pack.
    ``row_budget`` (rows -> rows) pins a stable canvas height across
    batches (QADataModule._row_budget) so the train step compiles once."""
    from viquae_torch.ops import packing

    ids = inputs["input_ids"]
    lens = inputs["attention_mask"].sum(axis=1).astype(int)
    seqs = [ids[i, : lens[i]] for i in range(len(ids))]
    p = packing.pack_token_sequences(seqs, row_len=row_len, pad_rows_to=8)
    if row_budget is not None:
        p = packing.pad_packed_rows(p, row_budget(p.rows))
    return {
        "canvas_input_ids": p.input_ids,
        "canvas_segment_ids": p.segment_ids,
        "canvas_position_ids": p.position_ids,
        "canvas_cls_rows": p.cls_rows,
        "canvas_cls_cols": p.cls_cols,
    }


def mm_visual_mask(face_inputs, image_inputs,
                   face_and_image_are_exclusive: bool = False) -> np.ndarray:
    """(B, T_vis) visual-token validity in models.mm._visual_tokens ORDER:
    faces (n_images*n_faces) then each image kind (n_images each) in
    image_inputs insertion order, with the face/image exclusivity rule."""
    faces = face_inputs["face"]
    b, n_images, n_faces = faces.shape[:3]
    parts = []
    face_mask = face_inputs["attention_mask"].reshape(b, n_images * n_faces)
    if n_faces > 0:
        parts.append(face_mask)
    image_parts = [
        v["attention_mask"] for v in (image_inputs or {}).values()
    ]
    if image_parts:
        im = np.concatenate(image_parts, axis=1)
        if face_and_image_are_exclusive:
            has_face = face_mask.sum(axis=1, keepdims=True) > 0
            im = np.where(has_face, 0, im)
        parts.append(im)
    if not parts:
        return np.zeros((b, 0), np.int32)
    return np.concatenate(parts, axis=1).astype(np.int32)


def pack_mm_text_inputs(mm_inputs: Dict[str, Any], row_len: int,
                        face_and_image_are_exclusive: bool = False,
                        needs_vis: bool = True, row_budget=None) -> dict:
    """Canvas fields for mm.eca_apply_packed: strip text padding, pack with
    T_vis reserved slots per sample (the visual-token scatter targets), and
    zero the segment id of slots whose face/image is ABSENT so attention
    ignores them (the packed equivalent of eca_apply's mask concat).
    `face_and_image_are_exclusive` must mirror the model's MMConfig.

    needs_vis=False (IntermediateLinearFusion: the visual side is a SUM of
    projections, not attention tokens) packs the text alone — reserved
    slots would otherwise sit in the text attention as stray pad tokens."""
    from viquae_torch.ops import packing

    text = mm_inputs["text_inputs"]
    if not needs_vis:
        return pack_text_inputs(text, row_len, row_budget=row_budget)
    vis_mask = mm_visual_mask(
        mm_inputs["face_inputs"], mm_inputs.get("image_inputs"),
        face_and_image_are_exclusive,
    )
    t_vis = vis_mask.shape[1]
    ids = text["input_ids"]
    lens = text["attention_mask"].sum(axis=1).astype(int)
    seqs = [ids[i, : lens[i]] for i in range(len(ids))]
    p, vis_rows, vis_cols = packing.pack_with_reserved(
        seqs, t_vis, row_len=row_len, pad_rows_to=8
    )
    if row_budget is not None:
        # appended all-pad rows never move existing cls/vis pointers
        p = packing.pad_packed_rows(p, row_budget(p.rows))
    seg = p.segment_ids.copy()
    b = len(seqs)
    absent = vis_mask[:b] == 0
    seg[vis_rows[:b][absent], vis_cols[:b][absent]] = 0
    return {
        "canvas_input_ids": p.input_ids,
        "canvas_segment_ids": seg,
        "canvas_position_ids": p.position_ids,
        "canvas_cls_rows": p.cls_rows,
        "canvas_cls_cols": p.cls_cols,
        "canvas_vis_rows": vis_rows,
        "canvas_vis_cols": vis_cols,
    }
