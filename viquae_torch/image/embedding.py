"""Global image embedding stage (counterpart of
viquae_tpu/image/embedding.py; parity meerqat/image/embedding.py).

The reference's ``ImageEncoder`` wraps torchvision ResNet50 cut at -2 +
pool, OpenAI CLIP RN50 ``model.visual`` or HF CLIP-ViT
``get_image_features``, with None-tolerant batching. Here the encoder is
one chain of device work over a fixed (batch, size, size, 3) uint8 canvas:
preprocessing (resize + normalize, ``ops.image.preprocess``) runs on the
device in the same call as the tower. None images are masked on the host
and their embedding rows are NaN (NaN marks the reference's "no result"
through Arrow float columns, and ir.search treats all-NaN query vectors as
None). The host decode and resize is PIL's, in a prefetch thread.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from viquae_torch.core.device import resolve_device, upload
from viquae_torch.data.loading import load_image_batch
from viquae_torch.ops import image as image_ops


def _resize_center_crop(img, target: int, resample=None) -> np.ndarray:
    """Aspect-preserving shorter-side resize + center crop to a square
    (the CLIP/torchvision transform; squashing to a square distorts
    embeddings for every non-square corpus image)."""
    if getattr(img, "mode", "RGB") != "RGB":
        # dataset columns / serving queries can hold 'L'/'P'/'RGBA' PIL
        # images directly — without this the canvas assignment below gets
        # a (H, W) or (H, W, 4) array and crashes the whole batch
        img = img.convert("RGB")
    w, h = img.size
    if (w, h) != (target, target):
        scale = target / min(w, h)
        nw, nh = max(target, round(w * scale)), max(target, round(h * scale))
        img = img.resize((nw, nh), resample=resample)
        left = (nw - target) // 2
        top = (nh - target) // 2
        img = img.crop((left, top, left + target, top + target))
    return np.asarray(img)


def decode_image_batch(pil_images, raw_size: int, batch_size: int):
    """Host decode/resize of a serving batch of PIL images (None allowed).

    Returns (canvas uint8 (batch_size, raw, raw, 3), valid bool
    (batch_size,)) — rows past len(pil_images) and None images are zeroed
    with valid=False. The serving pipelines upload the canvas and run
    ops.image.preprocess + the encoder in the same chain of device work."""
    canvas = np.zeros((batch_size, raw_size, raw_size, 3), np.uint8)
    valid = np.zeros((batch_size,), bool)
    for i, img in enumerate(pil_images):
        if img is None:
            continue
        canvas[i] = _resize_center_crop(img, raw_size)
        valid[i] = True
    return canvas, valid


class ImageEmbedder:
    """dataset.map(batched=True) callable writing an embedding column.

    apply_fn(params, pixels) -> (B, D): pixels are (B, size, size, 3)
    normalized NHWC in ``compute_dtype`` on ``device`` (default: the GPU),
    where ``params`` (a tower module) must live."""

    def __init__(
        self,
        apply_fn: Callable,
        params,
        save_as: str,
        image_key: str = "image",
        image_size: int = 224,
        preprocessing: str = "clip",  # ops.image.preprocess kind
        batch_size: int = 64,
        compute_dtype=torch.float32,
        device=None,
    ):
        self.apply_fn = apply_fn
        self.params = params
        self.save_as = save_as
        self.image_key = image_key
        self.image_size = image_size
        self.preprocessing = preprocessing
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        # host-side decode target == model input: the reference transform
        # is shorter-side Resize(size)+CenterCrop(size) for BOTH imagenet
        # and clip — no 256-resize intermediate
        self.raw_size = image_size

    @torch.no_grad()
    def _forward(self, params, raw_images: torch.Tensor) -> torch.Tensor:
        """A uint8 canvas on the device -> (B, D) embeddings, enqueued
        without waiting for the device."""
        pixels = image_ops.preprocess(
            raw_images, size=self.image_size, kind=self.preprocessing
        ).to(self.compute_dtype)
        return self.apply_fn(params, pixels)

    def embed_images(self, pil_images) -> np.ndarray:
        """List of PIL images (or None) -> (N, D) float32 with NaN rows.

        Host decode/resize runs in a prefetch thread so chunk i+1's CPU work
        overlaps chunk i's device forward.
        """
        from PIL import Image as pil_image

        from viquae_torch.utils.prefetch import PrefetchIterable

        # torchvision Resize interpolates BILINEAR; CLIP's transform (and
        # PIL's default) is BICUBIC
        resample = (
            pil_image.Resampling.BILINEAR
            if self.preprocessing == "imagenet" else None
        )

        def decoded_chunks():
            for start in range(0, len(pil_images), self.batch_size):
                chunk = pil_images[start: start + self.batch_size]
                present = [
                    (i, _resize_center_crop(img, self.raw_size, resample))
                    for i, img in enumerate(chunk) if img is not None
                ]
                if present:
                    idx, arrays = zip(*present)
                    batch = np.zeros(
                        (self.batch_size, self.raw_size, self.raw_size, 3),
                        np.uint8,
                    )
                    for j, arr in enumerate(arrays):
                        batch[j] = arr
                else:
                    idx, batch = (), None
                yield len(chunk), idx, batch

        out_chunks = []
        for n_chunk, idx, batch in PrefetchIterable(
            decoded_chunks(), buffer_size=2
        ):
            if batch is not None:
                emb = self._forward(self.params, upload(batch, self.device))
                emb = emb[: len(idx)].float().cpu().numpy()
                rows = np.full((n_chunk, emb.shape[1]), np.nan, np.float32)
                for j, i in enumerate(idx):
                    rows[i] = emb[j]
            else:
                rows = None  # resolved once dim is known
            out_chunks.append((rows, n_chunk))
        dim = next(
            (c.shape[1] for c, _ in out_chunks if c is not None), None
        )
        if dim is None:
            # every image in this call was None: probe the encoder's output
            # width so the NaN block matches other batches' column width
            # (a (N, 1) guess would make the Arrow column ragged)
            zero = torch.zeros(
                (self.batch_size, self.raw_size, self.raw_size, 3),
                dtype=torch.uint8, device=self.device)
            dim = int(self._forward(self.params, zero).shape[1])
        resolved = [
            c if c is not None else np.full((n, dim), np.nan, np.float32)
            for c, n in out_chunks
        ]
        return np.concatenate(resolved, axis=0)[: len(pil_images)]

    def __call__(self, batch: dict) -> dict:
        images = load_image_batch(batch[self.image_key])
        batch[self.save_as] = self.embed_images(images)
        return batch


def dataset_embed_images(dataset_path, embedder: ImageEmbedder,
                         map_kwargs: Optional[dict] = None):
    from datasets import load_from_disk

    from viquae_torch.ir.embedding import save_in_place

    dataset = load_from_disk(str(dataset_path))
    dataset = dataset.map(
        embedder, batched=True, batch_size=embedder.batch_size,
        **(map_kwargs or {}),
    )
    save_in_place(dataset, dataset_path)
    return dataset
