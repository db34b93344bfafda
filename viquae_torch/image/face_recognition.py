"""Face alignment + ArcFace embedding stage (counterpart of
viquae_tpu/image/face_recognition.py; parity
meerqat/image/face_recognition.py).

Per detected face: estimate the similarity transform from the 5 landmarks
to the canonical ArcFace template (insightface constants), warp to
112x112, normalize with mean/std 0.5, embed with iresnet50 — all on the
device (Umeyama + affine warp + encoder). ``max_n_faces`` caps faces per
image (default 1). Output column ``face_embedding``: (n_faces, 512) per
image or None.

:class:`FaceQueryEncoder` is the online face leg of serving: raw query
image -> MTCNN -> most probable face -> align -> ArcFace, one chain of
device work per sub-batch over one uint8 canvas upload, and one read back
per sub-batch (the host decides from it which images take the
full-resolution path).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from viquae_torch.core.device import HostCopy, resolve_device, upload
from viquae_torch.data.loading import load_image
from viquae_torch.models import arcface
from viquae_torch.models import mtcnn as mtcnn_lib
from viquae_torch.ops import image as image_ops

# canonical 5-point template for 112x112 ArcFace crops (insightface)
SRC = np.array([
    [30.2946, 51.6963],
    [65.5318, 51.5014],
    [48.0252, 71.7366],
    [33.5493, 92.3655],
    [62.7299, 92.2041],
], dtype=np.float32)
SRC[:, 0] += 8.0


@functools.lru_cache(maxsize=8)
def _template(device: torch.device) -> torch.Tensor:
    return upload(SRC, device)


def align_face(image: torch.Tensor, landmarks: torch.Tensor,
               image_size: int = 112) -> torch.Tensor:
    """(H, W, 3) float [0,255] + (5, 2) landmarks -> (112, 112, 3) crop;
    or a batch: (B, H, W, 3) + (B, 5, 2) -> (B, 112, 112, 3)."""
    dst = _template(landmarks.device).expand(landmarks.shape)
    forward = image_ops.umeyama_similarity(landmarks, dst)
    inverse = image_ops.invert_affine(forward)  # output px -> input px
    return image_ops.affine_warp(image, inverse, (image_size, image_size))


class FaceEmbedder:
    def __init__(self, params, cfg: Optional[arcface.ArcFaceConfig] = None,
                 max_n_faces: int = 1, image_key: str = "image",
                 batch_size: int = 32, canvas: int = 512, device=None):
        self.params = params
        self.cfg = cfg or arcface.ArcFaceConfig()
        self.max_n_faces = max_n_faces
        self.image_key = image_key
        self.batch_size = batch_size
        self.canvas = canvas
        self.device = resolve_device(device)

    @torch.no_grad()
    def _embed(self, params, crops: torch.Tensor) -> torch.Tensor:
        """crops (B, 112, 112, 3) in [0, 255] on the device -> (B, 512)."""
        x = image_ops.normalize(crops / 255.0, image_ops.FACE_MEAN,
                                image_ops.FACE_STD)
        return arcface.apply(params, self.cfg, x)

    def _align(self, image, landmarks):
        return align_face(image, landmarks, self.cfg.image_size)

    @staticmethod
    def _to_rgb_array(image) -> np.ndarray:
        """PIL image or array of any mode -> (H, W, 3) float32. load_image
        converts str-path inputs to RGB, but a dataset column can hold PIL
        images directly (mode 'L', 'P', 'RGBA', ...) — without this, a
        grayscale image becomes (H, W) and affine_warp treats columns as
        channels, an RGBA one breaks the (3,)-stat normalize broadcast."""
        if hasattr(image, "convert"):
            image = image.convert("RGB")
        arr = np.asarray(image, dtype=np.float32)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        elif arr.shape[-1] == 4:
            arr = arr[..., :3]
        return arr

    @torch.no_grad()
    def _aligned_crop(self, arr: np.ndarray, lm: np.ndarray) -> torch.Tensor:
        """Align ONE face from a full-resolution image -> (112, 112, 3) on
        the device. (The reference zero-pads the image to a power-of-two
        shape first, to bound its compile count; affine_warp reads 0 past
        the edge either way, so the padding changes nothing and is not
        done here.)"""
        return self._align(upload(arr, self.device),
                           upload(np.asarray(lm, np.float32), self.device))

    def _embed_crops(self, crops) -> np.ndarray:
        """A list of device crops -> (n, 512) host rows, batch_size at a
        time."""
        out = []
        for start in range(0, len(crops), self.batch_size):
            chunk = torch.stack(crops[start: start + self.batch_size])
            out.append(self._embed(self.params, chunk).cpu().numpy())
        return np.concatenate(out)

    def __call__(self, batch: dict) -> dict:
        output = [None] * len(batch[self.image_key])
        crops, owners = [], []
        for i, (file_name, landmarks) in enumerate(
            zip(batch[self.image_key], batch["face_landmarks"])
        ):
            if landmarks is None:
                continue
            image = (
                load_image(file_name)
                if isinstance(file_name, str) else file_name
            )
            if image is None:
                continue
            arr = self._to_rgb_array(image)
            lms = np.asarray(landmarks, np.float32)[: self.max_n_faces]
            for lm in lms:
                crops.append(self._aligned_crop(arr, lm))
                owners.append(i)
        if not crops:
            batch["face_embedding"] = output
            return batch
        embeddings = self._embed_crops(crops)
        for i in set(owners):
            rows = [embeddings[j] for j, o in enumerate(owners) if o == i]
            output[i] = np.stack(rows).tolist()
        batch["face_embedding"] = output
        return batch


def dataset_compute_face_embedding(dataset_path, embedder: FaceEmbedder,
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


class FaceQueryEncoder:
    """ONLINE face leg for serving: raw query image -> MTCNN detect ->
    most-probable face -> align -> ArcFace 512-d feature.

    Output rows are NaN for queries without an image or a detected face —
    the serving pipelines' 'absent from this run' contract
    (ir/serving.MultiIndexRetrievalPipeline NaN masking)."""

    def __init__(self, mtcnn_params, arcface_params,
                 mtcnn_cfg: Optional[mtcnn_lib.MTCNNConfig] = None,
                 arcface_cfg: Optional[arcface.ArcFaceConfig] = None,
                 batch_size: int = 64, device=None):
        self.mtcnn_params = mtcnn_params
        self.mtcnn_cfg = mtcnn_cfg or mtcnn_lib.MTCNNConfig()
        self.device = resolve_device(device)
        self.embedder = FaceEmbedder(
            arcface_params, cfg=arcface_cfg, max_n_faces=1,
            batch_size=batch_size, device=self.device)
        self.batch_size = batch_size
        self.dim = self.embedder.cfg.embedding_size

    def _detect(self, m_params, imgs, hws):
        """-> (landmarks of the most probable valid face (B, 5, 2), has a
        face (B,))."""
        det = mtcnn_lib.detect_faces_batch(m_params, imgs, hws,
                                           self.mtcnn_cfg)
        probs = torch.where(det["valid"], det["probs"], -torch.inf)
        best = torch.argmax(probs, dim=1)
        rows = torch.arange(imgs.shape[0], device=imgs.device)
        return det["landmarks"][rows, best], det["valid"][rows, best]

    def _align_embed(self, a_params, imgs, lms):
        crops = align_face(imgs, lms, self.embedder.cfg.image_size)
        return self.embedder._embed(a_params, crops)

    @torch.no_grad()
    def _face_program(self, m_params, a_params, canvases_u8, hws):
        """The whole face leg of one sub-batch on the device: detect ->
        pick the most-probable valid face -> align (canvas coords) ->
        ArcFace. -> (embeddings, has a face, landmarks)."""
        imgs = canvases_u8.to(torch.float32)
        lms, has = self._detect(m_params, imgs, hws)
        return self._align_embed(a_params, imgs, lms), has, lms

    def __call__(self, pil_images) -> np.ndarray:
        side = self.mtcnn_cfg.canvas
        out = np.full((len(pil_images), self.dim), np.nan, np.float32)
        canvases, hws, owners, scales, originals = [], [], [], [], []
        for i, img in enumerate(pil_images):
            if img is None:
                continue
            rgb = img.convert("RGB")
            w, h = rgb.size
            if min(w, h) < self.mtcnn_cfg.min_face_size:
                continue  # parity: too-small images keep None
            scale = min(1.0, side / max(w, h))
            original = rgb
            if scale < 1.0:
                rgb = rgb.resize((max(1, int(w * scale)),
                                  max(1, int(h * scale))))
            arr = np.asarray(rgb, dtype=np.uint8)
            canvas = np.zeros((side, side, 3), np.uint8)
            canvas[: arr.shape[0], : arr.shape[1]] = arr
            canvases.append(canvas)
            hws.append((arr.shape[0], arr.shape[1]))
            owners.append(i)
            scales.append(scale)
            originals.append(original if scale < 1.0 else None)
        if not canvases:
            return out
        bs = self.batch_size
        embs, present, lms_all = [], [], []
        for start in range(0, len(canvases), bs):
            imgs = canvases[start: start + bs]
            hw = hws[start: start + bs]
            n_real = len(imgs)
            pad = bs - n_real
            if pad:
                imgs = imgs + [np.zeros((side, side, 3), np.uint8)] * pad
                hw = hw + [(side, side)] * pad
            emb, has, lms = HostCopy(*self._face_program(
                self.mtcnn_params, self.embedder.params,
                upload(np.stack(imgs), self.device),
                upload(np.asarray(hw, np.float32), self.device))).result()
            embs.append(emb.numpy()[:n_real])
            present.append(has.numpy()[:n_real])
            lms_all.append(lms.numpy()[:n_real])
        embs = np.concatenate(embs)
        present = np.concatenate(present)
        lms_all = np.concatenate(lms_all)
        # Images LARGER than the canvas were detected downscaled; align +
        # embed those at FULL resolution like the dataset stages do
        # (FaceDetector rescales landmarks to original coords,
        # FaceEmbedder warps the original image) — the fused canvas crop
        # would sample the face at reduced resolution and change the
        # embedding.
        redo = [j for j in range(len(owners))
                if present[j] and scales[j] < 1.0]
        if redo:
            crops = [self.embedder._aligned_crop(
                FaceEmbedder._to_rgb_array(originals[j]),
                lms_all[j] / scales[j]) for j in redo]
            embs[np.asarray(redo)] = self.embedder._embed_crops(crops)
        owners = np.asarray(owners)
        out[owners[present]] = embs[present]
        return out
