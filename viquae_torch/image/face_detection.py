"""Face-detection dataset stage (counterpart of
viquae_tpu/image/face_detection.py; parity meerqat/image/face_detection.py).

Writes ``face_prob``, ``face_box``, ``face_landmarks`` columns (None when
no face or undecodable image). Images are padded onto the detector's
canvas (scaled down first when larger) and run through the batched
cascade ``batch_size`` at a time; the final chunk is padded with zero
canvases, which detect nothing and are sliced off. Images whose min side
is below ``min_face_size`` are skipped.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from viquae_torch.core.device import resolve_device, upload
from viquae_torch.data.loading import load_image_batch
from viquae_torch.models import mtcnn


class FaceDetector:
    def __init__(self, params, cfg: Optional[mtcnn.MTCNNConfig] = None,
                 image_key: str = "image", batch_size: int = 16,
                 device=None):
        self.params = params
        self.cfg = cfg or mtcnn.MTCNNConfig()
        self.image_key = image_key
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def detect_batch(self, pil_images):
        """List of PIL images (or None) -> per-image (probs, boxes,
        landmarks) lists, None where nothing detected."""
        cfg = self.cfg
        n = len(pil_images)
        probs_out = [None] * n
        boxes_out = [None] * n
        landmarks_out = [None] * n

        present = []
        for i, img in enumerate(pil_images):
            if img is None:
                continue
            w, h = img.size
            if min(w, h) < cfg.min_face_size:
                continue  # parity: too-small images keep None
            # scale down onto the canvas if needed (preserve aspect)
            scale = min(1.0, cfg.canvas / max(w, h))
            if scale < 1.0:
                img = img.resize((max(1, int(w * scale)),
                                  max(1, int(h * scale))))
            if getattr(img, "mode", "RGB") != "RGB":
                img = img.convert("RGB")  # 'L'/'P'/'RGBA' columns
            arr = np.asarray(img, dtype=np.float32)
            canvas = np.zeros((cfg.canvas, cfg.canvas, 3), np.float32)
            canvas[: arr.shape[0], : arr.shape[1]] = arr
            present.append((i, canvas, (arr.shape[0], arr.shape[1]), scale))

        for start in range(0, len(present), self.batch_size):
            chunk = present[start: start + self.batch_size]
            n_pad = self.batch_size - len(chunk)
            images_np = np.stack(
                [c[1] for c in chunk]
                + [np.zeros((cfg.canvas, cfg.canvas, 3), np.float32)] * n_pad
            )
            hws_np = np.array(
                [c[2] for c in chunk] + [(1.0, 1.0)] * n_pad, np.float32
            )
            out = mtcnn.detect_faces_batch(
                self.params, upload(images_np, self.device),
                upload(hws_np, self.device), cfg)
            boxes = out["boxes"].cpu().numpy()
            probs = out["probs"].cpu().numpy()
            landmarks = out["landmarks"].cpu().numpy()
            valid = out["valid"].cpu().numpy()
            for j, (i, _, _, scale) in enumerate(chunk):
                m = valid[j]
                if not m.any():
                    continue
                inv = 1.0 / scale
                probs_out[i] = probs[j][m].tolist()
                boxes_out[i] = (boxes[j][m] * inv).tolist()
                landmarks_out[i] = (landmarks[j][m] * inv).tolist()
        return probs_out, boxes_out, landmarks_out

    def __call__(self, batch: dict) -> dict:
        images = load_image_batch(batch[self.image_key])
        probs, boxes, landmarks = self.detect_batch(images)
        batch["face_prob"] = probs
        batch["face_box"] = boxes
        batch["face_landmarks"] = landmarks
        return batch


def dataset_detect_faces(dataset_path, detector: FaceDetector,
                         map_kwargs: Optional[dict] = None):
    from datasets import load_from_disk

    from viquae_torch.ir.embedding import save_in_place

    dataset = load_from_disk(str(dataset_path))
    dataset = dataset.map(
        detector, batched=True, batch_size=detector.batch_size * 4,
        **(map_kwargs or {}),
    )
    save_in_place(dataset, dataset_path)
    return dataset
