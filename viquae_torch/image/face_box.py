"""Face bounding-box feature stage (parity meerqat/image/face_box.py).

Writes UNITER-style 7-d scaled box features (`face_box` -> `scaled_face_box`)
and scales landmarks into [0,1] given the image size. Pure numpy host stage
over viquae_torch.ops.image.scale_box semantics.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from viquae_torch.data.loading import load_image


def scale_boxes_item(item: dict, image_key: str = "image") -> dict:
    boxes = item.get("face_box")
    if boxes is None:
        item["scaled_face_box"] = None
        item["scaled_face_landmarks"] = item.get("face_landmarks")
        return item
    image = load_image(item[image_key])
    if image is None:
        # keep the output schema identical across items (datasets.map's
        # Arrow writer needs every item to carry the same keys)
        item["scaled_face_box"] = None
        item["scaled_face_landmarks"] = None
        return item
    width, height = image.size
    boxes = np.asarray(boxes, np.float32)
    x1, y1 = boxes[:, 0] / width, boxes[:, 1] / height
    x2, y2 = boxes[:, 2] / width, boxes[:, 3] / height
    w, h = x2 - x1, y2 - y1
    item["scaled_face_box"] = np.stack(
        [x1, y1, x2, y2, w, h, w * h], axis=1
    ).tolist()
    landmarks = item.get("face_landmarks")
    if landmarks is not None:
        lm = np.asarray(landmarks, np.float32)
        lm[..., 0] /= width
        lm[..., 1] /= height
        item["scaled_face_landmarks"] = lm.tolist()
    return item


def dataset_scale_face_boxes(dataset_path, image_key: str = "image",
                             map_kwargs: Optional[dict] = None):
    from datasets import load_from_disk

    from viquae_torch.ir.embedding import save_in_place

    dataset = load_from_disk(str(dataset_path))
    dataset = dataset.map(
        scale_boxes_item, fn_kwargs={"image_key": image_key},
        **(map_kwargs or {}),
    )
    save_in_place(dataset, dataset_path)
    return dataset
