"""Offline thumbnailing of the image corpus (parity meerqat/image/resize.py).

The reference maps `torchvision.transforms.Resize(size=512)` over every
image referenced by the dataset (`get_transform`, reference :18-21): the
SMALLER edge is resized to `size` (aspect preserved, bilinear, small
images are UPSCALED — torchvision semantics, not PIL.thumbnail's
shrink-only), already-existing outputs are skipped (resumable corpus
builds, reference :26-27), undecodable images are skipped with a warning
(load_image -> None, reference :31-33), and the file walk fans out over a
multiprocessing Pool (reference :36-40). Decode/encode is inherently host
work — there is no device leg to this stage.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional


def smaller_edge_size(width: int, height: int, size: int):
    """torchvision F.resize int-size semantics: smaller edge -> `size`,
    the other edge scaled with int() truncation; a no-op when the smaller
    edge already equals `size`."""
    if (width <= height and width == size) or (
            height <= width and height == size):
        return width, height
    if width < height:
        return size, int(size * height / width)
    return int(size * width / height), size


def resize_image(file_name, root, save_root, size: int = 512,
                 skip_existing: bool = True):
    """Resize one image; returns True (resized), None (output already
    exists — reference :26-27), or False (undecodable/unwritable)."""
    from PIL import Image

    src = Path(root) / file_name
    dst = Path(save_root) / file_name
    if skip_existing and dst.exists():
        return None
    try:
        image = Image.open(src).convert("RGB")
        new_size = smaller_edge_size(*image.size, size)
        if new_size != image.size:
            image = image.resize(new_size, Image.BILINEAR)
        dst.parent.mkdir(parents=True, exist_ok=True)
        image.save(dst)
        return True
    except Exception as e:  # noqa: BLE001 parity: skip undecodable
        import warnings

        warnings.warn(f"Could not resize {src}: {e}")
        return False


def dataset_resize(dataset_path, root, save_root, size: int = 512,
                   image_key: str = "image", processes: Optional[int] = None):
    """Resize every image referenced by the dataset's `image_key` column.

    Returns the number of images actually resized (skipped-existing and
    failed files are excluded — rerunning a partially-complete build only
    pays for the missing outputs)."""
    from datasets import load_from_disk

    dataset = load_from_disk(str(dataset_path))
    file_names = dataset[image_key]
    if processes:
        from multiprocessing import Pool

        with Pool(processes) as pool:
            results = pool.starmap(
                resize_image,
                [(f, root, save_root, size) for f in file_names],
            )
    else:
        results = [resize_image(f, root, save_root, size) for f in file_names]
    return sum(r is True for r in results)
