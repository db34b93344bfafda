"""Image preprocessing as batched device ops (counterpart of
viquae_tpu/ops/image.py).

Decode stays on the host (PIL); everything after raw RGB runs on the
tensor's device: resize, crop, normalize and the affine warp of face
alignment. Images are NHWC, as in the reference.

- :func:`resize_bilinear` is ``jax.image.resize``: half-pixel centres,
  antialiasing (the kernel is widened by the downscale factor), weights
  renormalised at the edges, Keys cubic with a = -0.5 for "cubic". The two
  separable weight matrices are built as ``jax._src.image.scale`` builds
  them and applied as two float32 products; a dimension whose size does
  not change is left alone, as there. (``F.interpolate`` differs: its
  bicubic uses a = -0.75 without antialiasing.)
- :func:`map_coordinates_bilinear` is order-1
  ``jax.scipy.ndimage.map_coordinates`` in its two modes: ``constant``
  (a tap outside the image reads 0) and ``nearest`` (taps are clamped),
  with the reference's order of products and sums.
- :func:`umeyama_similarity` solves the 2x2 problem in closed form: the
  best rotation of a 2x2 cross-covariance [[a, b], [c, d]] is the angle
  atan2(c - b, a + d) and the trace term is the norm of that vector, which
  is what ``u @ diag(1, sign(det u det vt)) @ vt`` of its SVD gives. No
  SVD, determinant or inverse call, so nothing waits for the device.

Every function takes leading batch dimensions where the reference takes
one image, so the face leg aligns a whole sub-batch in one call.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

# normalization constants (reference: image/embedding.py:86-94 and CLIP)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
FACE_MEAN = (0.5, 0.5, 0.5)   # ArcFace (face_recognition.py:64-69)
FACE_STD = (0.5, 0.5, 0.5)

_F32_EPS = float(torch.finfo(torch.float32).eps)


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


_KERNELS = {"bilinear": _triangle, "linear": _triangle, "cubic": _keys_cubic,
            "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=256)
def _weight_mat(in_size: int, out_size: int, method: str, antialias: bool,
                device: torch.device) -> torch.Tensor:
    """(in_size, out_size) float32 resampling weights, as
    jax._src.image.scale.compute_weight_mat with translation 0."""
    kernel = _KERNELS[method]
    inv_scale = torch.full((), 1.0 / (out_size / in_size),
                           dtype=torch.float32, device=device)
    kernel_scale = (torch.clamp(inv_scale, min=1.0) if antialias
                    else torch.ones((), device=device))
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(
        in_size, dtype=torch.float32, device=device)[:, None]).abs() \
        / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_bilinear(images: torch.Tensor, size: Tuple[int, int],
                    antialias: bool = True,
                    method: str = "bilinear") -> torch.Tensor:
    """(B, H, W, C) float -> (B, h, w, C), align_corners=False semantics."""
    x = images
    _, h, w, _ = x.shape
    if h != size[0]:
        wy = _weight_mat(h, size[0], method, antialias, x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, wy)
    if w != size[1]:
        wx = _weight_mat(w, size[1], method, antialias, x.device)
        x = torch.einsum("bhwc,wW->bhWc", x, wx)
    return x


def center_crop(images: torch.Tensor, size: int) -> torch.Tensor:
    _, h, w, _ = images.shape
    top = (h - size) // 2
    left = (w - size) // 2
    return images[:, top: top + size, left: left + size, :]


@functools.lru_cache(maxsize=64)
def _channel_constant(values: Tuple[float, ...], dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    # fill kernels: a copy from host memory would wait for the device
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values])


def normalize(images: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    mean = _channel_constant(tuple(mean), images.dtype, images.device)
    std = _channel_constant(tuple(std), images.dtype, images.device)
    return (images - mean) / std


def preprocess(images: torch.Tensor, size: int = 224, kind: str = "clip"
               ) -> torch.Tensor:
    """uint8/float (B, H, W, 3) in [0, 255] -> normalized float32 (B, s, s, 3).

    kind: "clip" (bicubic shorter-side resize + center crop + CLIP stats),
    "imagenet" (bilinear shorter-side resize + center crop + ImageNet
    stats: Resize(224)+CenterCrop(224), not the 256-resize recipe), "face"
    (size x size resize + 0.5/0.5 stats).
    """
    x = images.to(torch.float32) / 255.0
    if kind in ("imagenet", "clip"):
        # resize the SHORTER side to `size`, center crop: never squash the
        # aspect ratio. CLIP's transform interpolates BICUBIC, torchvision
        # Resize bilinear
        h, w = x.shape[1], x.shape[2]
        scale = size / min(h, w)
        x = resize_bilinear(
            x, (max(size, int(round(h * scale))),
                max(size, int(round(w * scale)))),
            method="cubic" if kind == "clip" else "bilinear",
        )
        x = center_crop(x, size)
        if kind == "imagenet":
            return normalize(x, IMAGENET_MEAN, IMAGENET_STD)
        return normalize(x, CLIP_MEAN, CLIP_STD)
    if kind == "face":
        x = resize_bilinear(x, (size, size))
        return normalize(x, FACE_MEAN, FACE_STD)
    raise ValueError(f"Unknown preprocessing kind {kind!r}")


# --------------------------------------------------------------------------
# order-1 map_coordinates
# --------------------------------------------------------------------------
def linear_taps(coord: torch.Tensor, size: int, mode: str):
    """The two (index, weight, valid) taps of order-1 interpolation along
    one axis; indices clamped into the image (their values are masked
    where ``valid`` is False in mode "constant")."""
    lower = torch.floor(coord)
    upper_w = coord - lower
    lower_w = 1.0 - upper_w
    index = lower.to(torch.int64)
    taps = []
    for idx, weight in ((index, lower_w), (index + 1, upper_w)):
        valid = (idx >= 0) & (idx < size) if mode == "constant" else None
        taps.append((idx.clamp(0, size - 1), weight, valid))
    return taps


def map_coordinates_bilinear(images: torch.Tensor, ys: torch.Tensor,
                             xs: torch.Tensor, mode: str = "constant"
                             ) -> torch.Tensor:
    """Order-1 ``map_coordinates`` of (B, H, W, C) images at per-image
    sample points ys, xs of shape (B, P) -> (B, P, C). mode "constant"
    reads 0 outside the image, "nearest" clamps the taps."""
    if mode not in ("constant", "nearest"):
        raise ValueError(f"unsupported mode {mode!r}")
    b, h, w, c = images.shape
    flat = images.reshape(b, h * w, c)
    out = None
    for yi, wy, vy in linear_taps(ys, h, mode):
        for xi, wx, vx in linear_taps(xs, w, mode):
            idx = (yi * w + xi)[..., None].expand(-1, -1, c)
            value = torch.gather(flat, 1, idx)
            if mode == "constant":
                value = torch.where((vy & vx)[..., None], value, 0.0)
            term = (wy * wx)[..., None] * value
            out = term if out is None else out + term
    return out


# --------------------------------------------------------------------------
# affine warp (face alignment)
# --------------------------------------------------------------------------
def affine_warp(image: torch.Tensor, matrix: torch.Tensor,
                out_size: Tuple[int, int]) -> torch.Tensor:
    """Inverse-map affine warp with a 2x3 matrix mapping OUTPUT pixel
    coords -> INPUT coords (cv2.warpAffine with WARP_INVERSE_MAP
    semantics), bilinear sampling, zero padding. One (H, W, C) image and a
    (2, 3) matrix, or a batch: (B, H, W, C) and (B, 2, 3)."""
    if image.dim() == 3:
        return affine_warp(image[None], matrix[None], out_size)[0]
    hh, ww = out_size
    ys = torch.arange(hh, dtype=torch.float32,
                      device=image.device)[:, None].expand(hh, ww)
    xs = torch.arange(ww, dtype=torch.float32,
                      device=image.device)[None, :].expand(hh, ww)
    m = matrix.to(torch.float32)[:, :, :, None, None]
    src_x = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    src_y = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    b = image.shape[0]
    out = map_coordinates_bilinear(
        image.to(torch.float32), src_y.reshape(b, -1), src_x.reshape(b, -1),
        mode="constant")
    return out.reshape(b, hh, ww, image.shape[-1])


def umeyama_similarity(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares similarity transform (rotation+scale+translation)
    mapping src (..., N, 2) -> dst (..., N, 2); returns (..., 2, 3).

    skimage's SimilarityTransform.estimate (Umeyama 1991), used by the
    reference for 5-landmark face alignment, in closed form for 2-D (see
    the module docstring)."""
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    n = src.shape[-2]
    src_mean = src.mean(dim=-2)
    dst_mean = dst.mean(dim=-2)
    src_c = src - src_mean[..., None, :]
    dst_c = dst - dst_mean[..., None, :]
    cov = (dst_c[..., :, :, None] * src_c[..., :, None, :]).sum(-3) / n
    p = cov[..., 0, 0] + cov[..., 1, 1]
    q = cov[..., 1, 0] - cov[..., 0, 1]
    norm = torch.sqrt(p * p + q * q)
    cos, sin = p / norm, q / norm
    rotation = torch.stack([torch.stack([cos, -sin], -1),
                            torch.stack([sin, cos], -1)], -2)
    var_src = (src_c ** 2).sum(dim=(-2, -1)) / n
    scale = norm / var_src
    translation = dst_mean - scale[..., None] * (
        rotation @ src_mean[..., None])[..., 0]
    return torch.cat([scale[..., None, None] * rotation,
                      translation[..., None]], dim=-1)


def invert_affine(matrix: torch.Tensor) -> torch.Tensor:
    """Invert a (..., 2, 3) affine matrix (the 2x2 inverse in closed
    form)."""
    a, b = matrix[..., 0, 0], matrix[..., 0, 1]
    c, d = matrix[..., 1, 0], matrix[..., 1, 1]
    det = a * d - b * c
    a_inv = torch.stack([torch.stack([d, -b], -1),
                         torch.stack([-c, a], -1)], -2) / det[..., None, None]
    t = matrix[..., :, 2:]
    return torch.cat([a_inv, -(a_inv @ t)], dim=-1)


def scale_box(boxes: torch.Tensor, width, height) -> torch.Tensor:
    """UNITER-style 7-d box features scaled to [0,1]:
    (x1, y1, x2, y2, w, h, area) — parity image/face_box.py:16-43."""
    x1 = boxes[..., 0] / width
    y1 = boxes[..., 1] / height
    x2 = boxes[..., 2] / width
    y2 = boxes[..., 3] / height
    w = x2 - x1
    h = y2 - y1
    return torch.stack([x1, y1, x2, y2, w, h, w * h], dim=-1)
