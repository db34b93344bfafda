"""MTCNN face detection cascade, batched with static shapes (counterpart of
viquae_tpu/models/mtcnn.py).

The reference's cascade is a per-image program vmapped over a batch:
images padded onto a fixed canvas, a fixed top-K proposal set per pyramid
scale, fixed-size greedy NMS, bilinear stage crops as two products with
per-box weight matrices. Here the same cascade runs on the whole batch at
once, and nothing in it reads a device value back on the host:

- :func:`nms_fixed` runs greedy NMS over any number of leading batch
  dimensions (images, and images x scales for the per-scale NMS) for a
  FIXED number of iterations: min(max_keep, K). Every iteration keeps one
  box in each row that still has a live candidate and leaves the other
  rows unchanged (a row with none would otherwise keep ``argmax`` of an
  all-NEG_INF row, index 0). Each live iteration keeps one box, so the
  count bounds the keeps exactly as the reference's ``n < cap`` does; its
  data-dependent early exit becomes rows that stop changing. ``argmax``
  returns the first of equal maxima, as ``jnp.argmax``.
- top-k selections are stable descending sorts: ``jax.lax.top_k`` breaks
  ties by the lower index, ``torch.topk`` promises no order among ties
  (flat regions and zero padding give tied PNet probabilities).
- max pooling is ``F.max_pool2d(ceil_mode=True)``, which equals the
  reference's -inf padding when h > window (tests/test_torch_face.py).
- every product is float32: the threshold decisions are sensitive near
  0.6 / 0.7, the reference pins ``Precision.HIGHEST``, and this port keeps
  TF32 off (core/device.py).

Network weights follow facenet_pytorch's PNet/RNet/ONet layout
(:func:`params_from_facenet`); modules are named as the JAX tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from viquae_torch.models import convert
from viquae_torch.models import layers as L
from viquae_torch.models.resnet import nchw
from viquae_torch.ops.image import linear_taps

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class MTCNNConfig:
    canvas: int = 512
    min_face_size: int = 20
    thresholds: Tuple[float, float, float] = (0.6, 0.7, 0.7)
    factor: float = 0.709
    k_per_scale: int = 64      # proposals kept per pyramid scale
    k_stage1: int = 128        # proposals after stage-1 NMS
    k_stage2: int = 64         # candidates after RNet
    max_faces: int = 16        # final detections
    bn_eps: float = 1e-5  # (no BN in MTCNN; kept for interface uniformity)

    @property
    def scales(self) -> Tuple[float, ...]:
        m = 12.0 / self.min_face_size
        scales = []
        s = m
        while self.canvas * s >= 12.0:
            scales.append(s)
            s *= self.factor
        return tuple(scales)


# --------------------------------------------------------------------------
# networks (facenet_pytorch layer layout)
# --------------------------------------------------------------------------
def _conv(c: nn.Conv2d, x, stride=1):
    return F.conv2d(x, c.weight, c.bias, stride)


_prelu = L.prelu


def _maxpool(x, window, stride):
    """ceil_mode=True maxpool (facenet_pytorch uses ceil_mode)."""
    return F.max_pool2d(x, window, stride, ceil_mode=True)


def _convs(spec, **factory):
    """{name: Conv2d} and {prelu name: PReLU} from (name, cin, cout, k)."""
    mods = {}
    for i, (name, cin, cout, k) in enumerate(spec, start=1):
        mods[name] = nn.Conv2d(cin, cout, k, **factory)
        if not name.startswith("conv4_"):
            mods[f"prelu{i}"] = nn.PReLU(cout, **factory)
    return mods


class MTCNN(nn.Module):
    """The three networks, named as the JAX tree (``pnet.conv1``, ...)."""

    def __init__(self, **factory):
        super().__init__()
        self.pnet = nn.ModuleDict(_convs(
            [("conv1", 3, 10, 3), ("conv2", 10, 16, 3), ("conv3", 16, 32, 3),
             ("conv4_1", 32, 2, 1), ("conv4_2", 32, 4, 1)], **factory))
        self.rnet = nn.ModuleDict({
            **_convs([("conv1", 3, 28, 3), ("conv2", 28, 48, 3),
                      ("conv3", 48, 64, 2)], **factory),
            "dense4": nn.Linear(576, 128, **factory),
            "prelu4": nn.PReLU(128, **factory),
            "dense5_1": nn.Linear(128, 2, **factory),
            "dense5_2": nn.Linear(128, 4, **factory)})
        self.onet = nn.ModuleDict({
            **_convs([("conv1", 3, 32, 3), ("conv2", 32, 64, 3),
                      ("conv3", 64, 64, 3), ("conv4", 64, 128, 2)],
                     **factory),
            "dense5": nn.Linear(1152, 256, **factory),
            "prelu5": nn.PReLU(256, **factory),
            "dense6_1": nn.Linear(256, 2, **factory),
            "dense6_2": nn.Linear(256, 4, **factory),
            "dense6_3": nn.Linear(256, 10, **factory)})


def init(seed: int = 0, device=None) -> MTCNN:
    """Seeded random weights (layers.init_weights_) on ``device``."""
    return L.seeded(MTCNN, seed=seed, device=device)


def from_jax(tree: Dict[str, Any], device=None) -> MTCNN:
    """The JAX package's MTCNN tree (numpy leaves) -> :class:`MTCNN`."""
    return convert.module_from_tree(MTCNN, tree=tree, device=device)


def _lin(lin: nn.Linear, x):
    return x @ lin.weight.t() + lin.bias


@torch.no_grad()
def pnet_apply(p, x):
    """(B, H, W, 3) -> probs (B, h, w), reg (B, h, w, 4)."""
    x = _prelu(p["prelu1"], _conv(p["conv1"], nchw(x)))
    x = _maxpool(x, 2, 2)
    x = _prelu(p["prelu2"], _conv(p["conv2"], x))
    x = _prelu(p["prelu3"], _conv(p["conv3"], x))
    probs = torch.softmax(_conv(p["conv4_1"], x), dim=1)[:, 1]
    reg = _conv(p["conv4_2"], x).permute(0, 2, 3, 1)
    return probs, reg


def _flatten_torch(x):
    """NCHW -> facenet's dense-input order: it permutes to (B, C, W, H)
    before flattening."""
    return x.transpose(2, 3).reshape(x.shape[0], -1)


@torch.no_grad()
def rnet_apply(p, x):
    x = _prelu(p["prelu1"], _conv(p["conv1"], nchw(x)))
    x = _maxpool(x, 3, 2)
    x = _prelu(p["prelu2"], _conv(p["conv2"], x))
    x = _maxpool(x, 3, 2)
    x = _prelu(p["prelu3"], _conv(p["conv3"], x))
    x = _flatten_torch(x)
    x = _prelu(p["prelu4"], _lin(p["dense4"], x))
    probs = torch.softmax(_lin(p["dense5_1"], x), dim=-1)[:, 1]
    reg = _lin(p["dense5_2"], x)
    return probs, reg


@torch.no_grad()
def onet_apply(p, x):
    x = _prelu(p["prelu1"], _conv(p["conv1"], nchw(x)))
    x = _maxpool(x, 3, 2)
    x = _prelu(p["prelu2"], _conv(p["conv2"], x))
    x = _maxpool(x, 3, 2)
    x = _prelu(p["prelu3"], _conv(p["conv3"], x))
    x = _maxpool(x, 2, 2)
    x = _prelu(p["prelu4"], _conv(p["conv4"], x))
    x = _flatten_torch(x)
    x = _prelu(p["prelu5"], _lin(p["dense5"], x))
    probs = torch.softmax(_lin(p["dense6_1"], x), dim=-1)[:, 1]
    reg = _lin(p["dense6_2"], x)
    landmarks = _lin(p["dense6_3"], x)
    return probs, reg, landmarks


# --------------------------------------------------------------------------
# fixed-shape geometry helpers (any leading batch dimensions)
# --------------------------------------------------------------------------
def iou_matrix(boxes: torch.Tensor, mode: str = "union") -> torch.Tensor:
    """(..., K, 4) xyxy -> (..., K, K) IoU ('union') or min-overlap
    ('min')."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    if mode == "min":
        denom = torch.minimum(area[..., :, None], area[..., None, :])
    else:
        denom = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(denom, min=1e-9)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              iou_threshold: float, mode: str = "union",
              max_keep: Optional[int] = None) -> torch.Tensor:
    """Greedy NMS with static shapes over (..., K) rows: returns the keep
    mask (..., K). Runs min(max_keep, K) iterations with no host read (see
    the module docstring); ``max_keep`` bounds the keeps EXACTLY, and
    greedy NMS keeps in descending score order, so the first N keeps are
    the top-N survivors."""
    lead, k = scores.shape[:-1], scores.shape[-1]
    cap = k if max_keep is None else min(int(max_keep), k)
    boxes = boxes.reshape(-1, k, 4)
    scores = scores.reshape(-1, k)
    valid = valid.reshape(-1, k)
    rows = torch.arange(scores.shape[0], device=scores.device)
    ious = iou_matrix(boxes, mode)
    masked = torch.where(valid, scores, NEG_INF)
    keep = torch.zeros_like(valid)
    alive = valid.clone()
    s = masked
    for _ in range(cap):
        best = torch.argmax(s, dim=1)
        live = s[rows, best] > NEG_INF
        keep[rows, best] |= live
        dead = (ious[rows, best] > iou_threshold) & live[:, None]
        alive &= ~dead
        alive[rows, best] &= ~live
        s = torch.where(alive, masked, NEG_INF)
    return (keep & valid).reshape(*lead, k)


def rerec(boxes: torch.Tensor) -> torch.Tensor:
    """Make boxes square around their center (MTCNN 'rerec')."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    side = torch.maximum(w, h)
    cx = boxes[..., 0] + w * 0.5
    cy = boxes[..., 1] + h * 0.5
    return torch.stack([
        cx - side * 0.5, cy - side * 0.5, cx + side * 0.5, cy + side * 0.5,
    ], dim=-1)


def calibrate(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """Apply bbox regression offsets (MTCNN 'bbreg')."""
    w = (boxes[..., 2] - boxes[..., 0])[..., None]
    h = (boxes[..., 3] - boxes[..., 1])[..., None]
    scale = torch.cat([w, h, w, h], dim=-1)
    return boxes + reg * scale


def crop_resize(images: torch.Tensor, boxes: torch.Tensor, out: int
                ) -> torch.Tensor:
    """Bilinear crops of (B, K, 4) xyxy boxes from (B, H, W, 3) images ->
    (B, K, out, out, 3), as two f32 products with per-box interpolation
    weight matrices (out[k] = Wy[k] @ image @ Wx[k]^T per channel). The
    weight w[i, p] = max(0, 1 - |c_i - p|) reproduces order-1
    map_coordinates with mode='constant' cval=0 exactly."""
    h, w = images.shape[1:3]
    ar = torch.arange(out, dtype=torch.float32, device=images.device)

    def weight_mat(lo, hi, n_px):
        # sample centers along one axis for every box: (B, K, out)
        centers = (lo[..., None] + (ar + 0.5) * ((hi - lo) / out)[..., None]
                   - 0.5)
        px = torch.arange(n_px, dtype=torch.float32, device=images.device)
        return torch.clamp(1.0 - (centers[..., None] - px).abs(), min=0.0)

    wy = weight_mat(boxes[..., 1], boxes[..., 3], h)     # (B, K, out, H)
    wx = weight_mat(boxes[..., 0], boxes[..., 2], w)     # (B, K, out, W)
    tmp = torch.einsum("bkih,bhwc->bkiwc", wy, images)
    return torch.einsum("bkiwc,bkjw->bkijc", tmp, wx)


def _normalize(x):
    return (x - 127.5) * 0.0078125


def _bilinear_resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, size, size, 3) half-pixel bilinear with clamped
    taps (order-1 map_coordinates, mode 'nearest'): facenet_pytorch's
    non-antialiased interpolation. The grid is separable, so the taps are
    row and column gathers."""
    _, h, w, _ = images.shape
    ar = torch.arange(size, dtype=torch.float32, device=images.device)
    ys = (ar + 0.5) * (h / size) - 0.5
    xs = (ar + 0.5) * (w / size) - 0.5
    out = None
    for yi, wy, _ in linear_taps(ys, h, "nearest"):
        rows = images[:, yi]                               # (B, size, W, 3)
        for xi, wx, _ in linear_taps(xs, w, "nearest"):
            term = (wy[:, None] * wx[None, :])[None, :, :, None] \
                * rows[:, :, xi]
            out = term if out is None else out + term
    return out


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last dim: descending, ties by the lower
    index (a stable sort)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) rows picked by idx (B, k) -> (B, k, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


# --------------------------------------------------------------------------
# the cascade
# --------------------------------------------------------------------------
# Four stages, each one call on the whole batch; detect_faces_batch chains
# them, and they are public so that a caller can time or inspect each.
@torch.no_grad()
def pnet_stage(params: MTCNN, images, true_hws, cfg: MTCNNConfig):
    """Pyramid + PNet: the top ``k_per_scale`` cells of every scale as
    boxes (B, S, K, 4) in canvas coords, their probabilities (B, S, K),
    regressions (B, S, K, 4) and validity (threshold 0 and inside the real
    extent) (B, S, K)."""
    b = images.shape[0]
    all_boxes, all_scores, all_reg, all_valid = [], [], [], []
    for scale in cfg.scales:
        size = max(12, int(round(cfg.canvas * scale)))
        scaled = _bilinear_resize(images, size)
        probs, reg = pnet_apply(params.pnet, _normalize(scaled))
        h, w = probs.shape[1:]
        flat = probs.reshape(b, -1)
        k = min(cfg.k_per_scale, flat.shape[1])
        top_p, top_i = _top_k(flat, k)
        row = (top_i // w).to(torch.float32)
        col = (top_i % w).to(torch.float32)
        # cell -> original coords (stride 2, cell 12)
        q1x = (col * 2 + 1) / scale
        q1y = (row * 2 + 1) / scale
        q2x = (col * 2 + 12) / scale
        q2y = (row * 2 + 12) / scale
        boxes = torch.stack([q1x, q1y, q2x, q2y], dim=-1)
        regs = _take(reg.reshape(b, -1, 4), top_i)
        valid = top_p >= cfg.thresholds[0]
        # inside the real (unpadded) extent
        valid &= (q1x < true_hws[:, 1:2]) & (q1y < true_hws[:, 0:1])
        if k < cfg.k_per_scale:
            pad = cfg.k_per_scale - k
            boxes = F.pad(boxes, (0, 0, 0, pad))
            regs = F.pad(regs, (0, 0, 0, pad))
            top_p = F.pad(top_p, (0, pad))
            valid = torch.cat([valid, valid.new_zeros((b, pad))], dim=1)
        all_boxes.append(boxes)
        all_scores.append(top_p)
        all_reg.append(regs)
        all_valid.append(valid)
    return (torch.stack(all_boxes, dim=1), torch.stack(all_scores, dim=1),
            torch.stack(all_reg, dim=1), torch.stack(all_valid, dim=1))


def _select(boxes, regs, scores, keep, k):
    """The top-k kept boxes by score (NEG_INF for the rest), calibrated and
    squared; -> boxes, valid."""
    sel_scores, sel = _top_k(torch.where(keep, scores, NEG_INF), k)
    boxes = rerec(calibrate(_take(boxes, sel), _take(regs, sel)))
    return boxes, sel_scores > NEG_INF


@torch.no_grad()
def stage1_nms(boxes, scores, regs, valid, cfg: MTCNNConfig):
    """Per-scale NMS 0.5 (all scales of all images at once), cross-scale
    NMS 0.7 capped at ``k_stage1``, then the ``k_stage1`` best kept boxes,
    calibrated and squared -> boxes (B, k_stage1, 4), valid."""
    b = boxes.shape[0]
    keep = nms_fixed(boxes, scores, valid, 0.5).reshape(b, -1)
    boxes, scores = boxes.reshape(b, -1, 4), scores.reshape(b, -1)
    regs = regs.reshape(b, -1, 4)
    keep = nms_fixed(boxes, scores, keep, 0.7, max_keep=cfg.k_stage1)
    return _select(boxes, regs, scores, keep, cfg.k_stage1)


@torch.no_grad()
def rnet_stage(params: MTCNN, images, boxes, valid, cfg: MTCNNConfig):
    """24x24 crops -> RNet -> threshold 1 -> NMS 0.7 capped at
    ``k_stage2`` -> the best kept, calibrated and squared.
    -> (RNet probabilities (B, k_stage1), boxes (B, k_stage2, 4), valid)."""
    b, k = boxes.shape[:2]
    crops = crop_resize(images, boxes, 24)
    probs, reg = rnet_apply(params.rnet,
                            _normalize(crops).reshape(b * k, 24, 24, 3))
    probs, reg = probs.reshape(b, k), reg.reshape(b, k, 4)
    valid = valid & (probs >= cfg.thresholds[1])
    keep = nms_fixed(boxes, probs, valid, 0.7, max_keep=cfg.k_stage2)
    return (probs, *_select(boxes, reg, probs, keep, cfg.k_stage2))


@torch.no_grad()
def onet_stage(params: MTCNN, images, boxes, valid, cfg: MTCNNConfig):
    """48x48 crops -> ONet -> threshold 2 -> landmarks, calibration ->
    min-overlap NMS 0.7 capped at ``max_faces`` -> the detections.
    -> (ONet probabilities (B, k_stage2), the detections dict)."""
    b, k = boxes.shape[:2]
    crops = crop_resize(images, boxes, 48)
    probs3, reg3, lm = onet_apply(
        params.onet, _normalize(crops).reshape(b * k, 48, 48, 3))
    probs3 = probs3.reshape(b, k)
    reg3, lm = reg3.reshape(b, k, 4), lm.reshape(b, k, 10)
    valid = valid & (probs3 >= cfg.thresholds[2])
    w = (boxes[..., 2] - boxes[..., 0])[..., None]
    h = (boxes[..., 3] - boxes[..., 1])[..., None]
    # landmarks: first 5 x-coords then 5 y-coords, relative to the box
    lm_x = boxes[..., 0:1] + lm[..., 0:5] * w
    lm_y = boxes[..., 1:2] + lm[..., 5:10] * h
    landmarks = torch.stack([lm_x, lm_y], dim=-1)    # (B, K, 5, 2)
    boxes = calibrate(boxes, reg3)
    keep = nms_fixed(boxes, probs3, valid, 0.7, mode="min",
                     max_keep=cfg.max_faces)
    sel_scores, sel = _top_k(torch.where(keep, probs3, NEG_INF),
                             cfg.max_faces)
    found = sel_scores > NEG_INF
    return probs3, {
        "boxes": _take(boxes, sel),
        "probs": torch.where(found, sel_scores, 0.0),
        "landmarks": _take(landmarks, sel),
        "valid": found,
    }


@torch.no_grad()
def detect_faces_batch(params: MTCNN, images: torch.Tensor,
                       true_hws: torch.Tensor,
                       cfg: MTCNNConfig = MTCNNConfig()
                       ) -> Dict[str, torch.Tensor]:
    """Detection on a batch of canvases: images (B, canvas, canvas, 3)
    float32 in [0, 255], true_hws (B, 2) real height/width before padding.

    Returns fixed-size tensors: boxes (B, max_faces, 4) xyxy in canvas
    pixel coords, probs (B, max_faces), landmarks (B, max_faces, 5, 2),
    valid (B, max_faces). The reference's ``detect_faces`` on each image.
    """
    images = images.to(torch.float32)
    true_hws = true_hws.to(torch.float32)
    boxes, valid = stage1_nms(*pnet_stage(params, images, true_hws, cfg),
                              cfg)
    _, boxes, valid = rnet_stage(params, images, boxes, valid, cfg)
    return onet_stage(params, images, boxes, valid, cfg)[1]


def detect_faces(params: MTCNN, image: torch.Tensor, true_hw: torch.Tensor,
                 cfg: MTCNNConfig = MTCNNConfig()) -> Dict[str, torch.Tensor]:
    """Single-image detection: ``detect_faces_batch`` on a batch of one."""
    out = detect_faces_batch(params, image[None], true_hw[None], cfg)
    return {k: v[0] for k, v in out.items()}


# --------------------------------------------------------------------------
# weight port (facenet_pytorch MTCNN state_dict)
# --------------------------------------------------------------------------
def tree_from_facenet(state_dict) -> Dict[str, Any]:
    """facenet_pytorch's MTCNN state_dict -> the JAX package's tree (its
    ``params_from_facenet``)."""
    def get(name):
        t = state_dict[name]
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                          else t)

    def conv_p(name):
        return {
            "kernel": np.transpose(get(f"{name}.weight"), (2, 3, 1, 0)),
            "bias": get(f"{name}.bias"),
        }

    def dense_p(name):
        return {"kernel": get(f"{name}.weight").T, "bias": get(f"{name}.bias")}

    def prelu_p(name):
        return {"alpha": get(f"{name}.weight")}

    tree = {}
    for net, convs, prelus, denses in (
            ("pnet", ("conv1", "conv2", "conv3", "conv4_1", "conv4_2"),
             (1, 2, 3), ()),
            ("rnet", ("conv1", "conv2", "conv3"), (1, 2, 3, 4),
             ("dense4", "dense5_1", "dense5_2")),
            ("onet", ("conv1", "conv2", "conv3", "conv4"), (1, 2, 3, 4, 5),
             ("dense5", "dense6_1", "dense6_2", "dense6_3"))):
        tree[net] = {
            **{c: conv_p(f"{net}.{c}") for c in convs},
            **{f"prelu{i}": prelu_p(f"{net}.prelu{i}") for i in prelus},
            **{d: dense_p(f"{net}.{d}") for d in denses}}
    return tree


def params_from_facenet(state_dict, device=None) -> MTCNN:
    """facenet_pytorch's MTCNN state_dict (a local checkpoint) ->
    :class:`MTCNN` on ``device``."""
    return from_jax(tree_from_facenet(state_dict), device)
