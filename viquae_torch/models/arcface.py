"""ArcFace face embedder, insightface iresnet50, 512-d (counterpart of
viquae_tpu/models/arcface.py).

The reference embeds aligned 112x112 face crops with insightface's
``arcface_torch`` r50 backbone. Here: 3x3 stem (stride 1) + BN + PReLU,
IBasicBlock stages [3, 4, 14, 3] (BN-conv-BN-PReLU-conv-BN with a 1x1-conv
downsample), then BN -> flatten in (C, H, W) order -> FC(512) ->
BatchNorm1d features. Modules are named as the JAX param tree;
``compute_dtype=torch.bfloat16`` runs the convolutions and the FC in bf16
(the reference checkpoint's fp16 inference), BN and PReLU stay f32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from viquae_torch.models import convert
from viquae_torch.models import layers as L
from viquae_torch.models.resnet import conv, nchw


@dataclasses.dataclass(frozen=True)
class ArcFaceConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 14, 3)   # iresnet50
    width: int = 64
    embedding_size: int = 512
    image_size: int = 112
    bn_eps: float = 1e-5


prelu = L.prelu
batch_norm = L.batch_norm


class IBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, downsample: bool, **factory):
        super().__init__()
        self.bn1 = L.BatchNorm(cin, **factory)
        self.conv1 = nn.Conv2d(cin, cout, 3, bias=False, **factory)
        self.bn2 = L.BatchNorm(cout, **factory)
        self.prelu = nn.PReLU(cout, **factory)
        self.conv2 = nn.Conv2d(cout, cout, 3, bias=False, **factory)
        self.bn3 = L.BatchNorm(cout, **factory)
        if downsample:
            self.downsample_conv = nn.Conv2d(cin, cout, 1, bias=False,
                                             **factory)
            self.downsample_bn = L.BatchNorm(cout, **factory)


class ArcFace(nn.Module):
    def __init__(self, cfg: ArcFaceConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, cfg.width, 3, bias=False, **factory)
        self.bn1 = L.BatchNorm(cfg.width, **factory)
        self.prelu = nn.PReLU(cfg.width, **factory)
        self.layers = nn.ModuleList()
        cin = cfg.width
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            cout = cfg.width * 2 ** stage
            blocks = nn.ModuleList()
            for b in range(n_blocks):
                blocks.append(IBasicBlock(cin, cout, b == 0, **factory))
                cin = cout
            self.layers.append(blocks)
        feat = cin * (cfg.image_size // 16) ** 2
        self.bn2 = L.BatchNorm(cin, **factory)
        self.fc = nn.Linear(feat, cfg.embedding_size, **factory)
        self.features_bn = L.BatchNorm(cfg.embedding_size, **factory)

    def forward(self, images, compute_dtype=None):
        return apply(self, self.cfg, images, compute_dtype)


def init(cfg: ArcFaceConfig = ArcFaceConfig(), seed: int = 0, device=None
         ) -> ArcFace:
    """Seeded random weights (layers.init_weights_; the FC ~ N(0, 0.01) as
    the JAX init's) on ``device``."""
    return L.seeded(ArcFace, cfg, seed=seed, device=device, linear_std=0.01)


def from_jax(tree: Dict[str, Any], cfg: ArcFaceConfig, device=None
             ) -> ArcFace:
    """The JAX package's ArcFace tree (numpy leaves) -> :class:`ArcFace`."""
    return convert.module_from_tree(ArcFace, cfg, tree=tree, device=device)


def _block_apply(p: IBasicBlock, x, stride, eps, compute_dtype=None):
    cd = compute_dtype
    out = batch_norm(p.bn1, x, eps)
    out = conv(p.conv1, out, compute_dtype=cd)
    out = batch_norm(p.bn2, out, eps)
    out = prelu(p.prelu, out)
    out = conv(p.conv2, out, stride=stride, compute_dtype=cd)
    out = batch_norm(p.bn3, out, eps)
    if hasattr(p, "downsample_conv"):
        identity = batch_norm(p.downsample_bn, conv(
            p.downsample_conv, x, stride, compute_dtype=cd), eps)
    else:
        identity = x
    return out + identity


@torch.no_grad()
def apply(params: ArcFace, cfg: ArcFaceConfig, images: torch.Tensor,
          compute_dtype=None) -> torch.Tensor:
    """(B, 112, 112, 3) normalized with mean/std 0.5 -> (B, 512)."""
    eps = cfg.bn_eps
    x = prelu(params.prelu, batch_norm(
        params.bn1, conv(params.conv1, nchw(images.float()),
                         compute_dtype=compute_dtype), eps))
    for blocks in params.layers:
        for b, block in enumerate(blocks):
            x = _block_apply(block, x, stride=2 if b == 0 else 1, eps=eps,
                             compute_dtype=compute_dtype)
    x = batch_norm(params.bn2, x, eps)
    # torch flattens NCHW: (C, H, W) order
    x = x.reshape(x.shape[0], -1)
    if compute_dtype is not None:
        x = L.dense(params.fc, x, compute_dtype)
    else:
        x = x @ params.fc.weight.t() + params.fc.bias
    return batch_norm(params.features_bn, x, eps)


def tree_from_insightface(state_dict, cfg: ArcFaceConfig) -> Dict[str, Any]:
    """insightface ``iresnet50`` backbone.pth weights -> the JAX package's
    tree (its ``params_from_insightface``)."""
    def get(name):
        t = state_dict[name]
        return np.asarray(t.detach().cpu().float().numpy()
                          if hasattr(t, "detach") else t)

    def conv_p(name):
        return {"kernel": np.transpose(get(f"{name}.weight"), (2, 3, 1, 0))}

    def bn_p(name):
        return {
            "scale": get(f"{name}.weight"), "bias": get(f"{name}.bias"),
            "mean": get(f"{name}.running_mean"),
            "var": get(f"{name}.running_var"),
        }

    def prelu_p(name):
        return {"alpha": get(f"{name}.weight")}

    params: Dict[str, Any] = {
        "conv1": conv_p("conv1"),
        "bn1": bn_p("bn1"),
        "prelu": prelu_p("prelu"),
        "layers": [],
    }
    for stage, n_blocks in enumerate(cfg.stage_sizes, start=1):
        blocks = []
        for b in range(n_blocks):
            base = f"layer{stage}.{b}"
            p = {
                "bn1": bn_p(f"{base}.bn1"),
                "conv1": conv_p(f"{base}.conv1"),
                "bn2": bn_p(f"{base}.bn2"),
                "prelu": prelu_p(f"{base}.prelu"),
                "conv2": conv_p(f"{base}.conv2"),
                "bn3": bn_p(f"{base}.bn3"),
            }
            if f"{base}.downsample.0.weight" in state_dict:
                p["downsample_conv"] = conv_p(f"{base}.downsample.0")
                p["downsample_bn"] = bn_p(f"{base}.downsample.1")
            blocks.append(p)
        params["layers"].append(blocks)
    params["bn2"] = bn_p("bn2")
    params["fc"] = {"kernel": get("fc.weight").T, "bias": get("fc.bias")}
    params["features_bn"] = bn_p("features")
    return params


def params_from_insightface(state_dict, cfg: ArcFaceConfig, device=None
                            ) -> ArcFace:
    """Port insightface ``iresnet50`` backbone.pth weights (a local
    checkpoint) -> :class:`ArcFace` on ``device``."""
    return from_jax(tree_from_insightface(state_dict, cfg), cfg, device)
