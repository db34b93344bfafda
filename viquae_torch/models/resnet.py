"""Bottleneck ResNet (torchvision layout) for ImageNet image embeddings
(counterpart of viquae_tpu/models/resnet.py).

The reference's "imagenet-RN50" embedder is a torchvision ResNet-50 cut at
the penultimate layer with a configurable pool: the 2048-d pooled trunk
output is the image embedding. Inference-mode batch norm.

Images come in NHWC as in the reference; the trunk runs NCHW tensors whose
memory is channels-last (the permuted input's own strides), which is the
layout cuDNN's fast convolutions take. Modules are named as the JAX param
tree (``conv1``, ``bn1``, ``layers.{stage}.{block}.conv1`` ...,
``downsample_conv`` / ``downsample_bn``), so :func:`from_jax` is
``convert.module_from_tree``. ``compute_dtype=torch.bfloat16`` runs the
convolutions in bf16 (cuDNN accumulates in f32, and rounds each output to
bf16, where the reference keeps it in f32); batch norm stays f32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from viquae_torch.models import convert
from viquae_torch.models.layers import BatchNorm, batch_norm, seeded


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)   # resnet-50
    width: int = 64
    bn_eps: float = 1e-5
    pool: str = "avg"        # "avg" | "max" | "none" (feature map)


def conv(c: nn.Conv2d, x: torch.Tensor, stride: int = 1,
         padding: Optional[int] = None,
         compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """2D convolution of NCHW ``x`` with ``c.weight`` (OIHW), no bias,
    'same' padding for odd kernels unless given; f32 result."""
    kh = c.weight.shape[2]
    if padding is None:
        padding = (kh - 1) // 2
    weight = c.weight
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        weight = weight.to(compute_dtype)
    return F.conv2d(x, weight, None, stride, padding).float()


def _conv(cin, cout, k, **factory):
    return nn.Conv2d(cin, cout, k, bias=False, **factory)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, downsample: bool, **factory):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1, **factory)
        self.bn1 = BatchNorm(planes, **factory)
        self.conv2 = _conv(planes, planes, 3, **factory)
        self.bn2 = BatchNorm(planes, **factory)
        self.conv3 = _conv(planes, planes * 4, 1, **factory)
        self.bn3 = BatchNorm(planes * 4, **factory)
        if downsample:
            self.downsample_conv = _conv(cin, planes * 4, 1, **factory)
            self.downsample_bn = BatchNorm(planes * 4, **factory)


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.conv1 = _conv(3, cfg.width, 7, **factory)
        self.bn1 = BatchNorm(cfg.width, **factory)
        self.layers = nn.ModuleList()
        cin = cfg.width
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            planes = cfg.width * (2 ** stage)
            blocks = nn.ModuleList()
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                downsample = b == 0 and (stride != 1 or cin != planes * 4)
                blocks.append(Bottleneck(cin, planes, downsample, **factory))
                cin = planes * 4
            self.layers.append(blocks)

    def forward(self, images, compute_dtype=None):
        return apply(self, self.cfg, images, compute_dtype)


def _bottleneck_apply(p: Bottleneck, x, stride, eps, compute_dtype=None):
    cd = compute_dtype
    out = F.relu(batch_norm(p.bn1, conv(p.conv1, x, compute_dtype=cd), eps))
    out = F.relu(batch_norm(p.bn2, conv(p.conv2, out, stride,
                                        compute_dtype=cd), eps))
    out = batch_norm(p.bn3, conv(p.conv3, out, compute_dtype=cd), eps)
    if hasattr(p, "downsample_conv"):
        identity = batch_norm(p.downsample_bn, conv(
            p.downsample_conv, x, stride, compute_dtype=cd), eps)
    else:
        identity = x
    return F.relu(out + identity)


def nchw(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> an NCHW view with channels-last memory."""
    return images.permute(0, 3, 1, 2)


@torch.no_grad()
def apply(params: ResNet, cfg: ResNetConfig, images: torch.Tensor,
          compute_dtype=None) -> torch.Tensor:
    """(B, H, W, 3) normalized -> (B, 2048) pooled embedding (or the
    (B, h, w, 2048) feature map with pool='none')."""
    x = conv(params.conv1, nchw(images.float()), stride=2, padding=3,
             compute_dtype=compute_dtype)
    x = F.relu(batch_norm(params.bn1, x, cfg.bn_eps))
    # torchvision maxpool: kernel 3, stride 2, padding 1 (pads with -inf)
    x = F.max_pool2d(x, 3, 2, padding=1)
    for stage, blocks in enumerate(params.layers):
        for b, block in enumerate(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            x = _bottleneck_apply(block, x, stride, cfg.bn_eps,
                                  compute_dtype=compute_dtype)
    if cfg.pool == "avg":
        return x.mean(dim=(2, 3))
    if cfg.pool == "max":
        return x.amax(dim=(2, 3))
    return x.permute(0, 2, 3, 1)


def init(cfg: ResNetConfig = ResNetConfig(), seed: int = 0, device=None
         ) -> ResNet:
    """Seeded random weights (layers.init_weights_) on ``device``."""
    return seeded(ResNet, cfg, seed=seed, device=device)


def from_jax(tree: Dict[str, Any], cfg: ResNetConfig, device=None) -> ResNet:
    """The JAX package's ResNet param tree (numpy leaves) -> :class:`ResNet`
    on ``device`` (default: the GPU), f32."""
    return convert.module_from_tree(ResNet, cfg, tree=tree, device=device)


# --------------------------------------------------------------------------
# weight port (torchvision state_dict layout)
# --------------------------------------------------------------------------
def tree_from_torchvision(state_dict, cfg: ResNetConfig) -> Dict[str, Any]:
    """A torchvision ResNet state_dict -> the JAX package's param tree
    (numpy leaves), as its ``params_from_torchvision`` reads it."""
    def get(name):
        t = state_dict[name]
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                          else t)

    def conv_p(name):
        # torch OIHW -> HWIO
        return {"kernel": np.transpose(get(f"{name}.weight"), (2, 3, 1, 0))}

    def bn_p(name):
        return {
            "scale": get(f"{name}.weight"),
            "bias": get(f"{name}.bias"),
            "mean": get(f"{name}.running_mean"),
            "var": get(f"{name}.running_var"),
        }

    params: Dict[str, Any] = {
        "conv1": conv_p("conv1"),
        "bn1": bn_p("bn1"),
        "layers": [],
    }
    for stage, n_blocks in enumerate(cfg.stage_sizes, start=1):
        blocks = []
        for b in range(n_blocks):
            base = f"layer{stage}.{b}"
            p = {
                "conv1": conv_p(f"{base}.conv1"),
                "bn1": bn_p(f"{base}.bn1"),
                "conv2": conv_p(f"{base}.conv2"),
                "bn2": bn_p(f"{base}.bn2"),
                "conv3": conv_p(f"{base}.conv3"),
                "bn3": bn_p(f"{base}.bn3"),
            }
            if f"{base}.downsample.0.weight" in state_dict:
                p["downsample_conv"] = conv_p(f"{base}.downsample.0")
                p["downsample_bn"] = bn_p(f"{base}.downsample.1")
            blocks.append(p)
        params["layers"].append(blocks)
    return params


def params_from_torchvision(state_dict, cfg: ResNetConfig, device=None
                            ) -> ResNet:
    """A torchvision ResNet state_dict (a local checkpoint) ->
    :class:`ResNet` on ``device``."""
    return from_jax(tree_from_torchvision(state_dict, cfg), cfg, device)
