"""The elementwise glue of the post-LN encoder block at inference: two row
kernels that take a GEMM's f32 output before its bias and write what the
next consumer reads.

Replaces no TPU kernel: the JAX package's glue (viquae_tpu/models/
layers.py ``dense`` and ``layer_norm``, the block of viquae_tpu/models/
bert.py) is plain XLA. On the port's plain path (``models.bert.
_layer_forward``) it is some 226 KB a token a layer of f32 passes through
device memory: a pass for each bias add and residual, about eight for
each LayerNorm, GELU on its own, and a bf16 cast of every GEMM operand
(three of the same tensor for q, k and v). Both kernels are bound by the
bytes they must move (csrc/encoder_glue.cu says how much and what the
design does about it):

- :func:`bias_residual_layernorm` (kernel A): ``t = x + (y + bias)``, the
  two-pass f32 LayerNorm of ``t``, written in f32 (the residual stream)
  and rounded to bf16 (the next GEMM's operand);
- :func:`bias_gelu` (kernel B): the exact (erf) GELU of ``g + bias`` in
  f32, written rounded to bf16 only (the ``mlp.out`` GEMM's operand).

They keep every rounding point of the plain path: LayerNorm and GELU in
f32, bf16 only where the next GEMM casts. Only the order of the
LayerNorm's f32 sums differs, and the kernel's ``erff`` may differ from
PyTorch's by an f32 ulp.

Each wrapper launches its kernel for CUDA tensors and runs its plain twin
(:func:`bias_residual_layernorm_plain`, :func:`bias_gelu_plain`, the
plain path's own operations) only for CPU tensors. ``.launches`` on each
wrapper counts its launches.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from viquae_torch.kernels.build import launch

MAX_WIDTH = 1024        # kernel A: hidden widths of whole 128-column chunks
MAX_INNER = 8192        # kernel B: intermediate widths of whole 8-columns
_PARAM_DTYPES = (torch.bfloat16, torch.float32)


def takes(width: int, inner: int) -> bool:
    """Whether the kernels take a block of hidden width ``width`` and FFN
    width ``inner``."""
    return (0 < width <= MAX_WIDTH and width % 128 == 0
            and 0 < inner <= MAX_INNER and inner % 8 == 0)


def bias_residual_layernorm_plain(y, bias, x, weight, shift, eps: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A's plain twin, the plain path's operations: ``x + (y +
    bias)`` and ``models.layers.layer_norm`` -> (out f32, out in bf16)."""
    t = x + (y + bias)
    mean = t.mean(dim=-1, keepdim=True)
    var = ((t - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (t - mean) * torch.rsqrt(var + eps) * weight + shift
    return out, out.to(torch.bfloat16)


def bias_gelu_plain(g, bias) -> torch.Tensor:
    """Kernel B's plain twin: the exact GELU of ``g + bias`` in f32,
    rounded to bf16."""
    return F.gelu(g + bias, approximate="none").to(torch.bfloat16)


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        # the kernels read rows as 16-byte vectors
        raise ValueError(f"{name} must be contiguous with a 16-byte aligned "
                         f"start, got strides {t.stride()}")


def _check_vectors(width: int, **vectors) -> bool:
    """The (width,) parameter vectors, of one type, bf16 or f32; returns
    whether they are bf16."""
    dtypes = {v.dtype for v in vectors.values()}
    if len(dtypes) != 1 or not dtypes <= set(_PARAM_DTYPES):
        raise TypeError(f"{', '.join(vectors)} must share one type, "
                        f"bfloat16 or float32, got "
                        f"{[str(v.dtype) for v in vectors.values()]}")
    for name, v in vectors.items():
        if tuple(v.shape) != (width,) or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({width},), got "
                             f"{tuple(v.shape)}")
    return dtypes == {torch.bfloat16}


def _check_device(*tensors) -> None:
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("every operand must lie on one CUDA device")


def bias_residual_layernorm(y: torch.Tensor, bias: torch.Tensor,
                            x: torch.Tensor, weight: torch.Tensor,
                            shift: torch.Tensor, eps: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LayerNorm(``x + (y + bias)``) with scale ``weight`` and shift
    ``shift``: y (the GEMM's output before its bias) and x (the residual)
    (..., D) f32 -> (out f32, out rounded to bf16), both (..., D). CUDA
    tensors go to kernel A (and nowhere else); CPU tensors to the twin."""
    tensors = (y, bias, x, weight, shift)
    if not any(t.is_cuda for t in tensors):
        return bias_residual_layernorm_plain(y, bias, x, weight, shift, eps)
    _check_device(*tensors)
    _check_rows("y", y)
    _check_rows("x", x)
    if y.shape != x.shape:
        raise ValueError(f"y and x must have one shape, got "
                         f"{tuple(y.shape)} and {tuple(x.shape)}")
    width = x.shape[-1]
    if width % 128 or not 0 < width <= MAX_WIDTH:
        raise ValueError(f"hidden width {width}: the kernel takes whole "
                         f"128-column chunks up to {MAX_WIDTH}")
    low = _check_vectors(width, bias=bias, weight=weight, shift=shift)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    out_low = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    launch("encoder_glue", "bias_residual_layernorm_launch", y, bias, x,
           weight, shift, out, out_low, x.numel() // width, width, int(low),
           float(eps))
    bias_residual_layernorm.launches += 1
    return out, out_low


def bias_gelu(g: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """GELU_erf(``g + bias``) rounded to bf16: g (the GEMM's output before
    its bias) (..., F) f32 -> (..., F) bf16. CUDA tensors go to kernel B
    (and nowhere else); CPU tensors to the twin."""
    if not (g.is_cuda or bias.is_cuda):
        return bias_gelu_plain(g, bias)
    _check_device(g, bias)
    _check_rows("g", g)
    width = g.shape[-1]
    if width % 8 or not 0 < width <= MAX_INNER:
        raise ValueError(f"intermediate width {width}: the kernel takes "
                         f"whole 8-column groups up to {MAX_INNER}")
    low = _check_vectors(width, bias=bias)
    h = torch.empty(g.shape, dtype=torch.bfloat16, device=g.device)
    launch("encoder_glue", "bias_gelu_launch", g, bias, h,
           g.numel() // width, width, int(low))
    bias_gelu.launches += 1
    return h


bias_residual_layernorm.launches = 0
bias_gelu.launches = 0
