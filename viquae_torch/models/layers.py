"""Shared building blocks for the encoders (counterpart of
viquae_tpu/models/layers.py).

Weights live in ``nn.Linear`` / ``nn.LayerNorm`` / ``nn.ModuleDict``
containers laid out like the JAX param tree; the functions here are the
forward math and keep the JAX rounding points:

- ``dense`` casts both operands to ``compute_dtype``, accumulates in f32
  and returns f32 plus the bias (``jnp.dot(..., preferred_element_type=
  float32) + bias``);
- ``layer_norm`` runs in f32 whatever the input dtype;
- attention logits and softmax are f32, the probabilities are rounded to
  ``compute_dtype`` before the product with the (f32) values;
- masks are FINITE additive biases (``finfo(float32).min * 0.5``): a canvas
  padding row allows no key at all, and a -inf or boolean mask would turn
  its softmax into NaN, which the next layer spreads to every real token
  sharing the row.

Evaluation only: dropout is not ported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_F32_MIN = torch.finfo(torch.float32).min


# ---- dense ----------------------------------------------------------------
def dense_init(d_in: int, d_out: int, **factory) -> nn.Linear:
    return nn.Linear(d_in, d_out, **factory)


def _dot_f32_upcast(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ weight.T as an f32 product of the upcast operands."""
    return torch.matmul(x.float(), weight.float().t())


def _dot_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ weight.T with f32 accumulation and an f32 result. bf16 products
    are exact in f32, so upcasting the operands computes the same sum as a
    bf16 GEMM with an f32 output; on the GPU the latter is the fast form
    (tests/test_torch_cuda.py and chip_smoke.py hold it to the upcast)."""
    if x.is_cuda and x.dtype == weight.dtype == torch.bfloat16:
        out = torch.mm(x.reshape(-1, x.shape[-1]), weight.t(),
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], weight.shape[0])
    return _dot_f32_upcast(x, weight)


def dense(lin: nn.Linear, x: torch.Tensor,
          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    weight = lin.weight
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        weight = weight.to(compute_dtype)
    else:
        x = x.to(torch.promote_types(x.dtype, weight.dtype))
        weight = weight.to(x.dtype)
    return _dot_f32(x, weight) + lin.bias


# ---- layer norm -----------------------------------------------------------
def layer_norm_init(dim: int, eps: float = 1e-12, **factory) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=eps, **factory)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-12
               ) -> torch.Tensor:
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * ln.weight + ln.bias


# ---- activations ----------------------------------------------------------
ACT = {
    # HF "gelu" is the exact erf form; ``dense`` returns f32, so the JAX
    # package's bf16 tanh branch is never taken on this path either
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "tanh": torch.tanh,
}


# ---- multi-head attention -------------------------------------------------
def mha_init(dim: int, **factory) -> nn.ModuleDict:
    return nn.ModuleDict({name: dense_init(dim, dim, **factory)
                          for name in ("q", "k", "v", "o")})


def mha(
    attn: nn.ModuleDict,
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    n_heads: int = 12,
    compute_dtype: Optional[torch.dtype] = torch.float32,
) -> torch.Tensor:
    """Scaled dot-product self-attention.

    x: (B, L, D); bias: additive f32 bias broadcastable to (B, H, L, L).
    """
    b, length, dim = x.shape
    head_dim = dim // n_heads

    def heads(t):  # (B, L, D) -> (B, H, L, hd)
        return t.reshape(b, length, n_heads, head_dim).transpose(1, 2)

    q = heads(dense(attn["q"], x, compute_dtype))
    k = heads(dense(attn["k"], x, compute_dtype))
    v = heads(dense(attn["v"], x, compute_dtype))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head_dim)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores.float(), dim=-1)
    probs = probs.to(compute_dtype or probs.dtype).float()
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, length, dim)
    return dense(attn["o"], ctx, compute_dtype)


# ---- MLP ------------------------------------------------------------------
def mlp_init(dim: int, hidden: int, **factory) -> nn.ModuleDict:
    return nn.ModuleDict({"in": dense_init(dim, hidden, **factory),
                          "out": dense_init(hidden, dim, **factory)})


def mlp(m: nn.ModuleDict, x: torch.Tensor, act: str = "gelu",
        compute_dtype: Optional[torch.dtype] = torch.float32) -> torch.Tensor:
    return dense(m["out"], ACT[act](dense(m["in"], x, compute_dtype)),
                 compute_dtype)


# ---- masks ----------------------------------------------------------------
def attention_bias_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) 1/0 mask -> (B, 1, 1, L) finite additive f32 bias."""
    return ((1.0 - mask.float()) * (_F32_MIN * 0.5))[:, None, None, :]


def attention_bias_from_segments(segment_ids: torch.Tensor) -> torch.Tensor:
    """(B, L) segment ids (0 = padding) -> (B, 1, L, L) block-diagonal
    finite f32 bias: token q may attend to token k iff they carry the same
    non-zero segment id."""
    same = segment_ids[:, :, None] == segment_ids[:, None, :]
    valid = (segment_ids > 0)[:, None, :]
    allowed = same & valid
    return ((~allowed).float() * (_F32_MIN * 0.5))[:, None]
