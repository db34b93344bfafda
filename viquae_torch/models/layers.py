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
- the convolutional towers keep batch-norm statistics in :class:`BatchNorm`
  and apply them in f32 (:func:`batch_norm`);
- masks are FINITE additive biases (``finfo(float32).min * 0.5``): a canvas
  padding row allows no key at all, and a -inf or boolean mask would turn
  its softmax into NaN, which the next layer spreads to every real token
  sharing the row.

Evaluation only: dropout is not ported. :func:`init_weights_` draws
seeded random weights for a module built from a config.
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


# ---- batch norm (inference statistics) ------------------------------------
class BatchNorm(nn.Module):
    """Inference batch-norm statistics of ``channels`` features, named as
    torch's batch-norm layers (``weight``, ``bias``, ``running_mean``,
    ``running_var``; the JAX tree's scale / bias / mean / var)."""

    def __init__(self, channels: int, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, **factory))
        self.bias = nn.Parameter(torch.zeros(channels, **factory))
        self.register_buffer("running_mean", torch.zeros(channels, **factory))
        self.register_buffer("running_var", torch.ones(channels, **factory))


def batch_norm(bn: BatchNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32 over dim 1
    (channels of NCHW, features of (B, C)), folded into one scale and one
    shift so that it is a single pass over ``x``."""
    inv = torch.rsqrt(bn.running_var + eps) * bn.weight
    shift = bn.bias - bn.running_mean * inv
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return torch.addcmul(shift.view(shape), x.float(), inv.view(shape))


def prelu(p: nn.PReLU, x: torch.Tensor) -> torch.Tensor:
    """Per-channel PReLU over dim 1 (``p.weight`` holds the slopes)."""
    alpha = p.weight.view((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, alpha * x)


# ---- seeded initialisation ------------------------------------------------
def seeded(module_cls, *args, seed: int = 0, device=None,
           **init_kwargs) -> nn.Module:
    """``module_cls(*args)`` built on the meta device, materialised on
    ``device`` (default: the GPU) and drawn by :func:`init_weights_`;
    evaluation mode, no grad."""
    from viquae_torch.core.device import resolve_device

    with torch.device("meta"):
        model = module_cls(*args)
    model.to_empty(device=resolve_device(device))
    return init_weights_(model, seed, **init_kwargs).requires_grad_(
        False).eval()


@torch.no_grad()
def init_weights_(module: nn.Module, seed: int, linear_std: float = 0.02,
                  embed_std: float = 0.02) -> nn.Module:
    """Draw every weight of ``module`` in place from a ``torch.Generator``
    on the module's device, in the kinds of the JAX package's inits:
    convolution kernels He-normal (std sqrt(2 / fan_in)), dense kernels
    and bare embedding tables N(0, std), biases 0, norm scales 1 and shifts
    0, running means 0 and variances 1, PReLU slopes 0.25. The draws are
    not the JAX package's (another generator), so parity runs go through
    converted weights."""
    device = next(iter(module.parameters())).device
    gen = torch.Generator(device=device).manual_seed(seed)
    done = set()
    for mod in module.modules():
        params = dict(mod.named_parameters(recurse=False))
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=gen)
        elif isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, linear_std, generator=gen)
        elif isinstance(mod, (BatchNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.PReLU):
            mod.weight.fill_(0.25)
        else:
            for p in params.values():
                p.normal_(0.0, embed_std, generator=gen)
        if isinstance(mod, (nn.Conv2d, nn.Linear, BatchNorm, nn.LayerNorm)) \
                and getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
        done.update(id(p) for p in params.values())
    assert all(id(p) in done for p in module.parameters())
    return module
