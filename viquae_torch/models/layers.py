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

Dropout (:func:`dropout`, and on the attention probabilities in
:func:`mha`) takes one integer seed per site, drawn from the caller's
``torch.Generator`` by :func:`dropout_seeds` before the forward: a layer
recomputed under ``torch.utils.checkpoint`` then draws the same masks
again (checkpoint restores only the global RNG, not a generator passed
in by hand). :func:`init_weights_` draws seeded random weights for a
module built from a config.

Tensor parallelism (the JAX package's ``*_spec`` companions): a spec
names, for each parameter of a block, its ``(dim, mesh axis)`` on the
port's tensor, or None when it is replicated; a third entry counts the
whole units (attention heads) the split must keep together. The specs
are the reference's PartitionSpecs put through
``models.convert.torch_partition``, so a dense kernel's ``shard_out``
is the ``nn.Linear`` weight's dim 0. When ``models.sharding`` has split
a block's weights, :func:`mha` and :func:`mlp` run it Megatron-style on
the current mesh (``core.mesh.current``): the input through ``copy_to``,
q / k / v (whole heads) and ``mlp.in`` column-parallel, ``o`` and
``mlp.out`` row-parallel with one ``reduce_from`` before their
replicated bias. With ``seq_axis`` (sequence parallelism) the input is
this rank's slice of L: ``gather_from`` makes it whole for the block and
a reduce-scatter returns the output's slice.

Under a mesh, :func:`dropout` folds the ``data`` coordinate into its
seed (the rows are split over ``data``, and each rank must drop other
positions), and the callers fold ``model`` where the activation itself is
split over it (attention heads, a sequence slice); an activation
replicated over ``model`` gets the same mask on every ``model`` rank.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from viquae_torch.core import mesh as meshlib
from viquae_torch.core import profiling
from viquae_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from viquae_torch.ops import encoder_glue as glue
from viquae_torch.ops import segment_attention as segattn

_F32_MIN = torch.finfo(torch.float32).min


# ---- dropout --------------------------------------------------------------
def dropout_seeds(generator: Optional[torch.Generator], n: int,
                  deterministic: bool) -> List[Optional[int]]:
    """``n`` dropout-site seeds drawn from a CPU ``generator`` (host only:
    no device work, no wait), or ``n`` Nones when ``deterministic``."""
    if deterministic:
        return [None] * n
    if generator is None or generator.device.type != "cpu":
        raise ValueError("deterministic=False needs a CPU torch.Generator "
                         "(core.prng.SeedBundle.split)")
    return torch.randint(0, 1 << 62, (n,), generator=generator).tolist()


# odd multipliers that fold a mesh coordinate into a dropout seed, one per
# axis, so that the data and model folds never cancel
_FOLD = {DATA_AXIS: 0x9E3779B97F4A7C15, MODEL_AXIS: 0xC2B2AE3D27D4EB4F}


def fold_seed(seed: int, axes: Sequence[str] = (DATA_AXIS,)) -> int:
    """``seed`` with this rank's coordinate on each of ``axes`` (of the
    current mesh) folded in; unchanged where an axis has one rank."""
    ctx = meshlib.current()
    for axis in axes:
        if ctx.size(axis) > 1:
            seed = (seed ^ ((ctx.coordinate(axis) + 1) * _FOLD[axis])) \
                % (1 << 62)
    return seed


def dropout(x: torch.Tensor, rate: float, seed: Optional[int],
            split_axes: Sequence[str] = (DATA_AXIS,)) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability 1 - rate and
    scale it by 1 / (1 - rate); the identity for ``seed`` None or rate 0.
    The mask is a function of ``seed``, the shape and this rank's
    coordinates on ``split_axes`` (:func:`fold_seed`), the mesh axes ``x``
    is split over."""
    if seed is None or rate == 0.0:
        return x
    seed = fold_seed(seed, split_axes)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return x * keep / (1.0 - rate)


# ---- dense ----------------------------------------------------------------
def truncated_normal_(tensor: torch.Tensor, std: float = 0.02,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """In place: N(0, std) truncated to +-2 std, the distribution of the
    JAX package's ``truncated_normal_init`` (not its bits)."""
    return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


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


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with f32 accumulation and an f32 result, as
    :func:`_dot_f32`: a bf16 batched GEMM with an f32 output on the GPU,
    the product of the upcast operands elsewhere."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class ExpertDense(nn.Module):
    """E dense layers stacked on a leading axis, in the JAX tree's layout:
    ``weight`` (E, d_in, d_out) is the tree's ``kernel``, ``bias`` (E,
    d_out). The Mixture-of-Experts FFN's two layers (ops/moe.py)."""

    def __init__(self, n_experts: int, d_in: int, d_out: int, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((n_experts, d_in, d_out),
                                               **factory))
        self.bias = nn.Parameter(torch.empty((n_experts, d_out), **factory))


def _matmul(lin: nn.Linear, x: torch.Tensor,
            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`dense` without its bias."""
    weight = lin.weight
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        weight = weight.to(compute_dtype)
    else:
        x = x.to(torch.promote_types(x.dtype, weight.dtype))
        weight = weight.to(x.dtype)
    return _dot_f32(x, weight)


def dense(lin: nn.Linear, x: torch.Tensor,
          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return _matmul(lin, x, compute_dtype) + lin.bias


def dense_spec(shard_out: bool = False, shard_in: bool = False,
               units: Optional[int] = None) -> dict:
    """The reference's ``dense_spec`` (kernel P(in, out), bias P(out)) on
    an ``nn.Linear``: ``shard_out`` splits the weight's dim 0 and the
    bias, ``shard_in`` the weight's dim 1 (the bias stays replicated).
    ``units``: the whole units (heads) the split dimension holds."""
    from viquae_torch.models.convert import torch_partition

    weight = torch_partition((MODEL_AXIS if shard_in else None,
                              MODEL_AXIS if shard_out else None), 2)
    bias = torch_partition((MODEL_AXIS if shard_out else None,), 1,
                           kernel=False)
    if units is not None:
        weight = weight and weight + (units,)
        bias = bias and bias + (units,)
    return {"weight": weight, "bias": bias}


def shard_axis(module: nn.Module, name: str = "weight") -> Optional[str]:
    """The mesh axis ``module``'s parameter ``name`` is split over
    (``models.sharding.shard_module`` records it), or None."""
    entry = getattr(module, "sharded", {}).get(name)
    return entry[1] if entry else None


def _enter(x: torch.Tensor, axis: Optional[str], seq_axis: Optional[str]
           ) -> torch.Tensor:
    """A block's input in its tensor-parallel region: ``copy_to`` over
    the weights' axis; under sequence parallelism the whole sequence from
    this rank's slice (``gather_from`` when the weights are split, else a
    plain gather whose backward takes this rank's slice)."""
    if seq_axis is not None:
        if axis is not None:
            return meshlib.gather_from(x, seq_axis, dim=1)
        return meshlib.gather_to(x, seq_axis, dim=1)
    return x if axis is None else meshlib.copy_to(x, axis)


def _leave(y: torch.Tensor, lin: nn.Linear, axis: Optional[str],
           seq_axis: Optional[str]) -> torch.Tensor:
    """A block's output ``y`` (without ``lin``'s bias) out of its
    tensor-parallel region, plus the bias: the row-parallel sum
    (``reduce_from``; a reduce-scatter to this rank's slice of L under
    sequence parallelism). A bias added to a slice of L sums its gradient
    over the slices (``copy_to``)."""
    if seq_axis is not None:
        y = (meshlib.reduce_scatter_to(y, axis, dim=1) if axis is not None
             else meshlib.scatter_to(y, seq_axis, dim=1))
        return y + meshlib.copy_to(lin.bias, seq_axis)
    if axis is not None:
        y = meshlib.reduce_from(y, axis)
    return y + lin.bias


# ---- layer norm -----------------------------------------------------------
def layer_norm_init(dim: int, eps: float = 1e-12, **factory) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=eps, **factory)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-12,
               seq_axis: Optional[str] = None) -> torch.Tensor:
    """LayerNorm in f32. With ``seq_axis``, ``x`` is this rank's slice of
    L and the scale and shift sum their gradients over the slices."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    weight, bias = ln.weight, ln.bias
    if seq_axis is not None:
        weight = meshlib.copy_to(weight, seq_axis)
        bias = meshlib.copy_to(bias, seq_axis)
    return y * weight + bias


def layer_norm_spec() -> dict:
    return {"weight": None, "bias": None}


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


def mha_spec(n_heads: Optional[int] = None) -> dict:
    """q, k, v column-parallel and o row-parallel over ``model``, whole
    heads each (the reference's ``mha_spec``)."""
    col = dense_spec(shard_out=True, units=n_heads)
    return {"q": col, "k": dict(col), "v": dict(col),
            "o": dense_spec(shard_in=True, units=n_heads)}


def takes_fused_attention(x: torch.Tensor, kv: Optional[torch.Tensor],
                          segment_ids: Optional[torch.Tensor], n_heads: int,
                          compute_dtype: Optional[torch.dtype],
                          dropout_rate: float, seed: Optional[int],
                          seq_axis: Optional[str], weights) -> bool:
    """Whether :func:`mha` of ``x`` (B, L, D) runs the fused kernel of
    ops/segment_attention.py: self-attention (``kv`` None) of CUDA
    tensors, given packed ``segment_ids``, without dropout (no seed, or a
    rate of 0), with nothing to differentiate (grad mode off, or neither
    ``x`` nor any of ``weights`` requires grad), without ``seq_axis``,
    with heads of 64, L at most 512 and probabilities kept in f32 or
    rounded to bf16. Every other call takes the plain path."""
    if kv is not None or segment_ids is None or seq_axis is not None or (
            seed is not None and dropout_rate != 0.0):
        return False
    if x.shape[-1] // n_heads != segattn.HEAD_DIM \
            or x.shape[1] > segattn.MAX_LEN \
            or compute_dtype not in (None, torch.float32, torch.bfloat16) \
            or not x.is_cuda:
        return False
    return not (torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in weights)))


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], head_dim: int,
                    compute_dtype: Optional[torch.dtype],
                    dropout_rate: float = 0.0, seed: Optional[int] = None,
                    folds: Sequence[str] = (DATA_AXIS,)) -> torch.Tensor:
    """The plain path of :func:`mha` from the projections' f32 outputs,
    q (B, Lq, width) and k, v (B, Lk, width), heads concatenated, to the
    context (B, Lq, width): f32 logits, the additive ``bias``, an f32
    softmax, dropout (folded over ``folds``), the probabilities rounded
    to ``compute_dtype`` and an f32 product with v."""
    b, length, width = q.shape

    def heads(t):  # (B, L, width) -> (B, heads, L, hd)
        return t.reshape(b, -1, width // head_dim, head_dim).transpose(1, 2)

    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2)) \
        / math.sqrt(head_dim)
    if bias is not None:
        scores = scores + bias
    probs = dropout(torch.softmax(scores.float(), dim=-1), dropout_rate, seed,
                    folds)
    probs = probs.to(compute_dtype or probs.dtype).float()
    return torch.matmul(probs, heads(v)).transpose(1, 2).reshape(b, length,
                                                                 width)


def mha(
    attn: nn.ModuleDict,
    x: torch.Tensor,
    bias=None,
    n_heads: int = 12,
    compute_dtype: Optional[torch.dtype] = torch.float32,
    kv: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    seq_axis: Optional[str] = None,
    segment_ids: Optional[torch.Tensor] = None,
    out_bias: bool = True,
) -> torch.Tensor:
    """Scaled dot-product attention of the queries of ``x`` over the keys
    and values of ``kv`` (default ``x``: self-attention).

    x: (B, Lq, D); kv: (B, Lk, Dkv); bias: additive f32 bias broadcastable
    to (B, H, Lq, Lk), or a function of no arguments that gives it (read
    only on the plain path). With a ``seed``, dropout at ``dropout_rate``
    on the f32 attention probabilities. ``n_heads`` counts every head;
    when the weights hold a shard of them (tensor parallelism) this rank
    runs its own heads. With ``seq_axis``, ``x`` is this rank's slice of L
    (self-attention only) and so is the output.

    ``segment_ids`` (B, L): a packed canvas's segments (0 = padding),
    handed in beside their block-diagonal ``bias``. Where
    :func:`takes_fused_attention` holds, the fused kernel computes the
    attention from them and ``bias`` is not read; every other call runs
    :func:`plain_attention`. Every call adds one to the
    ``attention.fused_calls`` or ``attention.plain_calls`` counter
    (core/profiling.py) by the path it takes.

    ``out_bias=False`` hands back the output projection's product before
    its bias (the fused glue of ``bert._layer_forward`` adds it); it skips
    ``_leave``'s reduction too, so it is for weights that are not split,
    without ``seq_axis``.
    """
    axis = shard_axis(attn["o"])
    fused = takes_fused_attention(x, kv, segment_ids, n_heads, compute_dtype,
                                  dropout_rate, seed, seq_axis,
                                  attn.parameters())
    profiling.count("attention.fused_calls" if fused
                    else "attention.plain_calls")
    x = _enter(x, axis, seq_axis)
    if fused:
        ctx = segattn.segment_attention(
            dense(attn["q"], x, compute_dtype),
            dense(attn["k"], x, compute_dtype),
            dense(attn["v"], x, compute_dtype), segment_ids, compute_dtype)
    else:
        kv = x if kv is None else _enter(kv, axis, None)
        folds = (DATA_AXIS,) if axis is None else (DATA_AXIS, axis)
        ctx = plain_attention(
            dense(attn["q"], x, compute_dtype),
            dense(attn["k"], kv, compute_dtype),
            dense(attn["v"], kv, compute_dtype),
            bias() if callable(bias) else bias, x.shape[-1] // n_heads,
            compute_dtype, dropout_rate, seed, folds)
    out = _matmul(attn["o"], ctx, compute_dtype)
    return _leave(out, attn["o"], axis, seq_axis) if out_bias else out


# ---- the post-LN block's glue ----------------------------------------------
def takes_fused_glue(x: torch.Tensor, block: nn.ModuleDict,
                     compute_dtype: Optional[torch.dtype], act: str,
                     dropout: Sequence[tuple], seq_axis: Optional[str]
                     ) -> bool:
    """Whether the post-LN encoder block ``block`` (``attention``,
    ``attention_ln``, ``mlp``, ``output_ln``) of ``x`` (B, L, D) runs its
    glue through ops/encoder_glue.py's kernels (``bert._layer_forward``):
    CUDA tensors, bf16 ``compute_dtype``, nothing to differentiate (grad
    mode off, or neither ``x`` nor any weight requires grad), no dropout
    (each of ``dropout``'s (rate, seed) pairs without a seed or at rate
    0), no ``seq_axis``, the ``o`` and ``mlp.out`` weights not split over
    a mesh axis, a dense FFN with the exact GELU, widths the kernels take
    and weights of one type, bf16 or f32. Every other call takes the
    plain path."""
    if "mlp" not in block or seq_axis is not None \
            or compute_dtype != torch.bfloat16 \
            or act not in ("gelu", "gelu_exact") or not x.is_cuda:
        return False
    if any(seed is not None and rate != 0.0 for rate, seed in dropout):
        return False
    if shard_axis(block["attention"]["o"]) is not None \
            or shard_axis(block["mlp"]["out"]) is not None \
            or not glue.takes(x.shape[-1], block["mlp"]["in"].out_features):
        return False
    weights = list(block.parameters())
    if len({w.dtype for w in weights}) != 1 \
            or weights[0].dtype not in (torch.bfloat16, torch.float32):
        return False
    return not (torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in weights)))


# ---- MLP ------------------------------------------------------------------
def mlp_init(dim: int, hidden: int, **factory) -> nn.ModuleDict:
    return nn.ModuleDict({"in": dense_init(dim, hidden, **factory),
                          "out": dense_init(hidden, dim, **factory)})


def mlp_spec() -> dict:
    """``in`` column-parallel, ``out`` row-parallel over ``model``."""
    return {"in": dense_spec(shard_out=True),
            "out": dense_spec(shard_in=True)}


def mlp(m: nn.ModuleDict, x: torch.Tensor, act: str = "gelu",
        compute_dtype: Optional[torch.dtype] = torch.float32,
        seq_axis: Optional[str] = None) -> torch.Tensor:
    """The two-layer FFN; tensor-parallel when its weights are split, on a
    slice of L with ``seq_axis`` (as :func:`mha`)."""
    axis = shard_axis(m["out"])
    h = ACT[act](dense(m["in"], _enter(x, axis, seq_axis), compute_dtype))
    return _leave(_matmul(m["out"], h, compute_dtype), m["out"], axis,
                  seq_axis)


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
                  embed_std: float = 0.02, truncated: bool = False
                  ) -> nn.Module:
    """Draw every weight of ``module`` in place from a ``torch.Generator``
    on the module's device, in the kinds of the JAX package's inits:
    convolution kernels He-normal (std sqrt(2 / fan_in)), dense kernels
    and bare embedding tables N(0, std), biases 0, norm scales 1 and shifts
    0, running means 0 and variances 1, PReLU slopes 0.25. ``truncated``
    clips the dense and embedding draws to +-2 std (the BERT-family inits
    of the JAX package). The draws are not the JAX package's (another
    generator), so parity runs go through converted weights."""
    device = next(iter(module.parameters())).device
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(t, std):
        if truncated:
            truncated_normal_(t, std, gen)
        else:
            t.normal_(0.0, std, generator=gen)

    done = set()
    for mod in module.modules():
        params = dict(mod.named_parameters(recurse=False))
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=gen)
        elif isinstance(mod, (nn.Linear, ExpertDense)):
            draw(mod.weight, linear_std)
        elif isinstance(mod, (BatchNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.PReLU):
            mod.weight.fill_(0.25)
        else:
            for p in params.values():
                draw(p, embed_std)
        if isinstance(mod, (nn.Conv2d, nn.Linear, ExpertDense, BatchNorm,
                            nn.LayerNorm)) \
                and getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
        done.update(id(p) for p in params.values())
    assert all(id(p) in done for p in module.parameters())
    return module
