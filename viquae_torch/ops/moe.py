"""Mixture-of-Experts FFN (counterpart of viquae_tpu/ops/moe.py), on one
device or expert-parallel over the ``model`` mesh axis.

GShard routing (arXiv:2006.16668) with the reference's semantics:

- **Router in f32** whatever the compute dtype; each token takes the
  ``top_k`` experts of its softmax probabilities, ties to the lower expert
  (a stable descending sort, the order of ``lax.top_k``), and gates them
  with those probabilities renormalized to sum to 1.
- **Tokens in groups** of at most ``group_size`` (flattened B·L order),
  each expert taking at most ``capacity = ceil(cf * k * Tg / E)`` tokens a
  group, budgeted from the padded group length. Slots fill choice by
  choice: every token's j-th choice before any token's (j+1)-th, tokens
  in order within a choice. A choice past its expert's capacity is
  dropped. Tokens outside ``token_mask`` (and group padding) claim no slot,
  count nowhere in the aux loss and output zeros.
- **Dispatch by slot index.** The reference materializes one-hot
  dispatch / combine tensors (G, Tg, E, C) because GSPMD partitions that
  form. One device needs no such tensor: each kept (token, choice) has one
  slot, so the tokens are copied into an (E, G·C, D) buffer by index, the
  experts run as two batched products, and each token gathers back its
  ``top_k`` slots. Every slot holds at most one token, so the reference's
  one-hot products are copies here, and its combine sum has at most
  ``top_k`` non-zero terms, each a product of the same two rounded
  operands: for ``top_k <= 2`` the two forms give the same bits.

:func:`moe_apply` returns ``(y, aux)``: ``aux`` is the Switch
load-balance loss (E · sum_e f_e · p_e over the valid tokens' top-1
choices; 1 at perfect balance), for the caller to add to its loss.

**Expert parallelism** (:func:`moe_spec`: the stacked experts split on E
over ``model``, the router replicated; ``models.sharding`` places them).
The tokens are replicated within a ``model`` group, so every rank routes
them alike, on the replicated router, with the same capacity, slot order
and groups as one device. A rank then fills and runs only the slots of its
E/model experts, and ``core.mesh.reduce_from`` sums the combined outputs
over ``model``; a token's at most ``top_k`` non-zero terms are added in
another order only when they are more than two. The gates reach the
router through ``copy_to`` (each rank's cotangent covers its own experts)
and the aux is computed once, on the router's probabilities before it.

**Split rows.** Where the current mesh marks this call as one rank's
block of a global batch split over ``data`` (``core.mesh.row_block``:
``train.data_parallel.Rows``, the embedders' row split and the packed
reader's set it, with or without gradients), the tokens are that block's
(x's leading dim is the block's rows; rows past the global batch, the
padding of the last blocks, are no tokens). The groups, their length and
the capacity are then the global batch's, as the reference's single
program makes them, and this rank takes its own groups: that needs its
tokens to be whole groups, and where they are not and a choice could
drop, the call raises (without drops the groups change nothing). The
aux's statistics are summed over ``data``: the aux of the global batch.
Without the mark (one device, rows every rank computes alike) the call
groups the tokens it is given.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from viquae_torch.core import mesh as meshlib
from viquae_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from viquae_torch.models import layers as L


def moe_init(dim: int, hidden: int, n_experts: int, **factory
             ) -> nn.ModuleDict:
    """Router + stacked-expert two-layer FFN, named as the JAX tree:
    ``router`` (its ``kernel`` (D, E) is the transposed ``weight``),
    ``in`` / ``out`` :class:`layers.ExpertDense` ((E, D, H), (E, H, D))."""
    return nn.ModuleDict({
        "router": nn.Linear(dim, n_experts, bias=False, **factory),
        "in": L.ExpertDense(n_experts, dim, hidden, **factory),
        "out": L.ExpertDense(n_experts, hidden, dim, **factory),
    })


def moe_spec() -> dict:
    """The expert axis of ``in`` / ``out`` (weights and biases) over
    ``model``; the router replicated — the reference's ep sharding."""
    from viquae_torch.models.convert import torch_partition

    experts = {"weight": torch_partition((MODEL_AXIS,), 3),
               "bias": torch_partition((MODEL_AXIS,), 2, kernel=False)}
    return {"router": {"weight": None}, "in": experts, "out": dict(experts)}


def _act(name: str, h: torch.Tensor) -> torch.Tensor:
    """The reference applies the activation to the hidden layer rounded to
    the compute dtype; its "gelu" takes the tanh form on bf16 input."""
    if name == "gelu" and h.dtype == torch.bfloat16:
        return F.gelu(h, approximate="tanh")
    return L.ACT[name](h)


def _route(params, tokens, valid, top_k: int, capacity: int,
           n_groups: int, tg: int, axis=None):
    """(probs, gates, expert ids, slots) of the (G*Tg, D) tokens: the f32
    router's softmax, each token's ``top_k`` experts (ties to the lower
    expert) with their renormalized gates, and the (G*Tg, top_k) slot of
    each choice in the (E, G, C) expert batches — ``E*G*C`` (one past the
    last slot) where the choice is dropped or the token is not valid.
    With the experts split over ``axis``, the gates read the
    probabilities through ``copy_to``."""
    n_experts = params["router"].weight.shape[0]
    logits = torch.matmul(tokens.float(), params["router"].weight.float().T)
    probs = torch.softmax(logits, dim=-1)                  # (G*Tg, E)
    gate_i = torch.sort(probs, dim=-1, descending=True,
                        stable=True)[1][:, :top_k]
    gated = probs if axis is None else meshlib.copy_to(probs, axis)
    gate_v = torch.gather(gated, 1, gate_i)
    gate_v = gate_v / torch.clamp(gate_v.sum(-1, keepdim=True), min=1e-9)
    # choice by choice, with running per-(group, expert) fill counts
    gi = gate_i.view(n_groups, tg, top_k)
    valid_g = valid.view(n_groups, tg)
    counts = torch.zeros((n_groups, n_experts), dtype=torch.long,
                         device=tokens.device)
    group = torch.arange(n_groups, device=tokens.device)[:, None]
    n_slots = n_experts * n_groups * capacity
    slots = []
    for j in range(top_k):
        oh = F.one_hot(gi[..., j], n_experts) * valid_g[..., None]
        pos = torch.cumsum(oh, dim=1) - 1 + counts[:, None, :]
        counts = counts + oh.sum(dim=1)
        pos_j = torch.gather(pos, 2, gi[..., j: j + 1])[..., 0]  # (G, Tg)
        keep = valid_g & (pos_j < capacity)
        flat = (gi[..., j] * n_groups + group) * capacity + pos_j
        slots.append(torch.where(keep, flat, n_slots).reshape(-1))
    return probs, gate_v, gate_i, torch.stack(slots, dim=1)


def moe_apply(
    params: nn.ModuleDict,
    x: torch.Tensor,
    *,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    act: str = "gelu",
    compute_dtype: Optional[torch.dtype] = torch.float32,
    group_size: int = 1024,
    token_mask: Optional[torch.Tensor] = None,
):
    """MoE FFN over (..., D) activations -> (y f32 of x's shape, aux f32
    scalar). ``token_mask`` (x's leading shape, non-zero = real token)
    keeps padding out of routing, capacity and the aux loss. Experts that
    ``models.sharding`` split over a mesh axis (the axis it recorded on
    ``params["in"]``) run on this rank alone, and the outputs are summed
    over the axis (module docstring)."""
    orig_shape = x.shape
    dim = orig_shape[-1]
    tokens = x.reshape(-1, dim)
    t = tokens.shape[0]
    device = x.device
    axis = L.shard_axis(params["in"])
    n_experts = params["router"].weight.shape[0]
    top_k = min(top_k, n_experts)
    # on a marked row split, the groups are the global batch's
    ctx = meshlib.current()
    n_rows = ctx.global_rows(DATA_AXIS)
    total, offset, real = t, 0, t
    if n_rows is not None:
        start, per = meshlib.row_share(ctx, n_rows)
        if x.dim() < 2 or orig_shape[0] != per:
            raise ValueError(
                f"moe_apply on a row split: x's leading dim "
                f"{orig_shape[0] if x.dim() > 1 else None} is not this "
                f"rank's block of {per} of the global {n_rows} rows")
        per_row = t // per if per else 0
        total = n_rows * per_row
        offset = start * per_row
        real = max(0, min(per, n_rows - start)) * per_row
    n_groups = max(1, math.ceil(total / max(1, group_size)))
    tg = math.ceil(total / n_groups)
    capacity = max(1, math.ceil(capacity_factor * top_k * tg / n_experts))
    if (n_rows is not None and tg and real and capacity < tg
            and (offset % tg or (real % tg and offset + real != total))):
        raise ValueError(
            f"moe_apply: this rank's {real} tokens from token {offset} "
            f"are not whole groups of {tg} (the global batch's {total} "
            f"tokens in groups of at most {group_size}), and a capacity of "
            f"{capacity} can drop tokens: the drops would differ from one "
            "device's. Make each rank's tokens a multiple of the group "
            "length, or raise moe_capacity_factor to E / top_k or more")
    n_groups = math.ceil(t / tg) if tg else 1
    pad = n_groups * tg - t
    # rows past the global batch (a row split's padding) are no tokens
    valid = torch.arange(n_groups * tg, device=device) < real
    if token_mask is not None:
        tm = token_mask.reshape(-1).bool()
        if pad:
            tm = torch.cat([tm, tm.new_zeros((pad,))])
        valid = valid & tm
    if pad:
        tokens = torch.cat([tokens, tokens.new_zeros((pad, dim))])

    probs, gate_v, gate_i, slots = _route(
        params, tokens, valid, top_k, capacity, n_groups, tg, axis)
    n_slots = n_experts * n_groups * capacity
    local_experts = params["in"].weight.shape[0]
    if local_experts != n_experts:
        # this rank's experts own one block of the (E, G, C) slots
        n_local = local_experts * n_groups * capacity
        lo = ctx.coordinate(axis) * n_local
        slots = slots - lo
        slots = torch.where((slots >= 0) & (slots < n_local), slots, n_local)
        n_slots = n_local

    cd = compute_dtype or tokens.dtype
    src = (tokens if axis is None else meshlib.copy_to(tokens, axis)).to(cd)
    expert_in = src.new_zeros((n_slots + 1, dim))          # + a drop row
    for j in range(top_k):
        # kept slots are distinct; dropped choices all land on the drop row
        expert_in.index_copy_(0, slots[:, j], src)
    ei = expert_in[:n_slots].view(local_experts, n_groups * capacity, dim)
    h = L._bmm_f32(ei, params["in"].weight.to(cd)) \
        + params["in"].bias[:, None, :]
    h = _act(act, h.to(cd))
    eo = L._bmm_f32(h.to(cd), params["out"].weight.to(cd)) \
        + params["out"].bias[:, None, :]
    eo = torch.cat([eo.reshape(n_slots, dim).to(cd),
                    eo.new_zeros((1, dim), dtype=cd)])
    picked = eo[slots]                                     # (G*Tg, k, D)
    y = (gate_v.to(cd).float()[..., None] * picked.float()).sum(dim=1)
    if pad:
        y = y[:t]
    if axis is not None:
        y = meshlib.reduce_from(y, axis)

    # Switch load-balance loss over the valid tokens' top-1 choices
    top1 = F.one_hot(gate_i[:, 0], n_experts).float()
    vf = valid.float()[:, None]
    sums = torch.cat([(top1 * vf).sum(dim=0), (probs * vf).sum(dim=0),
                      vf.sum()[None]])
    if n_rows is not None:
        # the global batch's statistics (module docstring); without
        # gradients a plain all-gather serves
        sums = (meshlib.gather_from(sums[None], DATA_AXIS, ctx=ctx)
                if torch.is_grad_enabled() and sums.requires_grad
                else meshlib.all_gather(ctx, sums, DATA_AXIS)).sum(dim=0)
    denom = torch.clamp(sums[-1], min=1.0)
    f = sums[:n_experts] / denom
    p = sums[n_experts: 2 * n_experts] / denom
    aux = n_experts * torch.sum(f * p)
    return y.reshape(orig_shape), aux
