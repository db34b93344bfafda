"""A module's parameters split over the mesh, and back (the JAX package
places params by PartitionSpec with ``jax.device_put``; here each rank
holds its own shard module).

A spec (``layers.dense_spec``, ``bert.param_spec``, ``moe.moe_spec``, ...)
is a tree of dicts and lists named as the module's sub-modules, whose
leaves are each parameter's ``(dim, axis)`` (or ``(dim, axis, units)``,
where the split must keep ``units`` whole blocks together: attention
heads) or None for a replicated parameter. :func:`shard_module` keeps
this rank's block of every split parameter (an axis of one rank splits
nothing, so the module runs as on one device) and records ``{name: (dim,
axis)}`` on the owning module as ``sharded``, which the forward functions
read (``layers.shard_axis``); :func:`gather_module` undoes it. Names do not
change, so masks keyed by parameter name (AdamW's decay and freeze sets)
match the shard module as they match the full one.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from viquae_torch.core import mesh as meshlib


def flatten_spec(spec, prefix: str = "") -> Dict[str, Optional[tuple]]:
    """{parameter name: (dim, axis[, units]) or None} of a spec tree."""
    if isinstance(spec, dict):
        items = spec.items()
    elif isinstance(spec, list):
        items = enumerate(spec)
    else:
        return {prefix: spec}
    out = {}
    for key, sub in items:
        out.update(flatten_spec(sub, f"{prefix}.{key}" if prefix
                                else str(key)))
    return out


def _owner(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf


def sharded_parameters(module: nn.Module) -> Dict[str, Tuple[int, str]]:
    """{parameter name: (dim, axis)} of every split parameter."""
    out = {}
    for path, mod in module.named_modules():
        for leaf, entry in getattr(mod, "sharded", {}).items():
            out[f"{path}.{leaf}" if path else leaf] = entry
    return out


def parameter_axes(module: nn.Module) -> Dict[str, Optional[str]]:
    """{parameter name: the mesh axis it is one rank's block of, or None
    where it is replicated}, in ``named_parameters`` order."""
    split = sharded_parameters(module)
    return {n: split[n][1] if n in split else None
            for n, _ in module.named_parameters()}


@torch.no_grad()
def shard_module(module: nn.Module, spec, ctx: meshlib.MeshContext
                 ) -> nn.Module:
    """A copy of ``module`` holding this rank's block of every parameter
    ``spec`` splits (the rest replicated). A parameter the spec does not
    name stays replicated; a name that is no parameter raises, as does an
    axis whose size does not divide the split dimension (or its units)."""
    entries = flatten_spec(spec)
    params = dict(module.named_parameters())
    unknown = sorted(set(entries) - set(params))
    if unknown:
        raise ValueError(f"the spec names no parameter of the module: "
                         f"{unknown[:5]}")
    shard = copy.deepcopy(module)
    for name, entry in entries.items():
        if entry is None:
            continue
        dim, axis = entry[:2]
        full = params[name]
        units = entry[2] if len(entry) > 2 else full.shape[dim]
        size = ctx.size(axis)
        if units % size or full.shape[dim] % size:
            raise ValueError(
                f"a {axis!r} axis of size {size} does not divide {name} "
                f"({tuple(full.shape)}, dim {dim}: {units} "
                f"{'heads' if len(entry) > 2 else 'units'})")
        if size == 1:
            continue                    # one rank holds it all
        owner, leaf = _owner(shard, name)
        block = full.detach().chunk(size, dim)[ctx.coordinate(axis)]
        setattr(owner, leaf, nn.Parameter(block.clone(),
                                          requires_grad=full.requires_grad))
        owner.sharded = {**getattr(owner, "sharded", {}), leaf: (dim, axis)}
    return shard


@torch.no_grad()
def gather_module(shard: nn.Module, ctx: Optional[meshlib.MeshContext] = None
                  ) -> nn.Module:
    """The full module of a shard module: every split parameter gathered
    over its axis (every rank of the axis calls this together), the
    ``sharded`` records dropped. ``ctx`` defaults to the current mesh."""
    ctx = ctx if ctx is not None else meshlib.current()
    full = copy.deepcopy(shard)
    for name, (dim, axis) in sharded_parameters(shard).items():
        owner, leaf = _owner(full, name)
        part = getattr(owner, leaf)
        whole = torch.cat(list(meshlib.all_gather(
            ctx, part.detach(), axis).unbind(0)), dim=dim)
        setattr(owner, leaf, nn.Parameter(whole,
                                          requires_grad=part.requires_grad))
    for mod in full.modules():
        mod.__dict__.pop("sharded", None)
    return full
