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

A pipeline stage split is not a ``chunk`` of a tensor: a spec leaf
``ops.pipeline.StageSplit`` names a ``pipeline.Stages`` container (the
staged layers of ``bert.pipeline_params``), and the shard keeps this
rank's stage only, under its own index, recording the axis on the
container (:func:`staged_parameters`); :func:`gather_module` all-gathers
the stages' layers and rebuilds the per-layer list in global layer order.
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


def _stages(module: nn.Module):
    from viquae_torch.ops.pipeline import Stages

    return [(path, mod) for path, mod in module.named_modules()
            if isinstance(mod, Stages)]


def staged_parameters(module: nn.Module) -> Dict[str, str]:
    """{parameter name: axis} of every parameter of a pipeline stage that
    a shard holds alone (its stages split over the axis)."""
    out = {}
    for path, stages in _stages(module):
        axis = getattr(stages, "split_axis", None)
        if axis is not None:
            out.update({f"{path}.{n}" if path else n: axis
                        for n, _ in stages.named_parameters()})
    return out


def is_split(module: nn.Module) -> bool:
    """Whether :func:`gather_module` has anything to do: a parameter split
    over an axis, or staged layers to put back in the per-layer list."""
    return bool(sharded_parameters(module)) or bool(_stages(module))


def parameter_axes(module: nn.Module) -> Dict[str, Optional[str]]:
    """{parameter name: the mesh axis it is one rank's block (or stage)
    of, or None where it is replicated}, in ``named_parameters`` order."""
    split = sharded_parameters(module)
    staged = staged_parameters(module)
    return {n: split[n][1] if n in split else staged.get(n)
            for n, _ in module.named_parameters()}


@torch.no_grad()
def shard_module(module: nn.Module, spec, ctx: meshlib.MeshContext
                 ) -> nn.Module:
    """A copy of ``module`` holding this rank's block of every parameter
    ``spec`` splits (the rest replicated). A parameter the spec does not
    name stays replicated; a name that is no parameter raises, as does an
    axis whose size does not divide the split dimension (or its units)."""
    from viquae_torch.ops.pipeline import Stages, StageSplit

    entries = flatten_spec(spec)
    stage_entries = {n: e for n, e in entries.items()
                     if isinstance(e, StageSplit)}
    entries = {n: e for n, e in entries.items() if n not in stage_entries}
    params = dict(module.named_parameters())
    unknown = sorted(set(entries) - set(params)) + sorted(
        n for n in stage_entries
        if not isinstance(_submodule(module, n), Stages))
    if unknown:
        raise ValueError(f"the spec names no parameter (or stages) of the "
                         f"module: {unknown[:5]}")
    shard = copy.deepcopy(module)
    for name, entry in stage_entries.items():
        stages, size = shard.get_submodule(name), ctx.size(entry.axis)
        if stages.n_stages != size:
            raise ValueError(f"{name} holds {stages.n_stages} stages, the "
                             f"{entry.axis!r} axis has {size} ranks")
        if size == 1:
            continue                    # one rank holds every stage
        keep = ctx.coordinate(entry.axis)
        for key in [k for k in stages.keys() if int(k) != keep]:
            del stages[key]
        stages.split_axis = entry.axis
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
    for path, stages in _stages(full):
        owner, leaf = _owner(full, path)
        setattr(owner, leaf, _gather_stages(stages, ctx))
    for mod in full.modules():
        mod.__dict__.pop("sharded", None)
    return full


def _submodule(module: nn.Module, name: str) -> Optional[nn.Module]:
    try:
        return module.get_submodule(name)
    except AttributeError:
        return None


def _gather_stages(stages, ctx: meshlib.MeshContext) -> nn.ModuleList:
    """The per-layer list of a ``Stages`` (global layer order): a shard's
    stage all-gathered over its axis, one parameter at a time in name
    order (every rank of the axis calls this together)."""
    from viquae_torch.ops.pipeline import unstack_stages

    axis = getattr(stages, "split_axis", None)
    if axis is None:
        return unstack_stages(stages)
    (held,) = stages.held()
    local = stages[held]
    names = [n for n, _ in local.named_parameters()]
    parts = {n: meshlib.all_gather(ctx, p.detach(), axis)
             for n, p in local.named_parameters()}
    layers = []
    for s in range(stages.n_stages):
        stage = copy.deepcopy(local)
        for n in names:
            owner, leaf = _owner(stage, n)
            setattr(owner, leaf, nn.Parameter(
                parts[n][s].clone(),
                requires_grad=getattr(owner, leaf).requires_grad))
        layers.extend(stage)
    return nn.ModuleList(layers)
