"""Checkpoint / resume / export (counterpart of
viquae_tpu/train/checkpoint.py).

:func:`save_state` writes a trainer's whole state (parameters, optimizer
and schedule, step) with ``torch.save`` under ``<dir>/step_<n>/state.pt``
and keeps the newest ``keep``; :func:`restore_state` loads the newest (or
a given) step into a template that has ``load_state_dict``. On a mesh
each rank writes its own shard (parameters, AdamW moments, schedule,
step, generator state and the mesh it ran on) to
``<dir>/step_<n>/rank<r>.pt`` and reads it back, so a resume on the same
mesh continues bit for bit; :func:`export_params` takes full parameters
(the trainer gathers its shards first), so an export is the same file
as one device's.

An export directory holds ``params.npz``, one array per leaf of a param
tree named by its path ("/"-joined dict keys and list indices, as
``jax.tree_util`` names them: ``layers/0/attention/q/kernel``), and an
optional ``config.json``. A directory that either package writes loads in
the other; the port turns the tree into its modules with the converters of
``viquae_torch.models.convert`` (``tree_from_module`` goes back).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch


def _file(rank: Optional[int]) -> str:
    return "state.pt" if rank is None else f"rank{rank}.pt"


def save_state(ckpt_dir, state, step: int, keep: Optional[int] = None,
               rank: Optional[int] = None):
    """``state.state_dict()`` to ``ckpt_dir/step_<step>`` (``state.pt``,
    or ``rank<r>.pt`` for one rank of a mesh); with ``keep``, only the
    newest ``keep`` steps stay (each rank removes its own files)."""
    ckpt_dir = Path(ckpt_dir).resolve()
    path = ckpt_dir / f"step_{step}"
    path.mkdir(parents=True, exist_ok=True)
    name = _file(rank)
    tmp = path / f"{name}.tmp"
    torch.save(state.state_dict(), tmp)
    tmp.replace(path / name)
    if keep is not None:
        for old in sorted(all_steps(ckpt_dir, rank))[:-keep]:
            old_dir = ckpt_dir / f"step_{old}"
            if rank is None:
                shutil.rmtree(old_dir, ignore_errors=True)
                continue
            (old_dir / name).unlink(missing_ok=True)
            try:
                old_dir.rmdir()         # the last rank out removes it
            except OSError:
                pass
    return path


def all_steps(ckpt_dir, rank: Optional[int] = None):
    """The steps under ``ckpt_dir`` that hold ``state.pt`` (or, for a
    rank of a mesh, its ``rank<r>.pt``)."""
    ckpt_dir = Path(ckpt_dir)
    name = _file(rank)
    return [
        int(p.name.split("_")[1])
        for p in ckpt_dir.glob("step_*") if (p / name).is_file()
    ]


def restore_state(ckpt_dir, template, step: Optional[int] = None,
                  map_location="cpu", rank: Optional[int] = None):
    """(``template`` with the checkpoint loaded, step): ``template`` has
    ``load_state_dict`` (a ``trainer.TrainState``); ``step`` defaults to
    the newest; ``rank`` reads one rank's shard of a mesh."""
    ckpt_dir = Path(ckpt_dir).resolve()
    if step is None:
        steps = all_steps(ckpt_dir, rank)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = max(steps)
    template.load_state_dict(torch.load(
        ckpt_dir / f"step_{step}" / _file(rank), map_location=map_location,
        weights_only=True))
    return template, step


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    """{path: leaf} in the order ``jax.tree_util`` flattens: dict keys
    sorted, list and tuple items in order; None is an empty subtree."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flatten(tree[key], prefix + (str(key),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, item in enumerate(tree):
            out.update(_flatten(item, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def export_params(path, params, config: Optional[dict] = None):
    """Flat .npz of a params tree (nested dicts / lists of arrays) + JSON
    config."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = {name: np.asarray(leaf) for name, leaf in _flatten(params).items()}
    np.savez(path / "params.npz", **flat)
    if config is not None:
        (path / "config.json").write_text(json.dumps(config, indent=2))


def _unflatten(flat: Dict[str, np.ndarray]):
    """Nested dicts from "/"-joined names; a level whose keys are exactly
    0 .. n-1 becomes a list."""
    root: Dict[str, Any] = {}
    for name, arr in flat.items():
        node = root
        *parents, leaf = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def import_params(path) -> Any:
    """Inverse of :func:`export_params`: the tree of numpy arrays rebuilt
    from the names (a level keyed 0 .. n-1 is a list, as a param tree's
    ``layers``). The JAX package restores the structure of a template
    instead; the port's converters check every name and shape when they
    load the tree into a module."""
    with np.load(Path(path) / "params.npz") as data:
        return _unflatten({name: data[name] for name in data.files})
