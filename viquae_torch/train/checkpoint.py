"""Params-only export: the JAX package's inter-stage checkpoint contract
(counterpart of viquae_tpu/train/checkpoint.py ``export_params`` /
``import_params``), numpy only.

An export directory holds ``params.npz``, one array per leaf of a param
tree named by its path ("/"-joined dict keys and list indices, as
``jax.tree_util`` names them: ``layers/0/attention/q/kernel``), and an
optional ``config.json``. A directory that either package writes loads in
the other; the port turns the tree into its modules with the converters of
``viquae_torch.models.convert``. The orbax train-state checkpoints
(``save_state`` / ``restore_state``) come with training (ROADMAP A16).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np


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
