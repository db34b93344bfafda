"""Unified kwargs-tree config system.

The reference had three coexisting config systems (docopt+JSON kwargs trees,
LightningCLI YAML, jsonargparse CLIs — SURVEY.md §5.6). We keep ONE: a
JSON/YAML kwargs-tree where any dict holding a ``class_name`` key is
recursively instantiated through a name->factory registry, mirroring the
behavior of meerqat/data/loading.py:167-183 (`get_class_from_name`,
`get_pretrained`) and :443-453 (`load_pretrained_in_kwargs`) without the
transformers coupling. Counterpart of viquae_tpu/core/config.py; `yaml`
is imported only where a YAML file is read.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, Callable] = {}


def register(name: Optional[str] = None):
    """Decorator: make a class/factory instantiable from configs by name."""

    def deco(obj):
        _REGISTRY[name or obj.__name__] = obj
        return obj

    if callable(name):  # bare @register
        obj, name = name, None
        return deco(obj)
    return deco


def get_class_from_name(class_name: str) -> Callable:
    if class_name not in _REGISTRY:
        # lazily import the model modules whose import registers entries
        import viquae_torch.models.clip  # noqa: F401
        import viquae_torch.models.qa  # noqa: F401

    try:
        return _REGISTRY[class_name]
    except KeyError:
        raise ValueError(
            f"Unknown class_name {class_name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def get_pretrained(class_name: str, pretrained_model_name_or_path=None, **kwargs):
    """Instantiate a registered model, optionally from pretrained weights.

    Parity with meerqat/data/loading.py:174-183: registered factories must
    expose ``from_pretrained(path, **kwargs)`` and a bare constructor.
    """
    cls = get_class_from_name(class_name)
    if pretrained_model_name_or_path is None:
        return cls(**kwargs)
    return cls.from_pretrained(pretrained_model_name_or_path, **kwargs)


def instantiate_tree(obj: Any) -> Any:
    """Recursively instantiate every {"class_name": ...} node of a kwargs tree.

    Parity with meerqat/data/loading.py:443-453 (`load_pretrained_in_kwargs`),
    generalized: children are instantiated before parents.
    """
    if isinstance(obj, dict):
        out = {k: instantiate_tree(v) for k, v in obj.items()}
        if "class_name" in out:
            class_name = out.pop("class_name")
            return get_pretrained(class_name, **out)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(instantiate_tree(v) for v in obj)
    return obj


def load_config(path) -> dict:
    """Load a JSON or YAML kwargs-tree.

    Dict keys starting with "_" are comments (e.g. the experiment corpus's
    "_mirror" provenance pointers) and are stripped at every nesting level
    — configs are literal kwargs trees, so a comment key would otherwise
    reach a constructor as an unexpected argument."""
    path = Path(path)
    text = path.read_text()
    if path.suffix in (".yaml", ".yml"):
        import yaml

        config = yaml.safe_load(text)
    else:
        config = json.loads(text)

    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items()
                    if not (isinstance(k, str) and k.startswith("_"))}
        if isinstance(node, list):
            return [strip(v) for v in node]
        return node

    return strip(config)


def load_pretrained_in_config(path) -> dict:
    return instantiate_tree(load_config(path))
