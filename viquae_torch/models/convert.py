"""JAX param trees -> the port's weights.

The JAX package stores BERT params as a nested dict (``bert.init``,
viquae_tpu/models/bert.py:66-114) with dense kernels laid out (in, out).
:func:`params_from_jax` takes that tree with numpy leaves (any float dtype,
bf16 included) and returns a :class:`viquae_torch.models.bert.Bert` whose
``nn.Linear`` weights are (out, in). :func:`init_tree` draws a tree of the
same layout with numpy from a seed, for runs that need full-width weights
and no checkpoint. :func:`reader_from_jax` and :func:`init_reader_tree` do
the same for the reader tree (``bert``, ``qa_outputs``, ``score_proj_w/b``)
and :class:`viquae_torch.models.qa.Reader`.

:func:`state_dict_from_tree` and :func:`module_from_tree` do it for any tree whose
modules are named as its keys (the image and face towers, ViLT): a node
with a ``kernel`` becomes a ``weight`` (HWIO -> OIHW, (in, out) -> (out,
in)), a batch-norm node (scale, bias, mean, var) becomes weight, bias,
running_mean, running_var, a layer-norm node (scale, bias) weight and
bias, a PReLU node (alpha) weight; bare arrays keep their names.
:func:`module_from_tree` maps the subtree of every :class:`Bert` the
module holds by the BERT layout above (the multimodal encoders, the
re-rankers, the ECA reader, BEM, NER), so one call carries any of the
JAX package's trees across; :func:`tree_from_module` is its inverse.
:func:`staged_from_jax` / :func:`staged_tree_from_module` carry the
pipeline's staged BERT (``bert.pipeline_params``) across both ways.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from viquae_torch.core.device import resolve_device
from viquae_torch.models import qa
from viquae_torch.models.bert import Bert, BertConfig, _is_moe_layer


def _bert_cfg(cfg) -> BertConfig:
    return cfg.bert if hasattr(cfg, "bert") else cfg


def _state_dict_from_tree(tree: Dict[str, Any], cfg: BertConfig
                          ) -> Dict[str, np.ndarray]:
    def f32(a):
        return np.asarray(a, dtype=np.float32)

    emb = tree["embeddings"]
    sd = {
        "embeddings.word.weight": f32(emb["word"]),
        "embeddings.position.weight": f32(emb["position"]),
        "embeddings.token_type.weight": f32(emb["token_type"]),
        "embeddings.ln.weight": f32(emb["ln"]["scale"]),
        "embeddings.ln.bias": f32(emb["ln"]["bias"]),
    }

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = f32(p["kernel"]).T
        sd[f"{prefix}.bias"] = f32(p["bias"])

    def ln(prefix, p):
        sd[f"{prefix}.weight"] = f32(p["scale"])
        sd[f"{prefix}.bias"] = f32(p["bias"])

    if len(tree["layers"]) != cfg.num_hidden_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, config "
                         f"{cfg.num_hidden_layers}")
    for i, layer in enumerate(tree["layers"]):
        for name in ("q", "k", "v", "o"):
            lin(f"layers.{i}.attention.{name}", layer["attention"][name])
        ln(f"layers.{i}.attention_ln", layer["attention_ln"])
        if "moe" in layer:
            # stacked experts keep the tree's (E, D, H) / (E, H, D) layout
            moe = layer["moe"]
            sd[f"layers.{i}.moe.router.weight"] = f32(
                moe["router"]["kernel"]).T
            for name in ("in", "out"):
                sd[f"layers.{i}.moe.{name}.weight"] = f32(
                    moe[name]["kernel"])
                sd[f"layers.{i}.moe.{name}.bias"] = f32(moe[name]["bias"])
        else:
            lin(f"layers.{i}.mlp.in", layer["mlp"]["in"])
            lin(f"layers.{i}.mlp.out", layer["mlp"]["out"])
        ln(f"layers.{i}.output_ln", layer["output_ln"])
    if cfg.add_pooler and "pooler" in tree:
        lin("pooler", tree["pooler"])
    return sd


def params_from_jax(tree: Dict[str, Any], cfg, device=None,
                    dtype: torch.dtype = torch.float32) -> Bert:
    """The JAX BERT/DPR param tree (numpy leaves) -> a :class:`Bert` on
    ``device`` (default: the GPU) with every weight in ``dtype``. ``cfg`` is
    a BertConfig or a DPRConfig. The weights do not require grad."""
    cfg = _bert_cfg(cfg)
    with torch.device("meta"):
        model = Bert(cfg)
    return load_module(model, _state_dict_from_tree(tree, cfg), device, dtype)


def init_tree(cfg, seed: int = 0, stddev: float = 0.02) -> Dict[str, Any]:
    """A random param tree in the JAX layout, drawn with numpy: dense and
    embedding matrices (a MoE layer's router and stacked experts too)
    ~ N(0, stddev) clipped to +-2 stddev (as the JAX package's
    truncated-normal init), zero biases, unit LayerNorm scales."""
    cfg = _bert_cfg(cfg)
    rng = np.random.default_rng(seed)
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def mat(*shape):
        x = rng.standard_normal(shape, dtype=np.float32) * stddev
        return np.clip(x, -2 * stddev, 2 * stddev)

    def dense(d_in, d_out):
        return {"kernel": mat(d_in, d_out),
                "bias": np.zeros((d_out,), np.float32)}

    def ln():
        return {"scale": np.ones((h,), np.float32),
                "bias": np.zeros((h,), np.float32)}

    def ffn(i):
        if not _is_moe_layer(cfg, i):
            return {"mlp": {"in": dense(h, inter), "out": dense(inter, h)}}
        e = cfg.moe_experts
        return {"moe": {
            "router": {"kernel": mat(h, e)},
            "in": {"kernel": mat(e, h, inter),
                   "bias": np.zeros((e, inter), np.float32)},
            "out": {"kernel": mat(e, inter, h),
                    "bias": np.zeros((e, h), np.float32)},
        }}

    tree: Dict[str, Any] = {
        "embeddings": {
            "word": mat(cfg.vocab_size, h),
            "position": mat(cfg.max_position_embeddings, h),
            "token_type": mat(cfg.type_vocab_size, h),
            "ln": ln(),
        },
        "layers": [
            {
                "attention": {n: dense(h, h) for n in ("q", "k", "v", "o")},
                "attention_ln": ln(),
                **ffn(i),
                "output_ln": ln(),
            }
            for i in range(cfg.num_hidden_layers)
        ],
    }
    if cfg.add_pooler:
        tree["pooler"] = dense(h, h)
    return tree


def reader_from_jax(tree: Dict[str, Any], cfg: qa.ReaderConfig, device=None,
                    dtype: torch.dtype = torch.float32) -> qa.Reader:
    """The JAX reader tree (``bert``, ``qa_outputs`` and, with
    ``fuse_ir_score``, ``score_proj_w`` (1, 1) / ``score_proj_b`` (1,);
    numpy leaves) -> a :class:`qa.Reader` on ``device`` (default: the GPU)
    with every weight in ``dtype``."""
    tensors = {f"bert.{name}": a for name, a in
               _state_dict_from_tree(tree["bert"], cfg.bert).items()}
    head = tree["qa_outputs"]
    tensors["qa_outputs.weight"] = np.asarray(head["kernel"], np.float32).T
    tensors["qa_outputs.bias"] = np.asarray(head["bias"], np.float32)
    if cfg.fuse_ir_score:
        for name in ("score_proj_w", "score_proj_b"):
            tensors[name] = np.asarray(tree[name], np.float32)
    return qa.load_reader(
        cfg, {name: torch.from_numpy(np.array(a, order="C"))
              for name, a in tensors.items()}, device, dtype)


def init_reader_tree(cfg: qa.ReaderConfig, seed: int = 0,
                     stddev: float = 0.02) -> Dict[str, Any]:
    """A random reader tree in the JAX layout (as ``qa.init`` of the JAX
    package): :func:`init_tree` for ``bert``, a clipped-normal span head
    and the identity ``score_proj_w/b``."""
    rng = np.random.default_rng(seed + 1)
    h = cfg.bert.hidden_size
    kernel = rng.standard_normal((h, 2), dtype=np.float32) * stddev
    tree: Dict[str, Any] = {
        "bert": init_tree(cfg.bert, seed=seed, stddev=stddev),
        "qa_outputs": {"kernel": np.clip(kernel, -2 * stddev, 2 * stddev),
                       "bias": np.zeros((2,), np.float32)},
    }
    if cfg.fuse_ir_score:
        tree["score_proj_w"] = np.ones((1, 1), np.float32)
        tree["score_proj_b"] = np.zeros((1,), np.float32)
    return tree


def state_dict_from_tree(tree) -> Dict[str, np.ndarray]:
    """A JAX param tree (numpy or JAX leaves) -> a flat f32 state dict in
    torch layouts (see the module docstring)."""
    out: Dict[str, np.ndarray] = {}

    def f32(a):
        return np.asarray(a, dtype=np.float32)

    def visit(node, name):
        key = (lambda k: f"{name}.{k}") if name else (lambda k: str(k))
        if isinstance(node, dict):
            if "kernel" in node:
                kernel = f32(node["kernel"])
                # a 3-D kernel is a stack of experts: kept as it is
                out[key("weight")] = (kernel.transpose(3, 2, 0, 1)
                                      if kernel.ndim == 4 else kernel.T
                                      if kernel.ndim == 2 else kernel)
                if "bias" in node:
                    out[key("bias")] = f32(node["bias"])
            elif "mean" in node and "var" in node:
                out[key("weight")] = f32(node["scale"])
                out[key("bias")] = f32(node["bias"])
                out[key("running_mean")] = f32(node["mean"])
                out[key("running_var")] = f32(node["var"])
            elif "scale" in node:
                out[key("weight")] = f32(node["scale"])
                out[key("bias")] = f32(node["bias"])
            elif "alpha" in node:
                out[key("weight")] = f32(node["alpha"])
            else:
                for k, v in node.items():
                    visit(v, key(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(v, key(i))
        else:
            out[name] = f32(node)

    visit(tree, "")
    return out


def _without_none(tree):
    if isinstance(tree, dict):
        return {k: _without_none(v) for k, v in tree.items()
                if v is not None}
    return tree


def _split_off(tree: Dict[str, Any], path: str):
    """(the subtree at the "."-joined ``path``, the tree without it)."""
    if not path:
        return tree, {}
    head, _, rest = path.partition(".")
    sub, remaining = _split_off(tree[head], rest)
    out = dict(tree)
    if remaining:
        out[head] = remaining
    else:
        del out[head]
    return sub, out


def load_module(module: nn.Module, tensors: Dict[str, Any], device,
                dtype: torch.dtype = torch.float32) -> nn.Module:
    """``module`` (built on the meta device) holding ``tensors`` (numpy
    arrays or tensors under its state-dict names) on ``device`` (default:
    the GPU) in ``dtype``; strict, so a name or a shape that disagrees
    raises. A BERT pooler the tensors lack is dropped. The weights do not
    require grad."""
    device = resolve_device(device)
    for name, mod in list(module.named_modules()):
        prefix = f"{name}." if name else ""
        if isinstance(mod, Bert) and mod.pooler is not None \
                and f"{prefix}pooler.weight" not in tensors:
            mod.pooler = None

    def tensor(a):
        if isinstance(a, np.ndarray):  # a copy: .npz leaves are read-only
            a = np.array(a, order="C")
        return torch.as_tensor(a).contiguous().to(device=device, dtype=dtype)

    module.load_state_dict({name: tensor(a) for name, a in tensors.items()},
                           strict=True, assign=True)
    return module.requires_grad_(False).eval()


def module_from_tree(module_cls, *args, tree, device=None,
                     dtype: torch.dtype = torch.float32) -> nn.Module:
    """``module_cls(*args)`` built on the meta device, with the JAX param
    tree's tensors assigned on ``device`` (default: the GPU) in ``dtype``
    (:func:`load_module`). The subtree of each :class:`Bert` submodule
    goes through the BERT layout, the rest through
    :func:`state_dict_from_tree`; None leaves (an absent MoE term) are
    dropped."""
    with torch.device("meta"):
        module = module_cls(*args)
    rest = _without_none(tree)
    sd: Dict[str, np.ndarray] = {}
    for name, mod in list(module.named_modules()):
        if isinstance(mod, Bert):
            sub, rest = _split_off(rest, name)
            prefix = f"{name}." if name else ""
            sd.update({prefix + k: a for k, a in
                       _state_dict_from_tree(sub, mod.cfg).items()})
    sd.update(state_dict_from_tree(rest))
    return load_module(module, sd, device, dtype)


# --------------------------------------------------------------------------
# the inverse map: a module's tensors -> JAX param-tree paths
# --------------------------------------------------------------------------
# a JAX kernel is the port's weight permuted by these axes, by its number
# of dimensions: dense (in, out) from (out, in), expert stacks (E, in, out)
# as they are, convolutions HWIO from OIHW
KERNEL_AXES = {2: (1, 0), 3: (0, 1, 2), 4: (2, 3, 1, 0)}


def torch_partition(partition, ndim: int, kernel: bool = True):
    """A JAX leaf's partition (one mesh axis name or None for each of its
    dimensions, as a ``PartitionSpec``; missing trailing entries are None)
    as the port's ``(dim, axis)`` on the same tensor: a kernel's dimension
    maps through :data:`KERNEL_AXES`, any other leaf's is its own. None
    when the leaf is replicated."""
    partition = tuple(partition) + (None,) * (ndim - len(tuple(partition)))
    axes = KERNEL_AXES[ndim] if kernel else tuple(range(ndim))
    split = [(axes[d], a) for d, a in enumerate(partition) if a is not None]
    if len(split) > 1:
        raise ValueError(f"one sharded dimension a tensor, got {partition}")
    return split[0] if split else None


def _leaf_name(mod: nn.Module, name: str) -> str:
    """The JAX tree's name of ``mod``'s direct tensor ``name`` ("" for a
    bare embedding table, which is a leaf of its own in the tree)."""
    from viquae_torch.models.layers import BatchNorm, ExpertDense

    if isinstance(mod, nn.Embedding):
        return ""
    if isinstance(mod, (nn.Linear, nn.Conv2d, ExpertDense)) \
            and name == "weight":
        return "kernel"
    if isinstance(mod, (nn.LayerNorm, BatchNorm)) and name == "weight":
        return "scale"
    if isinstance(mod, BatchNorm):
        return {"running_mean": "mean", "running_var": "var"}.get(name,
                                                                   name)
    if isinstance(mod, nn.PReLU):
        return "alpha"
    return name


def jax_paths(module: nn.Module, buffers: bool = False) -> Dict[str, str]:
    """{torch name: JAX path} for every parameter of ``module`` (and its
    buffers with ``buffers``): the inverse of the tree -> state-dict maps
    above. Module names become "/"-joined tree keys, a weight becomes
    ``kernel`` (dense, convolution) or ``scale`` (norms), an embedding
    table is its module's own path. The JAX package's freeze and decay
    regexes are written for these paths (``layers/6/attention/q/kernel``,
    ``ln/scale``), so the port matches them here and not on its own
    names (``layers.6.attention.q.weight``, ``ln.weight``). A staged
    layer (``ops.pipeline.Stages``: ``layers.1.2...`` with 3 layers a
    stage) takes its per-layer path (``layers/5/...``), so that a staged
    module, or a shard holding one stage, decays and freezes the tensors
    its per-layer module does."""
    from viquae_torch.ops.pipeline import Stages

    staged = {path: mod.per for path, mod in module.named_modules()
              if isinstance(mod, Stages) and path}
    out = {}
    for mod_name, mod in module.named_modules():
        tensors = list(mod.named_parameters(recurse=False))
        if buffers:
            tensors += list(mod.named_buffers(recurse=False))
        for name, _ in tensors:
            parts = mod_name.split(".") if mod_name else []
            for k in range(1, len(parts) - 1):
                per = staged.get(".".join(parts[:k]))
                if per is not None:
                    # a staged layer (stage s, j-th) is global layer
                    # s * per + j: the per-layer list's path
                    parts[k: k + 2] = [str(int(parts[k]) * per
                                           + int(parts[k + 1]))]
                    break
            leaf = _leaf_name(mod, name)
            if leaf:
                parts.append(leaf)
            out[f"{mod_name}.{name}" if mod_name else name] = "/".join(parts)
    return out


def tree_from_module(module: nn.Module) -> Dict[str, Any]:
    """A module's weights as a JAX param tree of f32 numpy arrays (dense
    kernels (in, out), convolution kernels HWIO): what the JAX package's
    ``export_params`` writes for the same model, so an export directory
    of the port loads in either package; a level keyed 0 .. n-1 is a
    list, as the JAX tree's ``layers``."""
    from viquae_torch.train.checkpoint import _unflatten

    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    flat = {}
    for name, path in jax_paths(module, buffers=True).items():
        a = tensors[name].detach().to("cpu", torch.float32).numpy()
        if path.endswith("kernel"):
            a = a.transpose(KERNEL_AXES[a.ndim])
        flat[path] = np.ascontiguousarray(a)
    return _unflatten(flat)


# --------------------------------------------------------------------------
# the staged layout (ops/pipeline.py) both ways
# --------------------------------------------------------------------------
def _map_arrays(fn, *trees):
    """``fn`` on the matching arrays of same-shaped nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _map_arrays(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*(np.asarray(t) for t in trees))


def staged_from_jax(tree: Dict[str, Any], cfg, n_stages: int, device=None,
                    dtype: torch.dtype = torch.float32) -> Bert:
    """A JAX staged BERT tree (``bert.pipeline_params(params, n_stages)``:
    the ``layers`` leaves lead with ``(n_stages, per)``) -> the port's
    staged :class:`Bert` (``bert.pipeline_params`` of the same weights)."""
    from viquae_torch.models.bert import pipeline_params

    flat = _map_arrays(lambda a: a.reshape((-1,) + a.shape[2:]),
                       tree["layers"])
    layers = [_map_arrays(lambda a, i=i: a[i], flat)
              for i in range(_bert_cfg(cfg).num_hidden_layers)]
    return pipeline_params(
        params_from_jax(dict(tree, layers=layers), cfg, device, dtype),
        n_stages)


def staged_tree_from_module(params: Bert) -> Dict[str, Any]:
    """Inverse of :func:`staged_from_jax`: a staged :class:`Bert` holding
    every stage as the JAX staged tree (f32 numpy leaves)."""
    from viquae_torch.models.bert import pipeline_unstack

    tree = tree_from_module(pipeline_unstack(params))
    n_stages = params.layers.n_stages
    tree["layers"] = _map_arrays(
        lambda *xs: np.stack(xs).reshape((n_stages, -1) + xs[0].shape),
        *tree["layers"])
    return tree
