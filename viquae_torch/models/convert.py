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
modules are named as its keys (the image and face towers): a node with a
``kernel`` becomes a ``weight`` (HWIO -> OIHW, (in, out) -> (out, in)), a
batch-norm node (scale, bias, mean, var) becomes weight, bias,
running_mean, running_var, a layer-norm node (scale, bias) weight and
bias, a PReLU node (alpha) weight; bare arrays keep their names.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from viquae_torch.core.device import resolve_device
from viquae_torch.models import qa
from viquae_torch.models.bert import Bert, BertConfig


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
        if "mlp" not in layer:
            raise NotImplementedError(
                "MoE layers are not ported yet (see ROADMAP.md)")
        for name in ("q", "k", "v", "o"):
            lin(f"layers.{i}.attention.{name}", layer["attention"][name])
        ln(f"layers.{i}.attention_ln", layer["attention_ln"])
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
    device = resolve_device(device)
    sd = _state_dict_from_tree(tree, cfg)
    with torch.device("meta"):
        model = Bert(cfg)
    if model.pooler is not None and "pooler.weight" not in sd:
        model.pooler = None
    model.load_state_dict(
        {name: torch.from_numpy(np.array(a, order="C")).to(
            device=device, dtype=dtype) for name, a in sd.items()},
        strict=True, assign=True)
    return model.requires_grad_(False).eval()


def init_tree(cfg, seed: int = 0, stddev: float = 0.02) -> Dict[str, Any]:
    """A random param tree in the JAX layout, drawn with numpy: dense and
    embedding matrices ~ N(0, stddev) clipped to +-2 stddev (as the JAX
    package's truncated-normal init), zero biases, unit LayerNorm scales."""
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
                "mlp": {"in": dense(h, inter), "out": dense(inter, h)},
                "output_ln": ln(),
            }
            for _ in range(cfg.num_hidden_layers)
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
                out[key("weight")] = (kernel.transpose(3, 2, 0, 1)
                                      if kernel.ndim == 4 else kernel.T)
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


def module_from_tree(module_cls, *args, tree, device=None,
                     dtype: torch.dtype = torch.float32) -> nn.Module:
    """``module_cls(*args)`` built on the meta device, with the JAX param
    tree's tensors assigned on ``device`` (default: the GPU) in ``dtype``;
    strict, so a tree and a module that disagree on a name or a shape
    raise. The weights do not require grad."""
    device = resolve_device(device)
    with torch.device("meta"):
        module = module_cls(*args)
    sd = {name: torch.from_numpy(np.array(a, order="C")).to(
        device=device, dtype=dtype)
        for name, a in state_dict_from_tree(tree).items()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module.requires_grad_(False).eval()
