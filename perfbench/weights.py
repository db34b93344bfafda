"""Seeded weights, drawn on the device in a few large calls, named as the
port's modules name their parameters (``models.bert.Bert``,
``models.qa.Reader``).

The benchmark makes the weights and hands the same tensors to the program
and, drawn again from the same seed, to the reference. Dense kernels,
tables, biases and LayerNorm shifts are N(0, std), std the configuration's
``initializer_range``, and LayerNorm scales 1 + N(0, 0.1): every parameter
is non-trivial, so that a path that drops a bias or a scale shows in the
comparison.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def bert_shapes(b: dict, prefix: str = "") -> List[Tuple[str, tuple]]:
    """(name, shape) of every parameter of a BERT encoder without pooler,
    in the layout of ``models.bert.Bert`` (``nn.Linear`` weights are
    (out, in)). ``b``: the configuration's ``bert`` block."""
    h, ff = b["hidden_size"], b["intermediate_size"]
    out = [(prefix + "embeddings.word.weight", (b["vocab_size"], h)),
           (prefix + "embeddings.position.weight",
            (b["max_position_embeddings"], h)),
           (prefix + "embeddings.token_type.weight",
            (b["type_vocab_size"], h)),
           (prefix + "embeddings.ln.weight", (h,)),
           (prefix + "embeddings.ln.bias", (h,))]
    for i in range(b["num_hidden_layers"]):
        p = f"{prefix}layers.{i}."
        for name in ("q", "k", "v", "o"):
            out += [(f"{p}attention.{name}.weight", (h, h)),
                    (f"{p}attention.{name}.bias", (h,))]
        out += [(f"{p}attention_ln.weight", (h,)),
                (f"{p}attention_ln.bias", (h,)),
                (f"{p}mlp.in.weight", (ff, h)), (f"{p}mlp.in.bias", (ff,)),
                (f"{p}mlp.out.weight", (h, ff)), (f"{p}mlp.out.bias", (h,)),
                (f"{p}output_ln.weight", (h,)),
                (f"{p}output_ln.bias", (h,))]
    return out


def reader_shapes(b: dict) -> List[Tuple[str, tuple]]:
    """``models.qa.Reader`` without ``fuse_ir_score``: the encoder under
    ``bert.`` and the (hidden -> 2) span head."""
    return bert_shapes(b, "bert.") + [
        ("qa_outputs.weight", (2, b["hidden_size"])),
        ("qa_outputs.bias", (2,))]


def draw(shapes: List[Tuple[str, tuple]], seed: int, device,
         dtype: torch.dtype, std: float = 0.02) -> Dict[str, torch.Tensor]:
    """One f32 normal draw for all parameters from ``seed`` on ``device``,
    scaled by kind (``std``: the configuration's ``initializer_range``),
    rounded once to ``dtype``; each parameter a view of one buffer."""
    sizes = [int(torch.Size(s).numel()) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed % (2**63))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for (name, shape), size in zip(shapes, sizes):
        part = flat[at: at + size]
        if name.endswith("ln.weight"):
            part.mul_(0.1).add_(1.0)
        else:
            part.mul_(std)
        at += size
        out[name] = part
    buf = flat.to(dtype)
    del flat
    at = 0
    for (name, shape), size in zip(shapes, sizes):
        out[name] = buf[at: at + size].view(shape)
        at += size
    return out


def stream_seed(seed: int, stream: int) -> int:
    """A seed of its own for each thing drawn from one run seed."""
    return (seed * 1_000_003 + stream * 7919 + 17) % (2**62)
