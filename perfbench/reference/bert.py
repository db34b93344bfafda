"""Plain PyTorch BERT in float32 (post-LN, exact GELU, no pooler), on
padded rows with an attention mask, over the weights the benchmark drew
(``perfbench/weights.py``'s names). It imports nothing of the program.

``quant`` names a lower precision for the control: every matrix product
then takes both operands rounded to it (``fp8``: float8 e4m3 with one
scale a tensor, sums in f32), as the program takes them in bf16.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch

_F32_MIN = torch.finfo(torch.float32).min


@contextlib.contextmanager
def tf32(on: bool = False):
    """Float32 products inside the block in TF32 (``on``: the training
    cell's control) or exact, without TF32 (the reference)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rounded(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """``x`` (f32) rounded to ``quant`` and back: None leaves it, "fp8"
    rounds to float8 e4m3 under one scale that maps the largest magnitude
    to 448."""
    if quant is None:
        return x
    if quant == "fp8":
        scale = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {quant!r}")


def matmul(a: torch.Tensor, b: torch.Tensor, quant=None) -> torch.Tensor:
    return torch.matmul(rounded(a, quant), rounded(b, quant))


def linear(x, w: Dict[str, torch.Tensor], name: str, quant=None):
    return matmul(x, w[name + ".weight"].float().t(), quant) \
        + w[name + ".bias"].float()


def layer_norm(x, w, name: str, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w[name + ".weight"].float() \
        + w[name + ".bias"].float()


def encode(w: Dict[str, torch.Tensor], b: dict, ids: torch.Tensor,
           mask: torch.Tensor, token_types: Optional[torch.Tensor] = None,
           prefix: str = "", quant: Optional[str] = None) -> torch.Tensor:
    """(B, L) token ids and 0/1 mask -> (B, L, D) f32 last hidden states."""
    eps = b.get("layer_norm_eps", 1e-12)
    n_heads = b["num_attention_heads"]
    bsz, length = ids.shape
    if token_types is None:
        token_types = torch.zeros_like(ids)
    pos = torch.arange(length, device=ids.device)
    x = (w[prefix + "embeddings.word.weight"][ids.long()].float()
         + w[prefix + "embeddings.position.weight"][pos].float()[None]
         + w[prefix + "embeddings.token_type.weight"][
             token_types.long()].float())
    x = layer_norm(x, w, prefix + "embeddings.ln", eps)
    bias = ((1.0 - mask.float()) * (_F32_MIN * 0.5))[:, None, None, :]
    hd = x.shape[-1] // n_heads

    def heads(t):
        return t.reshape(bsz, length, n_heads, hd).transpose(1, 2)

    for i in range(b["num_hidden_layers"]):
        p = f"{prefix}layers.{i}."
        q, k, v = (heads(linear(x, w, p + f"attention.{n}", quant))
                   for n in ("q", "k", "v"))
        scores = matmul(q, k.transpose(-1, -2), quant) / math.sqrt(hd) + bias
        probs = torch.softmax(scores, dim=-1)
        ctx = matmul(probs, v, quant).transpose(1, 2).reshape(bsz, length, -1)
        x = layer_norm(x + linear(ctx, w, p + "attention.o", quant), w,
                       p + "attention_ln", eps)
        h = torch.nn.functional.gelu(linear(x, w, p + "mlp.in", quant))
        x = layer_norm(x + linear(h, w, p + "mlp.out", quant), w,
                       p + "output_ln", eps)
    return x


def pad_rows(seqs, device, pad_to: Optional[int] = None):
    """Lists of token ids -> (ids, mask) int64 tensors, right-padded."""
    length = pad_to or max(len(s) for s in seqs)
    ids = torch.zeros((len(seqs), length), dtype=torch.long)
    mask = torch.zeros((len(seqs), length), dtype=torch.long)
    for r, s in enumerate(seqs):
        s = list(s)[:length]
        ids[r, : len(s)] = torch.tensor(s, dtype=torch.long)
        mask[r, : len(s)] = 1
    return ids.to(device), mask.to(device)
