"""BERT encoder (post-LN), counterpart of viquae_tpu/models/bert.py.

:class:`Bert` holds the weights in the JAX package's tree layout
(``embeddings.{word,position,token_type,ln}``, ``layers[i].{attention.
{q,k,v,o}, attention_ln, mlp.{in,out}, output_ln}``, ``pooler``) so that
:func:`viquae_torch.models.convert.params_from_jax` maps names one to one;
:func:`apply` is the forward. Dense FFN only; evaluation only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from viquae_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-12
    add_pooler: bool = True


class Bert(nn.Module):
    """BERT weights in the JAX param-tree layout; ``forward`` is
    :func:`apply`."""

    def __init__(self, cfg: BertConfig, **factory):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.embeddings = nn.ModuleDict({
            "word": nn.Embedding(cfg.vocab_size, h, **factory),
            "position": nn.Embedding(cfg.max_position_embeddings, h,
                                     **factory),
            "token_type": nn.Embedding(cfg.type_vocab_size, h, **factory),
            "ln": L.layer_norm_init(h, cfg.layer_norm_eps, **factory),
        })
        self.layers = nn.ModuleList([
            nn.ModuleDict({
                "attention": L.mha_init(h, **factory),
                "attention_ln": L.layer_norm_init(h, cfg.layer_norm_eps,
                                                  **factory),
                "mlp": L.mlp_init(h, cfg.intermediate_size, **factory),
                "output_ln": L.layer_norm_init(h, cfg.layer_norm_eps,
                                               **factory),
            })
            for _ in range(cfg.num_hidden_layers)
        ])
        self.pooler = (L.dense_init(h, h, **factory) if cfg.add_pooler
                       else None)

    def forward(self, input_ids, **kw):
        return apply(self, self.cfg, input_ids, **kw)


def embed(
    params: Bert,
    cfg: BertConfig,
    input_ids: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """word + position + type embeddings, summed in the PARAMETER dtype
    (as the JAX package does), then the f32 LayerNorm -> (B, L, D) f32."""
    emb = params.embeddings
    b, l = input_ids.shape
    device = input_ids.device
    if position_ids is None:
        position_ids = torch.arange(l, device=device)[None, :]
    x = (emb["word"].weight[input_ids.long()]
         + emb["position"].weight[position_ids.long()])
    if token_type_ids is None:
        token_type_ids = torch.zeros((b, l), dtype=torch.long, device=device)
    x = x + emb["token_type"].weight[token_type_ids.long()]
    return L.layer_norm(emb["ln"], x, cfg.layer_norm_eps)


def _layer_forward(layer: nn.ModuleDict, x, bias, cfg: BertConfig,
                   compute_dtype):
    """One post-LN transformer block."""
    attn = L.mha(layer["attention"], x, bias=bias,
                 n_heads=cfg.num_attention_heads, compute_dtype=compute_dtype)
    x = L.layer_norm(layer["attention_ln"], x + attn, cfg.layer_norm_eps)
    ff = L.mlp(layer["mlp"], x, cfg.hidden_act, compute_dtype)
    return L.layer_norm(layer["output_ln"], x + ff, cfg.layer_norm_eps)


def encode(
    params: Bert,
    cfg: BertConfig,
    hidden: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Encoder stack over (B, L, D) hidden states. ``segment_ids`` (B, L),
    0 = padding: packed-canvas mode — attention is block-diagonal per
    segment, overriding ``attention_mask``."""
    b, l = hidden.shape[:2]
    if segment_ids is not None:
        bias = L.attention_bias_from_segments(segment_ids)
    else:
        if attention_mask is None:
            attention_mask = torch.ones((b, l), device=hidden.device)
        bias = L.attention_bias_from_mask(attention_mask)
    x = hidden
    for layer in params.layers:
        x = _layer_forward(layer, x, bias, cfg, compute_dtype)
    return x


def apply(
    params: Bert,
    cfg: BertConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    segment_ids: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """embed -> encode -> optional tanh pooler.

    Returns {"last_hidden_state": (B, L, D) f32, "pooler_output": (B, D)?}.
    With ``segment_ids`` pass the packer's ``position_ids`` too, so
    positions restart per segment.
    """
    x = embed(params, cfg, input_ids, token_type_ids=token_type_ids,
              position_ids=position_ids)
    x = encode(params, cfg, x, attention_mask, compute_dtype=compute_dtype,
               segment_ids=segment_ids)
    out = {"last_hidden_state": x}
    if cfg.add_pooler and params.pooler is not None:
        out["pooler_output"] = torch.tanh(L.dense(params.pooler, x[:, 0]))
    return out
