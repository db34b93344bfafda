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

    @classmethod
    def from_hf(cls, hf_config, add_pooler: bool = True) -> "BertConfig":
        """From an HF BERT config: the dict of a ``config.json`` or an
        object with the same attributes."""
        get = (hf_config.__getitem__ if isinstance(hf_config, dict)
               else lambda name: getattr(hf_config, name))
        names = ("vocab_size", "hidden_size", "num_hidden_layers",
                 "num_attention_heads", "intermediate_size",
                 "max_position_embeddings", "type_vocab_size", "hidden_act",
                 "layer_norm_eps")
        return cls(**{name: get(name) for name in names},
                   add_pooler=add_pooler)


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
    output_hidden_states: bool = False,
):
    """Encoder stack over (B, L, D) hidden states. ``segment_ids`` (B, L),
    0 = padding: packed-canvas mode — attention is block-diagonal per
    segment, overriding ``attention_mask``. With ``output_hidden_states``
    returns (final, [embedding_out, layer1_out, ...])."""
    b, l = hidden.shape[:2]
    if segment_ids is not None:
        bias = L.attention_bias_from_segments(segment_ids)
    else:
        if attention_mask is None:
            attention_mask = torch.ones((b, l), device=hidden.device)
        bias = L.attention_bias_from_mask(attention_mask)
    x = hidden
    all_hidden = [x]
    for layer in params.layers:
        x = _layer_forward(layer, x, bias, cfg, compute_dtype)
        if output_hidden_states:
            all_hidden.append(x)
    return (x, all_hidden) if output_hidden_states else x


def apply(
    params: Bert,
    cfg: BertConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    segment_ids: Optional[torch.Tensor] = None,
    output_hidden_states: bool = False,
) -> Dict[str, torch.Tensor]:
    """embed -> encode -> optional tanh pooler.

    Returns {"last_hidden_state": (B, L, D) f32, "pooler_output": (B, D)?}
    and, with ``output_hidden_states``, "hidden_states": [embedding_out,
    layer1_out, ...] (the per-layer seam of ``TextEmbedder(layers=...)``).
    With ``segment_ids`` pass the packer's ``position_ids`` too, so
    positions restart per segment.
    """
    x = embed(params, cfg, input_ids, token_type_ids=token_type_ids,
              position_ids=position_ids)
    x = encode(params, cfg, x, attention_mask, compute_dtype=compute_dtype,
               segment_ids=segment_ids,
               output_hidden_states=output_hidden_states)
    hidden_states = None
    if output_hidden_states:
        x, hidden_states = x
    out = {"last_hidden_state": x}
    if hidden_states is not None:
        out["hidden_states"] = hidden_states
    if cfg.add_pooler and params.pooler is not None:
        out["pooler_output"] = torch.tanh(L.dense(params.pooler, x[:, 0]))
    return out


def state_dict_from_hf(state_dict, cfg: BertConfig, prefix: str = ""
                       ) -> Dict[str, torch.Tensor]:
    """A torch ``BertModel`` state_dict under :class:`Bert`'s names
    (counterpart of the JAX package's ``bert.params_from_hf``; both sides
    keep dense weights (out, in), so only the names change). ``prefix``
    strips a wrapper path (e.g. "bert.")."""
    def get(name):
        return torch.as_tensor(state_dict[prefix + name]).detach()

    out = {
        "embeddings.word.weight": get("embeddings.word_embeddings.weight"),
        "embeddings.position.weight":
            get("embeddings.position_embeddings.weight"),
        "embeddings.token_type.weight":
            get("embeddings.token_type_embeddings.weight"),
    }

    def both(ours, theirs):
        out[f"{ours}.weight"] = get(f"{theirs}.weight")
        out[f"{ours}.bias"] = get(f"{theirs}.bias")

    both("embeddings.ln", "embeddings.LayerNorm")
    for i in range(cfg.num_hidden_layers):
        base, layer = f"encoder.layer.{i}", f"layers.{i}"
        both(f"{layer}.attention.q", f"{base}.attention.self.query")
        both(f"{layer}.attention.k", f"{base}.attention.self.key")
        both(f"{layer}.attention.v", f"{base}.attention.self.value")
        both(f"{layer}.attention.o", f"{base}.attention.output.dense")
        both(f"{layer}.attention_ln", f"{base}.attention.output.LayerNorm")
        both(f"{layer}.mlp.in", f"{base}.intermediate.dense")
        both(f"{layer}.mlp.out", f"{base}.output.dense")
        both(f"{layer}.output_ln", f"{base}.output.LayerNorm")
    if cfg.add_pooler and (prefix + "pooler.dense.weight") in state_dict:
        both("pooler", "pooler.dense")
    return out
