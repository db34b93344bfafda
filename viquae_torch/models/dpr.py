"""DPR question/context towers (counterpart of viquae_tpu/models/dpr.py).

A DPR tower is a BERT encoder whose embedding is the [CLS] hidden state
(no projection, no tanh pooler).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from viquae_torch.models import bert


@dataclasses.dataclass(frozen=True)
class DPRConfig:
    bert: bert.BertConfig = dataclasses.field(
        default_factory=lambda: bert.BertConfig(add_pooler=False)
    )


def apply(
    params: bert.Bert,
    cfg: DPRConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
) -> Dict[str, torch.Tensor]:
    """Returns {"pooler_output": (B, D) CLS embedding, "last_hidden_state"}."""
    out = bert.apply(params, cfg.bert, input_ids,
                     attention_mask=attention_mask,
                     token_type_ids=token_type_ids,
                     compute_dtype=compute_dtype)
    out["pooler_output"] = out["last_hidden_state"][:, 0]
    return out


def apply_packed(
    params: bert.Bert,
    cfg: DPRConfig,
    input_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    position_ids: torch.Tensor,
    cls_rows: torch.Tensor,
    cls_cols: torch.Tensor,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Packed-canvas forward (ops/packing.py): block-diagonal attention per
    segment; each question's embedding is its own [CLS] hidden state,
    gathered at (cls_rows, cls_cols). Returns (n_cls, D) f32; entries past
    the packer's ``n_seqs`` come from the (0, 0) pad pointer — slice them
    off."""
    out = bert.apply(params, cfg.bert, input_ids,
                     position_ids=position_ids, segment_ids=segment_ids,
                     compute_dtype=compute_dtype)
    hidden = out["last_hidden_state"]
    return hidden[cls_rows.long(), cls_cols.long()]


def make_packed_apply(cfg: DPRConfig):
    """Bind cfg into a PackedTextEmbedder-shaped apply:
    fn(params, input_ids, segment_ids, position_ids, cls_rows, cls_cols,
    **kw) -> (n_cls, D)."""
    def fn(params, input_ids, segment_ids, position_ids, cls_rows, cls_cols,
           **kw):
        return apply_packed(params, cfg, input_ids, segment_ids,
                            position_ids, cls_rows, cls_cols, **kw)
    return fn
