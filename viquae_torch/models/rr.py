"""Cross-encoder re-rankers (counterpart of viquae_tpu/models/rr.py).

Each scores a (question [SEP] passage) pair with one logit; training
reshapes the (N*M,) logits to (N, M) for the CE objective
(train.objectives.reranker_loss). :class:`BertReRanker` reads the BERT
[CLS] representation; :class:`ECAReRanker` and :class:`FlamantReRanker`
read the pooled output of the ported multimodal encoders
(``mm.eca_apply`` / ``mm.flamant_apply``, visual tokens included). Each
holds its weights named as the JAX tree (the encoder's, plus
``classifier``), so ``mm.from_jax`` / ``convert.module_from_tree`` load
them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from viquae_torch.models import bert
from viquae_torch.models import layers as L
from viquae_torch.models import mm
from viquae_torch.models.outputs import ReRankerOutput


@dataclasses.dataclass(frozen=True)
class BertReRankerConfig:
    bert: bert.BertConfig = dataclasses.field(
        default_factory=lambda: bert.BertConfig(add_pooler=False)
    )


class BertReRanker(nn.Module):
    def __init__(self, cfg: BertReRankerConfig, **factory):
        super().__init__()
        self.bert = bert.Bert(cfg.bert, **factory)
        self.classifier = L.dense_init(cfg.bert.hidden_size, 1, **factory)


def bert_reranker_init(cfg: BertReRankerConfig, seed: int = 0,
                       device=None) -> BertReRanker:
    """Seeded random re-ranker on ``device`` (default: the GPU), from the
    JAX init's distribution (truncated normal, std 0.02)."""
    return L.seeded(BertReRanker, cfg, seed=seed, device=device,
                    truncated=True)


def bert_reranker_apply(params: BertReRanker, cfg: BertReRankerConfig,
                        input_ids, attention_mask=None, token_type_ids=None,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None,
                        compute_dtype=torch.float32) -> ReRankerOutput:
    out = bert.apply(params.bert, cfg.bert, input_ids,
                     attention_mask=attention_mask,
                     token_type_ids=token_type_ids,
                     deterministic=deterministic, generator=generator,
                     compute_dtype=compute_dtype)
    logits = L.dense(params.classifier, out["last_hidden_state"][:, 0])
    return ReRankerOutput(logits=logits[..., 0], moe_aux=out.get("moe_aux"))


def bert_reranker_apply_packed(params: BertReRanker, cfg: BertReRankerConfig,
                               input_ids, segment_ids, position_ids,
                               token_type_ids, cls_rows, cls_cols,
                               deterministic: bool = True,
                               generator: Optional[torch.Generator] = None,
                               compute_dtype=torch.float32
                               ) -> ReRankerOutput:
    """Packed cross-encoder: pairs packed many-per-row (ops/packing.py);
    each pair's logit comes from its own [CLS] at (cls_rows, cls_cols)."""
    out = bert.apply(params.bert, cfg.bert, input_ids,
                     token_type_ids=token_type_ids,
                     position_ids=position_ids, segment_ids=segment_ids,
                     deterministic=deterministic, generator=generator,
                     compute_dtype=compute_dtype)
    cls = out["last_hidden_state"][cls_rows.long(), cls_cols.long()]
    logits = L.dense(params.classifier, cls)
    return ReRankerOutput(logits=logits[..., 0], moe_aux=out.get("moe_aux"))


# --------------------------------------------------------------------------
# multimodal re-rankers
# --------------------------------------------------------------------------
class ECAReRanker(mm.ECA):
    """ECA's weights plus the one-logit ``classifier``."""

    def __init__(self, cfg: mm.MMConfig, **factory):
        super().__init__(cfg, **factory)
        self.classifier = L.dense_init(cfg.bert.hidden_size, 1, **factory)


class FlamantReRanker(mm.Flamant):
    """Flamant's weights plus the one-logit ``classifier``."""

    def __init__(self, cfg: mm.FlamantConfig, **factory):
        super().__init__(cfg, **factory)
        self.classifier = L.dense_init(cfg.bert.hidden_size, 1, **factory)


def eca_reranker_init(cfg: mm.MMConfig, seed: int = 0,
                      device=None) -> ECAReRanker:
    """Seeded random ECA re-ranker on ``device`` (default: the GPU), its
    gates at 0 as the JAX init sets them (``mm.init``)."""
    return mm.init(ECAReRanker, cfg, seed, device)


def eca_reranker_apply(params: ECAReRanker, cfg: mm.MMConfig, text_inputs,
                       face_inputs, image_inputs=None,
                       deterministic: bool = True,
                       generator: Optional[torch.Generator] = None,
                       compute_dtype=torch.float32) -> ReRankerOutput:
    out = mm.eca_apply(params, cfg, text_inputs, face_inputs, image_inputs,
                       deterministic=deterministic, generator=generator,
                       compute_dtype=compute_dtype)
    logits = L.dense(params.classifier, out.pooler_output)
    return ReRankerOutput(logits=logits[..., 0], moe_aux=out.moe_aux)


def flamant_reranker_init(cfg: mm.FlamantConfig, seed: int = 0,
                          device=None) -> FlamantReRanker:
    return mm.init(FlamantReRanker, cfg, seed, device)


def flamant_reranker_apply(params: FlamantReRanker, cfg: mm.FlamantConfig,
                           text_inputs, face_inputs, image_inputs=None,
                           deterministic: bool = True, rng=None,
                           compute_dtype=torch.float32) -> ReRankerOutput:
    """Evaluation only, as ``mm.flamant_apply``."""
    out = mm.flamant_apply(params, cfg, text_inputs, face_inputs,
                           image_inputs, deterministic=deterministic,
                           rng=rng, compute_dtype=compute_dtype)
    logits = L.dense(params.classifier, out.pooler_output)
    return ReRankerOutput(logits=logits[..., 0], moe_aux=out.moe_aux)
