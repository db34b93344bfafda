"""BERT token-classification NER — the neural option of the kilt2vqa
entity-extraction seam (counterpart of viquae_tpu/models/ner.py).

A BERT encoder with a token-classification head (HF
``BertForTokenClassification`` weight-portable, e.g. CoNLL-03 checkpoints
like dslim/bert-base-NER), BIO decoding back to character spans, and a
:class:`NeuralNER` callable that satisfies kilt2vqa's
``ner_fn(text) -> [(span, start, end, label)]`` contract. :class:`NER`
holds the weights named as the JAX tree (``bert``, ``classifier``).

Inference pads every batch to ``batch_size`` rows of ``max_length``
tokens (one shape for every call, as the JAX package's one compiled
program) and runs the encoder in bf16 with f32 logits by default. The
mesh ``param_spec`` is listed in ROADMAP.md (A17b-2).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from viquae_torch.core.device import resolve_device, upload
from viquae_torch.models import bert
from viquae_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class NERConfig:
    bert: bert.BertConfig = dataclasses.field(
        default_factory=lambda: bert.BertConfig(add_pooler=False)
    )
    num_labels: int = 9  # CoNLL-03 BIO: O + B/I x PER/ORG/LOC/MISC
    # id -> label map, HF-config compatible; BIO tags ("B-PER", "I-PER",
    # "O"). Defaults to the dslim/bert-base-NER ordering.
    id2label: Tuple[str, ...] = (
        "O", "B-MISC", "I-MISC", "B-PER", "I-PER", "B-ORG", "I-ORG",
        "B-LOC", "I-LOC",
    )


class NER(nn.Module):
    def __init__(self, cfg: NERConfig, **factory):
        super().__init__()
        self.bert = bert.Bert(cfg.bert, **factory)
        self.classifier = L.dense_init(cfg.bert.hidden_size, cfg.num_labels,
                                       **factory)


def param_spec(cfg: NERConfig) -> dict:
    """The BERT tensor-parallel over ``model``, the classifier
    replicated."""
    return {"bert": bert.param_spec(cfg.bert),
            "classifier": L.dense_spec()}


def init(cfg: NERConfig, seed: int = 0, device=None) -> NER:
    """Seeded random NER model on ``device`` (default: the GPU): the JAX
    init's distribution (truncated normal, std 0.02), not its values."""
    return L.seeded(NER, cfg, seed=seed, device=device, truncated=True)


def from_jax(tree, cfg: NERConfig, device=None,
             dtype: torch.dtype = torch.float32) -> NER:
    """The JAX ``ner.init`` tree (numpy leaves) -> :class:`NER`."""
    from viquae_torch.models import convert

    return convert.module_from_tree(NER, cfg, tree=tree, device=device,
                                    dtype=dtype)


def apply(
    params: NER,
    cfg: NERConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """(B, L) ids -> (B, L, num_labels) f32 logits (HF
    ``BertForTokenClassification.forward`` semantics: encoder -> dropout
    -> linear; dropout only with ``deterministic=False``, its seeds drawn
    from the CPU ``generator``)."""
    (seed,) = L.dropout_seeds(generator, 1, deterministic)
    out = bert.apply(params.bert, cfg.bert, input_ids,
                     attention_mask=attention_mask,
                     token_type_ids=token_type_ids,
                     deterministic=deterministic, generator=generator,
                     compute_dtype=compute_dtype)
    h = L.dropout(out["last_hidden_state"], cfg.bert.hidden_dropout_prob,
                  seed)
    return L.dense(params.classifier, h).float()


def params_from_hf(state_dict, cfg: NERConfig, device=None,
                   dtype: torch.dtype = torch.float32) -> NER:
    """Port a torch ``BertForTokenClassification`` state_dict."""
    from viquae_torch.models import convert

    tensors = {f"bert.{name}": t for name, t in bert.state_dict_from_hf(
        state_dict, cfg.bert, prefix="bert.").items()}
    for name in ("classifier.weight", "classifier.bias"):
        tensors[name] = torch.as_tensor(state_dict[name])
    with torch.device("meta"):
        module = NER(cfg)
    return convert.load_module(module, tensors, device, dtype)


def save_pretrained_hf(params: NER, cfg: NERConfig, path):
    """Write an HF ``BertForTokenClassification`` directory (config.json
    with the label maps + pytorch_model.bin) of the weights."""
    id2label = dict(enumerate(cfg.id2label))
    return bert.save_pretrained_hf(
        params.bert, cfg.bert, path, prefix="bert.",
        head={"classifier.weight": params.classifier.weight,
              "classifier.bias": params.classifier.bias},
        architectures=["BertForTokenClassification"], id2label=id2label,
        label2id={label: i for i, label in id2label.items()})


def decode_bio(
    label_ids: Sequence[int],
    offsets: Sequence[Tuple[int, int]],
    word_ids: Sequence[Optional[int]],
    id2label: Sequence[str],
    text: str,
) -> List[Tuple[str, int, int, str]]:
    """BIO tag ids over wordpieces -> character-level entity spans.

    `offsets` are the tokenizer's (start_char, end_char) per token;
    `word_ids` the fast-tokenizer word index per token (None for
    [CLS]/[SEP]/pad — excluded). HF "first" aggregation: a word takes the
    tag of its FIRST wordpiece; continuation pieces only extend the
    word's character range. An I-X without a preceding B-X/I-X opens a
    span (common in real model output).
    """
    spans: List[Tuple[str, int, int, str]] = []
    cur: Optional[List] = None  # [start, end, label]
    prev_wid: Optional[int] = None
    for lid, (s, e), wid in zip(label_ids, offsets, word_ids):
        if wid is None or s == e:
            continue
        if wid == prev_wid:
            # continuation wordpiece: if the word opened/extended a span,
            # the span covers the whole word regardless of this tag
            if cur is not None and cur[1] >= s:
                cur[1] = max(cur[1], e)
            continue
        prev_wid = wid
        tag = id2label[int(lid)]
        if tag == "O":
            if cur is not None:
                spans.append(tuple(cur))
                cur = None
            continue
        kind, _, label = tag.partition("-")
        if cur is not None and kind == "I" and cur[2] == label:
            cur[1] = e
        else:
            if cur is not None:
                spans.append(tuple(cur))
            cur = [s, e, label]
    if cur is not None:
        spans.append(tuple(cur))
    return [(text[s:e], s, e, label) for s, e, label in spans]


class NeuralNER:
    """kilt2vqa-compatible ``ner_fn`` driven by the token-classification
    model on ``device`` (default: the GPU). Pads to fixed `max_length`,
    runs `batch_size` sentences a call (the last batch padded with empty
    rows), takes the argmax of the logits and decodes BIO to char
    spans. ``compute_dtype`` is a torch dtype or its name (a config's
    ``"float32"``)."""

    def __init__(
        self,
        params: NER,
        cfg: NERConfig,
        tokenizer,
        max_length: int = 64,
        batch_size: int = 32,
        compute_dtype=torch.bfloat16,
        device=None,
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.batch_size = batch_size
        self.compute_dtype = (getattr(torch, compute_dtype)
                              if isinstance(compute_dtype, str)
                              else compute_dtype)
        self.device = resolve_device(device)
        self._params = params.to(self.device)

    @torch.no_grad()
    def _labels(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        logits = apply(self._params, self.cfg, upload(ids, self.device),
                       upload(mask, self.device),
                       compute_dtype=self.compute_dtype)
        return logits.argmax(dim=-1).cpu().numpy()

    def predict_batch(
        self, texts: Sequence[str]
    ) -> List[List[Tuple[str, int, int, str]]]:
        if not texts:
            return []
        enc = self.tokenizer(
            list(texts), padding="max_length", truncation=True,
            max_length=self.max_length, return_offsets_mapping=True,
            return_tensors="np",
        )
        out: List[List[Tuple[str, int, int, str]]] = []
        n = len(texts)
        for i0 in range(0, n, self.batch_size):
            sl = slice(i0, min(i0 + self.batch_size, n))
            ids = enc["input_ids"][sl]
            mask = enc["attention_mask"][sl]
            pad = self.batch_size - ids.shape[0]
            if pad:  # fixed dispatch shape
                ids = np.pad(ids, ((0, pad), (0, 0)))
                mask = np.pad(mask, ((0, pad), (0, 0)))
            labels = self._labels(ids, mask)
            for j, text in enumerate(list(texts)[sl]):
                out.append(
                    decode_bio(
                        labels[j],
                        enc["offset_mapping"][i0 + j],
                        enc.word_ids(i0 + j),
                        self.cfg.id2label,
                        text,
                    )
                )
        return out

    def __call__(self, text: str) -> List[Tuple[str, int, int, str]]:
        return self.predict_batch([text])[0]


def config_from_hf(hf_config) -> NERConfig:
    """Build NERConfig from an HF BertForTokenClassification config."""
    raw = hf_config.id2label  # int keys in-process, str keys from JSON
    id2label = tuple(
        raw[i] if i in raw else raw[str(i)] for i in range(len(raw))
    )
    return NERConfig(
        bert=bert.BertConfig.from_hf(hf_config, add_pooler=False),
        num_labels=hf_config.num_labels,
        id2label=id2label,
    )
