"""BEM — BERT answer-equivalence scorer (https://arxiv.org/abs/2202.07654),
counterpart of viquae_tpu/models/bem.py.

A BERT encoder over ``[CLS] candidate [SEP] reference [SEP] question
[SEP]`` (segment ids 0/1/2) with a 2-way classification head on the
pooled output; equivalence = softmax[1] >= 0.5. :class:`BEM` holds the
weights named as the JAX tree (``bert``, ``head``), so
``convert.module_from_tree`` (:func:`from_jax`) loads an export of either
package; :func:`params_from_state_dict` ports a
``BertForSequenceClassification``-layout checkpoint (the public BEM
export's shape). :class:`BEMScorer` is the callable the Encyclopedic-VQA
protocol (data/evqa.py) takes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from viquae_torch.core.device import resolve_device, upload
from viquae_torch.models import bert
from viquae_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class BEMConfig:
    # BEM's canonical encoder is bert-base-uncased with 3 segment types
    bert: bert.BertConfig = dataclasses.field(
        default_factory=lambda: bert.BertConfig(
            type_vocab_size=3, add_pooler=True
        )
    )
    max_length: int = 512
    num_classes: int = 2


class BEM(nn.Module):
    def __init__(self, cfg: BEMConfig, **factory):
        super().__init__()
        self.bert = bert.Bert(cfg.bert, **factory)
        self.head = L.dense_init(cfg.bert.hidden_size, cfg.num_classes,
                                 **factory)


def init(cfg: BEMConfig, seed: int = 0, device=None) -> BEM:
    """Seeded random BEM on ``device`` (default: the GPU): the JAX init's
    distribution (truncated normal, std 0.02), not its values."""
    return L.seeded(BEM, cfg, seed=seed, device=device, truncated=True)


def from_jax(tree, cfg: BEMConfig, device=None,
             dtype: torch.dtype = torch.float32) -> BEM:
    """The JAX ``bem.init`` tree (numpy leaves; an export directory read
    by ``train.checkpoint.import_params``) -> :class:`BEM`."""
    from viquae_torch.models import convert

    return convert.module_from_tree(BEM, cfg, tree=tree, device=device,
                                    dtype=dtype)


def apply(params: BEM, cfg: BEMConfig, input_ids, segment_ids,
          attention_mask, deterministic: bool = True,
          generator: Optional[torch.Generator] = None,
          compute_dtype=torch.float32) -> torch.Tensor:
    """Returns (B, num_classes) logits. ``segment_ids`` here are BERT
    token_type ids (0=candidate, 1=reference, 2=question), NOT the packing
    segments."""
    out = bert.apply(params.bert, cfg.bert, input_ids,
                     attention_mask=attention_mask,
                     token_type_ids=segment_ids,
                     deterministic=deterministic, generator=generator,
                     compute_dtype=compute_dtype)
    pooled = out.get("pooler_output", out["last_hidden_state"][:, 0])
    return L.dense(params.head, pooled)


def params_from_state_dict(state_dict, cfg: BEMConfig,
                           bert_prefix: str = "bert.",
                           head_prefix: str = "classifier.", device=None,
                           dtype: torch.dtype = torch.float32) -> BEM:
    """Port a BertForSequenceClassification-layout checkpoint (the public
    BEM export shape) into a :class:`BEM` on ``device``."""
    from viquae_torch.models import convert

    tensors = {f"bert.{name}": t for name, t in bert.state_dict_from_hf(
        state_dict, cfg.bert, prefix=bert_prefix).items()}
    tensors["head.weight"] = torch.as_tensor(
        state_dict[head_prefix + "weight"])
    tensors["head.bias"] = torch.as_tensor(state_dict[head_prefix + "bias"])
    with torch.device("meta"):
        module = BEM(cfg)
    return convert.load_module(module, tensors, device, dtype)


def combine_segments(candidate_ids: List[int], reference_ids: List[int],
                     question_ids: List[int], cls_id: int, sep_id: int,
                     max_length: int = 512
                     ) -> Dict[str, np.ndarray]:
    """tf.text.combine_segments parity (meerqat/data/evqa.py:330-333):
    [CLS] cand [SEP] ref [SEP] question [SEP] with segment ids 0/1/2,
    zero-padded to max_length."""
    ids = [cls_id] + list(candidate_ids) + [sep_id]
    segs = [0] * len(ids)
    ids += list(reference_ids) + [sep_id]
    segs += [1] * (len(reference_ids) + 1)
    ids += list(question_ids) + [sep_id]
    segs += [2] * (len(question_ids) + 1)
    ids, segs = ids[:max_length], segs[:max_length]
    mask = [1] * len(ids)
    pad = max_length - len(ids)
    return {
        "input_ids": np.asarray(ids + [0] * pad, np.int32),
        "segment_ids": np.asarray(segs + [0] * pad, np.int32),
        "attention_mask": np.asarray(mask + [0] * pad, np.int32),
    }


class BEMScorer:
    """Callable scorer: example dict -> equivalence probability.

    tokenizer: an HF BertTokenizerFast (offline vocab works); examples are
    dicts with 'question', 'reference', 'candidate'. The model runs on
    ``device`` (default: the GPU); without ``params`` its weights are
    drawn from ``seed`` (:func:`init`).
    """

    def __init__(self, cfg: Optional[BEMConfig] = None, params=None,
                 tokenizer=None, seed: int = 0, max_length: int = 128,
                 device=None):
        self.cfg = cfg or BEMConfig(max_length=max_length)
        self.device = resolve_device(device)
        if tokenizer is None:
            raise ValueError(
                "BEMScorer requires a tokenizer (BertTokenizerFast with "
                "[CLS]/[SEP] in its vocab)"
            )
        self.params = (params.to(self.device) if params is not None
                       else init(self.cfg, seed, self.device))
        self.tokenizer = tokenizer
        self.max_length = min(max_length, self.cfg.max_length)
        cls_sep = tokenizer.convert_tokens_to_ids(["[CLS]", "[SEP]"])
        self.cls_id, self.sep_id = int(cls_sep[0]), int(cls_sep[1])

    def _encode(self, text: str) -> List[int]:
        return self.tokenizer(text, add_special_tokens=False)["input_ids"]

    @torch.no_grad()
    def score(self, examples: List[dict]) -> np.ndarray:
        rows = [
            combine_segments(
                self._encode(e["candidate"]), self._encode(e["reference"]),
                self._encode(e["question"]), self.cls_id, self.sep_id,
                self.max_length,
            )
            for e in examples
        ]
        batch = {
            k: upload(np.stack([r[k] for r in rows]), self.device)
            for k in ("input_ids", "segment_ids", "attention_mask")
        }
        logits = apply(self.params, self.cfg, batch["input_ids"],
                       batch["segment_ids"], batch["attention_mask"])
        return torch.softmax(logits, dim=-1)[:, 1].cpu().numpy()

    def __call__(self, example: dict, threshold_score: bool = True):
        score = float(self.score([example])[0])
        return float(score >= 0.5) if threshold_score else score
