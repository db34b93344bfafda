"""DPR question/context towers (counterpart of viquae_tpu/models/dpr.py).

A DPR tower is a BERT encoder whose embedding is the [CLS] hidden state
(no projection, no tanh pooler). :class:`DPREncoder` is its registry entry
(``get_pretrained("DPREncoder", ...)``): seeded weights, an export
directory of either package (``params.npz``) or a local HF DPR / BERT
directory; ``transformers`` is imported only to read the latter.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

from viquae_torch.core.config import register
from viquae_torch.core.device import resolve_device
from viquae_torch.models import bert
from viquae_torch.models import layers as L


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
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    remat_layers: bool = False,
) -> Dict[str, torch.Tensor]:
    """Returns {"pooler_output": (B, D) CLS embedding, "last_hidden_state"}
    and, for a MoE config, "moe_aux".
    ``deterministic`` / ``generator`` / ``remat_layers``: see
    :func:`viquae_torch.models.bert.apply`."""
    out = bert.apply(params, cfg.bert, input_ids,
                     attention_mask=attention_mask,
                     token_type_ids=token_type_ids,
                     compute_dtype=compute_dtype,
                     deterministic=deterministic, generator=generator,
                     remat_layers=remat_layers)
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
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    remat_layers: bool = False,
    return_aux: bool = False,
) -> torch.Tensor:
    """Packed-canvas forward (ops/packing.py): block-diagonal attention per
    segment; each question's embedding is its own [CLS] hidden state,
    gathered at (cls_rows, cls_cols). Returns (n_cls, D) f32; entries past
    the packer's ``n_seqs`` come from the (0, 0) pad pointer — slice them
    off. With ``return_aux``, (cls, moe_aux): the MoE load-balance term
    (None for a dense config)."""
    out = bert.apply(params, cfg.bert, input_ids,
                     position_ids=position_ids, segment_ids=segment_ids,
                     compute_dtype=compute_dtype,
                     deterministic=deterministic, generator=generator,
                     remat_layers=remat_layers)
    hidden = out["last_hidden_state"]
    cls = hidden[cls_rows.long(), cls_cols.long()]
    return (cls, out.get("moe_aux")) if return_aux else cls


def make_packed_apply(cfg: DPRConfig):
    """Bind cfg into a PackedTextEmbedder-shaped apply:
    fn(params, input_ids, segment_ids, position_ids, cls_rows, cls_cols,
    **kw) -> (n_cls, D)."""
    def fn(params, input_ids, segment_ids, position_ids, cls_rows, cls_cols,
           **kw):
        return apply_packed(params, cfg, input_ids, segment_ids,
                            position_ids, cls_rows, cls_cols, **kw)
    return fn


def param_spec(cfg: DPRConfig) -> dict:
    """Tensor parallelism of the tower: ``bert.param_spec``."""
    return bert.param_spec(cfg.bert)


def init(cfg: DPRConfig, seed: int = 0, device=None) -> bert.Bert:
    """Seeded random tower on ``device`` (default: the GPU), drawn with a
    ``torch.Generator`` from the JAX ``init``'s distribution (truncated
    normal, std 0.02), not its values."""
    return L.seeded(bert.Bert, cfg.bert, seed=seed, device=device,
                    truncated=True)


def params_from_hf_dpr(state_dict, cfg: DPRConfig, device=None,
                       dtype: torch.dtype = torch.float32) -> bert.Bert:
    """Port HF DPRQuestionEncoder / DPRContextEncoder (or bare BERT)
    weights; the prefix ("question_encoder.bert_model.",
    "ctx_encoder.bert_model.", "bert_model." or none) is detected."""
    for prefix in ("question_encoder.bert_model.", "ctx_encoder.bert_model.",
                   "bert_model.", ""):
        if (prefix + "embeddings.word_embeddings.weight") in state_dict:
            sd = bert.state_dict_from_hf(state_dict, cfg.bert, prefix=prefix)
            break
    else:
        raise ValueError("Unrecognized DPR state_dict layout")
    with torch.device("meta"):
        model = bert.Bert(cfg.bert)
    if "pooler.weight" not in sd:
        model.pooler = None
    model.load_state_dict(
        {name: t.to(device=resolve_device(device), dtype=dtype)
         for name, t in sd.items()}, strict=True, assign=True)
    return model.requires_grad_(False).eval()


@register("DPREncoder")
class DPREncoder:
    """Config-registry entry: a DPR tower bundling (cfg, params). Without
    ``params`` the weights are drawn from ``seed`` (:func:`init`);
    ``from_pretrained`` reads an export directory or a local HF model
    directory, never the hub."""

    def __init__(self, cfg: Optional[DPRConfig] = None, params=None,
                 seed: int = 0, bert_config: Optional[dict] = None,
                 device=None):
        if cfg is None:
            # JSON/YAML configs size the tower via a nested bert dict
            cfg = (DPRConfig(bert=bert.BertConfig(**bert_config))
                   if bert_config is not None else DPRConfig())
        self.cfg = cfg
        self.params = (params if params is not None
                       else init(cfg, seed, device))

    @classmethod
    def from_pretrained(cls, path, device=None, **kwargs):
        if os.path.exists(os.path.join(str(path), "params.npz")):
            # an export_params dir (train/checkpoint.py); cfg from kwargs
            from viquae_torch.models import convert
            from viquae_torch.train.checkpoint import import_params

            cfg = kwargs.pop("cfg", None) or DPRConfig(bert=bert.BertConfig(
                **kwargs.pop("bert_config", None) or {}))
            params = convert.params_from_jax(import_params(path), cfg,
                                             device=device)
            return cls(cfg=cfg, params=params, **kwargs)
        from transformers import AutoConfig, AutoModel

        hf_cfg = AutoConfig.from_pretrained(path, local_files_only=True)
        if not hasattr(hf_cfg, "hidden_size"):
            raise ValueError(
                f"{path}: config type {type(hf_cfg).__name__} has no "
                "hidden_size — expected a BERT-family encoder config")
        cfg = DPRConfig(bert=bert.BertConfig.from_hf(hf_cfg,
                                                     add_pooler=False))
        model = AutoModel.from_pretrained(path, local_files_only=True,
                                          torch_dtype=torch.float32)
        return cls(cfg=cfg, params=params_from_hf_dpr(model.state_dict(),
                                                      cfg, device=device))

    def __call__(self, input_ids, attention_mask=None, **kw):
        return apply(self.params, self.cfg, input_ids, attention_mask, **kw)

    def apply_fn(self, params, input_ids, attention_mask=None, **kw):
        """Apply over externally held params (the embedders' contract)."""
        return apply(params, self.cfg, input_ids, attention_mask, **kw)

    def packed_apply_fn(self, params, input_ids, segment_ids, position_ids,
                        cls_rows, cls_cols, **kw):
        """Packed-canvas apply: (n_cls, D) CLS embeddings."""
        return apply_packed(params, self.cfg, input_ids, segment_ids,
                            position_ids, cls_rows, cls_cols, **kw)
