"""Extractive reader: Multi-passage BERT + span extraction (counterpart of
viquae_tpu/models/qa.py).

- :func:`get_best_spans`: pairwise start (x) end scores, upper triangle,
  CLS ban, optional IR-score weighting (>1), best passage then best span —
  tensor ops on the inputs' device, no host round trip.
- :func:`reader_apply` — MultiPassageBERT: BERT + span head over (N*M, L)
  passages, global softmax across the M passages of each question via
  train.optim.multi_passage_rc_loss, optional learned IR-score fusion
  (score_proj w/b). :func:`reader_apply_packed` runs the same model on a
  packed canvas at the pairs' real lengths.

- :func:`eca_reader_apply` — MultiPassageECA: the same span head and
  global softmax over the TEXT part of an ECA sequence (``mm.eca_apply``,
  visual tokens appended after the text).

:class:`Reader` holds the weights (``bert``, ``qa_outputs``,
``score_proj_w``/``score_proj_b``), named as the JAX reader tree;
:class:`ECAReader` ECA's weights plus ``qa_outputs``. The mesh param
spec is listed in ROADMAP.md (A17b-2).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from viquae_torch.core.config import register as _register
from viquae_torch.models import bert
from viquae_torch.models import layers as L
from viquae_torch.models import mm
from viquae_torch.models.outputs import ReaderOutput
from viquae_torch.train.optim import multi_passage_rc_loss


@dataclasses.dataclass(frozen=True)
class ReaderConfig:
    bert: bert.BertConfig = dataclasses.field(
        default_factory=lambda: bert.BertConfig(add_pooler=False)
    )
    fuse_ir_score: bool = False


class Reader(nn.Module):
    """The reader's weights: ``bert`` encoder, ``qa_outputs`` span head
    (hidden -> 2) and, with ``fuse_ir_score``, the identity-initialised
    ``score_proj_w`` (1, 1) / ``score_proj_b`` (1,)."""

    def __init__(self, cfg: ReaderConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.bert = bert.Bert(cfg.bert, **factory)
        self.qa_outputs = L.dense_init(cfg.bert.hidden_size, 2, **factory)
        if cfg.fuse_ir_score:
            self.score_proj_w = nn.Parameter(torch.ones((1, 1), **factory))
            self.score_proj_b = nn.Parameter(torch.zeros((1,), **factory))

    def forward(self, input_ids, **kw):
        return reader_apply(self, self.cfg, input_ids, **kw)


def param_spec(cfg: ReaderConfig) -> dict:
    """The BERT tensor-parallel over ``model`` (``bert.param_spec``); the
    span head and the IR-score fusion scalars replicated."""
    spec = {"bert": bert.param_spec(cfg.bert), "qa_outputs": L.dense_spec()}
    if cfg.fuse_ir_score:
        spec["score_proj_w"] = spec["score_proj_b"] = None
    return spec


def init(cfg: ReaderConfig, seed: int = 0, device=None) -> Reader:
    """Seeded random reader on ``device`` (default: the GPU) from the JAX
    ``init``'s distribution (truncated normal, std 0.02; identity
    ``score_proj_w/b``), not its values."""
    model = L.seeded(Reader, cfg, seed=seed, device=device, truncated=True)
    if cfg.fuse_ir_score:
        with torch.no_grad():
            model.score_proj_w.fill_(1.0)
            model.score_proj_b.zero_()
    return model


def load_reader(cfg: ReaderConfig, tensors, device, dtype) -> Reader:
    """A :class:`Reader` on ``device`` holding ``tensors`` (its state-dict
    names) in ``dtype``; absent ``score_proj_*`` keep their identity
    initialisation. The weights do not require grad."""
    from viquae_torch.models.convert import load_module

    with torch.device("meta"):
        model = Reader(cfg)
    tensors = dict(tensors)
    if cfg.fuse_ir_score:
        tensors.setdefault("score_proj_w", torch.ones((1, 1)))
        tensors.setdefault("score_proj_b", torch.zeros((1,)))
    return load_module(model, tensors, device, dtype)


def params_from_hf(state_dict, cfg: ReaderConfig, prefix: str = "",
                   device=None, dtype: torch.dtype = torch.float32
                   ) -> Reader:
    """Port a torch ``MultiPassageBERT`` / ``BertForQuestionAnswering``
    state_dict (``bert.*`` encoder + ``qa_outputs`` span head, optional
    ``score_proj_w``/``score_proj_b``) into a :class:`Reader` — the entry
    point for the reference's released reader checkpoints and any locally
    fine-tuned ViQuAE reader."""
    tensors = {
        f"bert.{name}": t for name, t in bert.state_dict_from_hf(
            state_dict, cfg.bert, prefix=prefix + "bert.").items()}
    for name in ("qa_outputs.weight", "qa_outputs.bias"):
        tensors[name] = state_dict[prefix + name]
    if cfg.fuse_ir_score and (prefix + "score_proj_w") in state_dict:
        # absent when fine-tuning the fused variant from a non-fused
        # checkpoint — the identity parameters are seeded then
        tensors["score_proj_w"] = state_dict[prefix + "score_proj_w"]
        tensors["score_proj_b"] = state_dict[prefix + "score_proj_b"]
    return load_reader(cfg, tensors, device, dtype)


def params_from_pretrained_dir(path, cfg: Optional[ReaderConfig] = None,
                               device=None,
                               dtype: torch.dtype = torch.float32
                               ) -> Tuple[Reader, ReaderConfig]:
    """Load an HF ``save_pretrained`` reader dir (config.json +
    pytorch_model.bin / model.safetensors) and port it. Returns
    ``(reader, cfg)``; when ``cfg`` is None the BertConfig is derived from
    the dir's config.json so any released checkpoint ports unmodified."""
    if cfg is None:
        with open(os.path.join(str(path), "config.json")) as f:
            hf_cfg = json.load(f)
        cfg = ReaderConfig(bert=bert.BertConfig.from_hf(
            hf_cfg, add_pooler=False))
    # raw state-dict load: the fused variant's score_proj_w/b are
    # unexpected keys to HF's from_pretrained and would be dropped there
    sd = bert.load_hf_state_dict(path)
    return params_from_hf(sd, cfg, device=device, dtype=dtype), cfg


def _fuse_ir_score(params: Reader, passage_scores: torch.Tensor
                   ) -> torch.Tensor:
    """(N*M,) retrieval scores -> (N*M, 1) f32 logit offsets: the
    (N*M, 1) x (1, 1) product of the reference, as a multiply-add."""
    return (passage_scores.float()[:, None] * params.score_proj_w.float()
            + params.score_proj_b.float())


def reader_output(start_logits, end_logits, start_positions, end_positions,
                  answer_mask, m_passages) -> ReaderOutput:
    """The reader's output: logits, and with answer positions the global
    multi-passage loss and log-probs (``multi_passage_rc_loss``)."""
    loss = start_lp = end_lp = None
    if start_positions is not None and end_positions is not None:
        nm = start_logits.shape[0]
        loss, start_lp, end_lp = multi_passage_rc_loss(
            start_logits, end_logits,
            start_positions.reshape(nm, -1),
            end_positions.reshape(nm, -1),
            answer_mask.reshape(nm, -1),
            m_passages=m_passages,
        )
    return ReaderOutput(
        loss=loss,
        start_logits=start_logits,
        end_logits=end_logits,
        start_log_probs=start_lp,
        end_log_probs=end_lp,
    )


def reader_apply(
    params: Reader,
    cfg: ReaderConfig,
    input_ids: torch.Tensor,            # (N*M, L)
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    passage_scores: Optional[torch.Tensor] = None,   # (N*M,)
    start_positions: Optional[torch.Tensor] = None,  # (N*M, A) or (N, M, A)
    end_positions: Optional[torch.Tensor] = None,
    answer_mask: Optional[torch.Tensor] = None,
    m_passages: int = 24,
    compute_dtype=torch.float32,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
) -> ReaderOutput:
    bert_out = bert.apply(
        params.bert, cfg.bert, input_ids,
        attention_mask=attention_mask,
        token_type_ids=token_type_ids,
        compute_dtype=compute_dtype,
        deterministic=deterministic, generator=generator,
    )
    sequence = bert_out["last_hidden_state"]
    logits = L.dense(params.qa_outputs, sequence)  # (N*M, L, 2)
    start_logits = logits[..., 0]
    end_logits = logits[..., 1]

    if cfg.fuse_ir_score:
        assert passage_scores is not None
        fused = _fuse_ir_score(params, passage_scores)
        start_logits = start_logits + fused
        end_logits = end_logits + fused

    return reader_output(start_logits, end_logits, start_positions,
                         end_positions, answer_mask, m_passages
                         )._replace(moe_aux=bert_out.get("moe_aux"))


def reader_apply_packed(
    params: Reader,
    cfg: ReaderConfig,
    input_ids: torch.Tensor,          # (R, Lc) packed canvas
    segment_ids: torch.Tensor,        # (R, Lc) packing segments (0 = pad)
    position_ids: torch.Tensor,       # (R, Lc)
    token_type_ids: torch.Tensor,     # (R, Lc) BERT A/B types on the canvas
    gather_idx: torch.Tensor,         # (N*M, L) flat canvas positions
    gather_mask: torch.Tensor,        # (N*M, L) real-token mask
    passage_scores: Optional[torch.Tensor] = None,
    start_positions: Optional[torch.Tensor] = None,
    end_positions: Optional[torch.Tensor] = None,
    answer_mask: Optional[torch.Tensor] = None,
    m_passages: int = 24,
    compute_dtype=torch.float32,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    mesh_ctx=None,
) -> ReaderOutput:
    """Packed Multi-passage BERT: (question, passage) pairs packed many-
    per-row onto one canvas (ops/packing.py — the reference's passages are
    exactly 100 tokenizer tokens, so a ~125-token pair padded to 256 wastes
    >2x encoder FLOPs). Canvas logits are gathered back to the reference's
    (N*M, L) layout via packing.gather_indices; invalid slots get a large
    negative logit so the global softmax across each question's M passages
    ignores them (the padded path instead includes pad-token logits — a
    documented, strictly-cleaner divergence).

    With a ``mesh_ctx`` whose ``data`` axis has several ranks, the canvas
    rows are split over it (a pair never spans two rows): each rank
    encodes its rows and the canvas logits are gathered back in order
    (core/mesh.py), as the reference shards the canvas over ``data``; the
    encoder runs marked as this rank's block of the canvas
    (``core.mesh.row_block``), so that MoE layers group the whole
    canvas's tokens.
    """
    n_rows = input_ids.shape[0]
    scope = contextlib.nullcontext()
    if mesh_ctx is not None:
        from viquae_torch.core import mesh as meshlib

        input_ids, segment_ids, position_ids, token_type_ids = (
            meshlib.split_rows(mesh_ctx, t) for t in (
                input_ids, segment_ids, position_ids, token_type_ids))
        scope = meshlib.rows_scope(mesh_ctx, n_rows)
    with scope:
        bert_out = bert.apply(
            params.bert, cfg.bert, input_ids,
            token_type_ids=token_type_ids,
            position_ids=position_ids,
            segment_ids=segment_ids,
            compute_dtype=compute_dtype,
            deterministic=deterministic, generator=generator,
        )
    sequence = bert_out["last_hidden_state"]     # (R, Lc, D)
    logits = L.dense(params.qa_outputs, sequence)  # (R, Lc, 2)
    if mesh_ctx is not None:
        logits = meshlib.gather_rows(mesh_ctx, logits, n_rows)
    flat = logits.reshape(-1, 2)
    # masked-out entries point at canvas position 0 and get the fill, made
    # in the logits' dtype by a fill kernel: a scalar tensor copied from the
    # host would make this thread wait for the whole forward
    picked = flat[gather_idx.long()]             # (N*M, L, 2)
    invalid = ~gather_mask.bool()
    start_logits = picked[..., 0].masked_fill(invalid, -1e30)
    end_logits = picked[..., 1].masked_fill(invalid, -1e30)

    if cfg.fuse_ir_score:
        assert passage_scores is not None
        fused = _fuse_ir_score(params, passage_scores)
        start_logits = (start_logits + fused).masked_fill(invalid, -1e30)
        end_logits = (end_logits + fused).masked_fill(invalid, -1e30)

    return reader_output(start_logits, end_logits, start_positions,
                         end_positions, answer_mask, m_passages
                         )._replace(moe_aux=bert_out.get("moe_aux"))


class ECAReader(mm.ECA):
    """MultiPassageECA's weights: ECA's plus the ``qa_outputs`` span
    head."""

    def __init__(self, cfg: mm.MMConfig, **factory):
        super().__init__(cfg, **factory)
        self.qa_outputs = L.dense_init(cfg.bert.hidden_size, 2, **factory)


def eca_reader_init(mm_cfg: mm.MMConfig, seed: int = 0,
                    device=None) -> ECAReader:
    """Seeded random MultiPassageECA on ``device`` (default: the GPU),
    gates at 0 (``mm.init``)."""
    assert not mm_cfg.no_text, "no_text is only for IR"
    return mm.init(ECAReader, mm_cfg, seed, device)


def eca_reader_apply(
    params: ECAReader,
    mm_cfg: mm.MMConfig,
    text_inputs,
    face_inputs,
    image_inputs=None,
    start_positions: Optional[torch.Tensor] = None,  # (N*M, A) or (N, M, A)
    end_positions: Optional[torch.Tensor] = None,
    answer_mask: Optional[torch.Tensor] = None,
    m_passages: int = 24,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    compute_dtype=torch.float32,
) -> ReaderOutput:
    """Span extraction over the TEXT portion of the ECA sequence with the
    global multi-passage softmax: logits (N*M, Lt) for Lt =
    ``text_inputs["input_ids"].shape[1]``."""
    out = mm.eca_apply(params, mm_cfg, text_inputs, face_inputs,
                       image_inputs, deterministic=deterministic,
                       generator=generator, compute_dtype=compute_dtype)
    lt = text_inputs["input_ids"].shape[1]
    logits = L.dense(params.qa_outputs, out.last_hidden_state[:, :lt])
    return reader_output(logits[..., 0], logits[..., 1], start_positions,
                         end_positions, answer_mask,
                         m_passages)._replace(moe_aux=out.moe_aux)


def get_best_spans(
    start_probs: torch.Tensor,   # (N, M, L)
    end_probs: torch.Tensor,     # (N, M, L)
    weights: Optional[torch.Tensor] = None,  # (N, M), should be > 1
    cannot_be_first_token: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best (passage, start, end-exclusive) per question; ties go to the
    first maximum (lowest passage, then lowest flat span index), as
    ``torch.argmax`` and ``jnp.argmax`` both document."""
    n, m, length = start_probs.shape
    pairwise = start_probs[..., :, None] * end_probs[..., None, :]
    pairwise = torch.triu(pairwise)  # the last two axes
    if cannot_be_first_token:
        pairwise[:, :, 0, :] = 0.0
    if weights is not None:
        minimum = weights.min()
        weights = torch.where(minimum < 1, weights + 1 - minimum, weights)
        pairwise = pairwise * weights[:, :, None, None]
    flat = pairwise.reshape(n, m, length * length)
    max_per_passage = flat.amax(dim=2)
    passage_indices = max_per_passage.argmax(dim=1)
    best = flat[torch.arange(n, device=flat.device), passage_indices]
    flat_arg = best.argmax(dim=-1)
    start_indices = flat_arg // length
    end_indices = flat_arg % length + 1
    return passage_indices, start_indices, end_indices


def log_probs_to_answers(start_log_probs, end_log_probs, input_ids,
                         tokenizer, m_passages: int, weights=None):
    """Decode best spans back to answer strings."""
    start_log_probs = torch.as_tensor(start_log_probs)
    end_log_probs = torch.as_tensor(end_log_probs)
    nm, length = start_log_probs.shape
    n = nm // m_passages
    start_p = torch.exp(start_log_probs).reshape(n, m_passages, length)
    end_p = torch.exp(end_log_probs).reshape(n, m_passages, length)
    if weights is not None:
        weights = torch.as_tensor(weights, device=start_p.device)
    passage, start, end = (
        t.cpu().numpy()
        for t in get_best_spans(start_p, end_p, weights=weights))
    if isinstance(input_ids, torch.Tensor):
        input_ids = input_ids.cpu().numpy()
    ids = np.asarray(input_ids).reshape(n, m_passages, length)
    answers = []
    for i in range(n):
        span = ids[i, passage[i], start[i]: end[i]]
        answers.append(tokenizer.decode(span, skip_special_tokens=True))
    return answers


# --------------------------------------------------------------------------
# config-registry bundle (get_pretrained entry for the serving CLI)
# --------------------------------------------------------------------------
@_register("MultiPassageBERTReader")
class MultiPassageBERTReader:
    """cfg + params bundle for the extractive reader, instantiable by
    class_name via core.config.get_pretrained. Without ``params`` the
    weights are drawn from ``seed`` (models.convert.init_reader_tree)."""

    def __init__(self, cfg: Optional[ReaderConfig] = None, params=None,
                 seed: int = 0, bert_config=None,
                 fuse_ir_score: bool = False, device=None,
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg = cfg or self.config(bert_config, fuse_ir_score)
        if params is None:
            from viquae_torch.models import convert

            params = convert.reader_from_jax(
                convert.init_reader_tree(cfg, seed), cfg, device=device,
                dtype=dtype)
        self.params = params

    @classmethod
    def from_pretrained(cls, path, device=None,
                        dtype: torch.dtype = torch.float32, **kwargs):
        """Load from an export_params dir (train.checkpoint contract); the
        configuration comes from ``kwargs`` as for the constructor."""
        from viquae_torch.models import convert
        from viquae_torch.train.checkpoint import import_params

        cfg = kwargs.pop("cfg", None) or cls.config(
            kwargs.pop("bert_config", None),
            kwargs.pop("fuse_ir_score", False))
        return cls(cfg=cfg, params=convert.reader_from_jax(
            import_params(path), cfg, device=device, dtype=dtype), **kwargs)

    @staticmethod
    def config(bert_config=None, fuse_ir_score: bool = False
               ) -> ReaderConfig:
        """The reader configuration of a kwargs tree (no pooler)."""
        bcfg = bert.BertConfig(**{**(bert_config or {}), "add_pooler": False})
        return ReaderConfig(bert=bcfg, fuse_ir_score=fuse_ir_score)
