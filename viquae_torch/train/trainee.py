"""Trainees: model + objective + eval bundles (counterpart of
viquae_tpu/train/trainee.py).

Each trainee exposes what :class:`viquae_torch.train.trainer.Trainer`
consumes — ``params`` (a :class:`ParamTree` module named as the JAX
trainee's param tree), ``loss_fn(params, batch, generator,
deterministic=False)`` over a batch of device tensors, ``eval_fn(outputs)``
over host (numpy) outputs — plus ``export(dir)``, the save_ptm contract
(split question/context encoder export in the JAX package's
``params.npz`` format, loadable by either package).

- :class:`BiEncoderTrainee`: DPR-style dual tower, in-batch negatives;
  dense, packed and multimodal (ECA / ILF) inputs, shared encoders,
  per-layer remat;
- :class:`CrossModalTrainee`: CLIP symmetric contrastive;
- :class:`JointMonoAndCrossModalTrainee`: CLIP with weighted image-image
  and image-title similarities;
- :class:`JointBiEncoderAndClipTrainee`: text-text + image-image +
  image-title;
- :class:`ReRankerTrainee`: CE over M passage logits;
- :class:`ReaderTrainee`: the multi-passage reader with span decoding,
  squad-per-question eval, IR-score-weighted predictions, M tuning and the
  metrics.json / predictions.json files.

An encoder whose BERT has Mixture-of-Experts layers surfaces their
load-balance term; the BERT-family trainees add it to the task loss,
scaled by ``moe_aux_weight``, and report it as ``outputs["moe_aux"]``.

On a mesh the trainer hands every rank the whole global batch. Every
trainee runs its encoders on this rank's rows of their inputs
(``train.data_parallel.Rows``) and makes their per-sequence outputs
global before the objective (the pooled vectors; on a packed canvas the
CLS / ``gather_idx`` reads through pointers rebased to its rows, summed
over ``data``). Labels, pointers and per-sequence inputs are read as the
batch holds them: the objective, its in-batch negatives and its
normalisers are the global batch's, as XLA's single program makes them in
the JAX trainees. A question's M passages are read wherever their canvas
rows fall; the reader's loss runs on every passage's logits.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from viquae_torch.models import bert
from viquae_torch.models.convert import tree_from_module
from viquae_torch.train import checkpoint as ckpt_lib
from viquae_torch.train import data_parallel as dp
from viquae_torch.train import metrics as tmetrics
from viquae_torch.train import objectives


class ParamTree(nn.Module):
    """A trainee's parameters: named sub-modules (the towers) and named
    scalar parameters (fusion weights, temperatures), indexable like the
    JAX trainee's params dict (``params["question"]``)."""

    def __init__(self, modules: Dict[str, nn.Module],
                 tensors: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        for name, module in modules.items():
            self.add_module(name, module)
        for name, value in (tensors or {}).items():
            self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters

    def get(self, key: str, default=None):
        return self[key] if key in self else default


def _device_of(module: nn.Module) -> torch.device:
    return next(iter(module.parameters())).device


def _scalar(value, device, shape=()) -> torch.Tensor:
    return torch.full(shape, float(value), dtype=torch.float32,
                      device=device)


def _text_kwargs(inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    text = inputs.get("text_inputs", inputs)
    out = {
        "input_ids": text["input_ids"],
        "attention_mask": text.get("attention_mask"),
    }
    if "token_type_ids" in text:
        out["token_type_ids"] = text["token_type_ids"]
    return out


def _on_rows(fn, *inputs):
    """``fn`` on this rank's rows of ``inputs`` (trees of the global
    batch's rows): (its output, the :class:`data_parallel.Rows`)."""
    rows = dp.Rows.of(inputs[0])
    with rows.scope():
        return fn(*(rows.take(t) for t in inputs)), rows


def _export(path, module: nn.Module):
    ckpt_lib.export_params(path, tree_from_module(module))


def _moe_experts(model) -> int:
    """BertConfig.moe_experts of a trainee's encoder bundle (0 = dense)."""
    bcfg = getattr(getattr(model, "cfg", None), "bert", None)
    return getattr(bcfg, "moe_experts", 0) or 0


def _with_moe_aux(loss, outputs, aux):
    """The task loss plus the scaled load-balance term, which the outputs
    report as ``moe_aux``; unchanged for dense encoders (``aux`` None)."""
    if aux is None:
        return loss, outputs
    outputs["moe_aux"] = aux
    return loss + aux, outputs


class BiEncoderTrainee:
    """DPR-style dual tower with in-batch negatives."""

    def __init__(self, question_model, context_model=None,
                 shared_encoders: bool = False,
                 remat_layers: bool = False,
                 moe_aux_weight: float = 0.01):
        """question_model/context_model: config-registry bundles with
        .cfg, .params (a module) and apply_fn(params, ...) /
        packed_apply_fn(params, ...) — models.dpr.DPREncoder or the
        multimodal mm.ECAEncoder / mm.IntermediateLinearFusion.

        remat_layers=True checkpoints each transformer layer (the
        reference's `gradient_checkpointing: true` recipes).

        moe_aux_weight scales the MoE load-balance term added to the loss
        when an encoder has BertConfig.moe_experts > 0 (Switch
        Transformer's 1e-2): without it the experts collapse."""
        self.question_model = question_model
        self.shared_encoders = shared_encoders or context_model is None
        self.context_model = (question_model if self.shared_encoders
                              else context_model)
        self.remat_layers = remat_layers
        self.moe_aux_weight = moe_aux_weight
        modules = {"question": question_model.params}
        if not self.shared_encoders:
            modules["context"] = context_model.params
        self._params = ParamTree(modules)

    @property
    def params(self) -> ParamTree:
        return self._params

    def _encode(self, params, model, inputs, generator, deterministic):
        """(embeddings, moe_aux): moe_aux is None for a dense encoder."""
        packed_apply = getattr(model, "packed_apply_fn", None)
        kw = dict(deterministic=deterministic, generator=generator)
        if self.remat_layers:
            kw["remat_layers"] = True
        # packed applies return the embeddings alone unless asked for aux
        moe = _moe_experts(model) > 0
        packed_kw = dict(kw, return_aux=True) if moe else kw

        if "face_inputs" in inputs and not hasattr(model,
                                                    "PACKED_NEEDS_VIS"):
            # a text-only tower (DPR) given multimodal inputs — the ICT
            # context side of configs/experiments/ict/eca.yaml — reads the
            # text alone: an ECA canvas with its visual slots masked out
            # (the JAX trainee passes the visual inputs on and fails)
            text = dict(inputs["text_inputs"])
            if "canvas_vis_rows" in text:
                from viquae_torch.models.mm import mask_visual_slots

                text["canvas_segment_ids"] = mask_visual_slots(
                    text["canvas_segment_ids"], text.pop("canvas_vis_rows"),
                    text.pop("canvas_vis_cols"))
            inputs = text
        if "face_inputs" in inputs:
            # multimodal encoder inputs ({"text_inputs", "face_inputs",
            # "image_inputs"})
            text = inputs["text_inputs"]
            if "canvas_input_ids" in text and packed_apply is not None:
                # packed mm canvas: eca_apply_packed takes the visual-slot
                # pointers; ilf_apply_packed has no reserved slots
                canvas = (text["canvas_input_ids"], text["canvas_segment_ids"],
                          text["canvas_position_ids"])
                pointers = (text["canvas_cls_rows"], text["canvas_cls_cols"])
                if "canvas_vis_rows" in text:
                    pointers += (text["canvas_vis_rows"],
                                 text["canvas_vis_cols"])
                return dp.packed_read(
                    packed_apply, params, canvas, pointers,
                    inputs["face_inputs"], inputs.get("image_inputs"),
                    **packed_kw)
            out, rows = _on_rows(
                lambda t, f, i: model.apply_fn(params, t, f, i, **kw),
                _text_kwargs(inputs), inputs["face_inputs"],
                inputs.get("image_inputs"))
            return rows.gather(out.pooler_output), out.moe_aux
        if "canvas_input_ids" in inputs and packed_apply is not None:
            return dp.packed_read(
                packed_apply, params,
                (inputs["canvas_input_ids"], inputs["canvas_segment_ids"],
                 inputs["canvas_position_ids"]),
                (inputs["canvas_cls_rows"], inputs["canvas_cls_cols"]),
                **packed_kw)
        out, rows = _on_rows(lambda t: model.apply_fn(params, **t, **kw),
                             _text_kwargs(inputs))
        return rows.gather(out["pooler_output"]), out.get("moe_aux")

    def _encode_pair(self, params, batch, generator, deterministic):
        """(question embeddings, context embeddings, the scaled sum of
        their MoE terms or None)."""
        q, aux_q = self._encode(params["question"], self.question_model,
                                batch["question_inputs"], generator,
                                deterministic)
        c, aux_c = self._encode(params.get("context", params["question"]),
                                self.context_model, batch["context_inputs"],
                                generator, deterministic)
        live = [a for a in (aux_q, aux_c) if a is not None]
        return q, c, (self.moe_aux_weight * sum(live) if live else None)

    def loss_fn(self, params, batch, generator=None,
                deterministic: bool = False):
        q, c, aux = self._encode_pair(params, batch, generator,
                                      deterministic)
        return _with_moe_aux(*objectives.biencoder_loss(
            q, c, batch["labels"]), aux)

    def eval_fn(self, outputs: List[dict]) -> Dict[str, float]:
        return tmetrics.accumulate_batch_metrics([
            tmetrics.batch_retrieval(o["log_probs"], o["labels"])
            for o in outputs])

    def export(self, path, params=None, hf: bool = False):
        """Split-export the question/context towers (save_ptm contract);
        with hf=True also HF-loadable BertModel dirs."""
        params = params if params is not None else self.params
        path = Path(path)
        _export(path / "question_model", params["question"])
        if not self.shared_encoders:
            _export(path / "context_model", params["context"])
        if hf:
            bert.save_pretrained_hf(params["question"],
                                    self.question_model.cfg.bert,
                                    path / "question_model_hf")
            if not self.shared_encoders:
                bert.save_pretrained_hf(params["context"],
                                        self.context_model.cfg.bert,
                                        path / "context_model_hf")


def _l2norm(x):
    from viquae_torch.models.clip import l2norm

    return l2norm(x)


class CrossModalTrainee:
    """CLIP-style symmetric contrastive training (text <-> image)."""

    def __init__(self, text_model, vision_model,
                 logit_scale_init: float = 2.6592):
        self.text_model = text_model
        self.vision_model = vision_model
        self.logit_scale_init = logit_scale_init
        self._params = ParamTree(
            {"text": text_model.params, "vision": vision_model.params},
            {"logit_scale": _scalar(logit_scale_init,
                                    _device_of(text_model.params))})

    @property
    def params(self) -> ParamTree:
        return self._params

    def loss_fn(self, params, batch, generator=None,
                deterministic: bool = False):
        text, rows = _on_rows(lambda t: self.text_model.apply_fn(
            params["text"], **t)["text_embeds"],
            _text_kwargs(batch["text_inputs"]))
        text = rows.gather(text)
        image, rows = _on_rows(lambda px: self.vision_model.apply_fn(
            params["vision"], px)["image_embeds"], batch["pixel_values"])
        image = rows.gather(image)
        return objectives.clip_contrastive_loss(
            _l2norm(text), _l2norm(image), torch.exp(params["logit_scale"]))

    def eval_fn(self, outputs):
        return tmetrics.accumulate_batch_metrics([
            tmetrics.batch_retrieval(o["logits"],
                                     np.arange(len(o["logits"])))
            for o in outputs])


class JointMonoAndCrossModalTrainee:
    """CLIP trained with weighted image-image + image-title similarities:
    asymmetric NLL over image_weight * (q_img @ c_img.T) +
    cm_weight * (q_img @ c_title.T)."""

    def __init__(self, clip_text_model, clip_vision_model,
                 image_weight: float = 0.5, cm_weight: float = 0.5,
                 learn_weights: bool = False,
                 logit_scale_init: float = 2.6592):
        self.text_model = clip_text_model
        self.vision_model = clip_vision_model
        self.learn_weights = learn_weights
        device = _device_of(clip_text_model.params)
        self._params = ParamTree(
            {"text": clip_text_model.params,
             "vision": clip_vision_model.params},
            {"image_weight": _scalar(image_weight, device, (1,)),
             "cm_weight": _scalar(cm_weight, device, (1,)),
             "logit_scale": _scalar(logit_scale_init, device)})

    @property
    def params(self) -> ParamTree:
        return self._params

    def freeze_weights_regex(self):
        if self.learn_weights:
            return None
        return r"(image_weight|cm_weight)"

    def loss_fn(self, params, batch, generator=None,
                deterministic: bool = False):
        def image(key):
            emb, rows = _on_rows(lambda px: _l2norm(self.vision_model.apply_fn(
                params["vision"], px)["image_embeds"]), batch[key])
            return rows.gather(emb)

        q_img, c_img = image("pixel_values"), image("paired_pixel_values")
        titles, rows = _on_rows(lambda t: _l2norm(self.text_model.apply_fn(
            params["text"], **t)["text_embeds"]),
            _text_kwargs(batch["text_inputs"]))
        titles = rows.gather(titles)
        scale = torch.exp(params["logit_scale"])
        image_sim = scale * (q_img @ c_img.T)
        cm_sim = scale * (q_img @ titles.T)
        similarities = (params["image_weight"] * image_sim
                        + params["cm_weight"] * cm_sim)
        loss, log_probs = objectives._nll_from_similarities(
            similarities, batch["labels"])
        return loss, {
            "log_probs": log_probs,
            "labels": batch["labels"],
            "image_similarities": image_sim,
            "cm_similarities": cm_sim,
        }

    def eval_fn(self, outputs):
        metrics = tmetrics.accumulate_batch_metrics([
            tmetrics.batch_retrieval(o["log_probs"], o["labels"])
            for o in outputs])
        for model in ("image", "cm"):
            sub = tmetrics.accumulate_batch_metrics([
                tmetrics.batch_retrieval(o[f"{model}_similarities"],
                                         o["labels"])
                for o in outputs])
            metrics.update({f"{model}_{k}": v for k, v in sub.items()})
        return metrics

    def export(self, path, params=None):
        params = params if params is not None else self.params
        tree = {"text": tree_from_module(params["text"]),
                "vision": tree_from_module(params["vision"])}
        ckpt_lib.export_params(Path(path), tree)

        def value(name):
            return params[name].detach().cpu().numpy().astype(np.float32)

        scale = float(np.exp(value("logit_scale")))
        (Path(path) / "mm_weights.json").write_text(json.dumps({
            "image_weight": float(value("image_weight")[0]) * scale,
            "cm_weight": float(value("cm_weight")[0]) * scale,
        }))


class JointBiEncoderAndClipTrainee(BiEncoderTrainee):
    """3-way similarity: text-text + image-image + image-title, with
    learnable weights and temperature."""

    def __init__(self, question_model, context_model, clip_text_model,
                 clip_vision_model, question_weight=1 / 3, image_weight=1 / 3,
                 cm_weight=1 / 3, learn_weights: bool = False):
        super().__init__(question_model, context_model)
        self.clip_text_model = clip_text_model
        self.clip_vision_model = clip_vision_model
        self.learn_weights = learn_weights
        device = _device_of(question_model.params)
        for name, module in (("clip_text", clip_text_model.params),
                             ("clip_vision", clip_vision_model.params)):
            self._params.add_module(name, module)
        for name, value in (("question_weight", question_weight),
                            ("image_weight", image_weight),
                            ("cm_weight", cm_weight), ("temperature", 1.0)):
            self._params.register_parameter(
                name, nn.Parameter(_scalar(value, device, (1,))))

    def loss_fn(self, params, batch, generator=None,
                deterministic: bool = False):
        q, c, aux = self._encode_pair(params, batch, generator,
                                      deterministic)
        def image(key):
            emb, rows = _on_rows(lambda px: self.clip_vision_model.apply_fn(
                params["clip_vision"], px)["image_embeds"], batch[key])
            return rows.gather(emb)

        q_img = image("question_pixel_values")
        c_img = image("context_pixel_values")
        titles, rows = _on_rows(lambda t: self.clip_text_model.apply_fn(
            params["clip_text"], **t)["text_embeds"],
            _text_kwargs(batch["context_inputs"]["titles"]))
        return _with_moe_aux(*objectives.joint_mono_cross_modal_loss(
            q, c, q_img, c_img, rows.gather(titles), batch["labels"],
            params["question_weight"], params["image_weight"],
            params["cm_weight"], params["temperature"]), aux)

    def freeze_weights_regex(self) -> Optional[str]:
        """Regex freezing the fusion weights unless learn_weights."""
        if self.learn_weights:
            return None
        return r"(question_weight|image_weight|cm_weight|temperature)"


class ReRankerTrainee:
    def __init__(self, model, m_passages: int = 24,
                 moe_aux_weight: float = 0.01):
        self.model = model
        self.M = m_passages
        self.moe_aux_weight = moe_aux_weight

    @property
    def params(self):
        return self.model.params

    def loss_fn(self, params, batch, generator=None,
                deterministic: bool = False):
        packed_apply = getattr(self.model, "packed_apply_fn", None)
        kw = dict(deterministic=deterministic, generator=generator)
        if "canvas_input_ids" in batch and packed_apply is not None:
            rows_of = dp.Rows.of(batch["canvas_input_ids"])
            rows, keep = rows_of.rebase(batch["canvas_cls_rows"])
            if keep is not None:
                rows = torch.where(keep, rows, 0)
            canvas = (batch[k] for k in (
                "canvas_input_ids", "canvas_segment_ids",
                "canvas_position_ids", "canvas_token_type_ids"))
            with rows_of.scope():
                out = packed_apply(params, *map(rows_of.take, canvas), rows,
                                   batch["canvas_cls_cols"], **kw)
            scores = rows_of.combine(out.logits, keep)
        else:
            out, rows_of = _on_rows(
                lambda t: self.model.apply_fn(params, **t, **kw),
                _text_kwargs(batch))
            scores = rows_of.gather(out.logits)
        logits = scores.reshape(-1, self.M)
        loss, log_probs = objectives.reranker_loss(logits, batch["labels"])
        return _with_moe_aux(
            loss, {"log_probs": log_probs, "labels": batch["labels"],
                   "logits": logits},
            None if out.moe_aux is None else self.moe_aux_weight * out.moe_aux)

    def eval_fn(self, outputs):
        return tmetrics.accumulate_batch_metrics([
            tmetrics.batch_retrieval(o["log_probs"], o["labels"])
            for o in outputs])


def power_range(maximum: int):
    """1, 2, 4, ... up to maximum (inclusive cap)."""
    i = 0
    while True:
        p = min(2 ** i, maximum)
        yield p
        if p >= maximum:
            break
        i += 1


class ReaderTrainee:
    """Multi-passage extractive reader training + eval."""

    def __init__(self, cfg, params, tokenizer, m_passages: int = 24,
                 tune_M: bool = False, moe_aux_weight: float = 0.01):
        from viquae_torch.models import qa

        self.qa = qa
        self.cfg = cfg
        self._params = params
        self.tokenizer = tokenizer
        self.M = m_passages
        self.tune_M = tune_M
        self.moe_aux_weight = moe_aux_weight

    @property
    def params(self):
        return self._params

    def loss_fn(self, params, batch, generator=None,
                deterministic: bool = False):
        scores = (batch.get("passage_scores") if self.cfg.fuse_ir_score
                  else None)
        common = dict(m_passages=self.M, deterministic=deterministic,
                      generator=generator)
        if "canvas_input_ids" in batch:
            # packed canvas from ReaderCollator(packed=True); gather_idx
            # and the passage scores are the global batch's
            canvas = [batch[k] for k in (
                "canvas_input_ids", "canvas_segment_ids",
                "canvas_position_ids", "canvas_token_type_ids")]
            rows = dp.Rows.of(canvas[0])
            idx, keep = rows.rebase_flat(batch["gather_idx"],
                                         canvas[0].shape[1])
            with rows.scope():
                out = self.qa.reader_apply_packed(
                    params, self.cfg, *map(rows.take, canvas), idx,
                    batch["gather_mask"], passage_scores=scores, **common)
            start, end = (rows.combine(t, keep) for t in (
                out.start_logits, out.end_logits))
        else:
            inputs = {k: batch.get(k) for k in (
                "input_ids", "attention_mask", "token_type_ids")}
            out, rows = _on_rows(
                lambda t, s: self.qa.reader_apply(
                    params, self.cfg, t.pop("input_ids"), **t,
                    passage_scores=s, **common), inputs, scores)
            start, end = (rows.gather(t) for t in (
                out.start_logits, out.end_logits))
        out = self.qa.reader_output(
            start, end, batch["start_positions"], batch["end_positions"],
            batch["answer_mask"], self.M)._replace(moe_aux=out.moe_aux)
        return _with_moe_aux(
            out.loss, {"start_log_probs": out.start_log_probs,
                       "end_log_probs": out.end_log_probs},
            None if out.moe_aux is None else self.moe_aux_weight * out.moe_aux)

    # ---- evaluation ---------------------------------------------------
    def eval_fn(self, outputs: List[dict], batches: List[dict]
                ) -> Dict[str, float]:
        """Fit-time eval hook (the trainer's two-argument eval_fn): span
        log probs + host batches -> mean EM/F1, so `monitor: f1` has a
        metric to watch."""
        em: List[float] = []
        f1: List[float] = []
        for aux, batch in zip(outputs, batches):
            m = self.M
            ids = np.asarray(batch["input_ids"])
            n, length = ids.shape[0] // m, ids.shape[1]
            start_lp = np.asarray(aux["start_log_probs"]).reshape(
                n * m, length)
            end_lp = np.asarray(aux["end_log_probs"]).reshape(n * m, length)
            predictions = self.qa.log_probs_to_answers(
                start_lp, end_lp, ids.reshape(n, m, length),
                self.tokenizer, m)
            answer_strings = [
                batch["answer_strings"][i] for i in range(0, n * m, m)]
            per_q = tmetrics.squad_per_question(predictions, answer_strings)
            em.extend(per_q["exact_match"])
            f1.extend(per_q["f1"])
        return {
            "exact_match": float(np.mean(em)) if em else 0.0,
            "f1": float(np.mean(f1)) if f1 else 0.0,
        }

    def eval_batch(self, params, batch) -> dict:
        from viquae_torch.core.device import upload_batch

        with torch.no_grad():
            loss, aux = self.loss_fn(
                params, upload_batch(batch, _device_of(params)),
                deterministic=True)
        m, length = self.M, batch["input_ids"].shape[1]
        n = batch["input_ids"].shape[0] // m
        input_ids = np.asarray(batch["input_ids"]).reshape(n, m, length)
        answer_strings = [
            batch["answer_strings"][i] for i in range(0, n * m, m)]
        start_lp = aux["start_log_probs"].cpu().numpy().reshape(n, m, length)
        end_lp = aux["end_log_probs"].cpu().numpy().reshape(n, m, length)
        predictions = self.qa.log_probs_to_answers(
            start_lp.reshape(n * m, length), end_lp.reshape(n * m, length),
            input_ids, self.tokenizer, m)
        metrics = tmetrics.squad_per_question(predictions, answer_strings)
        out = {
            "loss": float(loss),
            "metrics": metrics,
            "predictions": predictions,
            "weighted_metrics": None,
            "weighted_predictions": None,
            "answer_strings": answer_strings,
            "input_ids": input_ids,
            "start_log_probs": start_lp,
            "end_log_probs": end_lp,
            "passage_scores": None,
        }
        passage_scores = batch.get("passage_scores")
        if passage_scores is not None and not self.cfg.fuse_ir_score:
            out["passage_scores"] = np.asarray(passage_scores).reshape(n, m)
            weighted = self.qa.log_probs_to_answers(
                start_lp.reshape(n * m, length),
                end_lp.reshape(n * m, length),
                input_ids, self.tokenizer, m,
                weights=torch.from_numpy(out["passage_scores"]))
            out["weighted_predictions"] = weighted
            out["weighted_metrics"] = tmetrics.squad_per_question(
                weighted, answer_strings)
        return out

    def eval_epoch_end(self, eval_outputs: List[dict]) -> dict:
        metrics = {"exact_match": [], "f1": [],
                   "weighted_exact_match": [], "weighted_f1": []}
        predictions, weighted = [], []
        for o in eval_outputs:
            for k, v in o["metrics"].items():
                metrics[k].extend(v)
            predictions.extend(o["predictions"])
            if o["weighted_metrics"] is not None:
                for k, v in o["weighted_metrics"].items():
                    metrics["weighted_" + k].extend(v)
                weighted.extend(o["weighted_predictions"])
        agg = {
            k: (sum(v) / len(v) if v else None) for k, v in metrics.items()
        }
        return {"metrics": agg, "predictions": predictions,
                "weighted_predictions": weighted}

    def test(self, params, eval_batches, log_dir) -> dict:
        """Full test pass emitting metrics.json / predictions.json."""
        outputs = [self.eval_batch(params, b) for b in eval_batches]
        result = self.eval_epoch_end(outputs)
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        (log_dir / "metrics.json").write_text(json.dumps(result["metrics"]))
        (log_dir / "predictions.json").write_text(
            json.dumps(result["predictions"]))
        if result["weighted_predictions"]:
            (log_dir / "weighted_predictions.json").write_text(
                json.dumps(result["weighted_predictions"]))
        if self.tune_M:
            result["metrics_wrt_m"] = self.m_tuning(outputs, log_dir)
        return result

    def m_tuning(self, eval_outputs: List[dict], log_dir=None) -> List[dict]:
        """Sweep M in powers of two and re-extract answers from the cached
        log-probs; returns metrics per M, written to metrics_wrt_m.json."""
        input_ids = np.concatenate([o["input_ids"] for o in eval_outputs])
        start_lp = np.concatenate([o["start_log_probs"] for o in eval_outputs])
        end_lp = np.concatenate([o["end_log_probs"] for o in eval_outputs])
        answers = sum((o["answer_strings"] for o in eval_outputs), [])
        scores = (
            np.concatenate([o["passage_scores"] for o in eval_outputs])
            if eval_outputs[0]["passage_scores"] is not None else None
        )
        n, M, length = input_ids.shape
        metrics_wrt_m = []
        for m in power_range(M):
            ids_m = input_ids[:, :m]
            preds = self.qa.log_probs_to_answers(
                start_lp[:, :m].reshape(n * m, length),
                end_lp[:, :m].reshape(n * m, length),
                ids_m, self.tokenizer, m)
            metrics = tmetrics.squad(preds, answers)
            metrics["@M"] = m
            if scores is not None:
                weighted = self.qa.log_probs_to_answers(
                    start_lp[:, :m].reshape(n * m, length),
                    end_lp[:, :m].reshape(n * m, length),
                    ids_m, self.tokenizer, m,
                    weights=torch.from_numpy(
                        np.ascontiguousarray(scores[:, :m])))
                for k, v in tmetrics.squad(weighted, answers).items():
                    metrics["weighted_" + k] = v
            metrics_wrt_m.append(metrics)
        if log_dir is not None:
            (Path(log_dir) / "metrics_wrt_m.json").write_text(
                json.dumps(metrics_wrt_m))
        return metrics_wrt_m

    def export(self, path, params=None):
        _export(path, params if params is not None else self._params)
