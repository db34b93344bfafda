"""Config-driven training entry (counterpart of viquae_tpu/train/run.py).

One YAML/JSON config — the JAX package's own — wires trainee + collator +
optimizer + trainer:

.. code-block:: yaml

    seed: 42
    trainee:
      kind: biencoder     # biencoder | reader | reranker | crossmodal | jcm
      question_model: {class_name: DPREncoder, seed: 0}
      context_model:  {class_name: DPREncoder, seed: 1}
    data:
      tokenizer: /path/to/tokenizer-or-vocab-dir
      dataset: /path/to/questions     # needs *_provenance_indices columns
      kb: /path/to/passages
      M: 24
      batch_size: 8
    optimizer: {lr: 2.0e-5, warmup_steps: 100, total_steps: 1000}
    trainer:   {max_steps: 1000, ckpt_dir: ckpts, eval_every: 100,
                monitor: "MRR@N*M"}
    export: ckpts/export        # save_ptm output after fit

Everything is built on ``device`` (the GPU unless the caller names
another). Models drawn from a ``seed`` take the port's own draws, so a
parity run between the packages shares weights through an export
directory (``pretrained_model_name_or_path``).

Under a process group (``torchrun``) the run is data-parallel over every
rank, as the JAX command is over every device: the mesh
(``core.mesh.make_mesh``, every rank on ``data``, or the caller's
current mesh) goes to the trainer, every rank builds the same batches
from the seed and trains on its rows, each rank writes its checkpoint
shard, and rank 0 alone writes the export, the test files and the
printed result.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

from viquae_torch.core.config import instantiate_tree, load_config
from viquae_torch.core.device import resolve_device


def _build_tokenizer(spec):
    from transformers import AutoTokenizer, BertTokenizerFast

    path = Path(str(spec))
    if path.is_dir() and (path / "vocab.txt").exists():
        return BertTokenizerFast(vocab_file=str(path / "vocab.txt"))
    if path.suffix == ".txt":
        return BertTokenizerFast(vocab_file=str(path))
    return AutoTokenizer.from_pretrained(str(spec))


def _batches(dataset, collate_fn, batch_size: int, shuffle_seed=None):
    from viquae_torch.train.prefetch import CollatorLoader

    return CollatorLoader(
        dataset, collate_fn, batch_size,
        shuffle=shuffle_seed is not None, seed=shuffle_seed or 0,
    )


def _model(spec: dict, device):
    return instantiate_tree({**spec, "device": device})


def build_trainee(config: dict, tokenizer=None, device=None):
    from viquae_torch.train import trainee as trainee_lib

    device = resolve_device(device)
    kind = config.pop("kind")
    if kind == "biencoder":
        question_model = _model(config.pop("question_model"), device)
        context_model = (
            _model(config.pop("context_model"), device)
            if "context_model" in config else None
        )
        return trainee_lib.BiEncoderTrainee(
            question_model, context_model, **config
        )
    if kind == "reader":
        from viquae_torch.models import bert, qa

        pretrained = config.pop("pretrained", None)
        fuse_ir_score = config.pop("fuse_ir_score", False)
        if pretrained is not None:
            # HF save_pretrained dir of a MultiPassageBERT /
            # BertForQuestionAnswering checkpoint; bert_config overrides
            # still apply on top of the dir's config
            import json

            with open(Path(str(pretrained)) / "config.json") as f:
                hf_cfg = json.load(f)
            base = dataclasses.asdict(
                bert.BertConfig.from_hf(hf_cfg, add_pooler=False))
            base.update(config.pop("bert_config", {}))
            cfg = qa.ReaderConfig(bert=bert.BertConfig(**base),
                                  fuse_ir_score=fuse_ir_score)
            params, cfg = qa.params_from_pretrained_dir(pretrained, cfg,
                                                        device=device)
            config.pop("seed", None)
        else:
            bert_cfg = bert.BertConfig(
                **config.pop("bert_config", {}), add_pooler=False
            )
            cfg = qa.ReaderConfig(bert=bert_cfg, fuse_ir_score=fuse_ir_score)
            params = qa.init(cfg, config.pop("seed", 0), device=device)
        return trainee_lib.ReaderTrainee(
            cfg, params, tokenizer, **config
        )
    if kind == "crossmodal":
        text_model = _model(config.pop("text_model"), device)
        vision_model = _model(config.pop("vision_model"), device)
        return trainee_lib.CrossModalTrainee(text_model, vision_model,
                                             **config)
    if kind == "jcm":
        # JointMonoAndCrossModal: weighted image-image + image-title
        # similarities over CLIP towers
        text_model = _model(config.pop("text_model"), device)
        vision_model = _model(config.pop("vision_model"), device)
        return trainee_lib.JointMonoAndCrossModalTrainee(
            text_model, vision_model, **config
        )
    if kind == "reranker":
        from viquae_torch.models import bert, rr

        bert_cfg = bert.BertConfig(
            **config.pop("bert_config", {}), add_pooler=False
        )
        rr_cfg = rr.BertReRankerConfig(bert=bert_cfg)
        params = rr.bert_reranker_init(rr_cfg, config.pop("seed", 0),
                                       device=device)

        class _Model:
            def __init__(self):
                self.params = params

            def apply_fn(self, p, **kw):
                return rr.bert_reranker_apply(p, rr_cfg, **kw)

            def packed_apply_fn(self, p, *args, **kw):
                return rr.bert_reranker_apply_packed(p, rr_cfg, *args, **kw)

        return trainee_lib.ReRankerTrainee(_Model(), **config)
    raise ValueError(f"Unknown trainee kind {kind!r}")


def build_collator(config: dict, tokenizer, trainee_kind: str):
    from datasets import load_from_disk

    from viquae_torch.train import data as tdata

    dataset = load_from_disk(str(config.pop("dataset")))
    eval_dataset = (
        load_from_disk(str(config.pop("eval_dataset")))
        if "eval_dataset" in config else None
    )
    kb = load_from_disk(str(config.pop("kb"))) if "kb" in config else None
    image_kb = (
        load_from_disk(str(config.pop("image_kb")))
        if "image_kb" in config else None
    )
    batch_size = config.pop("batch_size", 8)
    kind = config.pop(
        "collator", {"jcm": "crossmodal"}.get(trainee_kind, trainee_kind)
    )
    collator_cls = {
        "biencoder": tdata.BiEncoderCollator,
        "reader": tdata.ReaderCollator,
        "reranker": tdata.ReRankerCollator,
        "ict": tdata.ICTCollator,
        "crossmodal": tdata.CrossModalCollator,
    }[kind]
    collator = collator_cls(
        tokenizer, dataset=dataset, kb=kb, image_kb=image_kb, **config
    )
    return collator, dataset, eval_dataset, batch_size


def build_optimizer(config: dict, trainee):
    """The config's optimizer spec; a trainee with fixed fusion weights
    (jcm / joint with learn_weights=False) adds its freeze regex."""
    from viquae_torch.train import optim

    opt_cfg = dict(config.get("optimizer", {}))
    auto_freeze = getattr(trainee, "freeze_weights_regex", None)
    if auto_freeze is not None:
        fr = auto_freeze()
        if fr:
            existing = opt_cfg.get("freeze_regex")
            opt_cfg["freeze_regex"] = (
                f"(?:{existing})|(?:{fr})" if existing else fr
            )
    return optim.make_optimizer(trainee.params, **opt_cfg)


def run_from_config(config_path, subcommand: str = "fit",
                    ckpt_path=None, device=None) -> dict:
    """``fit`` (train, checkpoint, resume from ``ckpt_path``, export),
    ``test`` (the trainee's full test protocol from a checkpoint) or any
    other subcommand (``validate``: mean loss + the trainee's metrics)."""
    import torch.distributed as dist

    from viquae_torch.core import mesh as meshlib
    from viquae_torch.train import checkpoint as ckpt_lib
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    device = resolve_device(device)
    ctx = meshlib.current()
    if not ctx.distributed and dist.is_initialized():
        ctx = meshlib.make_mesh(device=device)
    writes = ctx.rank == 0
    rank = ctx.rank if ctx.distributed else None   # its checkpoint files
    config = load_config(config_path)
    if ckpt_path is not None:
        config["ckpt_path"] = ckpt_path
    seed = config.get("seed", 42)

    tokenizer = _build_tokenizer(config["data"].pop("tokenizer"))
    trainee_cfg = dict(config["trainee"])
    trainee_kind = trainee_cfg["kind"]
    trainee_cfg_had_pretrained = "pretrained" in trainee_cfg
    trainee = build_trainee(trainee_cfg, tokenizer=tokenizer, device=device)
    collator, dataset, eval_dataset, batch_size = build_collator(
        dict(config["data"]), tokenizer, trainee_kind
    )
    tx = build_optimizer(config, trainee)
    trainer_cfg = TrainerConfig(seed=seed, **config.get("trainer", {}))
    fit_resume = False
    if subcommand == "fit" and config.get("ckpt_path"):
        # `fit --ckpt-path` RESUMES training: restore the latest step
        # under that dir and keep checkpointing there
        fit_dir = config["ckpt_path"]
        if trainer_cfg.ckpt_dir and trainer_cfg.ckpt_dir != fit_dir:
            raise ValueError(
                f"--ckpt-path {fit_dir!r} conflicts with "
                f"trainer.ckpt_dir {trainer_cfg.ckpt_dir!r}; resume uses "
                "one checkpoint dir")
        if not ckpt_lib.all_steps(fit_dir, rank):
            raise ValueError(
                f"--ckpt-path {fit_dir!r} holds no checkpoint steps to "
                "resume from")
        trainer_cfg = dataclasses.replace(trainer_cfg, ckpt_dir=fit_dir)
        fit_resume = True
    collate_fn = collator.collate_fn
    if trainer_cfg.grad_accum > 1:
        # ALWAYS collate per-microbatch: packed canvases cannot be sliced
        # and in-batch `labels` index the full batch's rows
        from viquae_torch.train.data import microbatch_collate

        collate_fn = microbatch_collate(collate_fn, trainer_cfg.grad_accum)
        trainer_cfg = dataclasses.replace(trainer_cfg, microbatched=True)
    trainer = Trainer(
        trainee.loss_fn, trainee.params, tx, trainer_cfg, mesh_ctx=ctx,
        eval_fn=getattr(trainee, "eval_fn", None),
    )
    if subcommand == "fit":
        eval_batches = None
        if eval_dataset is not None:
            eval_batches = lambda: _batches(  # noqa: E731
                eval_dataset, collator.collate_fn, batch_size
            )
        elif trainer_cfg.eval_every:
            import warnings

            warnings.warn(
                "trainer.eval_every is set but data.eval_dataset is "
                "not: no eval/early-stop/best-checkpoint will run"
            )
        result = trainer.fit(
            _batches(dataset, collate_fn, batch_size, shuffle_seed=seed),
            eval_batches=eval_batches,
            resume=fit_resume,
        )
        export = config.get("export")
        if export and hasattr(trainee, "export"):
            params = trainer.full_params()   # every rank gathers
            if writes:
                trainee.export(export, params=params)
    elif subcommand == "test" and hasattr(trainee, "test"):
        # restore order: explicit `ckpt_path` > ckpt_dir/best > latest
        # ckpt_dir step; a missing checkpoint is an error (testing random
        # weights would report garbage as the run's metrics)
        ckpt_path = config.get("ckpt_path")
        if not ckpt_path and trainer_cfg.ckpt_dir:
            best = Path(trainer_cfg.ckpt_dir) / "best"
            if ckpt_lib.all_steps(best, rank):
                ckpt_path = best
            elif ckpt_lib.all_steps(trainer_cfg.ckpt_dir, rank):
                ckpt_path = trainer_cfg.ckpt_dir
        if ckpt_path:
            ckpt_lib.restore_state(ckpt_path, trainer.state,
                                   map_location=device, rank=rank)
        elif not trainee_cfg_had_pretrained:
            raise FileNotFoundError(
                "train test: no checkpoint found (set `ckpt_path`, "
                "populate trainer.ckpt_dir, or init the trainee from "
                "`pretrained:`)"
            )
        log_dir = (config.get("export") or trainer_cfg.ckpt_dir or ".")
        # the test protocol writes its files: rank 0 runs it
        result = trainee.test(
            trainer.state["params"],
            _batches(dataset, collator.collate_fn, batch_size),
            log_dir,
        ) if writes else None
    else:
        result = trainer.evaluate(
            _batches(dataset, collator.collate_fn, batch_size)
        )
    if writes:
        print(result)
    return result
