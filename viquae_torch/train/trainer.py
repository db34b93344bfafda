"""The training engine (counterpart of viquae_tpu/train/trainer.py).

One explicit loop over a trainee's loss: the trainer owns a copy of the
parameters on their device, uploads each host batch through
``core.device.upload_batch`` (pinned staging, no wait for the device),
runs the forward and ``torch.autograd`` backward, and takes the
optimizer step of ``train.optim`` (AdamW, schedule, clipping). Per-layer
remat is the trainee's ``remat_layers`` (``torch.utils.checkpoint``);
``torch.save`` checkpoints and monitor-based best-keeping replace the
reference's ModelCheckpoint / EarlyStopping; metrics stream to a JSONL
log. The step makes no host read: loss and grad norm stay device tensors
and are read on ``log_every`` steps only (and on every step under
``debug_nans``). While a profile runs, each optimizer step of
:meth:`Trainer.fit` is a ``train.step`` device span (core/profiling.py):
its host wall, and its time on the device from two CUDA events.

On a mesh (``mesh_ctx``, default ``core.mesh.current()``; the JAX
trainer's contract): ``param_spec`` shards the parameters over ``model``
(``models.sharding``; their AdamW state follows, as it is built on the
shards), every rank builds the same global batch and the loss gets the
whole of it, under the mesh (each microbatch's under ``microbatched``):
the trainees split their encoder inputs' rows over ``data`` and gather the
per-sequence outputs before the objective (``train.data_parallel``), and a
loss that does not computes the whole batch on every rank. After backward
every gradient is averaged over ``data`` in one all-reduce (never over
``model`` or ``pipe``). The global norm counts the shards' squares over
``model`` (a pipeline stage's over ``pipe``) and the replicated gradients
once; the optimizer's clipping reuses it. With
``param_spec=bert.pipeline_param_spec(cfg, S)`` each rank of a data x
pipe mesh holds one stage (``bert.encode_pipelined`` runs the schedule;
the replicated embeddings get the same gradient on every pipe rank), its
checkpoint holds that stage, and :meth:`Trainer.full_params` returns the
per-layer modules.
``batch_spec``, the JAX trainer's layout of named batch keys, is checked
and changes nothing: every rank holds the whole batch, which any layout's
ranks can read, and in JAX too the layout changes no result. Checkpoints
are per rank (``train.checkpoint``); only rank 0 prints and writes the
log; :meth:`Trainer.full_params` gathers the shards back.
"""
from __future__ import annotations

import copy
import dataclasses
import inspect
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from viquae_torch.core import mesh as meshlib
from viquae_torch.core import profiling
from viquae_torch.core.device import upload_batch
from viquae_torch.core.prng import DEFAULT_SEED, SeedBundle
from viquae_torch.models import sharding
from viquae_torch.train import checkpoint as ckpt_lib
from viquae_torch.train.optim import AdamWSpec, Optimizer, global_norm


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 1000
    eval_every: int = 0              # 0 = no periodic eval
    log_every: int = 10
    ckpt_every: int = 0              # 0 = only final
    ckpt_dir: Optional[str] = None
    keep_ckpts: Optional[int] = None
    monitor: Optional[str] = None    # eval metric name for best/earlystop
    monitor_mode: str = "max"
    early_stop_patience: Optional[int] = None  # in eval rounds
    seed: int = DEFAULT_SEED
    grad_accum: int = 1
    # batches arrive PRE-microbatched with a leading grad_accum dim (one
    # packed canvas per microbatch — data.microbatch_collate); the trainer
    # steps through that axis instead of slicing, which is how packing
    # composes with accumulation (slicing one canvas would corrupt its
    # pointers)
    microbatched: bool = False
    # fail fast on NaN/Inf: autograd anomaly mode plus a finite check of
    # every step's loss and grad norm (a host read per step)
    debug_nans: bool = False


class TrainState:
    """What a checkpoint holds: the parameters, the optimizer (AdamW
    moments and the schedule's count) and the step; on a mesh also the
    mesh's shape and this rank's coordinates (a resume must be on the same
    mesh) and the seed bundle's host generator state. ``state["params"]``
    and ``state["step"]`` read as the JAX trainer's state dict."""

    def __init__(self, params: nn.Module, optimizer, step: int = 0,
                 mesh_ctx=None, seeds: Optional[SeedBundle] = None):
        self.params = params
        self.optimizer = optimizer
        self.step = step
        self.mesh_ctx = mesh_ctx
        self.seeds = seeds

    def __getitem__(self, key: str):
        return {"params": self.params, "opt_state": self.optimizer,
                "step": self.step}[key]

    def state_dict(self) -> dict:
        state = {"params": self.params.state_dict(),
                 "opt_state": self.optimizer.state_dict(),
                 "step": self.step}
        if self.mesh_ctx is not None:
            state["mesh"] = {"sizes": dict(self.mesh_ctx.sizes),
                             "coords": dict(self.mesh_ctx.coords)}
            state["generator"] = json.dumps(
                self.seeds.host.bit_generator.state)
        return state

    def load_state_dict(self, state: dict):
        if self.mesh_ctx is not None:
            here = {"sizes": dict(self.mesh_ctx.sizes),
                    "coords": dict(self.mesh_ctx.coords)}
            if state.get("mesh") != here:
                raise ValueError(f"the checkpoint was written on the mesh "
                                 f"{state.get('mesh')}, this rank is {here}")
            self.seeds.host.bit_generator.state = json.loads(
                state["generator"])
        self.params.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_host(tree):
    return _map(lambda t: t.detach().cpu().numpy()
                if isinstance(t, torch.Tensor) else t, tree)


class Trainer:
    """Drives a loss function over batches.

    loss_fn(params, batch, generator, deterministic=False) -> (loss,
    aux_dict). Batches are dicts of host arrays with a LEADING GLOBAL
    batch dim (plus a leading grad_accum dim when ``microbatched``); on a
    mesh every rank's loss gets the whole batch, and the trainer keeps the
    parameters per ``param_spec`` (replicated by default)."""

    def __init__(
        self,
        loss_fn: Callable,
        params: nn.Module,
        optimizer: AdamWSpec,
        config: TrainerConfig = TrainerConfig(),
        mesh_ctx=None,
        param_spec=None,
        eval_fn: Optional[Callable] = None,
        batch_spec: Optional[dict] = None,
    ):
        self.cfg = config
        if config.monitor_mode not in ("max", "min"):
            # anything else would silently freeze best-keeping after the
            # first eval (both mode comparisons evaluate False)
            raise ValueError(
                f"monitor_mode must be 'max' or 'min', got "
                f"{config.monitor_mode!r}")
        if config.microbatched and config.grad_accum < 2:
            raise ValueError(
                "microbatched=True requires grad_accum >= 2 (batches carry "
                "a leading grad_accum dim — data.microbatch_collate)")
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.seeds = SeedBundle(config.seed)
        self.history: list = []
        self.mesh_ctx = ctx = mesh_ctx or meshlib.current()
        for key, spec in (batch_spec or {}).items():
            if any(a is not None and a not in meshlib.AXES
                   for a in tuple(spec)):
                raise ValueError(f"batch_spec[{key!r}] = {spec}: the entries "
                                 f"are mesh axes {meshlib.AXES} or None")
        # own the parameters: a copy (the shard module, or a deep copy),
        # so the steps never write into the caller's modules
        params = (sharding.shard_module(params, param_spec, ctx)
                  if param_spec is not None else copy.deepcopy(params))
        if ctx.device is not None:
            params = params.to(ctx.device)
        params = params.requires_grad_(True)
        self.device = next(iter(params.parameters())).device
        # the mesh axis each parameter is a block (or stage) of
        self._axes = list(sharding.parameter_axes(params).values())
        self.state = TrainState(
            params, optimizer.build(params), mesh_ctx=(
                ctx if ctx.distributed else None), seeds=self.seeds)

    @property
    def _rank(self) -> Optional[int]:
        """This rank, for its checkpoint files (None without a process
        group: one ``state.pt``)."""
        return self.mesh_ctx.rank if self.mesh_ctx.distributed else None

    def full_params(self) -> nn.Module:
        """The trained parameters whole: the shards gathered over their
        axes and staged layers back in the per-layer list (every rank
        calls this together), else the parameters."""
        params = self.state.params
        if not sharding.is_split(params):
            return params
        return sharding.gather_module(params, self.mesh_ctx)

    # ------------------------------------------------------------------
    def _microbatches(self, batch):
        """The host batch as a list of grad_accum microbatches, each a
        self-contained batch (the JAX trainer's refusals kept)."""
        accum = max(int(self.cfg.grad_accum), 1)
        if accum == 1:
            return [batch]
        leaves = [(k, v) for k, v in _leaves(batch)
                  if not isinstance(v, (str, bytes, list))]
        if self.cfg.microbatched:
            for _, v in leaves:
                if np.shape(v)[0] != accum:
                    raise ValueError(
                        f"microbatched=True expects every leaf to lead "
                        f"with grad_accum={accum}, got shape "
                        f"{np.shape(v)}. Wrap the collator with "
                        "data.microbatch_collate(collate, accum).")
            return [_map(lambda x, j=j: x[j], batch) for j in range(accum)]
        bad = [k for k, _ in leaves if "canvas_" in k or "gather_idx" in k]
        if bad:
            raise ValueError(
                "grad_accum > 1 cannot split packed-canvas batches: keys "
                f"{bad[:3]} hold pointers into the FULL canvas, so slicing "
                "rows silently corrupts the gather. Pack per-microbatch "
                "instead: wrap the collator with data.microbatch_collate "
                "and set TrainerConfig(microbatched=True).")
        if any(k.split("/")[-1] == "labels" for k, _ in leaves):
            # in-batch-contrastive labels index the FULL batch's rows; a
            # slice keeps the global values while each microbatch's
            # similarity matrix is local
            raise ValueError(
                "grad_accum > 1 cannot reshape-split batches with in-batch "
                "`labels` (their values index the full batch). Collate "
                "per-microbatch: wrap the collator with "
                "data.microbatch_collate and set "
                "TrainerConfig(microbatched=True) — "
                "train.run.run_from_config does this automatically.")
        for k, v in leaves:
            if np.shape(v)[0] % accum:
                raise ValueError(
                    f"grad_accum={accum} requires every batch leading dim "
                    f"to be divisible by it, got shape {np.shape(v)}")

        def part(x, j):
            if isinstance(x, (str, bytes, list)):
                return x     # host-only bookkeeping: upload_batch drops it
            n = np.shape(x)[0] // accum
            return x[j * n: (j + 1) * n]

        return [_map(lambda x, j=j: part(x, j), batch) for j in range(accum)]

    def _train_step(self, batch, generator: torch.Generator):
        """One optimizer step over a host batch; returns (loss, grad_norm,
        aux) as device tensors (aux of the last microbatch)."""
        params, opt = self.state.params, self.state.optimizer
        ctx = self.mesh_ctx
        micro = self._microbatches(batch)
        accum = len(micro)
        for p in params.parameters():
            p.grad = None
        loss = 0.0
        for mb in micro:
            # one microbatch's inputs on the device at a time
            dev = upload_batch(mb, self.device)
            with meshlib.use(ctx):
                mb_loss, aux = self.loss_fn(params, dev, generator)
                (mb_loss / accum).backward()
            loss = loss + mb_loss.detach()
        loss = loss / accum
        with_grad = [(p, a) for p, a in zip(params.parameters(), self._axes)
                     if p.grad is not None]
        grads = [p.grad for p, _ in with_grad]
        if ctx.distributed:
            # one all-reduce over data, in place in one flat copy: the
            # mean of every rank's gradients
            flat = torch._utils._flatten_dense_tensors(grads)
            meshlib.all_reduce(ctx, flat, meshlib.DATA_AXIS, op="mean",
                               inplace=True)
            torch._foreach_copy_(grads, list(
                torch._utils._unflatten_dense_tensors(flat, grads)))
            del flat
            loss = meshlib.all_reduce(ctx, loss, meshlib.DATA_AXIS,
                                      op="mean")
        # the optimizer's split axes: the same all-reduces on every rank
        grad_norm = global_norm(
            grads, [a for _, a in with_grad], ctx,
            over=opt.over if isinstance(opt, Optimizer) else None)
        with meshlib.use(ctx):      # the clipping norm's collectives
            if isinstance(opt, Optimizer):
                opt.step(grad_norm)
            else:
                opt.step()
        self.state.step += 1
        return loss, grad_norm, aux

    def fit(
        self,
        train_batches,
        eval_batches: Optional[Callable[[], Iterable]] = None,
        resume: bool = False,
    ) -> Dict[str, Any]:
        """train_batches is either an iterable of batches (resume replays
        the stream to fast-forward, O(steps)) or a step-indexed source — a
        callable ``step -> batch`` — which makes resume O(1)
        (data.step_indexed_batches)."""
        cfg = self.cfg
        start_step = 0
        if resume and cfg.ckpt_dir and ckpt_lib.all_steps(cfg.ckpt_dir,
                                                          self._rank):
            _, start_step = ckpt_lib.restore_state(
                cfg.ckpt_dir, self.state, map_location=self.device,
                rank=self._rank)
        best_metric, best_step, since_best = None, None, 0
        t0 = time.time()
        step = start_step
        indexed = callable(train_batches) and not hasattr(
            train_batches, "__iter__")
        if indexed:
            def next_batch(step):
                return train_batches(step)
        else:
            train_iter = iter(train_batches)
            # fast-forward the data stream so a resumed run sees the same
            # batch sequence as an uninterrupted one
            for _ in range(start_step):
                try:
                    next(train_iter)
                except StopIteration:
                    train_iter = iter(train_batches)
                    next(train_iter)

            def next_batch(step):
                nonlocal train_iter
                try:
                    return next(train_iter)
                except StopIteration:
                    train_iter = iter(train_batches)
                    return next(train_iter)

        with torch.autograd.set_detect_anomaly(cfg.debug_nans):
            while step < cfg.max_steps:
                batch = next_batch(step)
                with profiling.device_span("train.step", self.device,
                                           step=step):
                    loss, grad_norm, _ = self._train_step(
                        batch, self.seeds.split(f"step{step}"))
                step += 1
                if cfg.debug_nans and not (torch.isfinite(loss)
                                           and torch.isfinite(grad_norm)):
                    raise FloatingPointError(
                        f"step {step}: loss {float(loss)}, grad norm "
                        f"{float(grad_norm)}")
                if cfg.log_every and step % cfg.log_every == 0:
                    entry = {
                        "step": step,
                        "loss": float(loss),
                        "grad_norm": float(grad_norm),
                        "elapsed_s": round(time.time() - t0, 3),
                    }
                    self.history.append(entry)
                    self._log(entry)
                if cfg.ckpt_every and cfg.ckpt_dir \
                        and step % cfg.ckpt_every == 0:
                    ckpt_lib.save_state(cfg.ckpt_dir, self.state, step,
                                        keep=cfg.keep_ckpts, rank=self._rank)
                if cfg.eval_every and step % cfg.eval_every == 0 \
                        and eval_batches:
                    eval_metrics = self.evaluate(eval_batches())
                    entry = {"step": step, **{f"eval/{k}": v for k, v
                                              in eval_metrics.items()}}
                    self.history.append(entry)
                    self._log(entry)
                    if cfg.monitor:
                        current = eval_metrics[cfg.monitor]
                        better = (
                            best_metric is None
                            or (cfg.monitor_mode == "max"
                                and current > best_metric)
                            or (cfg.monitor_mode == "min"
                                and current < best_metric))
                        if better:
                            best_metric, best_step, since_best = (
                                current, step, 0)
                            if cfg.ckpt_dir:
                                # only the max step under best/ is ever
                                # restored: keep=1
                                ckpt_lib.save_state(
                                    Path(cfg.ckpt_dir) / "best", self.state,
                                    step, keep=1, rank=self._rank)
                        else:
                            since_best += 1
                            if (cfg.early_stop_patience
                                    and since_best
                                    >= cfg.early_stop_patience):
                                break
        if cfg.ckpt_dir:
            ckpt_lib.save_state(cfg.ckpt_dir, self.state, step,
                                keep=cfg.keep_ckpts, rank=self._rank)
        return {
            "final_step": step,
            "best_metric": best_metric,
            "best_step": best_step,
            "history": self.history,
        }

    def evaluate(self, eval_batches: Iterable) -> Dict[str, float]:
        """Mean loss + eval_fn aggregation over batches (no grad, and with
        dropout off when the loss_fn has a `deterministic` flag)."""
        try:
            accepts_det = "deterministic" in inspect.signature(
                self.loss_fn).parameters
        except (TypeError, ValueError):
            accepts_det = False
        kw = {"deterministic": True} if accepts_det else {}
        outputs, host_batches, losses = [], [], []
        ctx = self.mesh_ctx
        with torch.no_grad():
            for i, batch in enumerate(eval_batches):
                dev = upload_batch(batch, self.device)
                with meshlib.use(ctx):
                    loss, aux = self.loss_fn(
                        self.state.params, dev, self.seeds.split(f"eval{i}"),
                        **kw)
                if ctx.distributed:
                    loss = meshlib.all_reduce(ctx, loss, meshlib.DATA_AXIS,
                                              op="mean")
                losses.append(float(loss))
                outputs.append(_to_host(aux))
                host_batches.append(batch)
        metrics = {"loss": float(np.mean(losses)) if losses else 0.0}
        if self.eval_fn is not None:
            # a 2-arg eval_fn also receives the ORIGINAL host batches
            # (readers need input_ids/answer_strings for EM/F1)
            try:
                two_arg = len(inspect.signature(
                    self.eval_fn).parameters) >= 2
            except (TypeError, ValueError):
                two_arg = False
            metrics.update(
                self.eval_fn(outputs, host_batches) if two_arg
                else self.eval_fn(outputs))
        return metrics

    def _log(self, entry: dict):
        if self.mesh_ctx.rank != 0:
            return
        print(json.dumps(entry))
        if self.cfg.ckpt_dir:
            path = Path(self.cfg.ckpt_dir)
            path.mkdir(parents=True, exist_ok=True)
            with open(path / "log.jsonl", "a") as f:
                f.write(json.dumps(entry) + "\n")
