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
``debug_nans``).

Single device. The JAX trainer's mesh arguments (``mesh_ctx``,
``param_spec``, ``batch_spec``) raise by name (ROADMAP A17b-2).
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

from viquae_torch.core.device import upload_batch
from viquae_torch.core.prng import DEFAULT_SEED, SeedBundle
from viquae_torch.train import checkpoint as ckpt_lib
from viquae_torch.train.optim import AdamWSpec, global_norm


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
    moments and the schedule's count) and the step. ``state["params"]``
    and ``state["step"]`` read as the JAX trainer's state dict."""

    def __init__(self, params: nn.Module, optimizer, step: int = 0):
        self.params = params
        self.optimizer = optimizer
        self.step = step

    def __getitem__(self, key: str):
        return {"params": self.params, "opt_state": self.optimizer,
                "step": self.step}[key]

    def state_dict(self) -> dict:
        return {"params": self.params.state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict):
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
    aux_dict). Batches are dicts of host arrays with a LEADING batch dim
    (plus a leading grad_accum dim when ``microbatched``)."""

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
        if mesh_ctx is not None or param_spec is not None \
                or batch_spec is not None:
            raise NotImplementedError(
                "mesh_ctx / param_spec / batch_spec: the port trains on one "
                "device; sharded training is ROADMAP.md A17b-2")
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
        # own the parameters: a deep copy, so the steps never write into
        # the caller's modules through shared storage
        params = copy.deepcopy(params).requires_grad_(True)
        self.device = next(iter(params.parameters())).device
        self.state = TrainState(params, optimizer.build(params))

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
        micro = self._microbatches(batch)
        accum = len(micro)
        for p in params.parameters():
            p.grad = None
        loss = 0.0
        for mb in micro:
            # one microbatch's inputs on the device at a time
            dev = upload_batch(mb, self.device)
            mb_loss, aux = self.loss_fn(params, dev, generator)
            (mb_loss / accum).backward()
            loss = loss + mb_loss.detach()
        loss = loss / accum
        grads = [p.grad for p in params.parameters() if p.grad is not None]
        grad_norm = global_norm(grads)
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
        if resume and cfg.ckpt_dir and ckpt_lib.all_steps(cfg.ckpt_dir):
            _, start_step = ckpt_lib.restore_state(
                cfg.ckpt_dir, self.state, map_location=self.device)
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
                                        keep=cfg.keep_ckpts)
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
                                    step, keep=1)
                        else:
                            since_best += 1
                            if (cfg.early_stop_patience
                                    and since_best
                                    >= cfg.early_stop_patience):
                                break
        if cfg.ckpt_dir:
            ckpt_lib.save_state(cfg.ckpt_dir, self.state, step,
                                keep=cfg.keep_ckpts)
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
        with torch.no_grad():
            for i, batch in enumerate(eval_batches):
                loss, aux = self.loss_fn(
                    self.state.params, upload_batch(batch, self.device),
                    self.seeds.split(f"eval{i}"), **kw)
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
        print(json.dumps(entry))
        if self.cfg.ckpt_dir:
            path = Path(self.cfg.ckpt_dir)
            path.mkdir(parents=True, exist_ok=True)
            with open(path / "log.jsonl", "a") as f:
                f.write(json.dumps(entry) + "\n")
