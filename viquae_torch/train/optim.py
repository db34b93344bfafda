"""Optimizer, LR schedule and the multi-passage reading-comprehension loss
(counterpart of viquae_tpu/train/optim.py).

- :func:`linear_warmup_schedule`: linear 0 -> lr over the warmup, then
  linear lr -> 0 at ``total_steps``, in f32 as the JAX schedule;
- :func:`decay_mask` / :func:`freeze_mask`: which parameters decay and
  which train, by the JAX package's regexes matched on each parameter's
  JAX path (``models.convert.jax_paths``), so a shipped config freezes
  and decays the same tensors in both packages;
- :func:`make_optimizer`: the JAX package's optax chain as an
  :class:`AdamWSpec` that a trainer binds to its own parameters
  (:class:`Optimizer`): ``torch.optim.AdamW`` over a decay and a no-decay
  group of the trainable parameters, a ``LambdaLR`` holding the schedule,
  and global-norm clipping over the trainable gradients only; on a
  mesh the norm is the full parameter set's: the squares of gradients
  split over an axis (``models.sharding``: a tensor block, or a pipeline
  stage) are summed over it, the replicated ones counted once, every
  rank joining the same all-reduces in the same order;
- :func:`remat`: per-call gradient checkpointing;
- :func:`multi_passage_rc_loss`: (N*M, L) start/end logits get ONE softmax
  shared across the M passages of a question (reshape to (N, M*L)),
  per-answer-occurrence NLL, marginal log-likelihood with mean
  reduction, legacy ``max_pooling`` flag. A plain function on tensors:
  autograd gives its gradient.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def remat(apply_fn):
    """``apply_fn`` recomputed in the backward pass (activations are not
    kept). Dropout inside it must take seeds drawn outside the call
    (``layers.dropout_seeds``): checkpoint replays the global RNG, not a
    ``torch.Generator`` passed in by hand."""
    def fn(*args, **kwargs):
        return checkpoint(apply_fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return fn


def linear_warmup_schedule(lr: float, warmup_steps: int, total_steps: int):
    """step -> learning rate: linear 0 -> lr over ``warmup_steps``, then
    linear lr -> 0 at ``total_steps``, clipped at 0; computed in float32
    as the JAX package's schedule."""
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        warm = step / f32(max(1.0, warmup_steps))
        decay = (f32(total_steps) - step) / f32(
            max(1.0, total_steps - warmup_steps))
        frac = warm if step < warmup_steps else decay
        return float(f32(lr) * max(frac, f32(0.0)))

    return schedule


def _unmatched(params: nn.Module, pattern: str) -> Dict[str, bool]:
    """{parameter name: True where ``pattern`` is found nowhere in its JAX
    path}."""
    from viquae_torch.models.convert import jax_paths

    regex = re.compile(pattern)
    return {name: regex.search(path) is None
            for name, path in jax_paths(params).items()}


def decay_mask(params: nn.Module) -> Dict[str, bool]:
    """{parameter name: True where weight decay applies} — not biases or
    LayerNorm scales, by the JAX package's regex on the JAX paths."""
    return _unmatched(params, r"(bias|scale|ln\b|LayerNorm)")


def freeze_mask(params: nn.Module, freeze_regex: Optional[str]
                ) -> Dict[str, bool]:
    """{parameter name: True where trainable}. The regex is searched (not
    matched) in each JAX path: '.*/layers/(6|7)/.*' hits
    'question/bert/layers/6/attention/q/kernel'."""
    if freeze_regex is None:
        return {name: True for name, _ in params.named_parameters()}
    return _unmatched(params, freeze_regex)


class Optimizer:
    """An :class:`AdamWSpec` bound to a module's parameters: optax's
    ``multi_transform({"train": chain(clip_by_global_norm, adamw),
    "freeze": set_to_zero})``. Frozen parameters are in no group, so they
    never move and hold no Adam state; their gradients still count in
    the trainer's ``grad_norm``, as in the JAX trainer."""

    def __init__(self, spec: "AdamWSpec", params: nn.Module):
        from viquae_torch.models.sharding import parameter_axes

        self.spec = spec
        named = dict(params.named_parameters())
        axes = parameter_axes(params)
        trainable = freeze_mask(params, spec.freeze_regex)
        decays = decay_mask(params)
        self.trainable: List[torch.Tensor] = [
            p for n, p in named.items() if trainable[n]]
        self.all_trainable = len(self.trainable) == len(named)
        # the mesh axis each trainable parameter is split over, or None,
        # and every axis any parameter is split over (the norm's
        # all-reduces, the same on every rank)
        self.axes = [axes[n] for n in named if trainable[n]]
        self.over = sorted({a for a in axes.values() if a is not None})
        groups = [
            {"params": [p for n, p in named.items()
                        if trainable[n] and decays[n]],
             "weight_decay": spec.weight_decay},
            {"params": [p for n, p in named.items()
                        if trainable[n] and not decays[n]],
             "weight_decay": 0.0},
        ]
        self.adamw = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=spec.lr,
            betas=spec.betas, eps=spec.eps)
        schedule = linear_warmup_schedule(spec.lr, spec.warmup_steps,
                                          spec.total_steps)
        # LambdaLR multiplies the base lr; its count starts at 0, as
        # optax's, so with warmup the first update has lr 0
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.adamw,
            lambda step: schedule(step) / spec.lr if spec.lr else 0.0)

    def step(self, grad_norm: Optional[torch.Tensor] = None):
        """Clip the trainable gradients (global norm, on the device, no
        host read), take the AdamW step, advance the schedule.
        ``grad_norm``: the global norm of every gradient, where the caller
        has it; the clipping reuses it when every parameter is
        trainable."""
        if self.spec.grad_clip:
            clip_by_global_norm_(
                self.trainable, self.spec.grad_clip, self.axes,
                norm=grad_norm if self.all_trainable else None,
                over=self.over)
        self.adamw.step()
        self.scheduler.step()

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict):
        self.adamw.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["scheduler"])


def global_norm(tensors, axes: Optional[List[Optional[str]]] = None,
                mesh_ctx=None, over: Optional[Sequence[str]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm).
    ``axes`` (one per tensor): the mesh axis a tensor is one rank's block
    (or pipeline stage) of, whose squares are summed over that axis of
    ``mesh_ctx`` (default: the current mesh); None counts a replicated
    tensor once. ``over``: the axes to sum over, on every rank alike
    (default: those ``axes`` names) — a rank whose own tensors lie on no
    rank's block of an axis still joins its all-reduce (a pipeline stage
    whose parameters are all frozen), so that no rank waits alone."""
    tensors = list(tensors)
    axes = list(axes) if axes else [None] * len(tensors)
    from viquae_torch.core import mesh

    over = [a for a in mesh.AXES if a in set(over if over is not None
                                               else axes)]
    norms = torch._foreach_norm(tensors) if tensors else []
    if not over:
        return torch.linalg.vector_norm(torch.stack(norms))
    ctx = mesh_ctx if mesh_ctx is not None else mesh.current()
    device = tensors[0].device if tensors else ctx.device
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def squares(axis):
        picked = [n.float() for n, a in zip(norms, axes) if a == axis]
        return torch.stack(picked).square().sum() if picked else zero

    total = squares(None)
    for axis in over:
        total = total + mesh.all_reduce(ctx, squares(axis), axis)
    return torch.sqrt(total)


def clip_by_global_norm_(params: List[torch.Tensor], max_norm: float,
                         axes: Optional[List[Optional[str]]] = None,
                         mesh_ctx=None, norm: Optional[torch.Tensor] = None,
                         over: Optional[Sequence[str]] = None):
    """optax.clip_by_global_norm on the ``.grad`` of ``params``, in place:
    unchanged while the global norm is below ``max_norm``, else scaled by
    max_norm / norm (without torch's 1e-6 in the denominator). ``axes``,
    ``over``: as :func:`global_norm`, one axis per parameter; ``norm``:
    their global norm, where the caller has computed it."""
    pairs = [(p.grad, a) for p, a in zip(params, axes or [None] * len(
        params)) if p.grad is not None]
    if not pairs and not over:
        return
    grads = [g for g, _ in pairs]
    if norm is None:
        norm = global_norm(grads, [a for _, a in pairs], mesh_ctx, over)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    if grads:
        torch._foreach_mul_(grads, scale)


@dataclasses.dataclass(frozen=True)
class AdamWSpec:
    """The hyperparameters of :func:`make_optimizer`; :meth:`build` binds
    them to the parameters a trainer owns."""
    lr: float = 2e-5
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 0
    total_steps: int = 10_000
    grad_clip: Optional[float] = None
    freeze_regex: Optional[str] = None

    def build(self, params: nn.Module) -> Optimizer:
        return Optimizer(self, params)


def make_optimizer(params: Optional[nn.Module] = None, **hyper
                   ) -> AdamWSpec:
    """The JAX package's ``make_optimizer(params, lr=..., betas=..., eps=...,
    weight_decay=..., warmup_steps=..., total_steps=..., grad_clip=...,
    freeze_regex=...)`` as an :class:`AdamWSpec` (``params`` is accepted
    for its signature: the masks are taken by name when the spec is
    bound)."""
    if "betas" in hyper:
        hyper["betas"] = tuple(hyper["betas"])
    return AdamWSpec(**hyper)


def multi_passage_rc_loss(
    start_logits: torch.Tensor,     # (N*M, L)
    end_logits: torch.Tensor,       # (N*M, L)
    start_positions: torch.Tensor,  # (N*M, A) token positions (A = max answers)
    end_positions: torch.Tensor,    # (N*M, A)
    answer_mask: torch.Tensor,      # (N*M, A) 1 for real answer occurrences
    m_passages: int,
    max_pooling: bool = False,
):
    """Marginal log-likelihood over all answer occurrences with a global
    softmax across each question's M passages.

    Returns (loss, start_log_probs (N*M, L), end_log_probs (N*M, L)).
    """
    nm, length = start_logits.shape
    m = m_passages
    n = nm // m
    ignored_index = length
    start_positions = start_positions.long().clamp(0, ignored_index)
    end_positions = end_positions.long().clamp(0, ignored_index)

    # shared softmax across the M passages of each question
    start_lp = torch.log_softmax(
        start_logits.reshape(n, m * length), dim=1
    ).reshape(nm, length)
    end_lp = torch.log_softmax(
        end_logits.reshape(n, m * length), dim=1
    ).reshape(nm, length)

    def nll(log_probs, positions):
        # positions == ignored_index -> 0 loss (as NLLLoss ignore_index)
        padded = torch.cat(
            [log_probs, log_probs.new_zeros((nm, 1))], dim=1
        )
        picked = torch.gather(padded, 1, positions)  # (N*M, A)
        valid = positions < ignored_index
        return -picked * valid

    span_mask = answer_mask.float()
    loss_tensor = (
        nll(start_lp, start_positions) + nll(end_lp, end_positions)
    ) * span_mask  # (N*M, A)

    if max_pooling:  # legacy ViQuAE-paper behavior
        loss_tensor = loss_tensor.reshape(n, m, -1).amax(dim=1)
    # else: keep (N*M, A) — the marginal runs over answer OCCURRENCES WITHIN
    # each passage row and the mean over all N*M rows; only the max_pooling
    # branch reshapes to (N, ...)

    # zero-loss entries are excluded from the marginal via the -1e10 trick;
    # all-zero rows contribute log(1) = 0
    marginal = torch.sum(
        torch.exp(-loss_tensor - 1e10 * (loss_tensor == 0)), dim=1
    )
    loss = -torch.mean(torch.log(marginal + (marginal == 0)))
    return loss, start_lp, end_lp
