"""GPipe pipeline parallelism over the ``pipe`` mesh axis (counterpart of
viquae_tpu/ops/pipeline.py).

An encoder's layers split into ``n_stages`` equal stages, one a rank of
``pipe`` (each rank holds one stage's parameters: the memory win), and the
batch into ``n_micro`` microbatches that stream through the stage ring:
``n_micro + n_stages - 1`` ticks, the bubble ``(S - 1) / (M + S - 1)``.

**Layout.** :func:`stack_stages` turns a list of per-layer modules into a
:class:`Stages` container (``stages[s][j]`` is layer ``s * per + j``: the
reference's leading ``(n_stages, per)`` axes as nesting);
:func:`unstack_stages` goes back. ``models.convert`` carries the
reference's stacked arrays to and from this layout.
:func:`stage_spec` marks a ``Stages`` as split over ``pipe`` for
``models.sharding``: a shard keeps this rank's stage only.

**Schedule.** The reference runs one SPMD program: every tick on every
stage, garbage in the warm-up and drain ticks, stage 0 handed a state it
never reads, and autodiff transposes the whole for free. In PyTorch that
structure deadlocks (the unread state's backward never runs, so the last
stage waits forever on the reverse ring). :func:`pipeline_apply` is one
``torch.autograd.Function`` instead:

- forward: stage ``s`` computes microbatch ``m`` at tick ``t = m + s``
  only, receiving its input from ``s - 1`` (stage 0 reads ``inputs[m]``)
  and sending its output to ``s + 1``, and keeps each microbatch's
  detached input and output graph. The last stage banks the outputs; one
  broadcast from it hands every ``pipe`` rank the same outputs (the
  reference's masked ``psum``);
- backward, all inside the call: every pipe rank computed the same loss
  from the same outputs, so its output cotangent is the same; the last
  stage uses its own. Stage ``s`` receives microbatch ``m``'s cotangent
  from ``s + 1``, runs ``torch.autograd.backward`` on that microbatch's
  graph (the stage parameters' ``.grad`` accumulate) and sends the input's
  cotangent to ``s - 1``; stage 0's are broadcast over ``pipe``, so every
  rank returns the same input gradient (the replicated embeddings stay
  bit-equal over ``pipe`` with no all-reduce).

Every rank makes the same calls in the same order, so a loss with two
pipelined towers runs two self-contained backward schedules one after the
other. The Function always takes an anchor that requires grad, so that
its backward runs on every rank even where nothing else on the rank
requires grad (frozen embeddings, a frozen stage). Under
``torch.no_grad()`` the forward keeps no graph. Microbatches run one after
another on a rank: the stages of different microbatches overlap across
ranks, never within one.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from viquae_torch.core import mesh as meshlib
from viquae_torch.core.mesh import PIPE_AXIS


# ---- the staged layout -------------------------------------------------------
class Stages(nn.ModuleDict):
    """Layers in ``n_stages`` equal stages of ``per`` layers:
    ``self[s]`` is stage ``s``'s ``ModuleList`` (global layers ``s * per``
    to ``s * per + per - 1``). A shard over ``pipe`` holds one stage, under
    its own index."""

    def __init__(self, stages: Dict[int, Sequence[nn.Module]], n_stages: int,
                 per: int):
        super().__init__({str(s): nn.ModuleList(layers)
                          for s, layers in sorted(stages.items())})
        self.n_stages = n_stages
        self.per = per

    def __getitem__(self, s) -> nn.ModuleList:
        return super().__getitem__(str(s))

    def held(self) -> list:
        """The stages this container holds, in order."""
        return sorted(int(k) for k in self.keys())


class StageSplit(tuple):
    """A spec leaf (``models.sharding``): the :class:`Stages` it names is
    split over ``axis``, one stage a rank."""

    def __new__(cls, axis: str = PIPE_AXIS):
        return super().__new__(cls, (axis,))

    @property
    def axis(self) -> str:
        return self[0]


def _split_count(n_layers: int, n_stages: int) -> int:
    if n_stages < 1 or n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers do not split into {n_stages} equal stages")
    return n_layers // n_stages


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *items) for items in zip(*trees))
    return fn(*trees)


def stack_stages(layers: list, n_stages: int) -> Stages:
    """Per-layer modules -> a :class:`Stages` of ``n_stages`` equal stages
    (the modules themselves, not copies). Raises on an uneven split."""
    per = _split_count(len(layers), n_stages)
    return Stages({s: list(layers[s * per: (s + 1) * per])
                   for s in range(n_stages)}, n_stages, per)


def unstack_stages(staged: Stages) -> nn.ModuleList:
    """Inverse of :func:`stack_stages`: the per-layer list (``staged``
    must hold every stage)."""
    if staged.held() != list(range(staged.n_stages)):
        raise ValueError(f"a shard holds stages {staged.held()} of "
                         f"{staged.n_stages}: gather it first "
                         "(models.sharding.gather_module)")
    return nn.ModuleList([layer for s in range(staged.n_stages)
                          for layer in staged[s]])


def stage_spec(axis: str = PIPE_AXIS) -> StageSplit:
    """The spec leaf that splits a :class:`Stages` over ``axis``."""
    return StageSplit(axis)


def microbatch(x, n_micro: int):
    """(B, ...) -> (n_micro, B / n_micro, ...) for a tensor or every
    tensor of a tree; B must divide evenly."""
    def split(a):
        b = a.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
        return a.reshape((n_micro, b // n_micro) + tuple(a.shape[1:]))

    return _tree_map(split, x)


def unmicrobatch(x):
    """Inverse of :func:`microbatch` on the leading two axes."""
    return _tree_map(
        lambda a: a.reshape((a.shape[0] * a.shape[1],) + tuple(a.shape[2:])),
        x)


# ---- the schedule ------------------------------------------------------------
class _Run:
    """One call's stage, schedule and saved graphs."""

    def __init__(self, stage_fn, stage, consts, ctx, n_micro):
        self.stage_fn, self.stage, self.consts = stage_fn, stage, consts
        self.ctx, self.n_micro = ctx, n_micro
        self.n_stages = ctx.size(PIPE_AXIS)
        self.s = ctx.coordinate(PIPE_AXIS)
        self.offset = self.s * len(stage)
        self.saved = []           # (input leaf, output) per microbatch

    def const(self, m, tree=None):
        """Entry ``m`` of every leaf of the consts (dicts walked)."""
        tree = self.consts if tree is None else tree
        if isinstance(tree, dict):
            return {k: self.const(m, v) for k, v in tree.items()}
        return tree[m]

    def forward(self, inputs: torch.Tensor, keep: bool) -> torch.Tensor:
        """The forward ticks; every pipe rank returns the last stage's
        (n_micro, mb, ...) outputs."""
        ctx, s, last = self.ctx, self.s, self.n_stages - 1
        outs = []
        for m in range(self.n_micro):      # stage s's tick m + s
            x = (inputs[m] if s == 0 else
                 meshlib.recv_from(ctx, inputs[m], PIPE_AXIS, s - 1))
            if keep:
                x = x.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = self.stage_fn(self.stage, x, self.const(m),
                                      self.offset)
                self.saved.append((x, y))
            else:
                y = self.stage_fn(self.stage, x, self.const(m), self.offset)
            if s < last:
                meshlib.send_to(ctx, y, PIPE_AXIS, s + 1)
            else:
                outs.append(y.detach())
        out = (torch.stack(outs) if s == last
               else torch.empty_like(inputs))
        return meshlib.broadcast(ctx, out, PIPE_AXIS, last)

    def backward(self, g_out: torch.Tensor, need_input: bool):
        """The reverse ticks; every pipe rank returns stage 0's input
        cotangents (or None where the input needs none)."""
        ctx, s, last = self.ctx, self.s, self.n_stages - 1
        g_in = []
        with torch.enable_grad():
            for m in range(self.n_micro):
                x, y = self.saved[m]
                g = (g_out[m] if s == last else
                     meshlib.recv_from(ctx, y, PIPE_AXIS, s + 1))
                torch.autograd.backward(y, g)
                gx = x.grad if x.grad is not None else torch.zeros_like(x)
                if s > 0:
                    meshlib.send_to(ctx, gx, PIPE_AXIS, s - 1)
                else:
                    g_in.append(gx)
        self.saved = []
        if not need_input:
            return None
        out = torch.stack(g_in) if s == 0 else torch.empty_like(g_out)
        return meshlib.broadcast(ctx, out, PIPE_AXIS, 0)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(fctx, run, anchor, inputs):
        fctx.run = run
        return run.forward(inputs, keep=True)

    @staticmethod
    def backward(fctx, g_out):
        g_in = fctx.run.backward(g_out.contiguous(),
                                 fctx.needs_input_grad[2])
        return None, None, g_in


def pipeline_apply(
    stage_fn: Callable,
    stage_layers: nn.ModuleList,
    inputs: torch.Tensor,
    consts: Any = None,
    mesh_ctx: Optional[meshlib.MeshContext] = None,
) -> torch.Tensor:
    """Run ``inputs`` through the staged stack on the ``pipe`` axis.

    ``stage_fn(stage_layers, x, const, layer_offset) -> y`` with
    ``y.shape == x.shape``: ``stage_layers`` is this rank's stage (a
    :class:`Stages`' entry at this rank's ``pipe`` coordinate),
    ``layer_offset`` the global index of its first layer (for per-layer
    dropout seeds). ``inputs``: (n_micro, mb, ...) microbatches
    (:func:`microbatch`) of this rank's rows; ``consts``: a dict tree
    whose leaves lead with n_micro (tensors or lists), ``const`` its entry
    ``m`` (dicts walked). Returns the (n_micro, mb, ...) outputs, the same on every
    ``pipe`` rank, differentiable (module docstring)."""
    ctx = mesh_ctx if mesh_ctx is not None else meshlib.current()
    run = _Run(stage_fn, stage_layers, consts if consts is not None else {},
               ctx, inputs.shape[0])
    if not torch.is_grad_enabled():
        return run.forward(inputs, keep=False)
    anchor = torch.zeros((), device=inputs.device, requires_grad=True)
    return _Pipeline.apply(run, anchor, inputs)
