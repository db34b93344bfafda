"""Device mesh and the port's collectives (counterpart of
viquae_tpu/core/mesh.py).

One mesh of processes, one device each, with the reference's four named
axes, in the reference's grid order (data, pipe, model, kb):

- ``data``  — batch parallelism: the embedders split each batch's rows
  over it and gather the outputs back in order.
- ``model`` — tensor, sequence and expert parallelism (training): the
  Megatron column / row split of attention heads and MLP units, the L
  axis of the activations between layers, the stacked experts of a MoE
  FFN (models/sharding.py, models/layers.py, ops/moe.py).
- ``kb``    — the retrieval scale axis: a KB matrix (or a BM25 corpus) is
  row-split over it; each rank searches its shard and the candidates are
  merged after one all-gather (ops/mips.topk_sharded).
- ``pipe``  — pipeline parallelism: the layers of an encoder in equal
  stages, one a rank, and microbatches streamed through the stage ring
  (ops/pipeline.py, ``models.bert.encode_pipelined``; training, and any
  forward of a staged encoder). Serving does not stage its encoders.

A :class:`MeshContext` wraps a ``torch.distributed.device_mesh.DeviceMesh``
over the world of processes started with ``torch.distributed`` (NCCL for
CUDA devices, gloo for the CPU). Without a process group, and outside
:func:`use`, :func:`current` is a world of one: every single-device path
runs as it does without a mesh, with no collective.

This module is the one place in the port that calls a collective, as
``core/mesh.py`` is the one place that names the axes in the reference.
Every collective here records its name, axis and bytes moved in
``MeshContext.collective_log``, so that tests can hold the traffic to its
contract (candidate-sized for search, never score- or KB-sized). The log
keeps the last ``COLLECTIVE_LOG_LEN`` entries: a long-running server's
memory does not grow with its requests.

Training adds :func:`all_reduce`, :func:`reduce_scatter` and
differentiable operators (``torch.autograd.Function``), the Megatron
pair and its sequence-parallel companions:

- :func:`copy_to`: identity forward, all-reduce backward (Megatron *f*);
- :func:`reduce_from`: all-reduce forward, identity backward (*g*);
- :func:`gather_from`: all-gather along ``dim`` forward, this rank's
  slice of the summed cotangent backward (a reduce-scatter);
- :func:`scatter_to`: this rank's slice forward, all-gather backward;
- :func:`gather_to`: all-gather forward, this rank's slice backward (its
  adjoint, for a gathered tensor every rank then uses alike);
- :func:`reduce_scatter_to`: reduce-scatter forward, all-gather backward
  (the sequence-parallel row-parallel output).

The pipeline adds point-to-point calls over an axis: :func:`send_to` /
:func:`recv_from` a neighbour, :func:`ring_shift` (the counterpart of
``lax.ppermute`` over a ring) and :func:`broadcast` from one coordinate,
all logged.

A view of a context can mark that the computation under it runs on this
rank's block of a global batch's rows (:func:`row_block`): whoever splits
the rows marks the call, and ``ops.moe`` then groups the global batch's
tokens, as the reference's single program does, with or without
gradients.

gloo and CUDA tensors: gloo takes CUDA tensors in every collective used
here (all-gather, all-reduce, broadcast, reduce-scatter; checked on the
card, torch 2.11, ``chip_smoke.gloo_cuda_collectives``) and stages them
through host memory itself; :func:`collective_route` names the route a
context's collectives take (``"nccl"``, ``"gloo"`` or
``"gloo-cuda-staged"``) so that a caller can print it. gloo's
point-to-point path hands the transport the tensor's raw pointer, so the
p2p calls here stage a CUDA tensor through pinned host memory themselves
under gloo (``collective_route(ctx, p2p=True)``:
``"gloo-cuda-pinned-host"``). NCCL takes it as it is; NCCL p2p needs
two GPUs, and is not exercised on a machine with one.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
KB_AXIS = "kb"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, PIPE_AXIS, MODEL_AXIS, KB_AXIS)

_ACTIVE: List["MeshContext"] = []
COLLECTIVE_LOG_LEN = 256  # entries a MeshContext keeps


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """A live mesh: the size of each axis, this rank's coordinate on each,
    the device this rank runs on (None for the default world of one: the
    caller's device), and the DeviceMesh whose groups carry the
    collectives (None for a world of one without a process group)."""

    sizes: Dict[str, int]
    coords: Dict[str, int]
    device: Optional[torch.device] = None
    device_mesh: object = None
    collective_log: "collections.deque[Tuple[str, str, int]]" = (
        dataclasses.field(default_factory=lambda: collections.deque(
            maxlen=COLLECTIVE_LOG_LEN), compare=False))
    # the axes this view holds whole (:func:`whole`)
    whole: Tuple[str, ...] = ()
    # (axis, global rows): the computation under this view runs on this
    # rank's block of a batch of that many rows split over the axis
    # (:func:`row_block`)
    row_blocks: Tuple[Tuple[str, int], ...] = ()

    @property
    def data_size(self) -> int:
        return self.size(DATA_AXIS)

    @property
    def model_size(self) -> int:
        return self.size(MODEL_AXIS)

    @property
    def kb_size(self) -> int:
        return self.size(KB_AXIS)

    @property
    def pipe_size(self) -> int:
        return self.size(PIPE_AXIS)

    @property
    def distributed(self) -> bool:
        """Whether this context's collectives go through a process group
        (True for a NCCL or gloo world of one too)."""
        return self.device_mesh is not None

    @property
    def rank(self) -> int:
        """This process's rank in the world (0 without a process group)."""
        return dist.get_rank() if self.distributed else 0

    def coordinate(self, axis: str) -> int:
        return 0 if axis in self.whole else self.coords[axis]

    def size(self, axis: str) -> int:
        return 1 if axis in self.whole else self.sizes[axis]

    def global_rows(self, axis: str = DATA_AXIS) -> Optional[int]:
        """The row count of the global batch whose block (``row_share``)
        this rank computes, where a view marks rows split over ``axis``
        (:func:`row_block`) and the axis has several ranks; else None."""
        if self.size(axis) == 1:
            return None
        return dict(self.row_blocks).get(axis)

    def group(self, axis: str):
        """The process group of ``axis`` (None without a process group,
        or where this view holds the axis whole)."""
        if not self.distributed or axis in self.whole:
            return None
        return self.device_mesh.get_group(mesh_dim=axis)


def _local(device=None) -> MeshContext:
    ones = {axis: 1 for axis in AXES}
    zeros = {axis: 0 for axis in AXES}
    return MeshContext(ones, zeros,
                       None if device is None else torch.device(device))


def make_mesh(data: Optional[int] = None, model: int = 1, kb: int = 1,
              pipe: int = 1, device=None) -> MeshContext:
    """Build the framework mesh over the world of processes.

    By default every process goes to the ``data`` axis. Without a process
    group the world is this one process: the mesh must then be 1 x 1 x 1
    x 1, and has no collective. With one, every process of the world must
    call this together (it creates the axes' process groups). ``device``
    is this rank's device; by default the current CUDA device under NCCL
    and the CPU under gloo. Raises when the mesh is not the world's size.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = world // (model * kb * pipe)
    if data * model * kb * pipe != world:
        raise ValueError(f"mesh {data}x{pipe}x{model}x{kb} != {world} "
                         "processes")
    if not dist.is_initialized():
        return _local(device)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    from torch.distributed.device_mesh import init_device_mesh

    shape = (data, pipe, model, kb)
    device_mesh = init_device_mesh(device.type, shape, mesh_dim_names=AXES)
    coords = dict(zip(AXES, device_mesh.get_coordinate()))
    return MeshContext(dict(zip(AXES, shape)), coords, device, device_mesh)


def make_kb_mesh(kb: Optional[int] = None, device=None) -> MeshContext:
    """Every process on the ``kb`` axis — the search-serving layout."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    kb = kb if kb is not None else world
    return make_mesh(data=world // kb, model=1, kb=kb, device=device)


@contextlib.contextmanager
def use(ctx: MeshContext):
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


def whole(ctx: MeshContext, axis: str) -> MeshContext:
    """A view of ``ctx`` that holds ``axis`` whole: its size reads 1, its
    coordinate 0, and its collectives are identities. For work that every
    rank of the axis does alike on the same data (the rows of a batch that
    the ``data`` axis does not split); the other axes and the collective
    log are ``ctx``'s."""
    return dataclasses.replace(ctx, whole=ctx.whole + (axis,))


def row_block(ctx: MeshContext, n: int, axis: str = DATA_AXIS
              ) -> MeshContext:
    """A view of ``ctx`` marking that the computation under it runs on
    this rank's block (:func:`row_share`) of a global batch of ``n`` rows
    split over ``axis``, every rank's block of the same height (the last
    ones padded). Whoever splits the rows marks the call
    (``train.data_parallel.Rows``, the embedders, the packed reader);
    ``ops.moe`` reads the mark (``MeshContext.global_rows``)."""
    blocks = tuple((a, m) for a, m in ctx.row_blocks if a != axis)
    return dataclasses.replace(ctx, row_blocks=blocks + ((axis, int(n)),))


def rows_scope(ctx: MeshContext, n: int, axis: str = DATA_AXIS):
    """``use(row_block(ctx, n, axis))`` where ``axis`` has several ranks;
    else nothing (the caller's mesh stays current)."""
    if ctx.size(axis) == 1:
        return contextlib.nullcontext(ctx)
    return use(row_block(ctx, n, axis))


def current() -> MeshContext:
    """The innermost mesh of :func:`use`, else a world of one (each
    process alone, no collective) on the caller's device."""
    if _ACTIVE:
        return _ACTIVE[-1]
    return _local()


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def init_from_env(device: Optional[str] = None) -> torch.device:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``)
    and return this rank's device: ``cuda:LOCAL_RANK`` under NCCL, or the
    CPU under gloo when ``device`` names it. Nothing calls this implicitly;
    the command line does when ``WORLD_SIZE`` is set."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device is not None and torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for this rank; run with "
                "--device cpu for a gloo world on the CPU")
        dev, backend = torch.device("cuda", local_rank), "nccl"
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, rank=rank, world_size=world, **kwargs)
    return dev


def collective_route(ctx: MeshContext, p2p: bool = False) -> str:
    """How ``ctx``'s collectives (with ``p2p``, its point-to-point calls)
    move tensors on its device: ``"local"`` without a process group,
    ``"nccl"``, ``"gloo"``, or for CUDA tensors under gloo
    ``"gloo-cuda-staged"`` (gloo copies them through host memory inside
    the collective) and, for p2p, ``"gloo-cuda-pinned-host"`` (this
    module copies them through pinned host memory: gloo's send and recv
    take the raw pointer)."""
    if not ctx.distributed:
        return "local"
    backend = dist.get_backend(ctx.group(KB_AXIS))
    if backend == "gloo" and ctx.device.type == "cuda":
        return "gloo-cuda-pinned-host" if p2p else "gloo-cuda-staged"
    return backend


# ---- collectives -----------------------------------------------------------
def all_gather(ctx: MeshContext, x: torch.Tensor, axis: str) -> torch.Tensor:
    """(size(axis), *x.shape): every rank's ``x`` along ``axis``, in the
    order of the axis' coordinates. Without a process group, ``x[None]``
    and no collective. Logs the gathered bytes."""
    group = ctx.group(axis)
    if group is None:
        return x.unsqueeze(0)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ctx.size(axis))]
    dist.all_gather(parts, x, group=group)
    ctx.collective_log.append(
        ("all_gather", axis, x.numel() * x.element_size() * len(parts)))
    return torch.stack(parts)


def barrier(ctx: MeshContext) -> None:
    """Wait for every rank of the world (nothing without a process
    group)."""
    if ctx.distributed:
        dist.barrier()


def row_share(ctx: MeshContext, n: int, axis: str = DATA_AXIS
              ) -> Tuple[int, int]:
    """(start, rows): this rank's block of ``n`` rows split evenly over
    ``axis`` after padding ``n`` to a multiple of its size."""
    per = -(-n // ctx.size(axis))
    return ctx.coordinate(axis) * per, per


def split_rows(ctx: MeshContext, x, axis: str = DATA_AXIS):
    """This rank's block of the leading rows of ``x`` (numpy or a
    tensor), zero rows appended so that every rank's block has the same
    height."""
    start, per = row_share(ctx, len(x), axis)
    part = x[start: start + per]
    missing = per - len(part)
    if not missing:
        return part
    if isinstance(part, torch.Tensor):
        return torch.cat([part, part.new_zeros((missing,) + part.shape[1:])])
    return np.concatenate(
        [part, np.zeros((missing,) + part.shape[1:], part.dtype)])


def gather_rows(ctx: MeshContext, local: torch.Tensor, n: int,
                axis: str = DATA_AXIS) -> torch.Tensor:
    """Inverse of :func:`split_rows` on a per-rank output: the blocks of
    every rank along ``axis`` in order, the padding rows cut off (the
    first ``n`` rows)."""
    return all_gather(ctx, local, axis).flatten(0, 1)[:n]


# ---- training collectives ---------------------------------------------------
def _log(ctx: MeshContext, op: str, axis: str, x: torch.Tensor) -> None:
    ctx.collective_log.append((op, axis, x.numel() * x.element_size()))


def _peer(ctx: MeshContext, axis: str, coord: int) -> int:
    """The global rank of the rank at ``coord`` on ``axis`` (this rank's
    coordinates on the other axes)."""
    return dist.get_global_rank(ctx.group(axis), coord % ctx.size(axis))


def _staged(ctx: MeshContext, axis: str, x: torch.Tensor) -> bool:
    return (x.device.type == "cuda"
            and dist.get_backend(ctx.group(axis)) == "gloo")


def _p2p(ctx: MeshContext, axis: str, sends, recvs) -> None:
    """Post every send ``(tensor, coord)`` and receive ``(buffer, coord)``
    over ``axis`` in one ``batch_isend_irecv`` and wait for them. Under
    gloo a CUDA tensor goes through pinned host memory (gloo hands the
    transport the raw pointer)."""
    ops, copies = [], []
    for x, coord in sends:
        x = x.detach().contiguous()
        if _staged(ctx, axis, x):
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            x = host
        ops.append(dist.P2POp(dist.isend, x, _peer(ctx, axis, coord),
                              group=ctx.group(axis)))
        _log(ctx, "send", axis, x)
    for buf, coord in recvs:
        target = buf
        if _staged(ctx, axis, buf):
            target = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            copies.append((buf, target))
        ops.append(dist.P2POp(dist.irecv, target, _peer(ctx, axis, coord),
                              group=ctx.group(axis)))
        _log(ctx, "recv", axis, buf)
    if not ops:
        return
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for buf, host in copies:
        buf.copy_(host, non_blocking=True)


def send_to(ctx: MeshContext, x: torch.Tensor, axis: str, coord: int
            ) -> None:
    """Send ``x`` to the rank at ``coord`` on ``axis`` (waits until it is
    taken). Without a process group on the axis, nothing."""
    if ctx.group(axis) is not None:
        _p2p(ctx, axis, [(x, coord)], [])


def recv_from(ctx: MeshContext, like: torch.Tensor, axis: str, coord: int
              ) -> torch.Tensor:
    """A tensor of ``like``'s shape, dtype and device received from the
    rank at ``coord`` on ``axis``."""
    buf = torch.empty_like(like, memory_format=torch.contiguous_format)
    if ctx.group(axis) is not None:
        _p2p(ctx, axis, [], [(buf, coord)])
    return buf


def ring_shift(ctx: MeshContext, x: torch.Tensor, axis: str = PIPE_AXIS,
               shift: int = 1) -> torch.Tensor:
    """Every rank's ``x`` moved ``shift`` places along the ring of
    ``axis``: this rank sends its ``x`` to coordinate ``c + shift`` and
    returns what ``c - shift`` sent (``lax.ppermute`` with the pairs
    ``(i, i + shift mod S)``). Without a process group, ``x``."""
    if ctx.group(axis) is None or ctx.size(axis) == 1:
        return x
    c = ctx.coordinate(axis)
    buf = torch.empty_like(x, memory_format=torch.contiguous_format)
    _p2p(ctx, axis, [(x, c + shift)], [(buf, c - shift)])
    return buf


def broadcast(ctx: MeshContext, x: torch.Tensor, axis: str, coord: int
              ) -> torch.Tensor:
    """The ``x`` of the rank at ``coord`` on ``axis``, on every rank of
    the axis, in place: ``x`` itself where it is contiguous (else a
    contiguous copy), overwritten on the other ranks (their ``x`` gives
    the shape and dtype only). Without a process group, ``x``."""
    group = ctx.group(axis)
    if group is None:
        return x
    y = x.detach().contiguous()
    dist.broadcast(y, src=_peer(ctx, axis, coord), group=group)
    _log(ctx, "broadcast", axis, y)
    return y


def all_reduce(ctx: MeshContext, x: torch.Tensor, axis: str,
               op: str = "sum", inplace: bool = False) -> torch.Tensor:
    """The sum (or, with ``op="mean"``, the mean) of every rank's ``x``
    along ``axis``: a new tensor (``x`` is left as it is), or with
    ``inplace`` ``x`` itself, reduced where it lies. Without a process
    group, ``x``."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    group = ctx.group(axis)
    if group is None:
        return x
    y = x.detach() if inplace else x.detach().clone()
    dist.all_reduce(y, group=group)
    _log(ctx, "all_reduce", axis, y)
    if op == "mean":
        y = y.div_(ctx.size(axis)) if inplace else y / ctx.size(axis)
    return y


def reduce_scatter(ctx: MeshContext, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
    """This rank's block, along ``dim``, of the sum of every rank's ``x``
    along ``axis`` (``x.shape[dim]`` must divide by the axis' size). Logs
    the bytes of ``x``."""
    group = ctx.group(axis)
    if group is None:
        return x
    size = ctx.size(axis)
    if x.shape[dim] % size:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide by the {axis!r} axis' {size}")
    _log(ctx, "reduce_scatter", axis, x)
    moved = x.detach().movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // size,) + moved.shape[1:])
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def _cat_gather(ctx: MeshContext, x: torch.Tensor, axis: str, dim: int
                ) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated along ``dim``."""
    parts = all_gather(ctx, x.detach(), axis)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def _slice(ctx: MeshContext, x: torch.Tensor, axis: str, dim: int
           ) -> torch.Tensor:
    size = ctx.size(axis)
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"by the {axis!r} axis' {size}")
    return x.chunk(size, dim)[ctx.coordinate(axis)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axis):
        fctx.mesh, fctx.axis = ctx, axis
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return all_reduce(fctx.mesh, g, fctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axis):
        return all_reduce(ctx, x, axis)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axis, dim):
        fctx.mesh, fctx.axis, fctx.dim = ctx, axis, dim
        return _cat_gather(ctx, x, axis, dim)

    @staticmethod
    def backward(fctx, g):
        return (reduce_scatter(fctx.mesh, g, fctx.axis, fctx.dim), None,
                None, None)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axis, dim):
        fctx.mesh, fctx.axis, fctx.dim = ctx, axis, dim
        return _slice(ctx, x, axis, dim)

    @staticmethod
    def backward(fctx, g):
        return _cat_gather(fctx.mesh, g, fctx.axis, fctx.dim), None, None, \
            None


class _GatherTo(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axis, dim):
        fctx.mesh, fctx.axis, fctx.dim = ctx, axis, dim
        return _cat_gather(ctx, x, axis, dim)

    @staticmethod
    def backward(fctx, g):
        return _slice(fctx.mesh, g, fctx.axis, fctx.dim), None, None, None


class _ReduceScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axis, dim):
        fctx.mesh, fctx.axis, fctx.dim = ctx, axis, dim
        return reduce_scatter(ctx, x, axis, dim)

    @staticmethod
    def backward(fctx, g):
        return _cat_gather(fctx.mesh, g, fctx.axis, fctx.dim), None, None, \
            None


def _active(ctx: Optional[MeshContext], axis: str) -> Optional[MeshContext]:
    ctx = ctx if ctx is not None else current()
    return ctx if ctx.group(axis) is not None else None


def copy_to(x: torch.Tensor, axis: str = MODEL_AXIS,
            ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """Megatron *f*: ``x`` forward; the cotangent summed over ``axis``
    backward (the input of a column-parallel layer). ``ctx`` defaults to
    :func:`current`; without a process group, ``x``."""
    ctx = _active(ctx, axis)
    return x if ctx is None else _CopyTo.apply(x, ctx, axis)


def reduce_from(x: torch.Tensor, axis: str = MODEL_AXIS,
                ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """Megatron *g*: the sum of every rank's ``x`` over ``axis`` forward;
    the cotangent as it is backward (the output of a row-parallel
    layer)."""
    ctx = _active(ctx, axis)
    return x if ctx is None else _ReduceFrom.apply(x, ctx, axis)


def gather_from(x: torch.Tensor, axis: str = DATA_AXIS, dim: int = 0,
                ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """Every rank's ``x`` over ``axis`` concatenated along ``dim``
    forward; backward, this rank's block of the cotangent summed over the
    axis. Every rank that computes the same loss from the gathered tensor
    sends back ``size(axis)`` times its gradient: a trainer that averages
    gradients over ``axis`` then holds the gradient of that one loss."""
    ctx = _active(ctx, axis)
    return x if ctx is None else _GatherFrom.apply(x, ctx, axis, dim)


def gather_to(x: torch.Tensor, axis: str = MODEL_AXIS, dim: int = 1,
              ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """Every rank's ``x`` over ``axis`` concatenated along ``dim``
    forward; backward, this rank's block of its own cotangent. For a
    gathered tensor that every rank of the axis then computes with in the
    same way (the cotangents agree): the adjoint of :func:`scatter_to`."""
    ctx = _active(ctx, axis)
    return x if ctx is None else _GatherTo.apply(x, ctx, axis, dim)


def scatter_to(x: torch.Tensor, axis: str = MODEL_AXIS, dim: int = 1,
               ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` forward (the inverse of
    :func:`gather_from`); the cotangents gathered back backward."""
    ctx = _active(ctx, axis)
    return x if ctx is None else _ScatterTo.apply(x, ctx, axis, dim)


def reduce_scatter_to(x: torch.Tensor, axis: str = MODEL_AXIS, dim: int = 1,
                      ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``axis`` forward;
    the cotangents gathered back backward (a sequence-parallel row-parallel
    layer's output, split on L)."""
    ctx = _active(ctx, axis)
    return x if ctx is None else _ReduceScatterTo.apply(x, ctx, axis, dim)
