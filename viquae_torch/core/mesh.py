"""Device mesh and the port's collectives (counterpart of
viquae_tpu/core/mesh.py).

One mesh of processes, one device each, with the reference's four named
axes, in the reference's grid order (data, pipe, model, kb):

- ``data``  — batch parallelism: the embedders split each batch's rows
  over it and gather the outputs back in order.
- ``model`` — tensor parallelism (training; not used by serving yet).
- ``kb``    — the retrieval scale axis: a KB matrix (or a BM25 corpus) is
  row-split over it; each rank searches its shard and the candidates are
  merged after one all-gather (ops/mips.topk_sharded).
- ``pipe``  — pipeline parallelism (training; not used by serving yet).

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

gloo and CUDA tensors: gloo's all-gather takes CUDA tensors and stages
them through host memory itself; :func:`collective_route` names the route
a context's collectives take (``"nccl"``, ``"gloo"`` or
``"gloo-cuda-staged"``) so that a caller can print it.
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

    @property
    def data_size(self) -> int:
        return self.sizes[DATA_AXIS]

    @property
    def model_size(self) -> int:
        return self.sizes[MODEL_AXIS]

    @property
    def kb_size(self) -> int:
        return self.sizes[KB_AXIS]

    @property
    def pipe_size(self) -> int:
        return self.sizes[PIPE_AXIS]

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
        return self.coords[axis]

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def group(self, axis: str):
        """The process group of ``axis`` (None without a process group)."""
        if not self.distributed:
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


def collective_route(ctx: MeshContext) -> str:
    """How ``ctx``'s collectives move tensors on its device: ``"local"``
    without a process group, ``"nccl"``, ``"gloo"``, or
    ``"gloo-cuda-staged"`` (gloo copies CUDA tensors through host memory
    inside the collective)."""
    if not ctx.distributed:
        return "local"
    backend = dist.get_backend(ctx.group(KB_AXIS))
    if backend == "gloo" and ctx.device.type == "cuda":
        return "gloo-cuda-staged"
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
