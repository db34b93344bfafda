"""The ``data`` axis of training: the rows of a global batch that each rank
computes, and the global-batch view of what it computes (the JAX trainer's
sharded batch and XLA's global program, made explicit).

Every rank builds the same global batch (same data, same seed), and the
trainer hands the whole of it to the loss on every rank, with its
host-only leaves (strings, ragged or string lists) dropped
(``core.device.upload_batch``, the JAX trainer's rule). Labels, pointers and
every other leaf are thus global as they are. A trainee takes this rank's
rows of its encoder inputs only (:class:`Rows`): a block of them over
``data`` when their count divides by the axis' size (the JAX trainer's
default rule), else every row, computed alike on every rank under a view
of the mesh that holds ``data`` whole (``core.mesh.whole``). It runs the
encoder on those rows, then makes the per-sequence outputs global
(:meth:`Rows.gather`: one ``gather_from`` over ``data``, whose backward
sums each rank's cotangent, so that with the trainer's mean over ``data``
the gradient is that of the one global loss). The objective then runs on
the global batch: its in-batch negatives are every rank's rows and its
normalisers count the global batch. A loss that takes no rows of its own
computes the whole batch on every rank, and the mean is its gradient.

A packed canvas's rows split like any encoder input, while its pointers
(``canvas_cls_rows``, ``gather_idx``, ...) index the global canvas:
:meth:`Rows.rebase` / :meth:`Rows.rebase_flat` turn them into this rank's
rows and a mask, and :meth:`Rows.combine` sums the masked per-sequence
outputs over ``data`` (each sequence lives on one rank's rows). The whole
canvas is never gathered. :func:`packed_read` does all of it around one
packed apply, for the trainees and for the packed embedders
(``ir/embedding.py``), with or without gradients.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from viquae_torch.core import mesh as meshlib
from viquae_torch.core.mesh import DATA_AXIS


def _first_tensor(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            t = _first_tensor(v)
            if t is not None:
                return t
        return None
    return tree if isinstance(tree, torch.Tensor) else None


class Rows:
    """The rows of a global batch of ``n`` rows that this rank computes,
    on the mesh ``ctx`` (default: the current one): a block of ``per`` rows
    from ``start`` when ``n`` divides by the ``data`` axis' size
    (``split``), else all ``n``."""

    def __init__(self, n: int, ctx: Optional[meshlib.MeshContext] = None):
        self.ctx = ctx = ctx if ctx is not None else meshlib.current()
        size = ctx.size(DATA_AXIS)
        self.n = n
        self.split = (ctx.group(DATA_AXIS) is not None and size > 1
                      and n % size == 0)
        self.per = n // size if self.split else n
        self.start = ctx.coordinate(DATA_AXIS) * self.per if self.split \
            else 0

    @classmethod
    def of(cls, tree, ctx: Optional[meshlib.MeshContext] = None
           ) -> "Rows":
        """The rows of a batch tree (its first tensor's leading dim)."""
        return cls(_first_tensor(tree).shape[0], ctx)

    def take(self, tree):
        """This rank's rows of every tensor of ``tree`` (dicts walked,
        anything else kept)."""
        if isinstance(tree, dict):
            return {k: self.take(v) for k, v in tree.items()}
        if not self.split or not isinstance(tree, torch.Tensor):
            return tree
        if tree.shape[0] != self.n:
            raise ValueError(f"a leaf of {tree.shape[0]} rows among "
                             f"inputs of {self.n}")
        return tree[self.start: self.start + self.per]

    def scope(self):
        """The mesh to compute these rows under: for a block of rows the
        mesh marked as computing this rank's block of ``n``
        (``core.mesh.row_block``: MoE layers group the global batch's
        tokens, in training and in evaluation), else a view that holds
        ``data`` whole (every rank computes the same rows alike: the same
        dropout masks, groups and statistics, no ``data`` collective)."""
        return meshlib.use(meshlib.row_block(self.ctx, self.n) if self.split
                           else meshlib.whole(self.ctx, DATA_AXIS))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global rows of ``x``, an output of these rows."""
        if not self.split:
            return x
        return meshlib.gather_from(x, DATA_AXIS, 0, self.ctx)

    def rebase(self, rows: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Global canvas-row pointers as rows of this rank's block: (local
        rows, mask of the pointers that land in it). Pointers that land
        elsewhere get the row one past the block (a write through them
        drops, a read must use the mask). Unsplit: (rows, None)."""
        if not self.split:
            return rows, None
        local = rows.long() - self.start
        keep = (local >= 0) & (local < self.per)
        return torch.where(keep, local, self.per), keep

    def rebase_flat(self, flat: torch.Tensor, width: int
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Flat canvas positions (row * width + col) as positions in this
        rank's block, as :meth:`rebase`; positions that land elsewhere
        read position 0 (use the mask)."""
        if not self.split:
            return flat, None
        local = flat.long() - self.start * width
        keep = (local >= 0) & (local < self.per * width)
        return torch.where(keep, local, 0), keep

    def combine(self, x: torch.Tensor, keep: Optional[torch.Tensor]
                ) -> torch.Tensor:
        """Per-sequence outputs read through rebased pointers (``keep``:
        the entries this rank's rows hold, broadcast from the left) summed
        over ``data``: each entry comes from the one rank that holds it,
        whole (adding zeros changes no bit)."""
        if keep is None:
            return x
        keep = keep.reshape(keep.shape + (1,) * (x.dim() - keep.dim()))
        masked = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
        size = self.ctx.size(DATA_AXIS)
        return meshlib.gather_from(masked, DATA_AXIS, 0, self.ctx).reshape(
            (size,) + x.shape).sum(dim=0)


def packed_read(packed_apply, params, canvas, pointers, *visual,
                ctx: Optional[meshlib.MeshContext] = None, **kw):
    """A packed apply over this rank's canvas rows: ``canvas`` = (ids,
    segments, positions[, token types]) and ``pointers`` = (cls rows, cls
    cols[, vis rows, vis cols]) of the global canvas, ``visual`` the
    per-sequence inputs; (the global per-sequence outputs, moe_aux or
    None) — moe_aux when ``kw`` asks ``return_aux``."""
    rows_of = Rows.of(canvas[0], ctx)
    rows, keep = rows_of.rebase(pointers[0])
    if keep is not None:
        rows = torch.where(keep, rows, 0)
    cols, *vis = pointers[1:]
    if vis:
        vis[0] = rows_of.rebase(vis[0])[0]
    with rows_of.scope():
        res = packed_apply(params, *(rows_of.take(c) for c in canvas), rows,
                           cols, *vis, *visual, **kw)
    out, aux = res if kw.get("return_aux") else (res, None)
    return rows_of.combine(out, keep), aux
