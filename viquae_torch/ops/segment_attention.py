"""Fused self-attention of a packed canvas at inference: one pass per
(canvas row, head, tile of 64 queries) in place of the plain path's f32
score tensor.

Replaces no TPU kernel: the JAX package's attention
(viquae_tpu/models/layers.py ``mha``) is plain XLA. On a packed canvas
the port's plain path (``models.layers.mha``) builds an (R, 1, L, L)
block-diagonal bias and an f32 (R, H, L, L) score tensor that makes
about eight trips through device memory; :func:`segment_attention` reads
q, k and v where the projections wrote them and writes the context in
the layout the output projection reads (csrc/segment_attention.cu says
what bounds it and how).

It keeps every rounding point of the plain path: f32 logits from f32 q
and k, scaled by 1/8 after the sum; an exact f32 softmax; probabilities
rounded to bf16 (``probs_dtype``) and back; an f32 product with f32 v.
Keys of other segments are left out, as their probabilities are exact
zeros in the plain path. A padding query (segment id 0 or less) gets
what the plain path gives it: its finite bias makes its softmax uniform
over all L keys, so its context is the uniform probability times the sum
of v. Only the order of f32 sums differs from the plain path.

:func:`segment_attention` launches the kernel for CUDA tensors and runs
:func:`segment_attention_plain`, the same algorithm in plain PyTorch, only
for CPU tensors. ``segment_attention.launches`` counts the launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from viquae_torch.kernels.build import launch

HEAD_DIM = 64
MAX_LEN = 512
TILE = 64       # queries a block (and a tile of the plain version)


def _rounding(probs_dtype: Optional[torch.dtype]) -> bool:
    """Whether the probabilities are rounded to bf16 (else kept f32)."""
    if probs_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"probabilities are kept in f32 or rounded to bf16, "
                        f"not {probs_dtype}")
    return probs_dtype == torch.bfloat16


def segment_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, segment_ids: torch.Tensor,
                            probs_dtype: Optional[torch.dtype] =
                            torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the kernel, tile by tile as it works:
    for each row and tile of 64 queries, the keys its segments cover; the
    logits of those keys, -inf where a key is of another segment; the
    softmax, the rounding and the product with v; padding queries the
    uniform probability times the sum of v over the row.
    (R, L, heads x 64) f32 q, k, v and (R, L) ids -> (R, L, heads x 64)."""
    rows, length, width = q.shape
    heads = width // HEAD_DIM
    round_bf16 = _rounding(probs_dtype)

    def split(t):   # (L, width) -> (heads, L, 64)
        return t.reshape(-1, heads, HEAD_DIM).transpose(0, 1).float()

    uniform = torch.tensor(1.0 / length, dtype=torch.float32)
    if round_bf16:
        uniform = uniform.to(torch.bfloat16).float()
    ctx = torch.empty((rows, length, width), dtype=torch.float32,
                      device=q.device)
    for r in range(rows):
        seg = segment_ids[r].long()
        real = seg > 0
        kr, vr = split(k[r]), split(v[r])
        pad_ctx = (uniform.to(q.device) * vr.sum(dim=1)).reshape(width)
        ctx[r][~real] = pad_ctx
        for q0 in range(0, length, TILE):
            tile_seg = seg[q0: q0 + TILE]
            tile_real = tile_seg > 0
            if not tile_real.any():
                continue
            covered = real & torch.isin(seg, tile_seg[tile_real])
            keys = covered.nonzero().flatten()
            lo, hi = int(keys[0]), int(keys[-1]) + 1
            logits = torch.matmul(split(q[r, q0: q0 + TILE]),
                                  kr[:, lo: hi].transpose(1, 2)) / 8.0
            same = tile_seg[:, None] == seg[None, lo: hi]
            logits = logits.masked_fill(~(same & real[None, lo: hi]),
                                        float("-inf"))
            probs = torch.softmax(logits, dim=-1)
            if round_bf16:
                probs = probs.to(torch.bfloat16).float()
            out = torch.matmul(probs, vr[:, lo: hi])    # (heads, T, 64)
            out = out.transpose(0, 1).reshape(-1, width)
            rows_real = tile_real.nonzero().flatten() + q0
            ctx[r, rows_real] = out[tile_real]
    return ctx


def _check(q, k, v, segment_ids):
    """What the kernel needs: one CUDA device; q, k, v (R, L, heads x 64)
    f32 with last stride 1 and row and token strides that keep every
    16-byte vector aligned, L at most 512; (R, L) contiguous int32 or
    int64 segment ids."""
    tensors = (q, k, v, segment_ids)
    if not all(t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("q, k, v and segment_ids must share one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError(f"q, k and v must be float32, got {q.dtype}, "
                        f"{k.dtype} and {v.dtype}")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_ids must be int32 or int64, got "
                        f"{segment_ids.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one (R, L, width) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    rows, length, width = q.shape
    if width % HEAD_DIM:
        raise ValueError(f"width {width} is not a whole number of "
                         f"{HEAD_DIM}-wide heads")
    if length > MAX_LEN:
        raise ValueError(f"rows of {length} tokens: the kernel takes at "
                         f"most {MAX_LEN}")
    if tuple(segment_ids.shape) != (rows, length) or \
            not segment_ids.is_contiguous():
        raise ValueError(f"segment_ids must be contiguous ({rows}, "
                         f"{length}), got {tuple(segment_ids.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1 or t.stride(0) % 4 or t.stride(1) % 4 \
                or t.data_ptr() % 16:
            # the kernel reads every (token, head) as 16-byte vectors
            raise ValueError(f"{name} must have last stride 1, row and "
                             f"token strides that are multiples of 4 and "
                             f"a 16-byte aligned start, got strides "
                             f"{t.stride()}")


def segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      segment_ids: torch.Tensor,
                      probs_dtype: Optional[torch.dtype] = torch.bfloat16
                      ) -> torch.Tensor:
    """Self-attention of each canvas row's segments: q, k, v (R, L,
    heads x 64) f32, the outputs of the projections, read through their
    strides; ``segment_ids`` (R, L), 0 = padding. Returns the context
    (R, L, heads x 64) f32, heads concatenated. ``probs_dtype``: bf16
    rounds the probabilities, f32 or None keeps them. CUDA tensors go to
    the kernel (and nowhere else); CPU tensors to the plain version."""
    round_bf16 = _rounding(probs_dtype)
    if not any(t.is_cuda for t in (q, k, v, segment_ids)):
        return segment_attention_plain(q, k, v, segment_ids, probs_dtype)
    _check(q, k, v, segment_ids)
    rows, length, width = q.shape
    ctx = torch.empty((rows, length, width), dtype=torch.float32,
                      device=q.device)
    launch("segment_attention", "segment_attention_launch", q, k, v,
           segment_ids, ctx, rows, length, width // HEAD_DIM, q.stride(0),
           q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
           segment_ids.element_size(), int(round_bf16))
    segment_attention.launches += 1
    return ctx


segment_attention.launches = 0
