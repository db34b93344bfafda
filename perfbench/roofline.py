"""Peaks, rooflines and model FLOPs, computed from shapes.

``bound_ms`` and the peaks are frozen copies of ``chip_smoke.py``
l. 309-313 and 509-526 (the NVIDIA H100 SXM data sheet,
dense rates, 700 W). The model FLOPs count what the inputs need: the real
tokens, not the canvas or the padding.
"""
from __future__ import annotations

from typing import Iterable

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
PEAKS = {"bf16": PEAK_BF16_FLOPS, "f32": PEAK_F32_FLOPS}


def bound_ms(q_count, dim, n, itemsize, peak_flops, out_bytes) -> dict:
    """The least time the card could take: operations over the peak rate
    of their type, or each input read once and each output written once
    over the memory rate, whichever is larger."""
    flops = 2 * q_count * dim * n
    moved = (q_count + n) * dim * itemsize + out_bytes
    ops_ms = flops / peak_flops * 1e3
    bytes_ms = moved / PEAK_HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": moved}


def b1_bound(q_count: int, n_rows: int, dim: int) -> dict:
    """B1 (``score_segmax``): bf16 operands, bf16 scores and one bf16
    maximum a 128-row segment written."""
    out_bytes = q_count * n_rows * 2 + q_count * (n_rows // 128) * 2
    return bound_ms(q_count, dim, n_rows, 2, PEAK_BF16_FLOPS, out_bytes)


def bert_params(b: dict) -> int:
    """Non-embedding parameters of a BERT encoder without pooler."""
    h, ff, layers = (b["hidden_size"], b["intermediate_size"],
                     b["num_hidden_layers"])
    per_layer = 4 * (h * h + h) + (h * ff + ff) + (ff * h + h) + 4 * h
    return layers * per_layer


def encoder_flops(b: dict, lengths: Iterable[int], train: bool = False
                  ) -> float:
    """Forward FLOPs of the encoder over sequences of ``lengths`` real
    tokens, each attending only to itself: 2 x parameters x tokens plus
    4 x length^2 x hidden a layer for the two attention products; three
    times that with the backward pass (remat's recomputation not
    counted)."""
    lengths = list(lengths)
    tokens = sum(lengths)
    attn = 4 * b["num_hidden_layers"] * b["hidden_size"] * sum(
        s * s for s in lengths)
    fwd = 2 * bert_params(b) * tokens + attn
    return 3 * fwd if train else fwd


def search_flops(q_count: int, n_rows: int, dim: int) -> float:
    return 2.0 * q_count * n_rows * dim
