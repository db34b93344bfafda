"""Small shared helpers (parity meerqat/data/utils.py)."""
from __future__ import annotations

import hashlib


def md5(string: str) -> str:
    return hashlib.md5(string.encode("utf-8")).hexdigest()


def json_integer_keys(d: dict) -> dict:
    return {int(k): v for k, v in d.items()}


def to_markdown_table(metrics: dict) -> str:
    """Metric dict -> markdown table (role of `to_latex`)."""
    header = "| " + " | ".join(metrics) + " |"
    sep = "|---" * len(metrics) + "|"
    row = "| " + " | ".join(
        f"{v:.4f}" if isinstance(v, float) else str(v)
        for v in metrics.values()
    ) + " |"
    return "\n".join([header, sep, row])


def to_latex(metrics: dict) -> str:
    """Metric dict -> one-row LaTeX table body."""
    header = " & ".join(str(k) for k in metrics) + r" \\"
    row = " & ".join(
        f"{v:.4f}" if isinstance(v, float) else str(v)
        for v in metrics.values()
    ) + r" \\"
    return header + "\n" + row
