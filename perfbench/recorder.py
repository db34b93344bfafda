"""The program's own recording of the traced window, for the readers of
program spans and counters: ``viquae_torch.core.profiling.recorded()``
(the spans and counters since tracing last turned on, that is since the
harness's profiler started), or None where the program has no recorder."""
from __future__ import annotations

from typing import List, Optional


def recording():
    try:
        from viquae_torch.core import profiling
    except ImportError:
        return None
    read = getattr(profiling, "recorded", None)
    return read() if read is not None else None


def spans(name: str) -> list:
    """The window's spans named ``name`` (none without a recorder)."""
    rec = recording()
    return [] if rec is None else rec.named(name)


def mean_ms(values: List[float]) -> Optional[float]:
    return 1e3 * sum(values) / len(values) if values else None
