"""Median wait of the online service's requests in ``DynamicBatcher``,
from each request's ``submit`` to the start of its dispatch: the
window's ``batcher.wait`` spans (forming the batch, at most
``max_wait_ms``, and waiting for one of the ``max_inflight`` slots)."""
import statistics

from perfbench.recorder import spans


def read(run):
    waits = [s.seconds for s in spans("batcher.wait")]
    if not waits:
        return None
    return 1e3 * statistics.median(waits)
