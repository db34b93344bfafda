"""The 95th percentile of the online service's latency over all requests
due in the window, each timed from when it was due (host clock). It swings
with the collector's full collections, which land in some windows and not
in others, so it stands here beside the end-to-end median."""
import numpy as np


def read(run):
    latency = run.facts.get("latency_s")
    if latency is None or not len(latency) or not np.isfinite(latency).all():
        return None
    return 1e3 * float(np.percentile(latency, 95))
