"""Kernel B1's share of its roofline: the least time of one launch at the
batch's real shapes (``roofline.b1_bound``: Q queries, the KB's rows, d,
bf16, operation-bound) over B1's mean device time a launch, found by its
kernel name in the trace."""
from perfbench.roofline import b1_bound

KERNEL = "score_segmax_sm90"


def read(run):
    if not run.trace:
        return None
    hits = [(n, t) for name, (n, t) in run.trace["kernels"].items()
            if KERNEL in name]
    launches = sum(n for n, _ in hits)
    seconds = sum(t for _, t in hits)
    if not launches or seconds <= 0:
        return None
    f = run.facts
    bound = b1_bound(f["b1_q"], f["kb_rows"], f["dim"])
    return 100.0 * bound["bound_ms"] / (seconds / launches * 1e3)
