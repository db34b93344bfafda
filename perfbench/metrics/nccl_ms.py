"""NCCL's device time a training step on rank 0's card: the union of the
intervals of the kernels whose names hold ``nccl`` in rank 0's traced
window (the gradient all-reduce, the gathers of the [CLS] states and the
sums of their cotangents), over the window's steps. A NCCL kernel starts
when it is launched and runs until every rank has joined it, so this time
includes rank 0's wait for the slowest rank; None where the trace holds
no NCCL kernel."""


def read(run):
    t, steps = run.trace, run.facts.get("steps")
    if not t or not t.get("nccl_s") or not steps:
        return None
    return 1e3 * t["nccl_s"] / steps
