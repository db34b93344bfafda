"""Share of NCCL's device time on rank 0's card in which no other kernel,
copy or fill ran there (``nccl_ms``'s time that nothing overlaps: the
collectives' cost that the step pays in full, waits for slower ranks
included); None where the trace holds no NCCL kernel."""


def read(run):
    t = run.trace
    if not t or not t.get("nccl_s"):
        return None
    return 100.0 * t["nccl_exposed_s"] / t["nccl_s"]
