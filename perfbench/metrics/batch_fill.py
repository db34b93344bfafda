"""Share of the dispatch slots the online batcher filled over the window:
``DynamicBatcher.n_items / (n_dispatches x max_batch)`` (program counters,
read before and after the window)."""


def read(run):
    f = run.facts
    if not f.get("n_dispatches"):
        return None
    return 100.0 * f["n_items"] / (f["n_dispatches"] * f["max_batch"])
