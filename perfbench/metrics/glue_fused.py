"""Share of the window's encoder blocks that ran their glue through the
fused kernels: the program's ``glue.fused_calls`` over ``fused_calls +
plain_calls`` (``bert._layer_forward`` counts each block by its path).
None where the program counts neither, as a program without the kernels
does."""
from perfbench.recorder import recording


def read(run):
    rec = recording()
    if rec is None:
        return None
    fused = rec.counters.get("glue.fused_calls", 0)
    plain = rec.counters.get("glue.plain_calls", 0)
    if not fused + plain:
        return None
    return 100.0 * fused / (fused + plain)
