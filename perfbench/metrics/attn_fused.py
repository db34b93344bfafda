"""Share of the window's attention calls that ran the fused packed-segment
kernel: the program's ``attention.fused_calls`` over ``fused_calls +
plain_calls`` (``layers.mha`` counts each call by its path). None where
the program counts neither, as a program without the kernel does."""
from perfbench.recorder import recording


def read(run):
    rec = recording()
    if rec is None:
        return None
    fused = rec.counters.get("attention.fused_calls", 0)
    plain = rec.counters.get("attention.plain_calls", 0)
    if not fused + plain:
        return None
    return 100.0 * fused / (fused + plain)
