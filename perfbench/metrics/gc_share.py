"""Share of the traced window that Python's garbage collector held the
process: the program's ``gc.pause_s`` counter (every generation's pauses,
counted while tracing is on) over the window's length."""
from perfbench.recorder import recording


def read(run):
    rec = recording()
    if rec is None or not run.trace or run.trace["window_s"] <= 0:
        return None
    pause = rec.counters.get("gc.pause_s")
    if pause is None:
        return None
    return 100.0 * pause / run.trace["window_s"]
