"""Share of a packed canvas's slots (rows x row length) that hold real
tokens, over the window: the program's ``<prefix>.canvas_tokens`` over
``<prefix>.canvas_slots``. A cell's window records one such pair (the
reader's canvases in ``answer-batch``, the collator's in ``train-dpr``),
and the prefix is read from the recording; None where it holds no pair or
more than one."""
from perfbench.recorder import recording

TOKENS, SLOTS = ".canvas_tokens", ".canvas_slots"


def read(run):
    rec = recording()
    if rec is None:
        return None
    prefixes = {name[:-len(SLOTS)] for name in rec.counters
                if name.endswith(SLOTS)}
    if len(prefixes) != 1:
        return None
    prefix = prefixes.pop()
    slots = rec.counters[prefix + SLOTS]
    if not slots:
        return None
    return 100.0 * rec.counters.get(prefix + TOKENS, 0) / slots
