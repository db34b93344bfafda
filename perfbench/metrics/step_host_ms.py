"""Host wall of one optimizer step of ``Trainer.fit``: the mean of the
window's ``train.step`` spans (upload, forward, backward and AdamW
enqueued; as long as the device time where the host waits for it)."""
from perfbench.recorder import mean_ms, spans


def read(run):
    return mean_ms([s.seconds for s in spans("train.step")])
