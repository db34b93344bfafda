"""Device time of one optimizer step of ``Trainer.fit``: the mean of the
window's ``train.step`` device spans (two CUDA events around the step);
None where no device time was recorded."""
from perfbench.recorder import mean_ms, spans


def read(run):
    return mean_ms([s.device_s for s in spans("train.step")
                    if s.device_s is not None])
