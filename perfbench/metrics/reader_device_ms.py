"""Device time of one packed reader step: the mean of the window's
``reader.step`` device spans (two CUDA events around the reader's upload,
forward and span selection); None where no device time was recorded."""
from perfbench.recorder import mean_ms, spans


def read(run):
    return mean_ms([s.device_s for s in spans("reader.step")
                    if s.device_s is not None])
