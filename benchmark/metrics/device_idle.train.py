"""device_idle.train: the share of the traced window in which the device ran
nothing, in %: 1 - (union of every kernel, copy and set interval) / window,
from the torch.profiler trace of the traced window."""


def read(run, drv):
    t = run.traced
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
