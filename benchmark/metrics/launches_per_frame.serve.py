"""launches_per_frame.serve: host calls that put work on the device (runtime
and driver kernel launches, graph launches) in the traced window, over the
frames of every batch it dispatched (torch.profiler trace)."""


def read(run, drv):
    t = run.traced
    return t["launches"] / t["frames"] if t["frames"] else None
