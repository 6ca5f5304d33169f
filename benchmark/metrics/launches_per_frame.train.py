"""launches_per_frame.train: host calls that put work on the device (runtime
and driver kernel launches, graph launches) in the traced window, over the
frames that window completed (torch.profiler trace)."""


def read(run, drv):
    t = run.traced
    return t["launches"] / t["frames"] if t["frames"] else None
