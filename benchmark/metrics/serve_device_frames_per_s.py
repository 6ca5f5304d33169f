"""serve_device_frames_per_s: frames screened per second of the device's
work: the frames of every batch dispatched in the traced window (all of
which complete inside it) over the seconds in which the device ran any
kernel, copy or set there (the union of their intervals in the
torch.profiler trace). What the card spends on a frame, whatever pace the
host keeps; a run without a device trace reads nothing."""


def read(run, drv):
    t = run.traced
    return t["frames"] / t["busy_s"] if t.get("busy_s") else None
