"""train_frames_per_s: every frame of every update completed in the window,
over the window, by the host's clock (the window closes at the end of the
first update completed after ``--seconds``, synchronised)."""


def read(run, drv):
    w = run.window
    return w["frames"] / w["seconds"]
