"""serve_frames_per_s.wall: every real frame of every batch completed in the
window, over the window, by the host's clock (the window opens at the first
timed dispatch and closes at the first batch completed after ``--seconds``;
padded tail slots are not frames). The rate a user sees; on this path the
host's dispatch sets it, so it spreads from run to run with the host's pace."""


def read(run, drv):
    w = run.window
    return w["frames"] / w["seconds"]
