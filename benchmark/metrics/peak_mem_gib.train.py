"""peak_mem_gib.train: torch.cuda.max_memory_allocated() over the window
(reset after set-up), in GiB: what the timed path holds at once."""


def read(run, drv):
    return run.window["peak_bytes"] / 2 ** 30 if run.on_card else None
