"""Measurements of single layers after the window, for the per-layer readers.

- :func:`device_seconds`: the device time of a call, from the profiler:
  every device interval the calls launch, whatever its name, summed, over
  the number of calls. The host's pace between launches does not enter it.
- :func:`module_ms_per_row`: that of one module of the program on one full
  chunk of the cell's inputs, warm, over the chunk's rows.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from benchmark.lib.trace import is_device_work

ITERS = 5


def submodule(model, path: str):
    return functools.reduce(getattr, path.split("."), model)


def device_seconds(call: Callable[[int], object], calls: int) -> float:
    """Seconds of device work per call of ``call(i)``, ``i`` in
    ``range(calls)``, from a profiler trace of those calls (after one
    untraced warm call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            call(i)
        torch.cuda.synchronize()
    total = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA and is_device_work(e))
    return total * 1e-9 / calls


@torch.no_grad()
def module_ms_per_row(run, drv, path: str) -> float:
    x = drv.chunk_input(run)
    mod = submodule(drv.model(run), path)
    return device_seconds(lambda i: mod(x), ITERS) * 1e3 / x.shape[0]
