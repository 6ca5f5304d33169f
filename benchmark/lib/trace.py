"""Reduction of a ``torch.profiler`` trace of the traced window.

- Busy: the union of every device interval (kernels, copies, sets) inside
  the window, so overlapping work counts once; the window is the span of
  the ``bench.window`` record.
- Launches: host calls that put work on the device (runtime and driver
  kernel launches, cooperative and cluster launches, graph launches).
- Breakdown: the device operations that took most time, and the longest
  idle gaps, each named by the innermost host event that covers its middle.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

WINDOW = "bench.window"
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
    "cudaLaunchCooperativeKernel", "cudaLaunchCooperativeKernelMultiDevice",
    "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel",
    "cudaGraphLaunch", "cuGraphLaunch",
})

# the device activities that are work: kernels, copies, sets
DEVICE_WORK = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """Merged intervals clipped to ``[lo, hi]``."""
    out: List[Interval] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def gaps(busy: List[Interval], lo: float, hi: float) -> List[Interval]:
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def reduce(device: List[Tuple[str, float, float]], host: List[Tuple[str, float, float]],
           lo: float, hi: float, top: int = 10) -> Dict:
    """``device``/``host``: (name, start s, end s) events; ``[lo, hi]``: the
    window. Returns busy and window seconds, launch count and breakdown."""
    busy = union(((a, b) for _, a, b in device), lo, hi)
    busy_s = sum(b - a for a, b in busy)
    by_op: Dict[str, float] = defaultdict(float)
    for name, a, b in device:
        d = min(b, hi) - max(a, lo)
        if d > 0:
            by_op[name] += d
    launches = sum(1 for name, a, _ in host if name in LAUNCH_CALLS and lo <= a <= hi)
    # the innermost host event covering each gap's middle: of the events
    # begun by then and not ended, the one begun last (a max-heap on the
    # start, ended events dropped as they surface)
    spans = sorted((a, b, name) for name, a, b in host if b > a)
    by_gap: Dict[str, float] = defaultdict(float)
    active: list = []
    i = 0
    for a, b in gaps(busy, lo, hi):
        mid = (a + b) / 2
        while i < len(spans) and spans[i][0] <= mid:
            heapq.heappush(active, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        by_gap[active[0][2] if active else "host outside any recorded event"] += b - a
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"busy_s": busy_s, "window_s": hi - lo, "launches": launches,
            "device_ops": [[k, v] for k, v in rank(by_op)],
            "idle_gaps": [[k, v] for k, v in rank(by_gap)]}


def is_device_work(e) -> bool:
    """Whether a device-side kineto event is work: a record_function also
    leaves a span on the device's timeline (a GPU user annotation), which
    is none. (``activity_type`` is newer than some torch releases.)"""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_WORK
    return not e.is_user_annotation()


def from_profiler(prof) -> Dict:
    """:func:`reduce` over a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if is_device_work(e):
                device.append((e.name(), a, b))
        else:
            host.append((e.name(), a, b))
            if e.name() == WINDOW:
                window = (a, b)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} record")
    return reduce(device, [h for h in host if h[0] != WINDOW], *window)
