#!/usr/bin/env python3
"""The benchmark of ewvit_tpu_torch: one cell, one run, one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration (``benchmark/configs``), its traffic mix (``benchmark/traffic``,
whose ``runner`` runs it) and its limits (``benchmark/workloads``). A run:

1. makes the weights and inputs from ``--seed`` on the device, loads the
   weights into the program and warms up every shape the cell uses
   (``setup_s``: process start to the first timed dispatch);
2. measures for ``--seconds`` by the host clock;
3. traces a short further window with ``torch.profiler``, where the cell
   has an end-to-end metric read from the device's trace or with
   ``--trace 1``, and reads the cell's end-to-end metrics (``--trace 0``)
   or its per-layer metrics (``--trace 1``), each by its reader
   (``benchmark/metrics/<name>.py``; ``setup_s`` is the run's own);
4. frees the program and holds what the window produced against the fp32
   reference (``benchmark/reference``): ``correct``.

The last line of standard output is the result as JSON; the numbers
compared, each beside its limit, are the last lines of standard error. A
run exits non-zero and prints no result without the CUDA devices the cell
needs, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.lib import common, manifest, trace  # noqa: E402
from benchmark.lib.context import Run  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="ewvit_tpu_torch benchmark: one cell, one run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Refused(SystemExit):
    """A run that must print no result."""


def guard() -> None:
    found = common.forbidden_loaded()
    if found:
        print(f"benchmark: forbidden modules loaded in the measured process: {found}",
              file=sys.stderr)
        raise Refused(3)


def _traced(run: Run, drv) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.on_card else [])
    run.sync()
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            info = drv.traced(run)
    red = trace.from_profiler(prof)
    del prof
    red.update(info)
    return red


def execute(run: Run, t_start: float) -> dict:
    """Set up, measure, trace (``run.trace``) and check one run; returns the
    result line's object."""
    drv = manifest.runner(run.traffic, run.cell.root)
    drv.setup(run)
    setup_peak = torch.cuda.max_memory_allocated(run.device) if run.on_card else 0
    if run.on_card:
        torch.cuda.reset_peak_memory_stats(run.device)
    cpu0 = time.process_time()
    drv.measure(run, run.seconds)
    w = run.window
    w["process_cpu_s"] = time.process_time() - cpu0
    w["setup_s"] = w["t0"] - t_start
    w["peak_bytes"] = torch.cuda.max_memory_allocated(run.device) if run.on_card else 0
    # the program's peak: its set-up (from the runner's ``reset_peak``, once
    # the benchmark's own weights and inputs are made) and the window
    w["program_peak_bytes"] = max(setup_peak, w["peak_bytes"])
    guard()

    if run.trace or any(m["source"] == "device_trace" for m in run.cell.end_to_end):
        run.traced = _traced(run, drv)
    chosen = run.cell.per_layer if run.trace else run.cell.end_to_end
    readers = manifest.readers([m for m in chosen if m["name"] != "setup_s"], run.cell.root)
    metrics = {}
    for m in chosen:
        value = w["setup_s"] if m["name"] == "setup_s" else readers[m["name"]].read(run, drv)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = None
    if run.trace:
        breakdown = {"device_ops": run.traced["device_ops"],
                     "idle_gaps": run.traced["idle_gaps"]}

    answers = w.get("answers")
    drv.release(run)
    if run.on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    numbers = drv.check(run, answers)
    compared = {k: {"value": numbers[k], "limit": lim}
                for k, lim in run.cell.limits["check"]["limits"].items()}
    failed_numbers = [k for k, c in compared.items() if not c["value"] <= c["limit"]]
    # a number over its limit fails every answer it was taken over
    failed = int(run.data.get("compared", 0)) if failed_numbers else 0
    guard()

    device = {"platform": "gpu" if run.on_card else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if run.on_card else "cpu",
              "count": run.cell.chips, "memory_peak_bytes": int(w["program_peak_bytes"]),
              "power": common.power_limit() if run.on_card else "cpu"}
    if run.trace:
        device.update(busy_s=run.traced["busy_s"], window_s=run.traced["window_s"])
    result = {"correct": not failed_numbers, "attempted": int(w["units"]),
              "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    run.data["window_note"] = window_note(w)
    return result


def window_note(w: dict) -> str:
    """The host's side of the window, for finding why runs spread: the rate,
    the quartiles and the longest of the times between completions, and the
    process's CPU seconds in it."""
    import statistics

    ends = w.get("ends") or []
    steps = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    gaps = (" step ms q1/q2/q3/max " + "/".join(
        f"{1e3 * v:.2f}" for v in [*statistics.quantiles(steps, n=4), max(steps)])
        if len(steps) >= 2 else "")
    cpu = f" process_cpu_s {w['process_cpu_s']:.4g}" if "process_cpu_s" in w else ""
    return f"window {w['frames'] / w['seconds']:.6g} frames/s over {w['seconds']:.6g} s{gaps}{cpu}"


def _finite(obj):
    """JSON has no infinity: a non-finite number is written as null."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def report(result: dict, note: str = "") -> None:
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    if note:
        print(note, file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)


HOST_THREADS = 2       # one process, few threads: the host paces this program


def main(argv=None) -> int:
    args = parse_args(argv)
    torch.set_num_threads(HOST_THREADS)
    cell = manifest.load_cell(args.workload)
    dev = common.require_cuda(cell.chips)
    if not math.isfinite(args.seconds) or args.seconds <= 0:
        raise SystemExit("--seconds must be positive")
    run = Run(cell, args.seed, args.seconds, bool(args.trace), dev)
    try:
        result = execute(run, T_START)
    except Refused as e:
        return int(e.code)
    report(result, run.data.get("window_note", ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
