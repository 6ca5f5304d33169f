#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from (not run by a benchmark run).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control bf16|fp8|int8] [--fault NAME] [--out FILE]

For each seed, in one process: the cell's set-up, the answers of its checked
part through the timed entry (screening: every pool batch once through
``predict_stream``; training: the checked updates), and the numbers that a
run compares. ``--control`` puts the reference, computed one precision below
the configuration's bf16, in the program's place (the cell file's
``control`` names the one its limits were set against; ``bf16``, the
configuration's own precision, is a witness of what its rounding alone
does); ``--fault`` plants
one of ``lib/faults.py``'s faults in the program. One JSON line per seed on
standard output (and appended to ``--out``). Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.lib import common, faults, manifest  # noqa: E402
from benchmark.lib.context import Run  # noqa: E402


def reading(cell, seed: int, device, control=None, fault=None) -> dict:
    """Every number ``check`` returns for ``seed``: those a run compares
    and those read here alone."""
    drv = manifest.runner(cell.traffic, cell.root)
    run = Run(cell, seed, 0.0, False, device)
    t = time.perf_counter()
    plant = faults.FAULTS[fault]() if fault else contextlib.nullcontext()
    with plant:
        if control is not None:
            drv.prepare(run)
            answers = drv.control_answers(run, control)
        else:
            drv.setup(run)
            answers = drv.checked(run)
    drv.release(run)
    if run.on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    numbers = drv.check(run, answers)
    if run.on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        torch.cuda.empty_cache()
    out = {"workload": cell.name, "seed": seed, "control": control, "fault": fault,
           "seconds": time.perf_counter() - t, **numbers}
    if "losses" in run.data:
        out["losses"] = [float(v) for v in run.data["losses"]]
    if "left_out" in run.data:
        out["left_out"] = len(run.data["left_out"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", default=None, choices=("bf16", "fp8", "int8"))
    p.add_argument("--fault", default=None, choices=sorted(faults.FAULTS))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    dev = common.require_cuda(cell.chips)
    for s in args.seeds.split(","):
        r = reading(cell, int(s), dev, args.control, args.fault)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
