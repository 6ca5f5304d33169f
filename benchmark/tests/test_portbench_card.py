"""On the card (marked ``card``; they skip without one): the cell's control
and faults at the cell's own size fail its limits, on three seeds.

    python3 -m pytest benchmark/tests/test_portbench_card.py -m card

The readings that set the limits come from ``benchmark/calibrate.py`` over a
dozen seeds (PERF.md section 2); these tests repeat the control's and the
faults' side of them.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

from benchmark.lib import manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
# the cell's control (its file's ``control``) and each fault the cell can
# have: an answer altered, and half of each clip's frames scored
CASES = [("dynamic.screen", "control", None), ("dynamic.screen", None, "answer_altered"),
         ("dynamic.screen", None, "half_frames")]


def _calibrate():
    spec = importlib.util.spec_from_file_location("benchmark_calibrate", os.path.join(
        ROOT, "benchmark", "calibrate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.card
@pytest.mark.parametrize("name, control, fault", CASES)
def test_control_and_faults_fail_the_cell_at_its_size(card, name, control, fault):
    cell = manifest.load_cell(name, ROOT)
    limits = cell.limits["check"]["limits"]
    control = cell.limits["control"] if control else None
    cal = _calibrate()
    for seed in SEEDS:
        r = cal.reading(cell, seed, card, control, fault)
        over = [k for k, lim in limits.items() if not r[k] <= lim]
        assert over, r
