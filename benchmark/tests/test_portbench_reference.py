"""The benchmark's reference against the program's plain path, on the CPU at
micro width, on the same weights: served logits and the checked training
updates, in fp32 (where the two must agree to rounding) for both
configurations."""

from __future__ import annotations

import os

import pytest
import torch

from benchmark.lib import manifest
from benchmark.lib.context import Run

CELLS = ["dynamic.screen", "sfe_mwt.screen", "dynamic.train", "sfe_mwt.train"]
# fp32 on both sides, the same weights, inputs, jitter and dropout masks:
# what is left is summation order (served logits; the losses) and, through
# three Adam updates, its growth where a leaf's gradient is small
FP32_LIMITS = {"logit_gap": 1e-4, "logit_gap_rms": 1e-4, "logit_gap_rel": 1e-3,
               "logit_gap_halves": 1e-3,
               "logit_gap_first_rms": 1e-4, "loss_gap_first": 1e-5,
               "loss_gap": 1e-5, "grad_rel": 1e-3, "grad_rel_median": 1e-3,
               "grad_gap": 1e-3, "grad_gap_median": 1e-3,
               "update_gap": 1e-3, "update_gap_median": 1e-3}


def _run(root, name, seed, dtype="float32"):
    cell = manifest.load_cell(name, root)
    cell.config["compute_dtype"] = dtype
    run = Run(cell, seed, 0.0, False, torch.device("cpu"))
    drv = manifest.runner(cell.traffic, root)
    drv.setup(run)
    answers = drv.checked(run)
    drv.release(run)
    return drv.check(run, answers)


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_program_in_fp32(micro_root, name):
    numbers = _run(micro_root, name, seed=3)
    for k, v in numbers.items():
        assert v <= FP32_LIMITS[k], (name, k, v)


def test_state_dict_loads_strictly_into_the_program(micro_root):
    from benchmark.lib import program, weights

    cell = manifest.load_cell("dynamic.screen", micro_root)
    state = weights.make_state(cell.config, 5, "cpu")
    model = program.load_model(cell.config, state, 4, torch.device("cpu"))
    got = model.state_dict()
    assert set(got) == set(state)
    assert all(torch.equal(got[k], state[k]) for k in state)


def test_weights_are_a_function_of_the_seed(micro_root):
    from benchmark.lib import weights

    cfg = manifest.load_cell("sfe_mwt.screen", micro_root).config
    a, b, c = (weights.make_state(cfg, s, "cpu") for s in (7, 7, 8))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a if a[k].is_floating_point())


def test_reference_imports_nothing_of_the_program():
    import ast

    here = os.path.join(os.path.dirname(os.path.dirname(__file__)), "reference")
    for name in os.listdir(here):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(here, name)).read())
            for node in ast.walk(tree):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else []
                for m in mods:
                    assert m.split(".")[0] not in ("ewvit_tpu_torch", "ewvit_tpu", "jax",
                                                   "flax"), (name, m)
