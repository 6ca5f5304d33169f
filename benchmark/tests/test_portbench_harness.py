"""The harness on the CPU at micro width: it finds configurations, cells,
traffic and metrics by name, runs every cell end to end (the look for a
card skipped), and its ``correct`` comes out false under the control and
under each fault a cell can have."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os

import pytest
import torch

from benchmark.lib import faults, manifest
from benchmark.lib.context import Run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCREEN = ["dynamic.screen", "sfe_mwt.screen"]
TRAIN = ["dynamic.train", "sfe_mwt.train"]
# The CPU runs hold the program in fp32 at micro width, where it agrees with
# the reference to rounding (test_portbench_reference.py): at micro width in
# bf16 neither the fp8 control nor a small leaf's gradient separates from
# bf16 rounding from seed to seed and thread count to thread count. The
# limits of the cells themselves are set from readings on the card at their
# own sizes (PERF.md).
MICRO_LIMITS = {"logit_gap_rel": 1e-3, "logit_gap_halves": 1e-3, "grad_rel": 1e-3,
                "update_gap": 1e-3}
SEED = 2 ** 31 + 11


def _run_module():
    spec = importlib.util.spec_from_file_location("benchmark_run", os.path.join(
        ROOT, "benchmark", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _with_limits(root):
    d = os.path.join(root, "benchmark", "workloads")
    for name in os.listdir(d):
        path = os.path.join(d, name)
        with open(path) as f:
            w = json.load(f)
        w["check"]["limits"] = {k: MICRO_LIMITS[k] for k in w["check"]["limits"]}
        with open(path, "w") as f:
            json.dump(w, f)
    return root


def _cell(root, name):
    cell = manifest.load_cell(name, root)
    cell.config["compute_dtype"] = "float32"
    return cell


def _execute(root, name, trace=False, seed=SEED):
    cell = _cell(root, name)
    run = Run(cell, seed, 1.0, trace, torch.device("cpu"))
    return _run_module().execute(run, 0.0)


def _digest(root):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(os.path.join(root, "benchmark"))):
        for f in sorted(files):
            if f.endswith((".py", ".json")):
                h.update(open(os.path.join(d, f), "rb").read())
    h.update(open(os.path.join(root, "BENCHMARK.json"), "rb").read())
    return h.hexdigest()


def test_new_config_cell_traffic_and_metric_are_found_by_name(micro_root):
    """A later change adds files and manifest entries only."""
    before = _digest(ROOT)
    bench = os.path.join(micro_root, "benchmark")
    cfg = manifest.read_json(os.path.join(bench, "configs", "sfe_mwt.json"))
    cfg.update(name="sfe_mwt_k12", kernels=dict(cfg["kernels"], use_fused_mwt_tail=False))
    with open(os.path.join(bench, "configs", "sfe_mwt_k12.json"), "w") as f:
        json.dump(cfg, f)
    t = manifest.read_json(os.path.join(bench, "traffic", "screen.json"))
    t.update(frames_per_clip=4)
    with open(os.path.join(bench, "traffic", "short.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(bench, "workloads", "sfe_mwt_k12.short.json"), "w") as f:
        json.dump({"check": {"batches": 1, "limits": {"logit_gap": 1.0}}}, f)
    with open(os.path.join(bench, "metrics", "frames_per_window.serve.py"), "w") as f:
        f.write("def read(run, drv):\n    return float(run.window['frames'])\n")
    path = os.path.join(micro_root, "BENCHMARK.json")
    m = manifest.read_json(path)
    m["configs"].append(dict(m["configs"][1], name="sfe_mwt_k12",
                             file="benchmark/configs/sfe_mwt_k12.json"))
    m["workloads"].append({"name": "sfe_mwt_k12.short", "config": "sfe_mwt_k12",
                           "traffic": "short", "chips": 1, "why": "test"})
    m["end_to_end"][0]["workloads"].append("sfe_mwt_k12.short")
    m["per_layer"].append({"name": "frames_per_window.serve", "unit": "frames",
                           "better": "higher", "source": "host_clock", "layer": "serving engine",
                           "moves": "serve_device_frames_per_s",
                           "workloads": ["sfe_mwt_k12.short"]})
    with open(path, "w") as f:
        json.dump(m, f)

    cell = manifest.load_cell("sfe_mwt_k12.short", micro_root)
    assert cell.config["kernels"]["use_fused_mwt_tail"] is False
    assert cell.traffic["frames_per_clip"] == 4
    assert [e["name"] for e in cell.end_to_end] == ["serve_device_frames_per_s", "setup_s"]
    assert [p["name"] for p in cell.per_layer] == ["frames_per_window.serve"]
    assert set(manifest.readers(cell.per_layer, micro_root)) == {"frames_per_window.serve"}
    # the cells already there see nothing of it
    old = manifest.load_cell("sfe_mwt.screen", micro_root)
    assert "frames_per_window.serve" not in [p["name"] for p in old.per_layer]
    res = _execute(micro_root, "sfe_mwt_k12.short", trace=True)
    assert res["metrics"]["frames_per_window.serve"]["value"] > 0
    assert _digest(ROOT) == before


@pytest.mark.parametrize("name", SCREEN + TRAIN)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end(micro_root, name, trace):
    root = _with_limits(micro_root)
    res = _execute(root, name, trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    cell = manifest.load_cell(name, root)
    if trace:
        want = {m["name"] for m in cell.per_layer}
        # the card's readings (memory, layer times, kernel shares) read nothing here
        assert {"device_idle." + cell.traffic["runner"], "mfu." + cell.traffic["runner"],
                "launches_per_frame." + cell.traffic["runner"]} <= set(res["metrics"]) <= want
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["device"]["window_s"] > 0
    else:
        # the CPU leaves no device trace: a metric read from one reads nothing here
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end
                                       if m["source"] != "device_trace"}
        assert all(m["value"] > 0 for m in res["metrics"].values())
    for c in res["compared"].values():
        assert c["limit"] is None or c["value"] <= c["limit"]


@pytest.mark.parametrize("name, fault", [
    ("dynamic.screen", "answer_altered"), ("dynamic.screen", "half_frames"),
    ("sfe_mwt.screen", "answer_altered"), ("sfe_mwt.screen", "half_frames"),
    ("dynamic.train", "frozen_state"), ("dynamic.train", "half_batch"),
    ("sfe_mwt.train", "frozen_state"), ("sfe_mwt.train", "half_batch")])
def test_a_planted_fault_is_not_correct(micro_root, name, fault):
    root = _with_limits(micro_root)
    with faults.FAULTS[fault]():
        res = _execute(root, name)
    assert res["correct"] is False and res["failed"] > 0, res["compared"]


@pytest.mark.parametrize("name", SCREEN + TRAIN)
def test_the_control_is_not_correct(micro_root, name):
    spec = importlib.util.spec_from_file_location("benchmark_calibrate", os.path.join(
        ROOT, "benchmark", "calibrate.py"))
    cal = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cal)
    cell = _cell(micro_root, name)
    r = cal.reading(cell, SEED, torch.device("cpu"), control=cell.limits["control"])
    over = [k for k, lim in MICRO_LIMITS.items() if k in r and r[k] > lim]
    assert over, r


def test_device_rate_reads_the_traced_frames_over_the_busy_time():
    from types import SimpleNamespace

    mod = manifest.load_module(os.path.join(ROOT, "benchmark", "metrics",
                                            "serve_device_frames_per_s.py"), "device_rate")
    run = SimpleNamespace(traced={"frames": 4080, "busy_s": 1.25, "window_s": 3.0})
    assert mod.read(run, None) == 4080 / 1.25
    run.traced["busy_s"] = 0.0          # no device trace (the CPU): nothing
    assert mod.read(run, None) is None
