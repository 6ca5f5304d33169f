"""CPU tests of the benchmark; tests marked ``card`` need an NVIDIA GPU and
skip without one (run them on the card with
``python3 -m pytest benchmark/tests -m card``)."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the micro sizes of the CPU tests: every module of both configurations at
# 32 px, with 3-block backbones that land on a 4 x 4 map (one 4 x 4 patch)
MICRO = {
    "image_size": 32, "patch_size": 4, "dim": 32, "depth": 1, "dim_head": 16, "heads": 2,
    "mlp_dim": 32, "dama_dim": 16, "num_heads": 2, "levels": 2,
    "b0": {"stem_ch": 8, "head_ch": 32, "blocks": [
        [1, 3, 1, 1, 8, 8, 0.25, False], [1, 3, 2, 2, 8, 16, 0.25, False],
        [1, 5, 2, 2, 16, 16, 0.25, False]]},
    "v2s": {"stem_ch": 8, "head_ch": 32, "blocks": [
        [1, 3, 1, 1, 8, 8, 0.0, True], [1, 3, 2, 2, 8, 16, 0.0, True],
        [2, 3, 2, 2, 16, 16, 0.25, False]]},
    "batch_size": 2, "accum_steps": 2, "frame_count": 6,
}
MICRO_TRAFFIC = {
    "screen": {"clips_per_batch": 2, "frames_per_clip": 6, "frame_chunk": 4, "pool": 3,
               "traced_batches": 2},
    "train": {"frame_chunk": 4, "pool": 3, "checked_steps": 3, "traced_steps": 1},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda", 0)


def write_micro_root(dest: str) -> str:
    """A copy of ``BENCHMARK.json``, with the held-back cells added as a later
    change would add them, and of ``benchmark/`` under ``dest``, whose
    configurations and traffic are at the micro sizes."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "held_back.json")) as f:
        held = json.load(f)
    for key in ("configs", "workloads"):
        manifest[key] += held[key]
    for key in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in manifest[key]}
        for m in held[key]:
            if m["name"] in have:
                have[m["name"]]["workloads"] += m["workloads"]
            else:
                manifest[key].append(m)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in os.listdir(os.path.join(dest, "benchmark", "configs")):
        path = os.path.join(dest, "benchmark", "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(MICRO)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for kind, over in MICRO_TRAFFIC.items():
        path = os.path.join(dest, "benchmark", "traffic", f"{kind}.json")
        with open(path) as f:
            t = json.load(f)
        t.update(over)
        with open(path, "w") as f:
            json.dump(t, f)
    for name in os.listdir(os.path.join(dest, "benchmark", "workloads")):
        path = os.path.join(dest, "benchmark", "workloads", name)
        with open(path) as f:
            w = json.load(f)
        if "batches" in w["check"]:
            w["check"]["batches"] = 2
        with open(path, "w") as f:
            json.dump(w, f)
    return dest


@pytest.fixture
def micro_root(tmp_path):
    return write_micro_root(str(tmp_path))


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread per test process (several workers share the cores)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
