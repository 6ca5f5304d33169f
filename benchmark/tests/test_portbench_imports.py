"""Nothing the benchmark runs loads JAX or the JAX package; the run refuses
to measure without a card."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from benchmark.lib.common import FORBIDDEN, forbidden_loaded

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    """Every module a file imports, and every ``"module:attr"`` it names."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and ":" in node.value and " " not in node.value:
            yield node.value.split(":")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imported(path)}
    assert not tops & set(FORBIDDEN), (path, tops & set(FORBIDDEN))
    if os.sep + "reference" + os.sep in path:
        assert "ewvit_tpu_torch" not in tops, path


def test_forbidden_names_are_compared_whole():
    assert forbidden_loaded(["ewvit_tpu_torch", "ewvit_tpu_torch.ops.haar", "jaxtyping",
                             "flaxen.x", "torch"]) == []
    assert forbidden_loaded(["ewvit_tpu.ops", "jaxlib", "flax.linen", "jax"]) == \
        ["ewvit_tpu", "flax", "jax", "jaxlib"]


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A whole CPU run at micro width, in a fresh process."""
    code = f"""
import sys, torch
sys.path[:0] = [{ROOT!r}, {os.path.join(BENCH, 'tests')!r}]
torch.set_num_threads(1)
from conftest import write_micro_root
from benchmark.lib import manifest
from benchmark.lib.common import forbidden_loaded
from benchmark.lib.context import Run
import importlib.util
spec = importlib.util.spec_from_file_location("r", {os.path.join(BENCH, 'run.py')!r})
r = importlib.util.module_from_spec(spec); spec.loader.exec_module(r)
root = write_micro_root({str(tmp_path)!r})
import json, os
d = os.path.join(root, "benchmark", "workloads")
for f in os.listdir(d):          # any limit: what is loaded matters here
    w = json.load(open(os.path.join(d, f)))
    w["check"]["limits"] = {{k: 1e9 for k in w["check"]["limits"]}}
    json.dump(w, open(os.path.join(d, f), "w"))
for name in ("dynamic.screen", "dynamic.train"):
    r.execute(Run(manifest.load_cell(name, root), 1, 0.2, True, torch.device("cpu")), 0.0)
print("LOADED", forbidden_loaded())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "dynamic.screen", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
