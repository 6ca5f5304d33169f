"""The port's train and eval CLIs, called in-process on the CPU at
``--tiny`` on a small synthetic FF++ tree (``data/synthetic.py``).

The eval CLI's files are held against what the root ``eval.py``'s
``_export`` writes for the same rows.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ewvit_tpu_torch.cli import eval as cli_eval
from ewvit_tpu_torch.cli import train as cli_train
from ewvit_tpu_torch.data.synthetic import write_ff_tree
from ewvit_tpu_torch.data.transforms import cv2_module

pytestmark = pytest.mark.skipif(cv2_module() is None, reason="cv2 writes the frame tree")

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--tiny", "--device", "cpu", "--frame-count", "2", "--batch-size", "2",
          "--num-workers", "0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes that share the cores, and torch's default of
    one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_eval_module():
    spec = importlib.util.spec_from_file_location("root_eval_cli",
                                                  os.path.join(ROOT_DIR, "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """2 epochs of ``cli.train`` (2 train pairs, so 4 clips and one update of
    2 micro-batches in epoch 1, and after the curriculum's refresh 2 clips
    and one update of 1), then a ``--resume`` from the last checkpoint,
    which runs no epoch."""
    tmp = tmp_path_factory.mktemp("cli")
    root, out = str(tmp / "data"), str(tmp / "out")
    write_ff_tree(root, pairs=dict(train=2, val=2, test=1), frames=3, height=40, width=48,
                  seed=9)
    args = ["--root", root, "--output", out, "--epochs", "2", *COMMON]
    result = cli_train.main(args)
    ckpts = os.path.join(out, "checkpoints")
    files = sorted(os.listdir(ckpts))
    resumed = cli_train.main(args + ["--resume", os.path.join(ckpts, "checkpoint_2.pth")])
    return root, ckpts, result, files, resumed


def test_train_cli_checkpoints_and_resume(trained):
    _, ckpts, result, files, resumed = trained
    assert [h["epoch"] for h in result["history"]] == [0, 1]
    want = ["checkpoint_1.pth", "checkpoint_2.pth"]
    assert files in (want, ["best_model.pth"] + want)
    assert ("best_model.pth" in files) == (result["best_val_auc"] > 0)
    assert resumed["history"] == [] and resumed["best_val_auc"] == result["best_val_auc"]
    assert sorted(os.listdir(ckpts)) == files          # the resume wrote nothing
    obj = torch.load(os.path.join(ckpts, "checkpoint_2.pth"), weights_only=True)
    assert obj["epoch"] == 1 and obj["step"] > 0


def test_eval_cli_matches_root_export(trained, tmp_path):
    root, ckpts, _, _, _ = trained
    out = str(tmp_path / "port")
    got = cli_eval.main(["--root", root, "--model-path",
                         os.path.join(ckpts, "checkpoint_2.pth"), "--output", out,
                         "--dataset", "ff++", *COMMON])
    names = [r["name"] for r in got["rows"]]
    assert names == ["overall"] + cli_eval.FF_METHODS
    ref = str(tmp_path / "root")
    _root_eval_module()._export(ref, got["rows"], got["confusions"])
    for name in ("eval_results.csv", "confusion_matrices.json"):
        with open(os.path.join(out, name)) as a, open(os.path.join(ref, name)) as b:
            assert a.read() == b.read(), name
    with open(os.path.join(out, "confusion_matrices.json")) as f:
        assert list(json.load(f)) == names


def _write_images(directory, names, rng, size=(30, 36)):
    cv2 = cv2_module()
    os.makedirs(directory, exist_ok=True)
    for name in names:
        cv2.imwrite(os.path.join(directory, name), rng.integers(0, 256, (*size, 3), np.uint8))


@pytest.mark.parametrize("dataset", ["celeb-df", "diffusion"])
def test_eval_cli_other_datasets(trained, tmp_path, dataset):
    """Celeb-DF (one pass over the test list) and diffusion (all, then
    DDPM, DDIM, LDM) rows and files."""
    _, ckpts, _, _, _ = trained
    rng = np.random.default_rng(3)
    root = tmp_path / "data"
    if dataset == "celeb-df":
        for kind, vid in (("Celeb-real", "id0_000"), ("Celeb-synthesis", "id0_id1_000")):
            _write_images(root / "celebdf" / "frames" / kind / vid, ["0.png", "1.png"], rng)
        (root / "list.txt").write_text("1 Celeb-real/id0_000.mp4\n"
                                       "0 Celeb-synthesis/id0_id1_000.mp4\n")
        extra, want = ["--test-list", "list.txt"], ["celeb-df"]
    else:
        _write_images(root / "CelebA-Real", ["a.jpg", "b.jpg"], rng)
        for method in cli_eval.DIFFUSION_METHODS:
            _write_images(root / method, ["c.png"], rng)
        extra, want = [], ["all"] + cli_eval.DIFFUSION_METHODS
    out = str(tmp_path / "out")
    got = cli_eval.main(["--root", str(root), "--model-path",
                         os.path.join(ckpts, "checkpoint_2.pth"), "--output", out,
                         "--dataset", dataset, *extra, *COMMON])
    assert [r["name"] for r in got["rows"]] == want
    with open(os.path.join(out, "confusion_matrices.json")) as f:
        assert list(json.load(f)) == want
    assert all(np.isfinite(r["loss"]) for r in got["rows"])


def _close(a, b, path=""):
    """``a`` equals ``b``, floats within 1e-5 relative (wall times, the
    ``seconds`` keys, excepted)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            if k != "seconds":
                _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("cli", [cli_train, cli_eval])
def test_mesh_world_of_one(cli, trained, tmp_path):
    """``--mesh`` without torchrun's environment: a world of one over gloo,
    whose output is the run's without ``--mesh``: the eval rows and files
    equal, the train history within 1e-5. Train-mode BN takes its
    statistics through the mesh's all-reduces, in fp32 where torch's CPU BN
    sums in fp64, so gradients at noise level differ, and Adam turns each
    into a step of about lr: the run trains at lr 1e-6, where that moves
    the val loss by less than 1e-5. The process group is torn down at the
    end."""
    root, ckpts, _, _, _ = trained
    if cli is cli_eval:
        args = ["--root", root, "--model-path", os.path.join(ckpts, "checkpoint_2.pth"),
                "--dataset", "ff++", *COMMON]
    else:
        args = ["--root", root, "--epochs", "1", "--lr", "1e-6", *COMMON]
    runs = {}
    for name, extra in (("plain", []), ("mesh", ["--mesh"])):
        out = str(tmp_path / name)
        runs[name] = cli.main(args + ["--output", out] + extra)
        assert not torch.distributed.is_initialized()
    if cli is cli_eval:
        assert runs["mesh"] == runs["plain"]
        for name in ("eval_results.csv", "confusion_matrices.json"):
            with open(tmp_path / "mesh" / name) as a, open(tmp_path / "plain" / name) as b:
                assert a.read() == b.read(), name
    else:
        _close(runs["mesh"], runs["plain"])
        assert sorted(os.listdir(tmp_path / "mesh" / "checkpoints")) == \
            sorted(os.listdir(tmp_path / "plain" / "checkpoints"))


def test_new_modules_import_no_jax_and_no_cv2():
    """The training run's modules, the measuring, ablation and plotting
    entry points and data parallelism import nothing of JAX or the JAX package, no yaml or
    sklearn, matplotlib only inside a plotting call and cv2 only where a
    frame is decoded or resized (so the package imports on a machine
    without them)."""
    code = (
        "import sys, ewvit_tpu_torch.train.loop, ewvit_tpu_torch.cli.train, "
        "ewvit_tpu_torch.cli.eval, ewvit_tpu_torch.data, ewvit_tpu_torch.data.synthetic, "
        "ewvit_tpu_torch.cli.test, ewvit_tpu_torch.cli.bench, "
        "ewvit_tpu_torch.cli.calculate_gflops, ewvit_tpu_torch.cli.ablation, "
        "ewvit_tpu_torch.cli.plot_celebdf_roc, ewvit_tpu_torch.cli.visualize_feature_maps, "
        "ewvit_tpu_torch.utils.visualization, ewvit_tpu_torch.utils.metrics, "
        "ewvit_tpu_torch.parallel\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ewvit_tpu', 'yaml', 'cv2', 'matplotlib', 'sklearn', "
        "'seaborn')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT_DIR, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
