"""The port's learning proof and its initialiser, against the JAX package.

- ``data/synthetic.write_checkerboard_tree`` writes the files of
  ``tools/make_synthetic_fixture.py`` byte for byte (spread and unspread);
- the port's ``Trainer.fit`` learns ``tests/test_learning.py``'s separable
  checkerboard clips at that test's recipe and thresholds, from the JAX
  ``Trainer``'s seed-0 initial weights (``init_detector`` with the key the
  JAX ``Trainer`` splits off ``PRNGKey(0)``), at three train seeds (dropout,
  jitter and shuffle). From the port's own random init the recipe's outcome
  depends on the seed at this size, so the weights are JAX's;
- ``cli/learning_proof.prove`` at a micro config for one epoch on the CPU:
  the record's keys are the JAX tool's and its checks are computed from what
  the train and eval CLIs returned and wrote;
- ``models/detector.init_weights_`` draws flax's ``lecun_normal()``: every
  weight within the truncation point ``2 / (0.8796 sqrt(fan_in))`` and a
  standard deviation within 2% of JAX's draws on the same shape; and the
  whole micro detector's initial weights match the JAX ``Trainer``'s tensor
  by tensor.
"""

import csv
import filecmp
import importlib.util
import math
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn

from ewvit_tpu_torch import configs as pc
from ewvit_tpu_torch.data.pipeline import BatchLoader
from ewvit_tpu_torch.data.synthetic import write_checkerboard_tree
from ewvit_tpu_torch.data.transforms import cv2_module
from ewvit_tpu_torch.models.detector import TRUNC_STD, build_detector, init_weights_
from ewvit_tpu_torch.train.loop import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_cv2 = pytest.mark.skipif(cv2_module() is None, reason="cv2 is not importable")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@needs_cv2
@pytest.mark.parametrize("spread", [False, True])
def test_checkerboard_tree_is_the_tools_byte_for_byte(tmp_path, monkeypatch, spread):
    methods = ["Deepfakes", "FaceSwap"]
    argv = ["make_synthetic_fixture.py", str(tmp_path / "jax"), "--pairs", "2",
            "--val-pairs", "1", "--frames", "2", "--size", "40", "--amp", "30",
            "--seed", "3", "--methods", *methods] + (["--spread-methods"] if spread else [])
    monkeypatch.setattr(sys, "argv", argv)
    assert _tool("make_synthetic_fixture").main() == 0
    splits, n_png = write_checkerboard_tree(str(tmp_path / "port"), pairs=2, val_pairs=1,
                                            frames=2, size=40, amp=30, seed=3, methods=methods,
                                            spread_methods=spread)
    want = _tree_files(tmp_path / "jax")
    assert want == _tree_files(tmp_path / "port")
    assert n_png == sum(f.endswith(".png") for f in want) == 2 * 4 * (1 if spread else 2) + 2 * 4
    dirs = sorted(d for d in os.listdir(tmp_path / "port" / "faceforensics" / "ff++" / "frames"))
    assert dirs == sorted(["original", *methods])
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port", want,
                                           shallow=False)
    assert not mismatch and not errors
    assert [len(splits[s]) for s in ("train", "val", "test")] == [2, 1, 1]


# ------------------------------------------------------- the Trainer learns


def make_clips(n, size=32, frames=4, amp=24, seed=0):
    """tests/test_learning.py's clips: n clips, label i%2; fakes carry a
    +-amp pixel checkerboard."""
    rng = np.random.default_rng(seed)
    yy, xx = np.indices((size, size))
    cb = (((yy + xx) % 2) * 2 - 1).astype(np.int16)
    items = []
    for i in range(n):
        label = i % 2
        clip = []
        for _ in range(frames):
            base = rng.integers(40, 216, (size // 8, size // 8, 3))
            img = np.kron(base, np.ones((8, 8, 1))).astype(np.int16)
            if label:
                img = img + cb[..., None] * amp
            clip.append(np.clip(img, 0, 255).astype(np.uint8))
        items.append((np.stack(clip), label))
    return items


class ListDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.fixture(scope="module")
def jax_initial_state():
    """The JAX ``Trainer``'s initial weights at seed 0 (ewvit_tpu/train/
    loop.py:80-82) as the port's state dict."""
    import jax

    from ewvit_tpu.configs import ModelConfig
    from ewvit_tpu.models.detector import init_detector
    from ewvit_tpu_torch.utils.convert import jax_to_state_dict

    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    _, variables = init_detector(ModelConfig.micro(), init_rng)
    return jax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables),
                             pc.ModelConfig.micro())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trainer_learns_separable_data(jax_initial_state, seed):
    """tests/test_learning.py's recipe and thresholds (micro, lr 1e-3, 8
    epochs of 2 updates, batch 8, accum 2) on the port's ``Trainer.fit``."""
    cfg = pc.ModelConfig.micro()
    model = build_detector(cfg, device="cpu")
    model.load_state_dict(jax_initial_state, strict=True)
    tcfg = pc.TrainConfig(batch_size=8, epochs=8, lr=1e-3, frame_count=4, accum_steps=2,
                          seed=seed)
    train_loader = BatchLoader(ListDataset(make_clips(32, seed=0)), 8, shuffle=True,
                               drop_last=True, num_workers=0, seed=seed)
    val_loader = BatchLoader(ListDataset(make_clips(16, seed=1)), 8, num_workers=0,
                             pad_last=True)
    trainer = Trainer(cfg, tcfg, mode="dynamic", steps_per_epoch=2, device="cpu", model=model,
                      log=lambda *_: None)
    out = trainer.fit(train_loader, val_loader)
    h = out["history"]

    first_loss = h[0]["train"]["loss"]
    last_loss = h[-1]["train"]["loss"]
    last_auc = h[-1]["train"]["metrics"]["auc"]
    print(f"seed {seed}: loss {first_loss:.3f} -> {last_loss:.3f}, final train AUC "
          f"{last_auc:.3f}, best val AUC {out['best_val_auc']:.3f}")
    assert first_loss > 0.5, f"first-epoch loss {first_loss:.3f} already low?"
    assert last_loss < 0.45, (
        f"train loss did not drop materially: {first_loss:.3f} -> {last_loss:.3f} over "
        f"{tcfg.epochs} epochs")
    assert last_auc >= 0.9, f"final train AUC {last_auc:.3f} < 0.9"
    assert out["best_val_auc"] >= 0.75, f"best val AUC {out['best_val_auc']:.3f}"


# ------------------------------------------------------- the one-command proof


@needs_cv2
def test_prove_records_what_the_clis_returned(tmp_path, monkeypatch):
    """The tiny profile's fixture and CLIs at a micro config for one epoch:
    the JAX tool's record keys, and each check from the train CLI's losses
    and best val AUC and the eval CLI's ``overall`` row."""
    from ewvit_tpu_torch.cli import learning_proof
    from ewvit_tpu_torch.cli import train as train_cli

    trained = []
    run = train_cli._run

    def spy(*a, **kw):
        assert kw["face_detector"] == "none"      # the fixture holds no face
        assert a[0].seed == learning_proof.SEED
        trained.append(run(*a, **kw))
        return trained[-1]

    monkeypatch.setattr(train_cli, "_run", spy)
    out = learning_proof.prove(str(tmp_path), flagship=False, epochs=1,
                               model_cfg=pc.ModelConfig.micro(), device="cpu")
    rec = out["record"]
    assert list(rec) == ["metric", "profile", "epochs", "first_loss", "final_loss",
                         "best_val_auc", "test_auc", "test_acc", "ok"]
    assert (rec["metric"], rec["profile"], rec["epochs"]) == ("learning_proof", "tiny", 1)
    (res,) = trained
    assert rec["first_loss"] == rec["final_loss"] == res["history"][0]["train"]["loss"]
    assert rec["best_val_auc"] == res["best_val_auc"]
    with open(tmp_path / "eval" / "eval_results.csv") as f:
        rows = {r["name"]: r for r in csv.DictReader(f)}
    assert rec["test_auc"] == float(rows["overall"]["auc"]) == out["rows"][0]["auc"]
    assert rec["test_acc"] == float(rows["overall"]["accuracy"])
    p = learning_proof.profile(False)
    want = [rec["final_loss"] <= p["max_final_loss"], rec["final_loss"] < rec["first_loss"],
            rec["best_val_auc"] >= p["min_val_auc"], rec["test_auc"] >= p["min_test_auc"],
            rec["test_acc"] >= p["min_test_acc"]]
    assert list(out["checks"].values()) == want and rec["ok"] == all(want)
    assert os.path.exists(tmp_path / "train" / "checkpoints" / "best_model.pth")


# ------------------------------------------------------- the initialiser


def test_init_draws_flax_lecun_normal():
    """A conv of fan-in 3*3*128 = 1152 and a linear of fan-in 1152."""
    import jax

    fan_in = 1152
    model = nn.Sequential(nn.Conv2d(128, 256, 3), nn.Linear(fan_in, 256))
    init_weights_(model, seed=5)
    want_std = float(np.std(np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (3, 3, 128, 256)))))
    edge = 2.0 / (TRUNC_STD * math.sqrt(fan_in))
    for m in model:
        w = m.weight.detach().double()
        assert m.weight[0].numel() == fan_in
        assert float(w.abs().max()) <= edge * (1 + 1e-6)
        assert float(w.abs().max()) > 0.99 * edge          # the tails are there
        assert abs(float(w.std()) / want_std - 1.0) < 0.02
        assert float(m.bias.detach().abs().max()) == 0.0
    assert abs(want_std * math.sqrt(fan_in) - 1.0) < 0.02


def test_init_matches_jax_tensor_by_tensor(jax_initial_state):
    """The port's micro detector at seed 0 against the JAX ``Trainer``'s
    initial weights, tensor by tensor: a tensor JAX fills with one value
    (norms, biases, running statistics) equal; a drawn tensor of 1,000
    values or more (the smaller ones are too few to compare one draw) at a
    standard deviation within 10% of JAX's."""
    model = build_detector(pc.ModelConfig.micro(), device="cpu", seed=0)
    got = model.state_dict()
    assert set(got) == set(jax_initial_state)
    drawn = 0
    for name, want in jax_initial_state.items():
        if not want.is_floating_point():
            continue
        w, g = want.double(), got[name].double()
        if bool((w == w.reshape(-1)[0]).all()):
            assert torch.equal(g, w), name
        elif w.numel() >= 1000:
            drawn += 1
            assert abs(float(g.std()) / float(w.std()) - 1.0) < 0.1, name
    assert drawn > 10
