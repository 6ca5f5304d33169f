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
  by tensor;
- the flagship fixture's train set loses its fakes under the curriculum,
  epoch for epoch as the JAX package's, to none by the last epoch;
- the port's ``Trainer`` tracks the JAX ``Trainer`` in bf16 over 13 updates
  and 4 curriculum epochs at micro width, and (marked slow) the flagship's
  same-weights losses and first updates at full widths on 64-px frames,
  in fp32 and bf16.
"""

import csv
import dataclasses
import filecmp
import importlib.util
import math
import os
import sys

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from ewvit_tpu.configs import ModelConfig as JaxConfig
from ewvit_tpu.configs import TrainConfig as JaxTrainConfig
from ewvit_tpu.data import datasets as jds
from ewvit_tpu.data import pipeline as jpipe
from ewvit_tpu.data import transforms as jtf
from ewvit_tpu.models import efficientnet as je
from ewvit_tpu.models.detector import init_detector_fast
from ewvit_tpu.ops import preprocess as jpre
from ewvit_tpu.train import loop as jloop
from ewvit_tpu_torch import configs as pc
from ewvit_tpu_torch.data import datasets as pds
from ewvit_tpu_torch.data import pipeline as ppipe
from ewvit_tpu_torch.data import transforms as ptf
from ewvit_tpu_torch.data.datasets import FF_METHODS
from ewvit_tpu_torch.data.pipeline import BatchLoader
from ewvit_tpu_torch.data.synthetic import write_checkerboard_tree
from ewvit_tpu_torch.data.transforms import cv2_module
from ewvit_tpu_torch.models.detector import TRUNC_STD, build_detector, init_weights_
from ewvit_tpu_torch.models.layers import Attention, CrossAttention
from ewvit_tpu_torch.ops.preprocess import preprocess_batch
from ewvit_tpu_torch.train import loop as ploop
from ewvit_tpu_torch.train.loop import Trainer
from ewvit_tpu_torch.utils.convert import jax_to_state_dict

from test_torch_port_model import _fill
from test_torch_port_train import no_dropout

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




@needs_cv2
def test_flagship_curriculum_ends_on_reals_in_both_packages(tmp_path):
    """The flagship fixture's train set, epoch by epoch under the
    curriculum, in both packages: ``_init_sampling_strategy`` puts every
    fake into the fixed set (``fixed_sample_ratio`` is 1.0 at
    construction), so the novelty pool is empty and the fakes shrink with
    the fixed ratio to none by the last epoch, whose train loss the proof's
    final-loss check reads: it trains on the 48 reals alone (PERF.md
    section 6). The port's count of fakes equals the JAX package's at
    every epoch. The fixture's layout at 1 frame of 16 px; the counts do
    not depend on the pixels."""
    root = str(tmp_path)
    write_checkerboard_tree(root, pairs=48, val_pairs=4, frames=1, size=16, methods=FF_METHODS,
                            spread_methods=True)

    def fakes(ds, seed):
        train = ds.FaceForensicsDataset(root, split="train", frame_count=1, seed=seed)
        assert train.fake_ratio == 1.0                   # the CLIs' pos_weight
        counts = []
        for epoch in range(25):
            train.update_sampling_strategy(epoch, 25)
            assert len(train.real_videos) == 48
            counts.append(len(train) - 48)
        return counts

    for seed in (0, 2, 42):
        want = fakes(jds, seed)
        assert want[0] == 48 and want[-1] == 0, seed
        assert fakes(pds, seed) == want, seed


# ------------------------------------------------------- bf16 against JAX


def _checkerboard_loaders(pkg, root, *, size, frames, batch, seed):
    """One package's FF++ train and val sets and loaders over a
    checkerboard tree (``pkg``: ``(datasets, pipeline, transforms)``), as
    the train CLIs build them, face detector off; the train loader
    shuffles."""
    ds, pipe, tf = pkg
    t = tf.FrameTransform(resize=2 * size, crop=size, aligner=tf.FaceAligner(detector="none"))
    train = ds.FaceForensicsDataset(root, split="train", frame_count=frames, transform=t,
                                    seed=seed)
    val = ds.FaceForensicsDataset(root, split="val", frame_count=frames, transform=t, seed=seed)
    return (train, val,
            pipe.BatchLoader(train, batch, shuffle=True, drop_last=True, num_workers=0,
                             seed=seed),
            pipe.BatchLoader(val, batch, pad_last=True, num_workers=0))


def _trainers(monkeypatch, jcfg, pcfg, tcfg, train_set, steps_per_epoch, *,
              keep_grads=True):
    """The JAX ``Trainer`` and the port's from the same weights
    (seeded numpy, as ``test_torch_port_model.py`` fills them), dropout,
    stochastic depth and colour jitter off on both sides while they run
    (``monkeypatch``), no remat (the flagship's ``--no-remat``). Each side's
    train step is wrapped to record its per-update losses and labels; the
    port's also records its gradients (``keep_grads``) and, under
    ``record["dtypes"]``, the dtypes its step's forward gave the outputs of
    the first convolution and of every attention. Returns ``(jt, pt,
    start, record)``."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, y, *a, **kw: y)
    monkeypatch.setattr(je, "_stochastic_depth", lambda y, rate, det, rng: y)
    monkeypatch.setattr(jloop, "preprocess_batch", lambda x, key, train, dtype_name:
                        jpre.preprocess_batch(x, train=False, dtype_name=dtype_name))
    monkeypatch.setattr(jloop, "init_detector", lambda cfg, rng: (
        lambda model, shapes: (model, _fill(shapes, seed=1)))(*init_detector_fast(cfg)))
    record = {"jax": [], "port": [], "grads": [], "labels": {"jax": [], "port": []},
              "dtypes": {"conv": set(), "attention": set()}}
    jstep, pstep = jloop.train_step_donated, ploop.train_step
    in_step = []

    def hook(kind):
        def fn(module, args, out):
            if in_step:
                record["dtypes"][kind].add((out[0] if isinstance(out, tuple) else out).dtype)
        return fn

    def jax_step(*a, **kw):
        state, m = jstep(*a, **kw)
        record["jax"].append(float(m["loss"]))
        record["labels"]["jax"].append(np.asarray(a[2]).tolist())
        return state, m

    def port_step(model, *a, **kw):
        in_step.append(True)
        try:
            m = pstep(model, *a, **kw)
        finally:
            in_step.clear()
        record["port"].append(float(m["loss"]))
        record["labels"]["port"].append(a[2].tolist())
        if keep_grads:
            record["grads"].append({n: p.grad.clone() for n, p in model.named_parameters()
                                    if p.grad is not None})
        return m

    monkeypatch.setattr(jloop, "train_step_donated", jax_step)
    monkeypatch.setattr(ploop, "train_step", port_step)
    monkeypatch.setattr(ploop, "preprocess_batch", lambda x, dtype, train=False, generator=None:
                        preprocess_batch(x, dtype))
    pos_weight = train_set.fake_ratio
    jt = jloop.Trainer(jcfg, JaxTrainConfig(**tcfg), pos_weight=pos_weight,
                       steps_per_epoch=steps_per_epoch, rng=jax.random.PRNGKey(0),
                       remat=False, log=lambda s: None)
    start = jax.tree_util.tree_map(np.array, {"params": jt.state.params,
                                              "batch_stats": jt.state.batch_stats})
    model = build_detector(pcfg, device="cpu", seed=0)
    model.load_state_dict(jax_to_state_dict(start, pcfg), strict=True)
    next(m for m in model.modules() if isinstance(m, nn.Conv2d)).register_forward_hook(
        hook("conv"))
    for m in model.modules():
        if isinstance(m, (Attention, CrossAttention)):
            m.register_forward_hook(hook("attention"))
    pt = Trainer(pcfg, pc.TrainConfig(**tcfg), pos_weight=pos_weight,
                 steps_per_epoch=steps_per_epoch, device="cpu", model=no_dropout(model),
                 remat=False, log=lambda s: None)
    return jt, pt, jax_to_state_dict(start, pcfg), record


def _jax_weights(jt, pcfg):
    return jax_to_state_dict(jax.tree_util.tree_map(np.asarray, {
        "params": jt.state.params, "batch_stats": jt.state.batch_stats}), pcfg)


def _configs(jcfg, pcfg, frames, dtype="bfloat16"):
    """Both packages' config in ``dtype`` with one chunk a micro-batch (the
    flagship's ``frame_chunk`` 16 over 8 frames) and the JAX side's dropout
    rates at 0 (the port's go to 0 through ``no_dropout``)."""
    jcfg = jcfg.replace(compute_dtype=dtype, frame_chunk=frames,
                        arch=dataclasses.replace(jcfg.arch, dropout=0.0, emb_dropout=0.0))
    return jcfg, pcfg.replace(compute_dtype=dtype, frame_chunk=frames)


BF16_LR = 3e-4
BF16_LOSS_TOL = 2e-2       # test_fit_tracks_jax_in_bf16's docstring
BF16_SIGNAL_TOL = 0.3      # of updates * lr


def _sign_consistent(grads, floor=1e-2):
    """Per tensor, the elements whose gradient had one sign at every update
    and stayed above ``floor`` of the tensor's largest gradient: Adam moves
    them by about lr a step in one direction on both sides. A gradient
    that is 0 in exact arithmetic (a bias under a train-mode BN) is bf16
    noise that changes sign, and Adam turns it into steps of +-lr."""
    masks = {}
    for name in grads[0]:
        g = torch.stack([step[name] for step in grads])
        m = float(g.abs().max())
        if m > 0:
            masks[name] = (((g > 0).all(0) | (g < 0).all(0))
                           & (g.abs() > floor * m).all(0)).numpy()
    return masks


@needs_cv2
def test_fit_tracks_jax_in_bf16(tmp_path, monkeypatch):
    """The port's ``Trainer`` against the JAX package's in bf16 over 13
    updates in 4 epochs, at the flagship's batch 4, accum 2, lr 3e-4, no
    remat and one chunk a micro-batch, on a 17-pair checkerboard tree at
    micro width (32 px, 4 frames): the curriculum takes the train set from
    34 clips (8 batches) to 24 and then to 17 reals (the flagship's last
    epochs hold reals only, PERF.md section 6). Same weights, shuffle on
    (the two loaders draw the same order), dropout, stochastic depth and
    jitter off, so what differs is the two packages' bf16: autocast with
    fp32 BN statistics, softmax and losses in the port, bf16 module dtypes
    in JAX.

    Tolerances, from the measured difference of one bf16 update: update 1
    runs both forwards on the same weights and its losses differ by
    3.4e-3 (0.5% of 0.65; the port in fp32 differs from JAX's bf16 by as
    much, so this is bf16's rounding, not a line of either). Every
    per-update loss and every epoch's train and val loss agree within
    ``BF16_LOSS_TOL`` = 2e-2, six times that (measured: at most 8.9e-3 per
    update, 6.9e-3 and 8.4e-3 per epoch). Parameters: Adam's first step is
    lr * sign(g) on both sides, so one update leaves a signal element
    where it is on both; after that, the steps differ as the two bf16
    gradients' ratios do. Where the port's gradient kept one sign above 1%
    of its tensor's largest (:func:`_sign_consistent`; 262 elements in 41
    tensors here) the final weights agree within ``BF16_SIGNAL_TOL`` * 13 *
    lr (measured 0.15), and JAX moved each of them by more than that
    (measured at least 0.46); every element within 2 * 13 * lr (each
    update is about lr * sign(g) where the gradient is noise); the frozen
    tensors stay bit for bit; the BN running statistics within 10% of
    their tensor's largest value (measured 3%).

    The losses alone cannot tell the port's bf16 from its fp32 at this
    tolerance (its fp32 is as close to JAX's bf16), so the test also holds
    that the port's train steps ran in bf16: the first convolution's output
    and every attention's were bfloat16 in each of them."""
    root = str(tmp_path)
    frames, size = 4, 32
    write_checkerboard_tree(root, pairs=17, val_pairs=2, frames=frames, size=2 * size,
                            methods=FF_METHODS, spread_methods=True, seed=7)
    tcfg = dict(batch_size=4, epochs=4, lr=BF16_LR, accum_steps=2, seed=0, frame_count=frames)
    jcfg, pcfg = _configs(JaxConfig.micro(), pc.ModelConfig.micro(), frames)
    jtrain, jval, jtl, jvl = _checkerboard_loaders((jds, jpipe, jtf), root, size=size,
                                                   frames=frames, batch=4, seed=0)
    ptrain, pval, ptl, pvl = _checkerboard_loaders((pds, ppipe, ptf), root, size=size,
                                                   frames=frames, batch=4, seed=0)
    jt, pt, start, rec = _trainers(monkeypatch, jcfg, pcfg, tcfg, jtrain, len(jtl) // 2)
    jres = jt.fit(jtl, jvl, train_dataset=jtrain, val_dataset=jval)
    pres = pt.fit(ptl, pvl, train_dataset=ptrain, val_dataset=pval)
    monkeypatch.undo()

    n = len(rec["port"])
    assert n == len(rec["jax"]) == 13 and len(pres["history"]) == 4
    assert len(ptrain) == len(ptrain.real_videos) == 17          # the last epoch: reals only
    assert rec["labels"]["port"] == rec["labels"]["jax"]         # the same batches
    assert rec["dtypes"] == {"conv": {torch.bfloat16}, "attention": {torch.bfloat16}}
    diffs = np.abs(np.subtract(rec["port"], rec["jax"]))
    print(f"per-update loss differences: {np.array2string(diffs, precision=5)}")
    assert (diffs <= BF16_LOSS_TOL).all()
    for jh, ph in zip(jres["history"], pres["history"]):
        for part in ("train", "val"):
            assert ph[part]["loss"] == pytest.approx(jh[part]["loss"], abs=BF16_LOSS_TOL), (
                ph["epoch"], part)

    final, signal = _jax_weights(jt, pcfg), _sign_consistent(rec["grads"])
    frozen = {name for name, p in pt.model.named_parameters() if not p.requires_grad}
    step = n * BF16_LR
    worst, count = 0.0, 0
    for name, p in pt.model.named_parameters():
        got, want, first = p.detach().numpy(), final[name].numpy(), start[name].numpy()
        diff = np.abs(got - want)
        assert (diff <= 2 * step).all(), (name, float(diff.max()))
        if name in frozen:
            assert np.array_equal(got, first) and np.array_equal(want, first), name
        sig = signal.get(name)
        if sig is not None and sig.any():
            assert (diff[sig] <= BF16_SIGNAL_TOL * step).all(), (name, float(diff[sig].max()))
            assert (np.abs(want - first)[sig] > BF16_SIGNAL_TOL * step).all(), name
            worst, count = max(worst, float(diff[sig].max())), count + int(sig.sum())
    assert count >= 100 and frozen
    for name, buf in pt.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            want = final[name].numpy()
            assert np.abs(buf.numpy() - want).max() <= 0.1 * np.abs(want).max(), name
    print(f"{count} signal elements, largest difference {worst / step:.3f} * updates * lr")


FULL_WIDTH_FP32_TOL = 5e-3    # test_flagship_updates_track_jax_full_width's docstring
FULL_WIDTH_BF16_TOL = 5e-2    # the same


def _full_width_configs(size, dtype):
    """Both packages' ``ModelConfig()`` at ``size`` px (patch 2: one patch,
    as 224 px gives) in ``dtype``, one chunk a micro-batch of 8 frames."""
    jbase, pbase = JaxConfig(), pc.ModelConfig()
    return _configs(
        jbase.replace(arch=dataclasses.replace(jbase.arch, image_size=size, patch_size=2)),
        pbase.replace(arch=dataclasses.replace(pbase.arch, image_size=size, patch_size=2)),
        8, dtype)


def _micro_batch_losses(monkeypatch, loader, pos_weight, size):
    """Each micro-batch's train-mode loss at the same (initial) weights,
    randomness off, one row a micro-batch: JAX's fp32 ``_loss_fn``, the
    port's fp32 forward, the port's forward in float64 (parameters, inputs
    and compute dtype), JAX's bf16 ``_loss_fn`` and the port's bf16 forward
    (under autocast, as ``train_step`` runs it)."""
    from ewvit_tpu.train.steps import _loss_fn
    from ewvit_tpu_torch.models import detector as pdet
    from ewvit_tpu_torch.models.detector import video_forward
    from ewvit_tpu_torch.train.losses import combined_loss, weighted_bce_with_logits

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, y, *a, **kw: y)
    monkeypatch.setattr(je, "_stochastic_depth", lambda y, rate, det, rng: y)
    variables = _fill(init_detector_fast(_full_width_configs(size, "float32")[0])[1], seed=1)
    state = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables),
                              _full_width_configs(size, "float32")[1])
    batches = list(loader)          # one epoch's order (the loader reshuffles)
    criterion = lambda a, b: weighted_bce_with_logits(a, b, pos_weight=pos_weight)  # noqa: E731

    def jax_losses(dtype):
        jmodel = init_detector_fast(_full_width_configs(size, dtype)[0])[0]
        loss = jax.jit(lambda v, x, y: _loss_fn(
            v["params"], v["batch_stats"], jmodel, x, y, mode="dynamic", frame_chunk=8,
            pos_weight=pos_weight, epoch=0, max_epochs=25, rng=jax.random.PRNGKey(0),
            train=True, remat=False)[0])
        return [float(loss(variables, jpre.preprocess_batch(
            jax.numpy.asarray(frames), train=False, dtype_name=dtype),
            np.asarray(labels, np.float32))) for frames, labels in batches]

    def port_losses(dtype):
        dt = getattr(torch, dtype)
        pcfg = _full_width_configs(size, "bfloat16" if dt == torch.bfloat16 else "float32")[1]
        model = no_dropout(build_detector(pcfg, device="cpu", seed=0))
        model.load_state_dict(state, strict=True)
        model.train()
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.momentum = 0.0
        if dt == torch.float64:
            model.double()
            monkeypatch.setattr(pdet, "compute_dtype", lambda name: torch.float64)
        out = []
        for frames, labels in batches:
            x = preprocess_batch(torch.as_tensor(frames), torch.bfloat16 if dt == torch.bfloat16
                                 else torch.float32)
            lb = torch.as_tensor(np.asarray(labels), dtype=torch.float32)
            if dt == torch.float64:
                x, lb = x.double(), lb.double()
            with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                                 enabled=dt == torch.bfloat16):
                o = video_forward(model, x, mode="dynamic", frame_chunk=8, seed=0, remat=False)
                out.append(float(combined_loss(o, lb, criterion, 0, 25)[0]))
        return out

    cols = [jax_losses("float32"), port_losses("float32"), None, jax_losses("bfloat16"),
            port_losses("bfloat16")]
    cols[2] = port_losses("float64")      # last: it patches the port's compute dtype
    monkeypatch.undo()
    return np.asarray(cols).T


@pytest.mark.slow
@needs_cv2
def test_flagship_updates_track_jax_full_width(tmp_path, monkeypatch):
    """The flagship's first 5 updates at full width (``ModelConfig()``:
    V2-S at published widths, ``dama_dim`` 128, 4 heads, 3 MWT levels, the
    ViT at dim 512, depth 2, 8 heads), batch 4, accum 2, 8 frames, no
    remat, one 32-row chunk a micro-batch, JAX's ``Trainer`` against the
    port's from the same weights, randomness off. The frames are 64 px
    (patch 2, one patch as at 224 px) so that a CPU runs it in about 28
    minutes (1,675 s, ~5 GB); every width and every row count is the
    flagship's, but a BN sees 1/12 of the positions it sees at 224 px, so
    this is not the 224-px update.

    First the 10 micro-batches' train-mode losses at the same weights. In
    fp32: the port's within 1e-5 of its own float64 forward, and JAX's
    within ``FULL_WIDTH_FP32_TOL`` = 5e-3 of it. Measured: JAX's within
    1.7e-4 on 9 of them; on the one batch of 4 real clips (train-mode BN
    over a batch of one class) JAX's fp32 is 1.9e-3 off the float64
    forward, which the port's fp32 matches within 1e-6. In bf16 the
    port's (autocast) within ``FULL_WIDTH_BF16_TOL`` = 5e-2 of JAX's (bf16
    module dtypes) and of its own float64 forward. Measured: the port's
    bf16 within 1.9e-2 of float64 and JAX's within 3.1e-2, on different
    batches, so the two bf16 losses part by up to 3.2e-2 (JAX's rounding
    on its worst batch, where the port's is 1.3e-3) and by 1.3e-2 on
    average; the limit is 1.6 times the largest. A forward that predicts
    0.5 for every clip (loss 0.693) is 0.11 off on the worst batch.

    Then three legs of 5 updates, JAX's ``Trainer`` against the port's. In
    fp32 at lr 1e-5 every per-update loss agrees within
    ``FULL_WIDTH_FP32_TOL`` (measured: 6e-5 or less, and 1.7e-3 at the
    update on that batch). At the flagship's lr 3e-4, in fp32 and in
    bf16, only update 1 is held: it runs both packages on the same
    weights, in fp32 within ``FULL_WIDTH_FP32_TOL`` (measured 6.8e-5) and
    in bf16 within ``BF16_LOSS_TOL`` = 2e-2 (measured 8.7e-3), and the
    port's train steps of the bf16 leg ran in bf16 (the first
    convolution's output and every attention's). Updates 2-5 are printed,
    not held: Adam's first steps are about lr * sign(g) on every one of
    the ~60M trainable weights, so a gradient element near 0 whose sign
    the two programs' rounding decides moves by 2 lr from one package to
    the other, and the losses part within 3 updates in fp32 already (JAX's
    own bf16 and fp32 runs part as far)."""
    root = str(tmp_path)
    frames, size = 8, 64
    write_checkerboard_tree(root, pairs=20, val_pairs=1, frames=frames, size=2 * size,
                            methods=FF_METHODS, spread_methods=True, seed=7)

    def loaders():
        jtrain, _, jtl, _ = _checkerboard_loaders((jds, jpipe, jtf), root, size=size,
                                                  frames=frames, batch=4, seed=0)
        _, _, ptl, _ = _checkerboard_loaders((pds, ppipe, ptf), root, size=size, frames=frames,
                                             batch=4, seed=0)
        return jtrain, jtl, ptl

    jtrain, jtl, _ = loaders()
    same = _micro_batch_losses(monkeypatch, jtl, jtrain.fake_ratio, size)
    print("micro-batch losses at the same weights (JAX fp32, port fp32, port float64, "
          f"JAX bf16, port bf16):\n{same}\nport bf16 against JAX bf16: "
          f"{np.array2string(np.abs(same[:, 4] - same[:, 3]), precision=5)}")
    assert len(same) == 10
    assert np.abs(same[:, 1] - same[:, 2]).max() <= 1e-5
    assert np.abs(same[:, 0] - same[:, 2]).max() <= FULL_WIDTH_FP32_TOL
    assert np.abs(same[:, 4] - same[:, 3]).max() <= FULL_WIDTH_BF16_TOL
    assert np.abs(same[:, 4] - same[:, 2]).max() <= FULL_WIDTH_BF16_TOL

    losses, dtypes = {}, {}
    for dtype, lr in (("float32", 1e-5), ("float32", BF16_LR), ("bfloat16", BF16_LR)):
        tcfg = dict(batch_size=4, epochs=25, lr=lr, accum_steps=2, seed=0, frame_count=frames)
        jcfg, pcfg = _full_width_configs(size, dtype)
        jtrain, jtl, ptl = loaders()
        jt, pt, _, rec = _trainers(monkeypatch, jcfg, pcfg, tcfg, jtrain, len(jtl) // 2,
                                   keep_grads=False)
        jt.train_epoch(jtl, 0)
        pt.train_epoch(ptl, 0)
        monkeypatch.undo()
        del jt, pt
        assert len(rec["port"]) == len(rec["jax"]) == 5
        assert rec["labels"]["port"] == rec["labels"]["jax"]
        leg = losses[dtype, lr] = {k: np.asarray(rec[k]) for k in ("jax", "port")}
        dtypes[dtype, lr] = rec["dtypes"]
        print(f"{dtype} lr {lr}: JAX {np.array2string(leg['jax'], precision=5)}, port "
              f"{np.array2string(leg['port'], precision=5)}, differences "
              f"{np.array2string(np.abs(leg['port'] - leg['jax']), precision=5)}")

    small = losses["float32", 1e-5]
    assert (np.abs(small["port"] - small["jax"]) <= FULL_WIDTH_FP32_TOL).all()
    spread = np.abs(losses["bfloat16", BF16_LR]["jax"] - losses["float32", BF16_LR]["jax"])
    print(f"JAX bf16 against JAX fp32 at lr {BF16_LR}: {np.array2string(spread, precision=5)}")
    for dtype, tol in (("float32", FULL_WIDTH_FP32_TOL), ("bfloat16", BF16_LOSS_TOL)):
        leg = losses[dtype, BF16_LR]
        assert abs(leg["port"][0] - leg["jax"][0]) <= tol, dtype
        want = getattr(torch, dtype)
        assert dtypes[dtype, BF16_LR] == {"conv": {want}, "attention": {want}}, dtype
