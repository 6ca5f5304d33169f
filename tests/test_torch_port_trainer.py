"""The port's checkpoints and ``Trainer`` on the CPU, and one whole
training run held against the JAX package's ``Trainer``.

Port-only tests run ``ModelConfig.micro()`` (fp32, 32 px) with all four
kernel flags (their plain versions on the CPU) on in-memory uint8 clips;
the crash tests mirror ``tests/test_train_stack.py`` for the JAX manager.

Against JAX: one 2-epoch ``fit`` on each side over the same synthetic FF++
tree (``data/synthetic.py``; 6 train pairs, so 3 updates in epoch 1 and 2
after the curriculum's refresh, and 4 val pairs, 7 clips with a padded
tail), with the JAX ``Trainer``'s initial weights (seeded numpy, as
``test_torch_port_model.py`` fills them) converted into the port,
shuffle off, and dropout, stochastic depth and colour jitter neutralised on
both sides (as ``test_torch_port_train.py`` does for dropout; jitter by
preprocessing the train batches as eval batches). Per-epoch train and val
losses and val AUC agree within 1e-5. The final parameters, with the
bounds ``test_torch_port_train.py`` puts on one update: every update is
Adam's, about ``lr * sign(g)`` where a gradient is at noise level, so each
of the 5 updates may differ by up to 2 * lr; where the port's gradient was
signal at every update (:func:`_signal_mask`), within steps * (1e-6 + 1e-2
* lr). The frozen tensors stay bit for bit on both sides. The lr
is 1e-5: Adam turns a gradient at noise level into a step of about lr, and
at 1e-3 such steps moved the val loss by 1e-4 after 3 updates.
"""

import dataclasses
import os

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
from ewvit_tpu_torch.checkpoint import load_model
from ewvit_tpu_torch.data import datasets as pds
from ewvit_tpu_torch.data import pipeline as ppipe
from ewvit_tpu_torch.data import transforms as ptf
from ewvit_tpu_torch.data.synthetic import write_ff_tree
from ewvit_tpu_torch.data.transforms import cv2_module
from ewvit_tpu_torch.evaluation import eval_step
from ewvit_tpu_torch.models.detector import build_detector
from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops.preprocess import preprocess_batch
from ewvit_tpu_torch.train import checkpoint as pckpt
from ewvit_tpu_torch.train import loop as ploop
from ewvit_tpu_torch.train.checkpoint import CheckpointManager
from ewvit_tpu_torch.train.loop import EpochResult, Trainer, step_seeds
from ewvit_tpu_torch.train.optimizer import detector_frozen_names, make_optimizer
from ewvit_tpu_torch.train.steps import train_step
from ewvit_tpu_torch.utils.convert import jax_to_state_dict

from test_torch_port_model import _fill
from test_torch_port_train import no_dropout

FLAGS = dict(use_pallas_dwt=True, use_pallas_dwse=True, use_pallas_dama=True,
             use_fused_mwt_tail=True)
CFG = pc.ModelConfig.micro().replace(**FLAGS)
TCFG = pc.TrainConfig(batch_size=2, epochs=2, lr=1e-3, accum_steps=2, seed=5)
K = 3                       # frames a clip: chunks of 2 and a ragged tail of 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes that share the cores, and torch's default of
    one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clips:
    """In-memory map-style dataset of seeded uint8 clips, labels alternating."""

    def __init__(self, n, seed, size=32):
        g = np.random.default_rng(seed)
        self.clips = g.integers(0, 256, (n, K, size, size, 3), dtype=np.uint8)
        self.labels = [i % 2 for i in range(n)]

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.clips[i], self.labels[i]


def _loaders(n_train=8, n_val=5):
    train = ppipe.BatchLoader(Clips(n_train, 1), 2, drop_last=True, num_workers=0)
    val = ppipe.BatchLoader(Clips(n_val, 3), 2, pad_last=True, num_workers=0)
    return train, val


def _trainer(tmp_path=None, **kw):
    kw.setdefault("steps_per_epoch", 2)
    return Trainer(CFG, kw.pop("train_cfg", TCFG), device="cpu", log=lambda s: None,
                   checkpoint_dir=str(tmp_path) if tmp_path is not None else None, **kw)


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ----------------------------------------------------------------- checkpoints


@pytest.fixture
def small():
    """A model with a BN and the optimizer after one update."""
    torch.manual_seed(0)
    model = nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4), nn.Flatten(), nn.Linear(16, 1))
    from ewvit_tpu_torch.train.optimizer import ScheduledAdam, cosine_annealing_schedule
    opt = ScheduledAdam(model.parameters(), cosine_annealing_schedule(1e-3, 3, 2))
    model(torch.randn(2, 3, 4, 4)).sum().backward()
    opt.step()
    return model, opt


def _fresh(small):
    model, opt = small
    m2 = nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4), nn.Flatten(), nn.Linear(16, 1))
    o2 = type(opt)(m2.parameters(), opt.schedule)
    return m2, o2


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_round_trip(small, tmp_path, async_save):
    model, opt = small
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    mgr.save_epoch(model, opt, epoch=2, best_val_auc=0.77)
    mgr.save_best(model, opt, epoch=0, best_val_auc=0.5)
    mgr.save_best(model, opt, epoch=1, best_val_auc=0.9)      # overwrite in the queue
    mgr.wait_until_finished()
    assert sorted(os.listdir(tmp_path)) == ["best_model.pth", "checkpoint_3.pth"]
    m2, o2 = _fresh(small)
    assert mgr.restore(str(tmp_path / "checkpoint_3.pth"), m2, o2) == (3, pytest.approx(0.77))
    _assert_state_equal(m2.state_dict(), model.state_dict())
    assert o2.param_groups[0]["count"] == 1
    for a, b in zip(o2.state.values(), opt.state.values()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[key], b[key])
    assert mgr.restore(str(tmp_path / "best_model.pth"), m2)[0] == 2
    obj = torch.load(tmp_path / "best_model.pth", weights_only=True)
    assert set(obj) == {"epoch", "best_val_auc", "step", "model_state_dict",
                        "optimizer_state_dict"}
    assert obj["step"] == 1 and obj["best_val_auc"] == pytest.approx(0.9)


def _explode(*a, **k):
    raise RuntimeError("simulated crash mid-checkpoint-write")


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_crash_mid_save_keeps_previous(small, tmp_path, monkeypatch, async_save):
    model, opt = small
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    mgr.save_best(model, opt, epoch=3, best_val_auc=0.6)
    mgr.wait_until_finished()
    monkeypatch.setattr(pckpt.torch, "save", _explode)
    if async_save:
        mgr.save_best(model, opt, epoch=4, best_val_auc=0.95)
        with pytest.raises(RuntimeError, match="simulated crash"):
            mgr.wait_until_finished()
    else:
        with pytest.raises(RuntimeError, match="simulated crash"):
            mgr.save_best(model, opt, epoch=4, best_val_auc=0.95)
    monkeypatch.undo()
    m2, o2 = _fresh(small)
    assert mgr.restore(str(tmp_path / "best_model.pth"), m2, o2) == (4, pytest.approx(0.6))


def test_checkpoint_old_fallback_and_double_crash(small, tmp_path, monkeypatch):
    """A crash between the two moves leaves only ``.old``: ``restore`` reads
    it, and the next save promotes it back before writing, so a second crash
    mid-write still leaves it."""
    model, opt = small
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_best(model, opt, epoch=5, best_val_auc=0.7)
    os.replace(tmp_path / "best_model.pth", tmp_path / "best_model.pth.old")     # crash 1
    m2, o2 = _fresh(small)
    assert mgr.restore(str(tmp_path / "best_model.pth"), m2, o2) == (6, pytest.approx(0.7))
    monkeypatch.setattr(pckpt.torch, "save", _explode)
    with pytest.raises(RuntimeError, match="simulated crash"):                   # crash 2
        mgr.save_best(model, opt, epoch=6, best_val_auc=0.9)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["best_model.pth"]
    assert mgr.restore(str(tmp_path / "best_model.pth"), m2, o2) == (6, pytest.approx(0.7))
    mgr.save_best(model, opt, epoch=7, best_val_auc=0.8)      # a clean save leaves no debris
    assert sorted(os.listdir(tmp_path)) == ["best_model.pth"]


@pytest.mark.parametrize("resume_by", ["restore", "next_save"])
def test_checkpoint_crash_between_moves_resumes_newer(small, tmp_path, monkeypatch, resume_by):
    """A crash after the previous file moved to ``.old`` and before the
    ``.swap-in`` moved into place leaves both: the ``.swap-in`` is complete
    and newer, so ``restore`` (or the next save, even if it crashes while
    writing) promotes it, and the resume starts after the newer epoch."""
    model, opt = small
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_best(model, opt, epoch=3, best_val_auc=0.6)
    real = os.replace

    def stop_before_second_move(src, dst):
        if str(src).endswith(".swap-in"):
            raise RuntimeError("simulated crash between the two moves")
        real(src, dst)

    monkeypatch.setattr(pckpt.os, "replace", stop_before_second_move)
    with pytest.raises(RuntimeError, match="between the two moves"):
        mgr.save_best(model, opt, epoch=4, best_val_auc=0.9)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["best_model.pth.old", "best_model.pth.swap-in"]
    if resume_by == "next_save":
        monkeypatch.setattr(pckpt.torch, "save", _explode)
        with pytest.raises(RuntimeError, match="simulated crash"):
            mgr.save_best(model, opt, epoch=5, best_val_auc=0.95)
        monkeypatch.undo()
    m2, o2 = _fresh(small)
    assert mgr.restore(str(tmp_path / "best_model.pth"), m2, o2) == (5, pytest.approx(0.9))
    assert sorted(os.listdir(tmp_path)) == ["best_model.pth"]


def test_async_back_pressure(small, tmp_path, monkeypatch):
    """No more than 2 saves in flight; the third waits for the oldest."""
    model, opt = small
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    seen = []
    real = pckpt.torch.save

    def slow_save(obj, path):
        seen.append(len(mgr._pending))
        real(obj, path)

    monkeypatch.setattr(pckpt.torch, "save", slow_save)
    for e in range(4):
        mgr.save_epoch(model, opt, epoch=e, best_val_auc=0.5)
        assert len(mgr._pending) <= 2
    mgr.wait_until_finished()
    assert len(seen) == 4 and sorted(os.listdir(tmp_path)) == [
        f"checkpoint_{e}.pth" for e in range(1, 5)]


# ----------------------------------------------------------------- the Trainer


def test_fit_equals_the_steps_by_hand():
    """``fit`` over 2 epochs: bit for bit the ``train_step`` and ``eval_step``
    calls made by hand with the seeds of ``step_seeds``."""
    train, val = _loaders()
    trainer = _trainer()
    start = _state(trainer.model)
    before = dict(extension.LAUNCHES)
    result = trainer.fit(train, val)
    assert extension.LAUNCHES == before          # CPU tensors launch nothing

    model = build_detector(CFG, device="cpu", seed=TCFG.seed)
    _assert_state_equal(_state(model), start)
    opt = make_optimizer(model, lr=TCFG.lr, weight_decay=TCFG.weight_decay,
                         epochs=TCFG.epochs, steps_per_epoch=2, eta_min=TCFG.lr_min)
    for epoch in range(2):
        batches = list(train)
        losses = []
        for i in range(0, len(batches), 2):
            group = batches[i:i + 2]
            frames = torch.from_numpy(np.concatenate([b[0] for b in group]))
            labels = torch.from_numpy(np.concatenate([b[1] for b in group])).float()
            jitter, seed = step_seeds(TCFG.seed, opt.param_groups[0]["count"])
            x = preprocess_batch(frames, torch.float32, train=True,
                                 generator=torch.Generator().manual_seed(jitter))
            m = train_step(model, opt, x, labels, seed=seed, frame_chunk=CFG.frame_chunk,
                           accum_steps=len(group), epoch=epoch, max_epochs=2)
            losses.append(float(m["loss"]))
        hist = result["history"][epoch]
        assert hist["train"]["loss"] == pytest.approx(np.mean(losses), abs=1e-7)
        model.eval()
        val_losses, n_seen = [], 0
        for frames, lbls in val:
            n = min(len(lbls), 5 - n_seen)
            n_seen += n
            out = eval_step(model, preprocess_batch(torch.from_numpy(frames), torch.float32),
                            torch.from_numpy(lbls).float(),
                            torch.as_tensor(np.arange(len(lbls)) < n, dtype=torch.float32),
                            frame_chunk=CFG.frame_chunk, epoch=epoch, max_epochs=2)
            val_losses.append(float(out["loss"]) * n)
        assert hist["val"]["loss"] == pytest.approx(sum(val_losses) / 5, abs=1e-7)
    _assert_state_equal(_state(trainer.model), _state(model))
    assert trainer.optimizer.param_groups[0]["count"] == 4


def test_resume_repeats_the_run(tmp_path):
    """A run resumed from ``checkpoint_1.pth`` runs epoch 2 only and ends bit
    for bit where the uninterrupted run ends; ``best_model.pth`` loads
    through ``load_model``; the frozen tensors never move."""
    train, val = _loaders()
    full = _trainer(tmp_path / "a", async_ckpt=True)
    start = _state(full.model)
    result = full.fit(train, val)
    files = sorted(os.listdir(tmp_path / "a"))
    assert files == ["best_model.pth", "checkpoint_1.pth", "checkpoint_2.pth"]
    for n in detector_frozen_names():
        assert torch.equal(full.model.state_dict()[n], start[n]), n

    resumed = _trainer(tmp_path / "b", model=build_detector(CFG, device="cpu", seed=99))
    resumed.resume(str(tmp_path / "a" / "checkpoint_1.pth"))
    assert resumed.start_epoch == 1
    assert resumed.best_val_auc == pytest.approx(result["history"][0]["val"]["auc"]
                                                 if np.isfinite(result["history"][0]["val"]["auc"])
                                                 else 0.0)
    again = resumed.fit(*_loaders())
    assert [h["epoch"] for h in again["history"]] == [1]
    assert again["history"][0]["train"]["loss"] == result["history"][1]["train"]["loss"]
    _assert_state_equal(_state(resumed.model), _state(full.model))
    assert sorted(os.listdir(tmp_path / "b")) in (["checkpoint_2.pth"],
                                                  ["best_model.pth", "checkpoint_2.pth"])

    best = torch.load(tmp_path / "a" / "best_model.pth", weights_only=True)
    epoch_file = torch.load(tmp_path / "a" / f"checkpoint_{best['epoch'] + 1}.pth",
                            weights_only=True)
    loaded = load_model(str(tmp_path / "a" / "best_model.pth"), CFG, device="cpu")
    _assert_state_equal(loaded.state_dict(), epoch_file["model_state_dict"])


def test_save_every_and_best(tmp_path):
    """Epoch checkpoints every ``save_every`` epochs and at the last; the best
    model on a new best finite AUC only."""
    trainer = _trainer(tmp_path, save_every=2,
                       train_cfg=dataclasses.replace(TCFG, epochs=5))
    aucs = iter([0.5, float("nan"), 0.4, 0.7, 0.6])
    trainer.train_epoch = lambda loader, epoch: EpochResult(0.1, 0.1, 0.0, {}, 0.0)
    trainer.eval_epoch = lambda loader, epoch, max_epochs: EpochResult(
        0.2, float("nan"), float("nan"), {"auc": next(aucs)}, 0.0)
    saved = []
    real = trainer.ckpt._write_swap
    trainer.ckpt._write_swap = lambda obj, final: (
        saved.append((os.path.basename(final), obj["epoch"])), real(obj, final))
    assert trainer.fit([], [])["best_val_auc"] == pytest.approx(0.7)
    assert saved == [("best_model.pth", 0), ("checkpoint_2.pth", 1), ("best_model.pth", 3),
                     ("checkpoint_4.pth", 3), ("checkpoint_5.pth", 4)]


def test_val_epoch_under_autocast_keeps_fp32_weights():
    """The val epoch of a bf16 model under autocast: K2, K3 and K4's paths
    (their plain versions here) take what autocast gives them and agree with
    the plain modules within bf16 rounding; the weights stay fp32 and
    training goes on."""
    cfg = CFG.replace(compute_dtype="bfloat16", dama_dim=128, num_heads=4)
    _, val = _loaders()
    outs = {}
    for name, flags in (("kernels", FLAGS), ("plain", {k: False for k in FLAGS})):
        trainer = Trainer(cfg.replace(**flags), TCFG, device="cpu", log=lambda s: None,
                          model=build_detector(cfg.replace(**flags), device="cpu", seed=3))
        outs[name] = trainer.eval_epoch(val, epoch=0, max_epochs=2)
        assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert trainer.model.dama.cross_att.fuses() is False      # the plain run
    got, want = (np.asarray(outs[k].metrics["preds"]) for k in ("kernels", "plain"))
    assert got.shape == (5,) and np.abs(got - want).max() < 2e-2
    assert abs(outs["kernels"].loss - outs["plain"].loss) < 2e-2
    train, _ = _loaders(n_train=4)
    tr = trainer.train_epoch(train, 0)
    assert np.isfinite(tr.loss)


# ----------------------------------------------------------------- against JAX

_JBASE = JaxConfig.micro()
JCFG = _JBASE.replace(arch=dataclasses.replace(_JBASE.arch, dropout=0.0, emb_dropout=0.0))
PAIRS = dict(train=6, val=4, test=1)
LR = 1e-5


def _signal_mask(grads):
    """Per tensor, the elements whose gradient was signal at every update,
    by ``test_torch_port_train.py``'s rule for one update: above 1e-3 of
    the tensor's max abs and 100 times the gradient tolerance (1e-4 of the
    tensor's max abs, floored at 1e-6 of the model's largest gradient, the
    fp32 residue of a gradient that is 0 in exact arithmetic)."""
    masks = {}
    for step in grads:
        top = max(float(g.abs().max()) for g in step.values())
        for name, g in step.items():
            m = float(g.abs().max())
            tol = max(1e-4 * m, 1e-6 * top)
            ok = (g.abs() > 1e-3 * m) & (g.abs() > 100 * tol)
            masks[name] = masks[name] & ok if name in masks else ok
    return masks


def _data(pkg_ds, pkg_pipe, pkg_tf, root):
    tf = pkg_tf.FrameTransform(resize=64, crop=32, aligner=pkg_tf.FaceAligner(detector="none"))
    train = pkg_ds.FaceForensicsDataset(root, split="train", frame_count=K, transform=tf, seed=4)
    val = pkg_ds.FaceForensicsDataset(root, split="val", frame_count=K, transform=tf, seed=4)
    return (train, val, pkg_pipe.BatchLoader(train, 2, drop_last=True, num_workers=0),
            pkg_pipe.BatchLoader(val, 2, pad_last=True, num_workers=0))


@pytest.mark.skipif(cv2_module() is None, reason="cv2 writes the frame tree")
def test_fit_matches_jax(tmp_path, monkeypatch):
    root = str(tmp_path)
    write_ff_tree(root, pairs=PAIRS, frames=5, height=40, width=48, seed=6)
    tcfg = dict(batch_size=2, epochs=2, lr=LR, accum_steps=2, seed=0)

    # JAX: dropout, stochastic depth and jitter off while its programs trace
    jtrain, jval, jtl, jvl = _data(jds, jpipe, jtf, root)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, y, *a, **kw: y)
    monkeypatch.setattr(je, "_stochastic_depth", lambda y, rate, det, rng: y)
    monkeypatch.setattr(jloop, "preprocess_batch", lambda x, key, train, dtype_name:
                        jpre.preprocess_batch(x, train=False, dtype_name=dtype_name))
    # seeded weights without the ~20 s compile of the real initializer
    monkeypatch.setattr(jloop, "init_detector", lambda cfg, rng: (
        lambda model, shapes: (model, _fill(shapes, seed=1)))(*init_detector_fast(cfg)))
    jt = jloop.Trainer(JCFG, JaxTrainConfig(**tcfg), pos_weight=jtrain.fake_ratio,
                       steps_per_epoch=4, rng=jax.random.PRNGKey(0), remat=False,
                       log=lambda s: None)
    start = jax.tree_util.tree_map(np.array, {"params": jt.state.params,
                                              "batch_stats": jt.state.batch_stats})
    jres = jt.fit(jtl, jvl, train_dataset=jtrain, val_dataset=jval)
    monkeypatch.undo()

    # the port, from the same weights, all four kernel flags (plain on the CPU)
    ptrain, pval, ptl, pvl = _data(pds, ppipe, ptf, root)
    model = build_detector(CFG, device="cpu", seed=0)
    model.load_state_dict(jax_to_state_dict(start, CFG), strict=True)
    pt = Trainer(CFG, pc.TrainConfig(**tcfg), pos_weight=ptrain.fake_ratio, steps_per_epoch=4,
                 device="cpu", model=no_dropout(model), remat=True, log=lambda s: None)
    monkeypatch.setattr(ploop, "preprocess_batch", lambda x, dtype, train=False, generator=None:
                        preprocess_batch(x, dtype))
    grads = []

    def recording_step(model, *a, **kw):
        out = train_step(model, *a, **kw)
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return out

    monkeypatch.setattr(ploop, "train_step", recording_step)
    pres = pt.fit(ptl, pvl, train_dataset=ptrain, val_dataset=pval)

    assert [len(ptrain), len(pval)] == [8, 7]        # epoch 2: the curriculum's 2 fakes
    for jh, ph in zip(jres["history"], pres["history"]):
        for part, key in (("train", "loss"), ("train", "cls_loss"), ("train", "orth_loss"),
                          ("val", "loss"), ("val", "auc")):
            assert ph[part][key] == pytest.approx(jh[part][key], abs=1e-5), (ph["epoch"], part,
                                                                          key)
    assert pt.optimizer.param_groups[0]["count"] == int(jt.state.step) == 5

    steps, final = 5, jax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, {"params": jt.state.params,
                                            "batch_stats": jt.state.batch_stats}), CFG)
    first, signal = jax_to_state_dict(start, CFG), _signal_mask(grads)
    assert len(grads) == steps
    worst = 0.0
    for name, p in pt.model.named_parameters():
        got, want = p.detach().numpy(), final[name].numpy()
        diff = np.abs(got - want)
        assert (diff <= steps * 2 * LR).all(), (name, float(diff.max()))
        if name not in signal:                 # frozen
            assert np.array_equal(got, first[name].numpy()) and np.array_equal(want, got), name
            continue
        sig = signal[name].numpy()
        assert (diff[sig] <= steps * (1e-6 + 1e-2 * LR)).all(), (name, float(diff[sig].max()))
        worst = max(worst, float(diff[sig].max()) if sig.any() else 0.0)
    for name, buf in pt.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), final[name].numpy(), atol=1e-4, rtol=1e-4,
                                       err_msg=name)
    print(f"largest parameter difference from JAX where the updates are signal: {worst:.3e}")
