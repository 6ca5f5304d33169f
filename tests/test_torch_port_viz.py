"""The port's intermediates and visualisation held against the JAX package (CPU, fp32).

- the MWT's ``return_intermediates`` (``hf_level0``, ``freq_out``) against
  ``MWT.apply(..., return_intermediates=True)``;
- DAMA's ``return_intermediates`` (``space_map``, ``freq_map``,
  ``fused_map``, ``gate_weights``, the four attention maps) against
  ``DAMA.apply(..., return_intermediates=True)``, with the port's
  ``use_pallas_dama`` on and off: the attention takes the plain stack either
  way, and the fused MWT tail is not taken under intermediates;
- ``cli.visualize_feature_maps.collect`` against the arrays the JAX CLI
  computes (visualize_feature_maps.py:95-148: ``capture_intermediates`` for
  the V2-S stem, the MWT run alone for ``hf_level0``);
- ``Trainer.fit(viz=)`` feeds its ``viz`` the keys and values the JAX
  ``fit`` feeds its own, given the same epoch results.

One set of JAX variables (``init_detector_fast`` shapes refilled from a
numpy seed) is converted by ``utils/convert.jax_to_state_dict``; the
config is ``ModelConfig.micro()`` at ``dama_dim`` 128 and 4 heads, so K4's
route exists. Tolerance 1e-4 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewvit_tpu.configs import ModelConfig as JaxConfig
from ewvit_tpu.configs import TrainConfig as JaxTrainConfig
from ewvit_tpu.data.transforms import FrameTransform as JaxFrameTransform
from ewvit_tpu.models.dama import DAMA as JaxDAMA
from ewvit_tpu.models.detector import init_detector_fast
from ewvit_tpu.models.mwt import MWT as JaxMWT
from ewvit_tpu.ops.preprocess import preprocess_batch as jax_preprocess
from ewvit_tpu.train import loop as jloop
from ewvit_tpu_torch import configs as pc
from ewvit_tpu_torch.cli.visualize_feature_maps import collect
from ewvit_tpu_torch.models import layers
from ewvit_tpu_torch.models.detector import build_detector
from ewvit_tpu_torch.models.mwt import MWT
from ewvit_tpu_torch.train import loop as ploop
from ewvit_tpu_torch.utils.convert import jax_to_state_dict
from test_torch_port_model import _fill, _sub

WIDE = dict(dama_dim=128, num_heads=4)
FLAGS = dict(use_pallas_dwt=True, use_pallas_dwse=True, use_pallas_dama=True,
             use_fused_mwt_tail=True)
JCFG = JaxConfig.micro().replace(**WIDE)
PCFG = pc.ModelConfig.micro().replace(**WIDE, **FLAGS)
N = 3
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes that share the cores, and torch's default of
    one OpenMP thread per core oversubscribes them (each barrier then waits
    for descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jvars():
    _, shapes = init_detector_fast(JCFG, seed=0)
    return _fill(shapes, seed=1)


def _port(jvars, **kw):
    model = build_detector(PCFG.replace(**kw), device="cpu", seed=0)
    model.load_state_dict(jax_to_state_dict(jvars, PCFG), strict=True)
    return model


@pytest.fixture(scope="module")
def frames():
    x = np.random.default_rng(2).standard_normal((N, 32, 32, 3)).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _refuse(*a, **k):
    raise RuntimeError("a kernel path ran")


def test_mwt_intermediates_match_jax(jvars, frames, monkeypatch):
    x, xt = frames
    mwt = JaxMWT(in_channels=3, dama_dim=JCFG.dama_dim, levels=JCFG.levels)
    ref, inter = jax.jit(lambda v, x: mwt.apply(v, x, train=False, return_intermediates=True))(
        _sub(jvars, "dama", "mwt"), jnp.asarray(x))
    port = _port(jvars).dama.mwt
    assert port.use_fused_tail
    monkeypatch.setattr(MWT, "_fused_multiscale", _refuse)
    with pytest.raises(RuntimeError, match="kernel path"):      # the tail's gate is open
        port(xt)
    with torch.no_grad():
        freq, got = port(xt, return_intermediates=True)
    assert set(got) == {"hf_level0", "freq_out"} and got["freq_out"] is freq
    assert got["hf_level0"].shape == (N, JCFG.dama_dim, 16, 16)
    np.testing.assert_allclose(_nhwc(got["hf_level0"]), np.asarray(inter["hf_level0"]), **TOL)
    np.testing.assert_allclose(_nhwc(freq), np.asarray(inter["freq_out"]), **TOL)
    np.testing.assert_allclose(_nhwc(freq), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_dama_intermediates_match_jax(jvars, frames, monkeypatch, fused):
    x, xt = frames
    dama = JaxDAMA(arch=JCFG.arch, dim=JCFG.dama_dim, num_heads=JCFG.num_heads,
                   levels=JCFG.levels, backbone_spec=JCFG.backbone_spec)
    ref = jax.jit(lambda v, x: dama.apply(v, x, return_intermediates=True))(
        _sub(jvars, "dama"), jnp.asarray(x))
    port = _port(jvars, use_pallas_dama=fused).dama
    for name in ("fused_bidirectional_cross_attention",
                 "fused_bidirectional_cross_attention_packed"):
        monkeypatch.setattr(layers, name, _refuse)
    if fused:
        with torch.no_grad(), pytest.raises(RuntimeError, match="kernel path"):
            port(xt)                                   # K4's route without intermediates
    with torch.no_grad():
        got = port(xt, return_intermediates=True)
    for key in ("fused", "space", "freq"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), err_msg=key, **TOL)
    gi, ri = got["intermediates"], ref["intermediates"]
    assert set(gi) == set(ri)
    for key in ("space_map", "freq_map", "fused_map"):
        assert gi[key].shape == (N, JCFG.dama_dim, 1, 1)
        np.testing.assert_allclose(_nhwc(gi[key]), np.asarray(ri[key]), err_msg=key, **TOL)
    np.testing.assert_allclose(gi["gate_weights"].numpy(), np.asarray(ri["gate_weights"]),
                               **TOL)
    assert len(gi["attention"]) == len(ri["attention"]) == 4
    for i, (a, b) in enumerate(zip(gi["attention"], ri["attention"])):
        assert a.shape == (N, JCFG.num_heads, 1, 2)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"attention {i}", **TOL)


def test_collect_matches_the_jax_cli(jvars):
    """collect() against visualize_feature_maps.py:95-148 on the same image
    and weights; the port's model has every kernel flag on (their plain
    versions on the CPU), the JAX CLI's DAMA none."""
    image = np.random.default_rng(7).integers(0, 256, (48, 40, 3), np.uint8)
    got = collect(_port(jvars), PCFG, image)

    size = JCFG.arch.image_size
    crop = JaxFrameTransform(resize=max(1, round(size * 450 / 224)), crop=size)(image)
    x = jax_preprocess(jnp.asarray(crop[None, None]), train=False, dtype_name="float32")[:, 0]
    dama = JaxDAMA(arch=JCFG.arch, in_channels=3, dim=JCFG.dama_dim,
                   num_heads=JCFG.num_heads, levels=JCFG.levels,
                   backbone_spec=JCFG.backbone_spec)
    out, state = jax.jit(lambda v, x: dama.apply(
        v, x, train=False, return_intermediates=True, capture_intermediates=True,
        mutable=["intermediates"]))(_sub(jvars, "dama"), x)
    stem = np.asarray(state["intermediates"]["sfe"]["efficient_net"]["net"]["stem"]
                      ["__call__"][0])
    mwt = JaxMWT(in_channels=3, dama_dim=JCFG.dama_dim, levels=JCFG.levels)
    _, mwt_inter = jax.jit(lambda v, x: mwt.apply(v, x, train=False,
                                                  return_intermediates=True))(
        _sub(jvars, "dama", "mwt"), x)
    inter = out["intermediates"]

    np.testing.assert_array_equal(got["crop"], crop)
    np.testing.assert_allclose(got["stem"], stem[0].transpose(2, 0, 1), **TOL)
    np.testing.assert_allclose(got["hf_level0"],
                               np.asarray(mwt_inter["hf_level0"])[0].transpose(2, 0, 1), **TOL)
    np.testing.assert_allclose(got["gate_weights"], np.asarray(inter["gate_weights"])[0], **TOL)
    np.testing.assert_allclose(got["attention"],
                               np.stack([np.asarray(a)[0] for a in inter["attention"]]), **TOL)


class _Recorder:
    def __init__(self):
        self.updates, self.rendered = [], 0

    def update(self, **kw):
        self.updates.append(kw)

    def render_all(self):
        self.rendered += 1


def _epochs(result_cls):
    """Two epochs of train and val results: (train, val) per epoch."""
    out = []
    for e in range(2):
        tr = result_cls(loss=0.7 - 0.1 * e, cls_loss=0.6 - 0.1 * e, orth_loss=0.1 + e,
                        metrics={"accuracy": 0.5 + 0.1 * e, "auc": 0.55 + 0.1 * e},
                        seconds=1.5 + e)
        va = result_cls(loss=0.8 - 0.2 * e, cls_loss=float("nan"), orth_loss=float("nan"),
                        metrics={"accuracy": 0.25 + 0.5 * e, "auc": 0.4 + 0.3 * e,
                                 "preds": [], "labels": []}, seconds=0.25 * (e + 1))
        out.append((tr, va))
    return out


def _drive(trainer, result_cls, monkeypatch):
    epochs = iter(_epochs(result_cls))
    pending = []

    def train_epoch(loader, epoch):
        pending.append(next(epochs))
        return pending[-1][0]

    monkeypatch.setattr(trainer, "train_epoch", train_epoch)
    monkeypatch.setattr(trainer, "eval_epoch", lambda loader, **kw: pending[-1][1])
    viz = _Recorder()
    trainer.fit([], [], viz=viz)
    return viz


def test_fit_feeds_viz_as_jax(jvars, monkeypatch):
    tcfg = dict(batch_size=2, epochs=2, lr=1e-4, seed=0)
    monkeypatch.setattr(jloop, "init_detector", lambda cfg, rng: (
        init_detector_fast(cfg)[0], jvars))
    jt = jloop.Trainer(JCFG, JaxTrainConfig(**tcfg), steps_per_epoch=3, log=lambda s: None)
    want = _drive(jt, jloop.EpochResult, monkeypatch)
    pt = ploop.Trainer(PCFG, pc.TrainConfig(**tcfg), steps_per_epoch=3, device="cpu",
                       log=lambda s: None)
    got = _drive(pt, ploop.EpochResult, monkeypatch)
    assert (got.rendered, want.rendered) == (1, 1)
    assert len(got.updates) == len(want.updates) == 2
    for g, w in zip(got.updates, want.updates):
        assert list(g) == list(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-12), k
