"""The port's eval side held against the JAX package on the CPU: losses,
metrics, ``eval_step``, ``load_model`` on reference ``.pth`` files and
``evaluate`` over a padded in-memory loader.

Tolerances: losses 1e-6, absolute and relative (both fp32: a sum of six
losses near 30 differs by one fp32 ulp, 3.8e-6, between the two reduction
orders); metrics 1e-12 (both float64 numpy against sklearn); ``eval_step``
loss, orth_loss and predictions 1e-4 (a micro detector's forward in fp32).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewvit_tpu.configs import ModelConfig as JaxConfig
from ewvit_tpu.evaluation import evaluate as jax_evaluate
from ewvit_tpu.models.detector import init_detector_fast
from ewvit_tpu.train import losses as jl
from ewvit_tpu.train.steps import eval_step as jax_eval_step
from ewvit_tpu.utils.metrics import binary_metrics as jax_binary_metrics
from ewvit_tpu_torch import ModelConfig, build_detector
from ewvit_tpu_torch.evaluation import eval_step, evaluate, load_model, print_metrics
from ewvit_tpu_torch.ops.preprocess import preprocess_batch
from ewvit_tpu_torch.train import losses as pl
from ewvit_tpu_torch.utils.convert import jax_to_state_dict
from ewvit_tpu_torch.utils.metrics import binary_metrics

from test_torch_port_model import _fill


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes that share the cores, and torch's default of
    one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol, what="", rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=tol, rtol=rtol, err_msg=what)


# ------------------------------------------------------------------ losses


@pytest.fixture(scope="module")
def loss_inputs():
    g = np.random.default_rng(21)
    return dict(logits=(3 * g.standard_normal((6, 1))).astype(np.float32),
                labels=g.integers(0, 2, 6).astype(np.float32),
                space=g.standard_normal((6, 16)).astype(np.float32),
                freq=g.standard_normal((6, 16)).astype(np.float32),
                mask=np.array([1, 1, 1, 1, 0, 0], np.float32))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_bce_and_focal_match_jax(loss_inputs, reduction):
    x, y = loss_inputs["logits"], loss_inputs["labels"][:, None]
    _close(pl.weighted_bce_with_logits(torch.from_numpy(x), torch.from_numpy(y), 2.5,
                                       reduction),
           jl.weighted_bce_with_logits(jnp.asarray(x), jnp.asarray(y), 2.5, reduction),
           1e-6, "bce", rtol=1e-6)
    _close(pl.binary_focal_loss(torch.from_numpy(x), torch.from_numpy(y),
                                reduction=reduction),
           jl.binary_focal_loss(jnp.asarray(x), jnp.asarray(y), reduction=reduction),
           1e-6, "focal", rtol=1e-6)


def test_orthogonal_loss_and_lambda_match_jax(loss_inputs):
    s, f = loss_inputs["space"], loss_inputs["freq"]
    _close(pl.orthogonal_loss(torch.from_numpy(s), torch.from_numpy(f)),
           jl.orthogonal_loss(jnp.asarray(s), jnp.asarray(f)), 1e-6)
    for epoch, max_epochs in ((0, 10), (2, 10), (3, 10), (5, 10), (7, 10), (9, 10), (1, 1)):
        _close(pl.orth_lambda(epoch, max_epochs), jl.orth_lambda(epoch, max_epochs), 1e-6,
               f"lambda at {epoch}/{max_epochs}")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("features", [True, False])
def test_combined_loss_matches_jax(loss_inputs, masked, features):
    t = {k: torch.from_numpy(v) for k, v in loss_inputs.items()}
    j = {k: jnp.asarray(v) for k, v in loss_inputs.items()}
    keys = ("logits", "space", "freq") if features else ("logits",)
    got, parts = pl.combined_loss(
        {k: t[k] for k in keys}, t["labels"],
        functools.partial(pl.weighted_bce_with_logits, pos_weight=1.7), 4, 10,
        valid_mask=t["mask"] if masked else None)
    want, jparts = jl.combined_loss(
        {k: j[k] for k in keys}, j["labels"],
        functools.partial(jl.weighted_bce_with_logits, pos_weight=1.7), 4, 10,
        valid_mask=j["mask"] if masked else None)
    _close(got, want, 1e-6, "total", rtol=1e-6)
    for k in ("cls_loss", "orth_loss", "lambda_orth"):
        _close(parts[k], jparts[k], 1e-6, k, rtol=1e-6)
    if masked:     # a mask of n ones == the first n rows alone
        alone, _ = pl.combined_loss(
            {k: t[k][:4] for k in keys}, t["labels"][:4],
            functools.partial(pl.weighted_bce_with_logits, pos_weight=1.7), 4, 10)
        _close(got, alone, 1e-6, "masked vs first rows", rtol=1e-6)


# ------------------------------------------------------------------ metrics


def _scores(kind, g, n=200):
    labels = g.integers(0, 2, n)
    if kind == "ties":
        return labels, np.round(g.random(n), 1)          # 11 distinct scores
    if kind == "binary_ties":
        return labels, g.integers(0, 2, n).astype(np.float64)
    if kind == "single_class_pos":
        return np.ones(n, np.int64), g.random(n)
    if kind == "single_class_neg":
        return np.zeros(n, np.int64), g.random(n)
    if kind == "perfect":
        return labels, 0.3 + 0.4 * labels + 0.2 * g.random(n)
    return labels, np.clip(0.5 + 0.3 * (labels - 0.5) + 0.3 * g.standard_normal(n), 0, 1)


@pytest.mark.filterwarnings("ignore")      # sklearn warns on a single class
@pytest.mark.parametrize("kind", ["ties", "binary_ties", "single_class_pos",
                                  "single_class_neg", "perfect", "noisy"])
def test_metrics_match_sklearn_suite(kind):
    labels, scores = _scores(kind, np.random.default_rng(22))
    got = binary_metrics(labels, scores, loss=0.25)
    want = jax_binary_metrics(labels, scores, loss=0.25)
    assert set(got) == set(want)
    assert got["confusion_matrix"] == want["confusion_matrix"]
    for k in set(want) - {"confusion_matrix"}:
        np.testing.assert_allclose(got[k], want[k], atol=1e-12, rtol=0, err_msg=k)
    if kind.startswith("single_class"):
        assert all(np.isnan(got[k]) for k in ("auc", "eer", "eer_threshold", "ap"))
    if kind == "perfect":
        assert got["auc"] == 1.0 and got["eer"] == 0.0 and got["ap"] == 1.0


# ------------------------------------------------------------------ eval_step

JCFG = JaxConfig.micro()
PCFG = ModelConfig.micro()


@pytest.fixture(scope="module")
def micro_pair():
    jmodel, shapes = init_detector_fast(JCFG, seed=0)
    jvars = _fill(shapes, seed=23)
    port = build_detector(PCFG, device="cpu")
    port.load_state_dict(jax_to_state_dict(jvars, PCFG), strict=True)
    return jmodel, jvars, port


def test_eval_step_matches_jax(micro_pair):
    """dynamic, with two pad rows masked out of both loss terms."""
    jmodel, jvars, port = micro_pair
    g = np.random.default_rng(24)
    x = g.standard_normal((4, 3, 32, 32, 3)).astype(np.float32)
    labels = np.array([1, 0, 1, 0], np.float32)
    valid = np.array([1, 1, 0, 0], np.float32)
    want = jax_eval_step(jvars["params"], jvars["batch_stats"], jnp.asarray(x),
                         jnp.asarray(labels), jnp.asarray(valid), model=jmodel,
                         mode="dynamic", frame_chunk=2)
    got = eval_step(port, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3))),
                    torch.from_numpy(labels), torch.from_numpy(valid), mode="dynamic",
                    frame_chunk=2)
    for k in ("loss", "cls_loss", "orth_loss", "preds"):
        _close(got[k], want[k], 1e-4, k)
    assert float(got["orth_loss"]) > 0


# ------------------------------------------------------------------ load_model


@pytest.fixture(scope="module")
def micro_state():
    return build_detector(PCFG, device="cpu", seed=3).state_dict()


@pytest.mark.parametrize("layout", ["raw", "model_state_dict", "state_dict"])
@pytest.mark.parametrize("prefix", ["", "module."])
def test_load_model_reads_reference_layouts(tmp_path, micro_state, layout, prefix):
    sd = {prefix + k: v for k, v in micro_state.items()}
    path = str(tmp_path / "ckpt.pth")
    torch.save(sd if layout == "raw" else {layout: sd, "epoch": 3}, path)
    model = load_model(path, PCFG, device="cpu")
    assert not model.training
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, micro_state[k], atol=0, rtol=0, msg=k)


def test_load_model_refusals(tmp_path, micro_state, capsys):
    path = str(tmp_path / "ckpt.pt")
    sd = dict(micro_state)
    del sd["sfe_cls.mlp_head.2.weight"]
    torch.save(sd, path)
    with pytest.raises(ValueError, match="absent.*sfe_cls.mlp_head.2.weight"):
        load_model(path, PCFG, device="cpu")

    sd = dict(micro_state, **{"sfe.efficient_net._fc.weight": torch.zeros(2, 3)})
    torch.save(sd, path)
    load_model(path, PCFG, device="cpu")
    assert "Warning" in capsys.readouterr().out

    # num_batches_tracked is optional (the JAX converter neither needs nor makes it)
    torch.save({k: v for k, v in micro_state.items()
                if not k.endswith("num_batches_tracked")}, path)
    load_model(path, PCFG, device="cpu")

    torch.save(micro_state, path)
    with pytest.raises(ValueError, match="dama_dim=32"):
        load_model(path, PCFG.replace(dama_dim=32), device="cpu")
    with pytest.raises(ValueError, match="jax_to_state_dict"):
        load_model(str(tmp_path), PCFG, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_model(path, PCFG)       # the GPU unless the CPU is named


# ------------------------------------------------------------------ evaluate


class PaddedLoader:
    """Batches of 3 with the tail padded, as the JAX ``BatchLoader(pad_last=True)``;
    the number of true rows comes from ``true_len()``."""

    def __init__(self, clips, labels):
        self.clips, self.labels = clips, labels

    def true_len(self):
        return len(self.labels)

    def __iter__(self):
        n = len(self.labels)
        for i in range(0, n, 3):
            c, y = self.clips[i:i + 3], self.labels[i:i + 3]
            if len(y) < 3:
                c = np.concatenate([c, np.zeros((3 - len(y),) + c.shape[1:], c.dtype)])
                y = np.concatenate([y, np.ones(3 - len(y), y.dtype)])
            yield c, y


class DatasetLoader:
    """The same batches; the number of true rows is ``len(loader.dataset)``."""

    def __init__(self, clips, labels):
        self.dataset = list(labels)
        self._padded = PaddedLoader(clips, labels)

    def __iter__(self):
        return iter(self._padded)


@pytest.mark.parametrize("loader", [PaddedLoader, DatasetLoader])
def test_evaluate_keeps_pad_rows_out(micro_pair, loader, capsys):
    jmodel, jvars, port = micro_pair
    g = np.random.default_rng(25)
    clips = g.integers(0, 256, (7, 2, 32, 32, 3), np.uint8)
    labels = np.array([1, 0, 0, 1, 1, 0, 1])
    got = evaluate(port, loader(clips, labels), frame_chunk=2, device="cpu")
    assert len(got["preds"]) == len(got["labels"]) == 7 and got["labels"] == labels.tolist()
    # the JAX evaluate on the same padded loader and the same weights
    ref = jax_evaluate(jmodel, jvars, loader(clips, labels), compute_dtype="float32",
                       frame_chunk=2)
    assert set(got) == set(ref) and got["labels"] == ref["labels"]
    assert got["confusion_matrix"] == ref["confusion_matrix"]
    for k in set(ref) - {"confusion_matrix", "labels"}:
        _close(got[k], ref[k], 1e-4, k)
    # the true rows alone, batch by batch, with eval_step and the metrics
    preds, loss_sum, orth = [], 0.0, []
    for i in range(0, 7, 3):
        x = preprocess_batch(torch.from_numpy(clips[i:i + 3]), torch.float32)
        out = eval_step(port, x, torch.from_numpy(labels[i:i + 3]).float(), frame_chunk=2)
        preds += out["preds"].tolist()
        loss_sum += float(out["loss"]) * len(labels[i:i + 3])
        orth.append(float(out["orth_loss"]))
    want = binary_metrics(labels, preds, loss=loss_sum / 7)
    for k, v in want.items():
        if k == "confusion_matrix":
            assert got[k] == v
        else:
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["orth_losses"], orth, atol=1e-5, rtol=0)
    print_metrics("padded", got)
    assert "auc" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            evaluate(port, loader(clips, labels))     # the GPU unless the CPU is named
