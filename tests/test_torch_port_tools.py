"""The port's measuring and ablation entry points on the CPU, in-process.

- ``utils.metrics.precision_recall_curve`` against sklearn, ties included;
- ``cli.bench``'s policy functions against the root ``bench.py``'s, and its
  stop rule without the north-star margin;
- ``cli.calculate_gflops``: the FLOP count of a micro model equals 2 x the
  multiply-adds of its convolutions, linear layers and attention products,
  computed from the module shapes; a kernel flag is refused;
- ``cli.ablation``'s hand-written ``config.yaml`` against ``yaml.safe_load``;
- the CLIs through ``main(argv)`` at ``--tiny --device cpu`` on small
  synthetic trees (``data/synthetic.py``): test, bench (its chain shortened),
  calculate_gflops, ablation, plot_celebdf_roc, visualize_feature_maps, and
  the train and eval CLIs' ``--visualize``.
"""

import csv
import importlib.util
import os

import numpy as np
import pytest
import torch
import yaml
from sklearn.metrics import precision_recall_curve as sk_precision_recall_curve

from ewvit_tpu_torch import configs as pc
from ewvit_tpu_torch.checkpoint import load_model
from ewvit_tpu_torch.cli import ablation as cli_ablation
from ewvit_tpu_torch.cli import bench as cli_bench
from ewvit_tpu_torch.cli import calculate_gflops as cli_gflops
from ewvit_tpu_torch.cli import eval as cli_eval
from ewvit_tpu_torch.cli import plot_celebdf_roc as cli_roc
from ewvit_tpu_torch.cli import test as cli_test
from ewvit_tpu_torch.cli import train as cli_train
from ewvit_tpu_torch.cli import visualize_feature_maps as cli_fm
from ewvit_tpu_torch.data.synthetic import write_celebdf_tree, write_ff_tree
from ewvit_tpu_torch.data.transforms import cv2_module
from ewvit_tpu_torch.models import detector, layers
from ewvit_tpu_torch.models.detector import ABLATION_MODES, build_detector
from ewvit_tpu_torch.utils.metrics import precision_recall_curve

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--tiny", "--device", "cpu"]
needs_cv2 = pytest.mark.skipif(cv2_module() is None, reason="cv2 writes the frame trees")


def _root_module(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  os.path.join(ROOT_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


# ------------------------------------------------------------------ metrics


@pytest.mark.parametrize("seed", range(4))
def test_precision_recall_curve_matches_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = 40 + 10 * seed
    labels = rng.integers(0, 2, n)
    scores = np.round(rng.random(n), 1)          # ties across both classes
    for got, want in zip(precision_recall_curve(labels, scores),
                         sk_precision_recall_curve(labels, scores)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def test_precision_recall_curve_without_positives_matches_sklearn():
    labels, scores = np.zeros(6, int), np.array([0.1, 0.4, 0.4, 0.2, 0.9, 0.1])
    with pytest.warns(UserWarning):
        want = sk_precision_recall_curve(labels, scores)
    for got, w in zip(precision_recall_curve(labels, scores), want):
        np.testing.assert_allclose(got, w, atol=1e-12, rtol=0)


# ------------------------------------------------------------------ bench policy


def test_bench_policy_equals_root_bench():
    root = _root_module("bench")
    rng = np.random.default_rng(5)
    dn = cli_bench.N_LONG - cli_bench.N_SHORT
    for n in (1, 2, 3, 7):
        shorts = list(0.05 + 0.01 * rng.random(n))
        longs = list(0.30 + 0.05 * rng.random(n))
        slopes = [(lo - s) / dn for s, lo in zip(shorts, longs)]
        assert cli_bench.fast_spread(slopes) == root.fast_spread(slopes)
        assert cli_bench.headline_estimate(shorts, longs, slopes, dn) == \
            root.headline_estimate(shorts, longs, slopes, dn)
    # a deflated long chain takes the median fallback on both
    shorts, longs = [0.05] * 5, [0.30, 0.10, 0.30, 0.31, 0.30]
    slopes = [(lo - s) / dn for s, lo in zip(shorts, longs)]
    got = cli_bench.headline_estimate(shorts, longs, slopes, dn)
    assert got == root.headline_estimate(shorts, longs, slopes, dn)
    assert got[1] == "median (min deflated)"
    assert (cli_bench.BATCH, cli_bench.FRAMES, cli_bench.FRAME_CHUNK, cli_bench.N_SHORT,
            cli_bench.N_LONG, cli_bench.INIT_PAIRS, cli_bench.MAX_PAIRS,
            cli_bench.SPREAD_TARGET) == (root.BATCH, root.FRAMES, root.FRAME_CHUNK,
                                          root.N_SHORT, root.N_LONG, root.INIT_PAIRS,
                                          root.MAX_PAIRS, root.SPREAD_TARGET)


@pytest.mark.parametrize("attempts,slopes,more", [
    (0, [], True),                                    # below INIT_PAIRS
    (7, [1.0, 1.0, 1.0], True),                       # below INIT_PAIRS, even if settled
    (8, [1.0, 1.01, 1.02], False),                    # spread 2% < 4%: stop
    (8, [1.0, 1.05, 1.10], True),                     # spread 10%: more
    (8, [1.0], True),                                 # one valid pair: spread unknown
    (8, [1.0, 1.04], True),                           # exactly the target: more
    (31, [1.0, 1.5], True),
    (32, [1.0, 1.5], False),                          # MAX_PAIRS
    (40, [], False),
])
def test_bench_stop_rule(attempts, slopes, more):
    """At least INIT_PAIRS, then until the spread is below SPREAD_TARGET or
    MAX_PAIRS; no north-star margin (a TPU target) enters."""
    assert cli_bench.should_collect_more(attempts, slopes) is more


def test_bench_stop_rule_takes_the_callers_pair_counts():
    assert cli_bench.should_collect_more(1, [1.0, 1.5], init_pairs=2, max_pairs=3)
    assert cli_bench.should_collect_more(2, [1.0, 1.5], init_pairs=2, max_pairs=3)
    assert not cli_bench.should_collect_more(3, [1.0, 1.5], init_pairs=2, max_pairs=3)


class _Clock:
    """A ``perf_counter`` that moves only by ``step`` seconds per eval
    ``video_forward``: the serial chains then time exactly ``step`` a call,
    whatever else runs on the machine."""

    def __init__(self, monkeypatch, step=0.01):
        self.t = 0.0
        forward = detector.video_forward

        def timed(*a, **kw):
            self.t += step
            return forward(*a, **kw)

        monkeypatch.setattr(detector, "video_forward", timed)
        monkeypatch.setattr(cli_test, "time", self)

    def perf_counter(self):
        return self.t


def test_bench_main_prints_the_jax_keys(monkeypatch, capsys):
    """The bench at --tiny on the CPU, its chains shortened and timed by
    :class:`_Clock`: one JSON line with the JAX bench's keys, no north star,
    the frames per second of 10 ms a call, and zero spread, so it stops at
    INIT_PAIRS."""
    _Clock(monkeypatch)
    monkeypatch.setattr(cli_bench, "BATCH", 1)
    monkeypatch.setattr(cli_bench, "FRAMES", 2)
    monkeypatch.setattr(cli_bench, "FRAME_CHUNK", 2)
    monkeypatch.setattr(cli_bench, "N_LONG", 3)
    monkeypatch.setattr(cli_bench, "INIT_PAIRS", 2)
    monkeypatch.setattr(cli_bench, "MAX_PAIRS", 4)
    assert cli_bench.main(CPU + ["--mode", "sfe_mwt"]) == 0
    import json

    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tuple(line) == cli_bench.KEYS
    assert line["mode"] == "sfe_mwt" and line["vs_baseline"] is None \
        and line["verdict"] is None and line["unit"] == "frames/sec"
    assert line["value"] == pytest.approx(1 * 2 / 0.01)
    assert line["pairs"] == 2 and line["spread_pct"] == 0.0
    assert line["estimator"] == "min-of-minima"


# ------------------------------------------------------------------ GFLOPs


def _analytic_flops(model, x, mode, chunk):
    """2 x multiply-adds of every Conv2d and Linear (output size x weight
    fan-in), of the MWT's grouped hf_sep conv (the input of hf_fusion x the
    hf_sep fan-in), and of the two attention products (q k^T and attn v:
    tokens x keys x inner each), from shapes seen by forward hooks."""
    macs, handles = [0], []

    def mod_hook(m, inp, out):
        fan_in = m.weight[0].numel() if isinstance(m, torch.nn.Conv2d) else m.in_features
        macs[0] += out.numel() * fan_in

    def fusion_hook(mwt):
        def hook(m, inp):
            macs[0] += inp[0].numel() * mwt.hf_conv["seperate"][0][0].weight[0].numel()
        return hook

    def attn_hook(m, args, kwargs, out):
        x = args[0]
        context = args[1] if len(args) > 1 else kwargs.get("context")
        keys = x.shape[1] if context is None else context.shape[1]
        if kwargs.get("kv_include_self") and context is not None:
            keys += x.shape[1]
        inner = m.to_q.out_features if isinstance(m, layers.CrossAttention) \
            else m.to_qkv.out_features // 3
        macs[0] += 2 * x.shape[0] * x.shape[1] * keys * inner

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            handles.append(m.register_forward_hook(mod_hook))
        elif isinstance(m, (layers.Attention, layers.CrossAttention)):
            handles.append(m.register_forward_hook(attn_hook, with_kwargs=True))
        elif hasattr(m, "hf_conv"):
            handles.append(m.hf_conv["fusion"].register_forward_pre_hook(fusion_hook(m)))
    try:
        from ewvit_tpu_torch.models.detector import video_forward

        video_forward(model, x, mode=mode, frame_chunk=chunk)
    finally:
        for h in handles:
            h.remove()
    return 2 * macs[0]


@pytest.mark.parametrize("mode", ABLATION_MODES)
def test_flop_count_equals_analytic(mode):
    cfg = pc.ModelConfig.micro()
    model = build_detector(cfg, device="cpu", seed=0)
    flops, nbytes = cli_gflops.count(model, cfg, mode, batch=2, frames=3, frame_chunk=2)
    x = torch.zeros(2, 3, 3, 32, 32)
    assert flops == _analytic_flops(model, x, mode, 2) > 0
    # every op reads and writes at least the fp32 clip of each chunk
    assert nbytes > 2 * 2 * 3 * 32 * 32 * 4


@pytest.mark.parametrize("flag", cli_gflops.KERNEL_FLAGS)
def test_flop_count_refuses_kernel_flags(flag):
    cfg = pc.ModelConfig.micro().replace(**{flag: True})
    model = build_detector(cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="cannot see the CUDA kernels"):
        cli_gflops.count(model, cfg, "dynamic", frames=2, frame_chunk=2)


def test_gflops_cli_all_modes(capsys):
    out = cli_gflops.main(CPU + ["--frame-count", "2", "--frame-chunk", "2"])
    text = capsys.readouterr().out
    assert "Parameters:" in text and "GFLOPs" in text and "unfused upper bound" in text
    for mode in ABLATION_MODES:
        assert mode in text and out[mode]["flops"] > 0 and out[mode]["bytes"] > 0
    assert out["dynamic"]["flops"] > out["sfe_mwt"]["flops"] > out["sfe_only"]["flops"]


# ------------------------------------------------------------------ latency


def test_latency_cli_lines(monkeypatch, capsys):
    _Clock(monkeypatch)
    r = cli_test.main(CPU + ["--frame-count", "4", "--frame-chunk", "4", "--runs", "4",
                             "--warmup", "1", "--mode", "sfe_only"])
    text = capsys.readouterr().out
    for line in ("Parameters:", "Average inference time:", "Throughput:"):
        assert line in text
    # first call, one chain of 1, warmup 2, and 2 chains each of 2 and 4
    assert r["calls"] == 1 + 1 + 2 + 2 * 2 + 2 * 4 and r["chain_calls"] == 12
    assert r["per_call_ms"] == pytest.approx(10.0) and r["frames_per_s"] == pytest.approx(400)
    assert not any(r["chain_launches"].values())     # CPU tensors launch nothing


# ------------------------------------------------------------------ ablation config


def test_config_yaml_reads_back():
    cfg = {"root": 'a "quoted": path/x', "batch_size": 8, "epochs": 30, "lr": 1e-05,
           "small": 2.5e-10, "big": 1e20, "dim": 128, "frame_count": 300, "seed": 42,
           "modes": cli_ablation.MODES}
    assert yaml.safe_load(cli_ablation.yaml_text(cfg)) == cfg


# ------------------------------------------------------------------ the CLIs on trees


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """An FF++ tree, a Celeb-DF tree of 2 real and 2 fake videos, and a
    tiny detector's weights as a .pth."""
    tmp = tmp_path_factory.mktemp("tools")
    ff, cdf = str(tmp / "ff"), str(tmp / "cdf")
    write_ff_tree(ff, pairs=dict(train=1, val=1, test=1), frames=3, height=40, width=48,
                  seed=9)
    write_celebdf_tree(cdf, videos=2, frames=3)
    pth = str(tmp / "tiny.pth")
    torch.save({"model_state_dict": build_detector(pc.ModelConfig.tiny(), device="cpu",
                                                   seed=3).state_dict()}, pth)
    return ff, cdf, pth


LOADER = ["--batch-size", "2", "--frame-count", "2", "--num-workers", "0"]


@needs_cv2
def test_ablation_cli(trees, tmp_path):
    ff, _, _ = trees
    results, out_dir = cli_ablation.main(CPU + LOADER + ["--root", ff, "--output",
                                                          str(tmp_path), "--epochs", "1"])
    assert os.path.dirname(out_dir) == str(tmp_path) and list(results) == cli_ablation.MODES
    with open(os.path.join(out_dir, "metrics_comparison.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["mode"] for r in rows] == cli_ablation.MODES
    for r in rows:
        assert 0.0 <= float(r["accuracy"]) <= 1.0 and 0.0 <= float(r["f1"]) <= 1.0
    for name in ("learning_curves.png", "roc_curves.png"):
        assert os.path.getsize(os.path.join(out_dir, name)) > 0
    with open(os.path.join(out_dir, "config.yaml")) as f:
        assert yaml.safe_load(f) == {"root": ff, "batch_size": 2, "epochs": 1, "lr": 1e-4,
                                     "dim": 128, "frame_count": 2, "seed": 42,
                                     "modes": cli_ablation.MODES}
    for mode in cli_ablation.MODES:
        model = load_model(os.path.join(out_dir, f"{mode}_model", "best_model.pth"),
                           pc.ModelConfig.tiny(), device="cpu")
        assert model.cfg.arch.image_size == 64


@needs_cv2
@pytest.mark.parametrize("per_frame", [False, True])
def test_celebdf_roc_cli(trees, tmp_path, capsys, per_frame):
    _, cdf, pth = trees
    base = tmp_path / "xception.csv"
    base.write_text("label,score\n1,0.9\n0,0.2\n1,0.4\n0,0.6\n")
    curves = cli_roc.main(CPU + LOADER + ["--root", cdf, "--model-paths", f"tiny={pth}",
                                          "--test-list", "List_of_testing_videos.txt",
                                          "--output", str(tmp_path),
                                          "--baseline-scores", f"xception={base}"]
                          + (["--per-frame"] if per_frame else []))
    assert [c[0] for c in curves] == ["tiny", "xception"]
    labels, scores = curves[0][1], curves[0][2]
    assert len(scores) == (8 if per_frame else 4)       # 4 videos x 2 frames
    assert sorted(labels) == [0] * (len(labels) // 2) + [1] * (len(labels) // 2)
    text = capsys.readouterr().out
    assert ("4 videos x 2 frames = 8 per-frame scores" in text) == per_frame
    assert os.path.getsize(tmp_path / "celebdf_roc_comparison.png") > 0


@needs_cv2
def test_feature_map_cli(trees, tmp_path):
    ff, _, pth = trees
    img = os.path.join(ff, "faceforensics", "ff++", "frames", "original", "000", "0000.png")
    maps = cli_fm.main(CPU + ["--image", img, "--output", str(tmp_path), "--model-path", pth])
    for f in ("backbone_stem.png", "mwt_hf_level0.png", "gate_weights.txt",
              "cross_attention.png"):
        assert os.path.getsize(tmp_path / f) > 0, f
    cfg = pc.ModelConfig.tiny()
    assert maps["stem"].shape == (24, 32, 32)
    assert maps["hf_level0"].shape == (cfg.dama_dim, 32, 32)
    assert maps["attention"].shape == (4, cfg.num_heads, 1, 2)
    np.testing.assert_allclose(maps["gate_weights"].sum(), 1.0, atol=1e-6)
    np.testing.assert_allclose(maps["attention"].sum(-1), 1.0, atol=1e-6)


EVAL_PLOTS = ["confusion_matrix.png", "roc_curve.png", "pr_curve.png",
              "pred_distribution.png", "orth_vs_pred.png"]


@needs_cv2
def test_eval_cli_visualize(trees, tmp_path):
    ff, _, pth = trees
    cli_eval.main(CPU + LOADER + ["--root", ff, "--model-path", pth, "--output",
                                  str(tmp_path), "--visualize"])
    for name in ["all_methods"] + cli_eval.FF_METHODS:
        for p in EVAL_PLOTS:
            assert os.path.getsize(tmp_path / "visualizations" / name / p) > 0, (name, p)


@needs_cv2
def test_train_cli_visualize(trees, tmp_path):
    ff, _, _ = trees
    result = cli_train.main(CPU + LOADER + ["--root", ff, "--output", str(tmp_path),
                                            "--epochs", "1", "--accum-steps", "1",
                                            "--visualize"])
    for name in ("loss_curves.png", "metric_curves.png", "lr_schedule.png", "dashboard.png"):
        assert os.path.getsize(tmp_path / name) > 0, name
    with open(tmp_path / "training_history.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and rows[0]["epoch"] == "1"
    assert float(rows[0]["train_loss"]) == pytest.approx(result["history"][0]["train"]["loss"])
