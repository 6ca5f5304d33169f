"""Data parallelism over ``torch.distributed`` (``ewvit_tpu_torch.parallel``)
on the CPU over gloo, held against the world-of-one port and the JAX package.

Two spawned worlds, each started once for the module, run every scenario
once and hand their results back through files: a world of 2 for training
(``data`` 2, then ``frames`` 2: a train step and a ``Trainer.fit`` epoch) and
a world of 4 for serving and evaluation (meshes ``data`` 4; ``data`` 2 x
``frames`` 2; ``dcn`` 2 x ``frames`` 2), which also trains a step on the two
meshes with a frames axis. Training on a frames axis meets a ragged tail
chunk of one frame, so one rank of each frames group holds no row of it.
Each rank runs one torch thread. The module imports torch, numpy and the port only, so
the spawned ranks import no JAX; the JAX references are built in the parent
(their imports inside the fixtures), compiling while the worlds run.

Tolerances are ``tests/test_sharded_exactness.py``'s for the train step
(loss rtol 1e-5; preds rtol 1e-4, atol 1e-6; per tensor a relative-L2 bound
of 1e-2 on the SGD update and the three elementwise tiers 3e-2 / 1e-2 /
5e-4 of the tensor's max for BN-fed convs, BN parameters and the rest, a
zero-update tensor pinned below 1e-7; BN running statistics rtol 1e-4, atol
1e-5), ``tests/test_serving.py``'s atol 1e-5 for served probabilities, and
``tests/test_train_stack.py``'s for evaluation (labels equal, preds rtol
1e-5, atol 1e-6). The train step against JAX runs with dropout and
stochastic depth neutralised on both sides (as ``test_torch_port_train.py``
does: JAX's masks come from its own generator); with dropout on, the world
of 2 and every frames mesh are held to the world-of-one port, and with it
off, to JAX as well.
"""

import datetime
import multiprocessing
import os
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ewvit_tpu_torch import configs as pc
from ewvit_tpu_torch.data.pipeline import BatchLoader
from ewvit_tpu_torch.evaluation import evaluate
from ewvit_tpu_torch.models.detector import build_detector
from ewvit_tpu_torch.models.norm import BatchNorm2d, synced_batch_stats
from ewvit_tpu_torch.parallel import make_layout, make_mesh
from ewvit_tpu_torch.serving import InferenceEngine
from ewvit_tpu_torch.train.loop import Trainer
from ewvit_tpu_torch.train.steps import train_step

SE_S1 = dict(repeats=1, kernel=3, stride=1, expand=2, in_ch=16, out_ch=16, se_ratio=0.25)
PCFG = pc.ModelConfig.micro().replace(   # test_torch_port_train.py's PCFG
    backbone_spec=(pc.B0_MICRO, pc.BackboneSpec(
        pc.V2S_MICRO.blocks + (pc.BlockCfg(**SE_S1),), stem_ch=8, head_ch=32)),
    dama_dim=128, num_heads=4, use_pallas_dwse=True, use_pallas_dama=True,
    use_pallas_dwt=True, use_fused_mwt_tail=True)
TRAIN = dict(frame_chunk=2, accum_steps=2, pos_weight=1.3, epoch=1, max_epochs=2, seed=7)
B, K, LR = 2, 5, 0.1            # micro-batch of 2 clips of 5 frames: chunks 2, 2, 1
SERVE_CHUNK = 4
MESHES = {"data4": dict(data=4, frames=1, dcn=1), "data2_frames2": dict(data=2, frames=2, dcn=1),
          "dcn2_frames2": dict(data=1, frames=2, dcn=2)}
FIT_CFG = pc.ModelConfig.micro().replace(use_pallas_dwt=True, use_pallas_dwse=True,
                                         use_pallas_dama=True, use_fused_mwt_tail=True)
FIT_TCFG = pc.TrainConfig(batch_size=2, epochs=1, lr=1e-5, accum_steps=2, seed=5)
LARGE_MEAN = 3000.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the suite's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clips:
    """In-memory map-style dataset of seeded uint8 clips, labels alternating,
    counting ``mark_used`` calls."""

    def __init__(self, n, seed, frames=3, size=32):
        g = np.random.default_rng(seed)
        self.clips = g.integers(0, 256, (n, frames, size, size, 3), dtype=np.uint8)
        self.labels = [i % 2 for i in range(n)]

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.clips[i], self.labels[i]


def _train_data():
    g = np.random.default_rng(2)
    x = g.standard_normal((TRAIN["accum_steps"] * B, K, 32, 32, 3)).astype(np.float32)
    labels = np.array([1.0, 0.0, 0.0, 1.0], np.float32)
    return x, labels


def _clips(n, k, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, k, 32, 32, 3), np.uint8)


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
        if hasattr(m, "drop_rate"):
            m.drop_rate = 0.0
    return model


def _port(sd, dropout=True):
    model = build_detector(PCFG, device="cpu", seed=0)
    model.load_state_dict(sd, strict=True)
    return model if dropout else _no_dropout(model)


def _step(model, mesh=None):
    """One SGD step on the global batch (this rank's rows with a mesh):
    the loss, the preds, and the state after."""
    x, labels = _train_data()
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3)))
    lt = torch.from_numpy(labels)
    if mesh is not None:
        xt, lt = (mesh.shard(t, groups=TRAIN["accum_steps"]) for t in (xt, lt))
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    out = train_step(model, opt, xt, lt, mode="dynamic", mesh=mesh, **TRAIN)
    return {"loss": float(out["loss"]), "preds": out["preds"].numpy(),
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


# ----------------------------------------------------------------- the ranks


def _large_mean_bn(mesh):
    """A synced train-mode BN on this rank's rows of activations whose mean
    is far above their spread; the input gradient of this rank's rows and
    the parameter gradients summed over the ranks."""
    g = np.random.default_rng(11)
    x = torch.from_numpy((LARGE_MEAN + g.standard_normal((4, 3, 5, 5))).astype(np.float32))
    w = torch.from_numpy(g.standard_normal((4, 3, 5, 5)).astype(np.float32))
    rows = mesh.local_rows(4)
    bn = BatchNorm2d(3, eps=1e-5, momentum=0.1).train()
    xl = x[rows].clone().requires_grad_(True)
    with synced_batch_stats(mesh.batch_group):
        y = bn(xl)
    (y * w[rows]).sum().backward()
    grads = torch.cat([bn.weight.grad, bn.bias.grad])
    mesh.all_reduce_(grads)
    return {"y": y.detach(), "x_grad": xl.grad, "param_grads": grads,
            "running": torch.stack([bn.running_mean, bn.running_var])}


def _train_world(rank, tmp):
    sd = torch.load(os.path.join(tmp, "weights.pt"), weights_only=True)
    mesh = make_mesh(data=2, device="cpu")
    out = {"layout": (mesh.shape, mesh.batch_index, mesh.batch_shard)}
    out["dropout"] = _step(_port(sd, dropout=True), mesh)
    out["no_dropout"] = _step(_port(sd, dropout=False), mesh)
    out["bn"] = _large_mean_bn(mesh)
    ckpt = os.path.join(tmp, "fit")
    train = BatchLoader(Clips(8, 1), 2, drop_last=True, num_workers=0, shard=mesh.batch_shard)
    val = BatchLoader(Clips(5, 3), 2, pad_last=True, num_workers=0, shard=mesh.batch_shard)
    trainer = Trainer(FIT_CFG, FIT_TCFG, device="cpu", log=lambda s: None, steps_per_epoch=2,
                      checkpoint_dir=ckpt, mesh=mesh)
    out["fit"] = trainer.fit(train, val)
    out["fit_state"] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    out["fit_files"] = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    mesh.close()
    mesh = make_mesh(data=1, frames=2, device="cpu")
    out["frames2"] = _step(_port(sd, dropout=True), mesh)
    out["frames2_no_dropout"] = _step(_port(sd, dropout=False), mesh)
    ckpt = os.path.join(tmp, "fit_frames2")
    train = BatchLoader(Clips(8, 1), 2, drop_last=True, num_workers=0, shard=mesh.batch_shard)
    val = BatchLoader(Clips(5, 3), 2, pad_last=True, num_workers=0, shard=mesh.batch_shard)
    trainer = Trainer(FIT_CFG, FIT_TCFG, device="cpu", log=lambda s: None, steps_per_epoch=2,
                      checkpoint_dir=ckpt, mesh=mesh)
    out["fit_frames2"] = trainer.fit(train, val)
    out["fit_frames2_state"] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    out["fit_frames2_files"] = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    mesh.close()
    return out


def _serve_world(rank, tmp):
    sd = torch.load(os.path.join(tmp, "weights.pt"), weights_only=True)
    out = {}
    c4, c6 = _clips(3, 4), _clips(3, 6, seed=4)
    for name, shape in MESHES.items():
        mesh = make_mesh(device="cpu", **shape)
        axis = shape["frames"] > 1
        engine = InferenceEngine(_port(sd), frame_chunk=SERVE_CHUNK, device="cpu", mesh=mesh,
                                 frame_axis=axis)
        res = {"k4": engine.predict(c4), "k6": engine.predict(c6),
               "stream": list(engine.predict_stream(iter([c6, c6[:2]])))}
        if axis:
            try:
                engine.predict(_clips(2, 3))
                res["undivisible"] = None
            except ValueError as e:
                res["undivisible"] = str(e)
        if axis:
            res["train"] = _step(_port(sd, dropout=True), mesh)
            res["train_no_dropout"] = _step(_port(sd, dropout=False), mesh)
        if name == "data4":
            res["eval"] = evaluate(_port(sd), BatchLoader(Clips(10, 6, frames=4), 4,
                                                          pad_last=True, num_workers=0,
                                                          shard=mesh.batch_shard),
                                   frame_chunk=SERVE_CHUNK, device="cpu", mesh=mesh)
        out[name] = res
        mesh.close()
    return out


def _rank(rank, world, tmp, fn):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    try:
        result = {"_train": _train_world, "_serve": _serve_world}[fn](rank, tmp)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


class World:
    """``world`` spawned ranks running ``fn``; :meth:`results` waits."""

    def __init__(self, world, fn, tmp):
        self.tmp, self.world = str(tmp), world
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_rank, args=(r, world, self.tmp, fn))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self._results = None

    def results(self):
        if self._results is None:
            for p in self.procs:
                p.join(timeout=600)
            for p in self.procs:
                if p.is_alive():
                    p.kill()
            errors = [open(os.path.join(self.tmp, f)).read()
                      for f in sorted(os.listdir(self.tmp)) if f.endswith(".err")]
            codes = [p.exitcode for p in self.procs]
            assert not errors and codes == [0] * self.world, (codes, "\n".join(errors))
            self._results = [torch.load(os.path.join(self.tmp, f"rank{r}.pt"),
                                        weights_only=False) for r in range(self.world)]
        return self._results


# ----------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX model and variables (test_torch_port_train.py's config and
    seeded fill), and the port's state dict of them."""
    from ewvit_tpu.models.detector import init_detector_fast
    from ewvit_tpu_torch.utils.convert import jax_to_state_dict
    from test_torch_port_model import _fill
    from test_torch_port_train import JCFG

    jmodel, shapes = init_detector_fast(JCFG, seed=0)
    jvars = _fill(shapes, seed=1)
    return jmodel, jvars, jax_to_state_dict(jvars, PCFG)


@pytest.fixture(scope="module")
def worlds(jax_side, tmp_path_factory):
    """Both spawned worlds, started together on the same weights."""
    out = {}
    for name, world, fn in (("train", 2, "_train"), ("serve", 4, "_serve")):
        tmp = tmp_path_factory.mktemp(f"world_{name}")
        torch.save(jax_side[2], tmp / "weights.pt")
        out[name] = World(world, fn, tmp)
    yield out
    for w in out.values():
        for p in w.procs:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def jax_step(jax_side):
    """JAX's single-device ``train_step`` with ``optax.sgd(LR)`` on the same
    batch, dropout and stochastic depth patched out while it traces, compiled
    in a thread while the worlds run."""
    import concurrent.futures

    import flax.linen as fnn
    import jax
    import optax

    from ewvit_tpu.models import efficientnet as je
    from ewvit_tpu.train.steps import create_train_state
    from ewvit_tpu.train.steps import train_step as jax_train_step
    from test_torch_port_train import _start

    jmodel, jvars, _ = jax_side
    x, labels = _train_data()
    tx = optax.sgd(LR)
    state, _ = create_train_state(jvars, tx)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fnn.Dropout, "__call__", lambda self, y, *a, **kw: y)
            mp.setattr(je, "_stochastic_depth", lambda y, rate, det, rng: y)
            kw = {k: TRAIN[k] for k in ("frame_chunk", "accum_steps", "pos_weight", "epoch",
                                        "max_epochs")}
            pending = _start(pool, jax_train_step, state, x, labels, jax.random.PRNGKey(0),
                             model=jmodel, tx=tx, mode="dynamic", remat=False,
                             static=("model", "tx", "mode", "frame_chunk", "accum_steps",
                                     "remat"), **kw)
        yield pending, state


@pytest.fixture(scope="module")
def jax_stepped(jax_step):
    """JAX's step run once: its loss, preds and updated state as the port's
    state dict."""
    from ewvit_tpu_torch.utils.convert import jax_to_state_dict

    pending, _ = jax_step
    new, metrics = pending.result()()
    want = jax_to_state_dict({"params": _np_tree(new.params),
                              "batch_stats": _np_tree(new.batch_stats)}, PCFG)
    return float(metrics["loss"]), np.asarray(metrics["preds"]), want


@pytest.fixture(scope="module")
def jax_serve(jax_side):
    from ewvit_tpu.serving import InferenceEngine as JaxEngine

    jmodel, jvars, _ = jax_side
    engine = JaxEngine(jmodel, jvars, frame_chunk=SERVE_CHUNK)
    return {"k4": engine.predict(_clips(3, 4)), "k6": engine.predict(_clips(3, 6, seed=4))}


@pytest.fixture(scope="module")
def world_of_one(jax_side, worlds, jax_step):
    """The unsplit port (no mesh) on the same inputs, run while the worlds
    run."""
    sd = jax_side[2]
    engine = InferenceEngine(_port(sd), frame_chunk=SERVE_CHUNK, device="cpu")
    c6 = _clips(3, 6, seed=4)
    out = {"k4": engine.predict(_clips(3, 4)), "k6": engine.predict(c6),
           "k6_first2": engine.predict(c6[:2]),
           "dropout": _step(_port(sd, dropout=True)),
           "no_dropout": _step(_port(sd, dropout=False)),
           "eval": evaluate(_port(sd), BatchLoader(Clips(10, 6, frames=4), 4, pad_last=True,
                                                   num_workers=0),
                            frame_chunk=SERVE_CHUNK, device="cpu")}
    return out


@pytest.fixture(scope="module")
def fit_one(worlds, tmp_path_factory):
    """``Trainer.fit`` for one epoch without a mesh, on the loaders the
    world of 2 shards."""
    ckpt = str(tmp_path_factory.mktemp("fit_one"))
    train = BatchLoader(Clips(8, 1), 2, drop_last=True, num_workers=0)
    val = BatchLoader(Clips(5, 3), 2, pad_last=True, num_workers=0)
    trainer = Trainer(FIT_CFG, FIT_TCFG, device="cpu", log=lambda s: None, steps_per_epoch=2,
                      checkpoint_dir=ckpt)
    return trainer.fit(train, val), ckpt


# ----------------------------------------------------------------- comparisons


def _tiers(model):
    """Per parameter name, the elementwise tier of test_sharded_exactness.py:
    3e-2 for a conv beside a BN (its parent module holds a BN), 1e-2 for a
    BN's parameters, else 5e-4."""
    tiers = {}
    for prefix, mod in model.named_modules():
        has_bn = any(isinstance(c, nn.BatchNorm2d) for c in mod.children())
        for name, child in mod.named_children():
            full = f"{prefix}.{name}" if prefix else name
            for pname, _ in child.named_parameters(recurse=False):
                if isinstance(child, nn.BatchNorm2d):
                    tiers[f"{full}.{pname}"] = 1e-2
                elif isinstance(child, nn.Conv2d) and has_bn:
                    tiers[f"{full}.{pname}"] = 3e-2
    return {n: tiers.get(n, 5e-4) for n, _ in model.named_parameters()}


def _check_updates(start, ref, got, tiers, what, floor=None):
    """test_sharded_exactness.py's comparison of SGD updates, tensor by
    tensor; running statistics at rtol 1e-4, atol 1e-5. ``floor``: per
    tensor, an elementwise error allowed whatever the tier."""
    bad = []
    for name, atol in tiers.items():
        ref_d = (ref[name] - start[name]).double().numpy()
        got_d = (got[name] - start[name]).double().numpy()
        scale = np.abs(ref_d).max()
        if floor is not None:
            atol = max(atol, floor[name] / max(scale, 1e-30))
        if scale < 1e-7:
            if np.abs(got_d).max() >= 1e-7:
                bad.append(f"{name}: zero-update tensor moved {np.abs(got_d).max():.3e}")
            continue
        rel = np.linalg.norm(got_d - ref_d) / max(np.linalg.norm(ref_d), 1e-12)
        err = np.abs(got_d - ref_d).max()
        if rel >= 1e-2 or err > atol * scale + 5e-8:
            bad.append(f"{name}: relL2 {rel:.3e}, err {err:.3e} > {atol:.0e} of {scale:.3e}")
    for name in ref:
        if name.endswith(("running_mean", "running_var")):
            if not np.allclose(got[name].numpy(), ref[name].numpy(), rtol=1e-4, atol=1e-5):
                bad.append(f"{name}: running statistics")
    assert not bad, f"{what}:\n" + "\n".join(bad)


def test_layouts_and_groups_without_processes():
    lay = make_layout(8, frames=2, dcn=2)
    assert lay.shape == {"dcn": 2, "data": 2, "frames": 2} and lay.batch == 4
    assert [lay.coords(r) for r in (0, 1, 2, 5, 7)] == [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 1), (1, 1, 1)]
    assert lay.batch_groups() == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert lay.frame_groups() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert [lay.batch_index(r) for r in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    want = np.arange(8).reshape(2, 2, 2)          # JAX's row-major device grid
    for r in range(8):
        assert want[lay.coords(r)] == r
        assert lay.batch_members(r) == sorted(want[:, :, lay.coords(r)[2]].reshape(-1))
        assert lay.frame_members(r) == list(want[lay.coords(r)[:2]])
    assert make_layout(8, local_world=4).shape == {"dcn": 2, "data": 4, "frames": 1}
    assert make_layout(4).shape == {"dcn": 1, "data": 4, "frames": 1}
    for kw in (dict(data=3), dict(frames=3), dict(dcn=3), dict(data=2, frames=2, dcn=1)):
        with pytest.raises(ValueError):
            make_layout(8, **kw)


def test_mesh_refusals_without_processes():
    """What a mesh refuses before any collective (a batch that does not split
    over the batch ranks), and the rank arithmetic of training on a frames
    axis: each rank's contiguous share of a chunk, none of a tail chunk
    shorter than the axis, and the global rows of the share."""
    from ewvit_tpu_torch.models.detector import _frames_split
    from ewvit_tpu_torch.parallel import Mesh

    mesh = Mesh(make_layout(4, data=2, frames=2), rank=3, device=torch.device("cpu"),
                batch_group=None, frames_group=None)
    assert (mesh.batch_index, mesh.frame_index, mesh.batch_shard) == (1, 1, (1, 2))
    assert mesh.local_rows(6) == slice(3, 6)
    with pytest.raises(ValueError, match="does not split"):
        mesh.local_rows(3)
    lay = make_layout(6, data=2, frames=3)
    assert [lay.frame_share(5, f) for f in range(3)] == [(0, 2), (2, 4), (4, 5)]
    assert [lay.frame_share(2, f) for f in range(3)] == [(0, 1), (1, 2), (2, 2)]
    assert mesh.world_size == 4 and mesh.frame_share(2) == (1, 2) and mesh.frame_share(1) == (1, 1)
    # rank 3 holds clips 2 and 3 of a micro-batch of 4: frame 1 of a 2-frame
    # chunk is global rows 2*2+1 and 3*2+1; a 1-frame tail chunk, no row
    split = _frames_split(mesh, 2, 2, 1, 1, torch.device("cpu"))
    assert split.index.tolist() == [5, 7] and split.total == 8
    split = _frames_split(mesh, 2, 1, 1, 0, torch.device("cpu"))
    assert split.index.numel() == 0 and split.total == 4


def test_every_batchnorm_is_the_synced_one():
    """Every BN of every mode (the backbones', the MWT's hf_sep and tail, the
    DAMA fusion gate's) is ``models/norm.BatchNorm2d``, which syncs."""
    model = build_detector(PCFG, device="cpu", seed=0)
    bns = [n for n, m in model.named_modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    assert bns and all(type(model.get_submodule(n)) is BatchNorm2d for n in bns)
    assert "dama.fusion_gate.1" in bns and "dama.mwt.hf_conv.seperate.2.1" in bns


def test_world_of_one_mesh_and_teardown():
    """Without torchrun's environment ``make_mesh`` forms a world of one
    through a FileStore, its collectives are the identity, and ``close``
    tears it down so that another can form."""
    for _ in range(2):
        mesh = make_mesh(device="cpu")
        assert mesh.shape == {"dcn": 1, "data": 1, "frames": 1} and mesh.rank == 0
        t = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(mesh.gather(mesh.shard(t)), t)
        with pytest.raises(ValueError):
            make_mesh(data=2, device="cpu")       # the world holds one rank
        mesh.close()
        assert not dist.is_initialized()


def test_sharded_loader_rows_equal_the_unsharded_batches(tmp_path):
    """Shuffle, drop_last, pad_last (a tail that holds no row of rank 1), a
    curriculum refresh between two epochs of FF++ train, and the usage
    counts the refresh reads: every rank's, as the unsharded loader's."""
    from ewvit_tpu_torch.data.datasets import FaceForensicsDataset
    from ewvit_tpu_torch.data.synthetic import write_ff_tree
    from ewvit_tpu_torch.data.transforms import FrameTransform, cv2_module

    def check(make, epochs, count, refresh=None):
        ref = make(None)
        shards = [make((i, count)) for i in range(count)]
        for epoch in range(epochs):
            for loader in (ref, *shards):
                if refresh is not None:
                    refresh(loader.dataset, epoch)
            want = list(ref)
            got = [list(s) for s in shards]
            assert len(ref) == len(shards[0]) and all(len(g) == len(want) for g in got)
            for i, (frames, labels) in enumerate(want):
                np.testing.assert_array_equal(np.concatenate([g[i][0] for g in got]), frames)
                np.testing.assert_array_equal(np.concatenate([g[i][1] for g in got]), labels)
            assert all(s.true_len() == ref.true_len() for s in shards)
        return ref, shards

    check(lambda s: BatchLoader(Clips(5, 0), 4, pad_last=True, num_workers=0, shard=s), 1, 2)
    check(lambda s: BatchLoader(Clips(11, 0), 6, shuffle=True, drop_last=True, num_workers=2,
                                seed=3, shard=s), 2, 3)
    if cv2_module() is not None:
        write_ff_tree(str(tmp_path), pairs=dict(train=6, val=2, test=1), frames=2,
                      height=20, width=24, seed=1)
        tf = FrameTransform(resize=20, crop=16)

        def make(s):
            ds = FaceForensicsDataset(str(tmp_path), split="train", frame_count=2,
                                      transform=tf, seed=4)
            return BatchLoader(ds, 4, shuffle=True, drop_last=True, num_workers=0, seed=4,
                               shard=s)

        ref, shards = check(make, 3, 2,
                            refresh=lambda ds, e: ds.update_sampling_strategy(e, 3))
        for s in shards:
            assert s.dataset.video_usage_counts == ref.dataset.video_usage_counts
            assert [v["path"] for v in s.dataset.current_fake] == \
                [v["path"] for v in ref.dataset.current_fake]
    for bad in (dict(shard=(0, 3)), dict(shard=(2, 2), pad_last=True), dict(shard=(0, 2))):
        with pytest.raises(ValueError):
            BatchLoader(Clips(4, 0), 4, num_workers=0, **bad)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_serving_matches_world_of_one_and_jax(worlds, world_of_one, jax_serve, mesh):
    """B=3 on a batch divisor of 4 or 2 (tail padding); K=4 and K=6 with
    frame_chunk 4 (on a frames axis of 2 the ranks' halves of K=6 cut the
    first global chunk), through ``predict`` and ``predict_stream``; every
    rank returns the same ``[B]``."""
    results = [r[mesh] for r in worlds["serve"].results()]
    for key in ("k4", "k6"):
        np.testing.assert_allclose(world_of_one[key], jax_serve[key], atol=1e-5, rtol=0)
        for r in results:
            assert r[key].shape == (3,)
            np.testing.assert_allclose(r[key], world_of_one[key], atol=1e-5, rtol=0)
            np.testing.assert_allclose(r[key], jax_serve[key], atol=1e-5, rtol=0)
            np.testing.assert_array_equal(r[key], results[0][key])
    for r in results:
        a, b = r["stream"]
        np.testing.assert_allclose(a, world_of_one["k6"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(b, world_of_one["k6_first2"], atol=1e-5, rtol=0)
        if MESHES[mesh]["frames"] > 1:
            assert r["undivisible"] is not None and "frames" in r["undivisible"]


def test_sharded_evaluate_matches_world_of_one(worlds, world_of_one):
    """10 clips in batches of 4 over 4 ranks (a padded tail whose last two
    shares are pad only)."""
    base = world_of_one["eval"]
    for r in worlds["serve"].results():
        got = r["data4"]["eval"]
        assert got["labels"] == base["labels"] and len(got["preds"]) == 10
        np.testing.assert_allclose(got["preds"], base["preds"], rtol=1e-5, atol=1e-6)
        for key in ("loss", "accuracy", "auc", "ap", "eer", "f1", "orth_loss"):
            np.testing.assert_allclose(got[key], base[key], rtol=1e-5, atol=1e-6, err_msg=key)
        assert got["confusion_matrix"] == base["confusion_matrix"]


@pytest.mark.parametrize("dropout", [True, False])
def test_sharded_train_step_matches_world_of_one(worlds, world_of_one, jax_side, dropout):
    """One SGD step, accum 2, a ragged tail chunk, the orthogonality loss
    weighted (epoch 1 of 2): the world of 2 against the unsplit port, with
    dropout and stochastic depth on and off; parameters bitwise equal on
    both ranks."""
    key = "dropout" if dropout else "no_dropout"
    ranks = [r[key] for r in worlds["train"].results()]
    ref = world_of_one[key]
    start = jax_side[2]
    tiers = _tiers(_port(start))
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["preds"], ref["preds"], rtol=1e-4, atol=1e-6)
    _check_updates(start, ref["state"], ranks[0]["state"], tiers, key)
    for name, t in ranks[0]["state"].items():
        assert torch.equal(t, ranks[1]["state"][name]), name


@pytest.mark.parametrize("mesh", ["frames2", "data2_frames2", "dcn2_frames2"])
def test_frames_axis_train_step_matches_world_of_one(worlds, world_of_one, jax_side, mesh):
    """One SGD step (accum 2, dropout and stochastic depth on) with each
    chunk's frames split over a frames axis of 2, on worlds of 2 and 4: K 5
    in chunks of 2, 2 and a tail of 1 that one rank of each frames group
    holds no row of. Loss, predictions, the update of every parameter (its
    gradient) and the BN running statistics against the unsplit port at the
    batch axis's tolerances; ``num_batches_tracked`` equal (each BN moved
    once per global chunk); every rank's state bit for bit the same."""
    ranks = _frames_ranks(worlds, mesh, dropout=True)
    ref = world_of_one["dropout"]
    start = jax_side[2]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["preds"], ref["preds"], rtol=1e-4, atol=1e-6)
    _check_updates(start, ref["state"], ranks[0]["state"], _tiers(_port(start)), mesh)
    tracked = [n for n in ref["state"] if n.endswith("num_batches_tracked")]
    assert tracked and all(torch.equal(ranks[0]["state"][n], ref["state"][n]) for n in tracked)
    for name, t in ranks[0]["state"].items():
        for r in ranks[1:]:
            assert torch.equal(t, r["state"][name]), name


def _frames_ranks(worlds, mesh, dropout):
    """Every rank's step on a frames mesh of the worlds."""
    if mesh == "frames2":
        return [r["frames2" if dropout else "frames2_no_dropout"]
                for r in worlds["train"].results()]
    return [r[mesh]["train" if dropout else "train_no_dropout"]
            for r in worlds["serve"].results()]


def test_sharded_train_step_matches_jax(worlds, world_of_one, jax_stepped, jax_side):
    """The world of 2 (dropout off) against JAX's single-device
    ``train_step`` (dropout patched out), at the same tolerances, where the
    elementwise bound of a tensor is at least twice the unsplit port's own
    distance from JAX on it: the port's BN takes the variance in two passes
    and the JAX package's as ``E[x^2] - E[x]^2``, which loses digits on the
    ragged tail's 2-row chunk (``test_torch_port_train.py`` bounds that
    distance); sharding may not add more than that."""
    _check_against_jax([worlds["train"].results()[0]["no_dropout"]], world_of_one, jax_stepped,
                       jax_side, "against JAX")


@pytest.mark.parametrize("mesh", ["frames2", "data2_frames2", "dcn2_frames2"])
def test_frames_axis_train_step_matches_jax(worlds, world_of_one, jax_stepped, jax_side, mesh):
    """The frames-axis step with dropout off (K 5 in chunks of 2, 2 and a
    1-frame tail that one rank of each frames group holds no row of) against
    JAX's single-device ``train_step``, as the batch axis is held: every
    rank's loss and preds, rank 0's state, and every rank's state bit for bit
    rank 0's. JAX holds its own step on such meshes to the unsharded one
    (``tests/test_sharded_exactness.py``)."""
    ranks = _frames_ranks(worlds, mesh, dropout=False)
    _check_against_jax(ranks, world_of_one, jax_stepped, jax_side, f"{mesh} against JAX")
    for name, t in ranks[0]["state"].items():
        for r in ranks[1:]:
            assert torch.equal(t, r["state"][name]), name


def _check_against_jax(steps, world_of_one, jax_stepped, jax_side, what):
    """Sharded steps (dropout off; one per rank): each one's loss and preds
    against JAX's, and the first one's updated state, each tensor's bound
    floored at twice the unsplit port's distance from JAX."""
    loss, preds, want = jax_stepped
    for r in steps:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["preds"], preds, rtol=1e-4, atol=1e-6)
    start = jax_side[2]
    one = world_of_one["no_dropout"]["state"]
    floor = {n: 2 * float((one[n] - want[n]).abs().max()) for n in start}
    _check_updates(start, want, steps[0]["state"], _tiers(_port(start)), what, floor)


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def test_synced_bn_with_a_large_mean(worlds):
    """Activations at mean 3000, spread 1: the synced BN over 2 ranks against
    fp64 ``F.batch_norm`` on the whole batch. The two-pass sums keep their
    digits where fp32 ``E[x^2] - mean^2`` would not (checked here too)."""
    g = np.random.default_rng(11)
    x = torch.from_numpy((LARGE_MEAN + g.standard_normal((4, 3, 5, 5))).astype(np.float32))
    w = torch.from_numpy(g.standard_normal((4, 3, 5, 5)).astype(np.float32))
    xd = x.double().requires_grad_(True)
    weight = torch.ones(3, dtype=torch.float64, requires_grad=True)
    bias = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    rm, rv = torch.zeros(3, dtype=torch.float64), torch.ones(3, dtype=torch.float64)
    y = F.batch_norm(xd, rm, rv, weight, bias, training=True, momentum=0.1, eps=1e-5)
    (y * w.double()).sum().backward()
    ranks = [r["bn"] for r in worlds["train"].results()]
    got_y = torch.cat([r["y"] for r in ranks]).double()
    got_xg = torch.cat([r["x_grad"] for r in ranks]).double()
    np.testing.assert_allclose(got_y.numpy(), y.detach().numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_xg.numpy(), xd.grad.numpy(),
                               atol=1e-4 * float(xd.grad.abs().max()), rtol=0)
    np.testing.assert_allclose(ranks[0]["param_grads"].double().numpy(),
                               torch.cat([weight.grad, bias.grad]).numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ranks[0]["running"].double().numpy(),
                               torch.stack([rm, rv]).numpy(), rtol=1e-4, atol=1e-5)
    mean = x.mean(dim=(0, 2, 3))
    naive = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).double()
    true = xd.detach().var(dim=(0, 2, 3), unbiased=False)
    assert float((naive - true).abs().max() / true.max()) > 1e-2


def test_sharded_fit_checkpoint_matches_world_of_one(worlds, fit_one):
    """``Trainer.fit`` for one epoch (2 Adam updates at lr 1e-5, dropout
    on): rank 0's ``checkpoint_1.pth`` against the unsplit run's. Adam turns
    a gradient at noise level into a step of about lr, so each parameter is
    held within 2 * lr per update; the running statistics, metadata and
    epoch metrics as the train step's."""
    _check_fit(worlds, fit_one, "fit")


def test_frames_axis_fit_matches_world_of_one(worlds, fit_one):
    """The same epoch on a ``frames`` 2 mesh (3-frame clips in chunks of 2:
    rank 1 holds no row of the 1-frame tail chunk), against the unsplit run
    as the batch-axis fit is held."""
    _check_fit(worlds, fit_one, "fit_frames2")


def _check_fit(worlds, fit_one, key):
    result, ckpt = fit_one
    ranks = worlds["train"].results()
    assert ranks[0][f"{key}_files"] == sorted(os.listdir(ckpt))
    want = torch.load(os.path.join(ckpt, "checkpoint_1.pth"), weights_only=True)
    got = torch.load(os.path.join(worlds["train"].tmp, key, "checkpoint_1.pth"),
                     weights_only=True)
    assert {k: got[k] for k in ("epoch", "step")} == {k: want[k] for k in ("epoch", "step")}
    assert got["best_val_auc"] == pytest.approx(want["best_val_auc"], abs=1e-6)
    steps = want["step"]
    for name, t in want["model_state_dict"].items():
        g = got["model_state_dict"][name]
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g.numpy(), t.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        elif t.is_floating_point():
            assert float((g - t).abs().max()) <= 2 * FIT_TCFG.lr * steps + 1e-6, name
        else:
            assert torch.equal(g, t), name
    for name, t in ranks[0][f"{key}_state"].items():
        assert torch.equal(t, ranks[1][f"{key}_state"][name]), name
    assert len(ranks[0][key]["history"]) == len(result["history"]) == 1
    for a, b in zip(ranks[0][key]["history"], result["history"]):
        pairs = [(a["train"]["loss"], b["train"]["loss"])]
        pairs += [(a["train"]["metrics"][k], b["train"]["metrics"][k]) for k in ("auc", "accuracy")]
        pairs += [(a["val"][k], b["val"][k]) for k in ("loss", "auc", "accuracy")]
        for va, vb in pairs:
            np.testing.assert_allclose(va, vb, rtol=1e-4, atol=1e-5)
