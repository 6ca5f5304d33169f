"""The port's data pipeline held against the JAX package's on the CPU.

The JAX data modules are numpy and cv2, so nothing is compiled. Frame trees
are written into ``tmp_path`` with cv2 (``data/synthetic.py`` for FF++);
both packages read the same files, and the port must give the same
manifests, curriculum sets, clips and batches bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from ewvit_tpu import evaluation as jeval
from ewvit_tpu.data import datasets as jds
from ewvit_tpu.data import native as jnative
from ewvit_tpu.data import pipeline as jpipe
from ewvit_tpu.data import transforms as jtf
from ewvit_tpu_torch import evaluation as peval
from ewvit_tpu_torch.data import datasets as pds
from ewvit_tpu_torch.data import native as pnative
from ewvit_tpu_torch.data import pipeline as ppipe
from ewvit_tpu_torch.data import transforms as ptf
from ewvit_tpu_torch.data.synthetic import write_ff_tree
from ewvit_tpu_torch.data.transforms import cv2_module

cv2 = cv2_module()
pytestmark = pytest.mark.skipif(cv2 is None, reason="cv2 writes the frame trees")

FRAMES = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes that share the cores, and torch's default of
    one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _transform(pkg, detector="none"):
    return pkg.FrameTransform(resize=45, crop=24, aligner=pkg.FaceAligner(detector=detector))


@pytest.fixture(scope="module")
def ff_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ffpp"))
    write_ff_tree(root, pairs=dict(train=10, val=10, test=3), frames=FRAMES, height=30,
                  width=38, seed=3)
    return root


@pytest.fixture(scope="module")
def celebdf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("celebdf")
    rng = np.random.default_rng(0)
    for kind, ids in (("Celeb-real", ["id0_000", "id1_000", "id2_000"]),
                      ("Celeb-synthesis", ["id0_id1_000", "id1_id0_000", "id2_id0_000"])):
        for v in ids:
            d = root / "celebdf" / "frames" / kind / v
            os.makedirs(d)
            for i in range(3):
                cv2.imwrite(str(d / f"{i:03d}.png"), rng.integers(0, 256, (20, 26, 3), np.uint8))
    (root / "List_of_testing_videos.txt").write_text(
        "1 Celeb-real/id0_000.mp4\n0 Celeb-synthesis/id0_id1_000.mp4\n"
        "// a comment\n1 YouTube-real/yt0.mp4\n0 Celeb-synthesis/id2_id0_000.mp4\n")
    return str(root)


@pytest.fixture(scope="module")
def diffusion_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("diffusion")
    rng = np.random.default_rng(1)
    for sub, ext, n in (("CelebA-Real", ".jpg", 3), ("DDPM", ".png", 2), ("DDIM", ".png", 2),
                        ("LDM", ".jpg", 1)):
        os.makedirs(root / sub)
        for i in range(n):
            cv2.imwrite(str(root / sub / f"{i:02d}{ext}"),
                        rng.integers(0, 256, (27, 21, 3), np.uint8))
    return str(root)


def _manifest(ds):
    return {k: getattr(ds, k) for k in ("real_videos", "fake_videos", "current_fake",
                                         "video_usage_counts") if hasattr(ds, k)}


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_ff_manifests(ff_root, split):
    """Balancing (one fake per pair, least-represented method first), the
    seeded shuffles, and each clip bit for bit."""
    kw = dict(split=split, frame_count=4, seed=7)
    j = jds.FaceForensicsDataset(ff_root, transform=_transform(jtf), **kw)
    p = pds.FaceForensicsDataset(ff_root, transform=_transform(ptf), **kw)
    assert _manifest(p) == _manifest(j) and len(p) == len(j) and p.fake_ratio == j.fake_ratio
    methods = [v["method"] for v in p.fake_videos]
    assert max(map(methods.count, set(methods))) - min(map(methods.count, set(methods))) <= 1
    for i in (0, len(p) - 1):
        (cj, lj), (cp, lp) = j[i], p[i]
        assert lj == lp and cp.dtype == np.uint8 and np.array_equal(cp, cj)


@pytest.mark.parametrize("method", jds.FF_METHODS)
def test_ff_single_method(ff_root, method):
    kw = dict(split="test", frame_count=2, single_method=method, seed=0)
    j, p = jds.FaceForensicsDataset(ff_root, **kw), pds.FaceForensicsDataset(ff_root, **kw)
    assert _manifest(p) == _manifest(j)
    assert {v["method"] for v in p.fake_videos} == {method} and len(p.fake_videos) == 3


def test_ff_curriculum(ff_root):
    """``current_fake`` after ``update_sampling_strategy`` for epochs 0-4 of
    5, train and val (the val reshuffle included), with every clip read
    between epochs so the usage counts steer the refresh."""
    sets = {}
    for split in ("train", "val"):
        kw = dict(split=split, frame_count=2, seed=11)
        j = jds.FaceForensicsDataset(ff_root, transform=_transform(jtf), **kw)
        p = pds.FaceForensicsDataset(ff_root, transform=_transform(ptf), **kw)
        for epoch in range(5):
            j.update_sampling_strategy(epoch, 5)
            p.update_sampling_strategy(epoch, 5)
            assert (p.fixed_sample_ratio, p.novelty_ratio) == (j.fixed_sample_ratio,
                                                               j.novelty_ratio)
            assert _manifest(p) == _manifest(j), (split, epoch)
            sets.setdefault(split, []).append([v["path"] for v in p.current_fake])
            for i in range(len(p)):
                assert np.array_equal(p[i][0], j[i][0])
    assert len({tuple(s) for s in sets["train"]}) > 1     # the curriculum moved
    assert len({tuple(s) for s in sets["val"]}) > 1       # the dynamic 20% reshuffled


@pytest.mark.parametrize("split", ["test", "train"])
def test_celebdf(celebdf_root, split):
    kw = dict(split=[split], frame_count=4,
              testing_file=os.path.join(celebdf_root, "List_of_testing_videos.txt"))
    j = jds.CelebDFDataset(celebdf_root, transform=_transform(jtf), **kw)
    p = pds.CelebDFDataset(celebdf_root, transform=_transform(ptf), **kw)
    assert (p.real_videos, p.synthetic_videos) == (j.real_videos, j.synthetic_videos)
    assert len(p) == 3
    for i in range(len(p)):
        assert p[i][1] == j[i][1] and np.array_equal(p[i][0], j[i][0])


@pytest.mark.parametrize("method", [None, "DDPM", "LDM"])
def test_diffusion(diffusion_root, method):
    j = jds.DiffusionDataset(diffusion_root, transform=_transform(jtf), single_method=method)
    p = pds.DiffusionDataset(diffusion_root, transform=_transform(ptf), single_method=method)
    assert (p.real_images, p.fake_images) == (j.real_images, j.fake_images)
    for i in range(len(p)):
        assert p.get_image_info(i) == j.get_image_info(i)
        (cp, lp), (cj, lj) = p[i], j[i]
        assert lp == lj and cp.shape == (1, 24, 24, 3) and np.array_equal(cp, cj)


def test_clips_native_decode(ff_root):
    """``native_decode`` (centre square, bilinear resize in C++) where both
    libraries build; the port builds its own copy of native/frameio.cpp."""
    if not (pnative.available() and jnative.available()):
        pytest.skip("the native frame decoder does not build here (no g++, libpng or libjpeg)")
    assert os.path.dirname(pnative.library_path()) == pnative.BUILD_DIR
    kw = dict(split="val", frame_count=5, seed=2, native_decode=True)
    j, p = jds.FaceForensicsDataset(ff_root, **kw), pds.FaceForensicsDataset(ff_root, **kw)
    for ds in (j, p):
        ds.native_out_size = 24
    for i in range(len(p)):
        (cp, _), (cj, _) = p[i], j[i]
        assert cp.shape == (5, 24, 24, 3) and np.array_equal(cp, cj)


@pytest.mark.parametrize("detector", ["none", "haar"])
@pytest.mark.parametrize("hw", [(37, 53), (101, 67), (20, 20), (9, 31)])
def test_frame_transform_geometry(hw, detector):
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), np.uint8)
    for resize, crop in ((45, 24), (21, 24), (450, 224)):
        want = jtf.FrameTransform(resize, crop, jtf.FaceAligner(detector=detector))(img)
        got = ptf.FrameTransform(resize, crop, ptf.FaceAligner(detector=detector))(img)
        assert got.shape == (crop, crop, 3) and np.array_equal(got, want)
    assert np.array_equal(ptf.resize_shorter_side(img, 13), jtf.resize_shorter_side(img, 13))
    assert np.array_equal(ptf.center_crop(img, 40), jtf.center_crop(img, 40))


def _batches(pkg, ds, **kw):
    return [(f.copy(), l.copy()) for f, l in pkg.BatchLoader(ds, **kw)]


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, shuffle=True, seed=5, num_workers=0),
    dict(batch_size=3, shuffle=True, seed=5, num_workers=3),
    dict(batch_size=4, drop_last=True, num_workers=2),
    dict(batch_size=3, pad_last=True, num_workers=0),
], ids=["shuffle-sync", "shuffle-threads", "drop_last", "pad_last"])
def test_batch_loader(ff_root, kw):
    """Two epochs of batches bit for bit (the second reshuffles); threads
    give the synchronous batches; ``true_len``."""
    ds = pds.FaceForensicsDataset(ff_root, split="val", frame_count=3,
                                  transform=_transform(ptf))
    jl, pl = jpipe.BatchLoader(ds, **kw), ppipe.BatchLoader(ds, **kw)
    assert len(pl) == len(jl) and pl.true_len() == jl.true_len() == len(ds)
    for _ in range(2):
        got, want = [(f.copy(), l.copy()) for f, l in pl], [(f.copy(), l.copy()) for f, l in jl]
        assert len(got) == len(want) == len(pl)
        for (fp, lp), (fj, lj) in zip(got, want):
            assert fp.dtype == np.uint8 and lp.dtype == np.int32
            assert np.array_equal(fp, fj) and np.array_equal(lp, lj)
    sync = dict(kw, num_workers=0)
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(
        _batches(ppipe, ds, **kw), _batches(ppipe, ds, **sync)))
    if kw.get("pad_last"):      # 20 clips: the last batch holds 2 and a zero clip
        assert got[-1][0].shape[0] == 3 and not got[-1][0][len(ds) % 3:].any()
        assert got[-1][0][:len(ds) % 3].any() and got[-1][1].tolist()[-1] == 0


def test_device_prefetcher_passes_through_on_cpu(ff_root):
    ds = pds.FaceForensicsDataset(ff_root, split="val", frame_count=2,
                                  transform=_transform(ptf))
    loader = ppipe.BatchLoader(ds, batch_size=4, num_workers=0)
    out = list(ppipe.DevicePrefetcher(loader, "cpu"))
    assert len(out) == len(loader) == 5
    for (f, l), (g, m) in zip(out, loader):
        assert isinstance(f, np.ndarray) and np.array_equal(f, g) and np.array_equal(l, m)


@pytest.mark.parametrize("dataset", ["ff++", "ff++/FaceSwap", "celeb-df", "diffusion",
                                     "diffusion/DDIM"])
def test_get_dataloader(ff_root, celebdf_root, diffusion_root, dataset):
    name, _, method = dataset.partition("/")
    root = {"ff++": ff_root, "celeb-df": celebdf_root, "diffusion": diffusion_root}[name]
    kw = dict(batch_size=2, frame_count=3, single_method=method or None, num_workers=2,
              test_list=os.path.join(celebdf_root, "List_of_testing_videos.txt"))
    (jl, jd), (pl, pd_) = (mod.get_dataloader(root, name, transform=_transform(pkg), **kw)
                           for mod, pkg in ((jeval, jtf), (peval, ptf)))
    assert isinstance(pl, ppipe.BatchLoader) and pl.pad_last
    assert type(pd_).__name__ == type(jd).__name__ and len(pd_) == len(jd)
    assert pl.true_len() == jl.true_len()
    for (fp, lp), (fj, lj) in zip(pl, jl):
        assert np.array_equal(fp, fj) and np.array_equal(lp, lj)
    with pytest.raises(ValueError):
        peval.get_dataloader(root, "imagenet")
