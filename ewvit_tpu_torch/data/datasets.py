"""Dataset manifests: FaceForensics++, Celeb-DF-v2, diffusion images
(ewvit_tpu/data/datasets.py, a copy: the port imports nothing of the JAX
package).

Behavioural equivalents of the reference loaders (config/data_loader.py):

- :class:`FaceForensicsDataset` = ``FaceForensicsLoader`` (:10-339): the 1:1
  real/fake balancing that picks one forgery method per video pair,
  least-represented first (:147-155), the ``single_method`` test filter
  (:139-145), and the epoch curriculum (the fixed set for the first 30% of
  the epochs, then ``fixed_sample_ratio`` 1 -> 0 and ``novelty_ratio`` 0 -> 1,
  refreshing the fakes least used first, :229-268; val = an 80% fixed core +
  20% reshuffled each epoch with seed 42 + epoch, :184-194, :263-268).
- :class:`CelebDFDataset` = ``CelebDFLoader`` (:342-538), parsing
  ``List_of_testing_videos.txt`` (label 1 = real, 0 = fake, 'youtube' lines
  skipped, :405-408); the train split is the complement of the test file.
- :class:`DiffusionDataset` = ``DiffusionLoader`` (:540-711): DDPM/DDIM/LDM
  against CelebA-Real single images, T = 1.

As in the JAX package: clips come back as uint8 NHWC ``[T, H, W, 3]`` numpy
arrays (normalisation runs on the device); each dataset draws from a private
``random.Random(seed)``, so curriculum refreshes repeat for a seed and the
port draws the same clips in the same order as the JAX package; a frame that
fails to decode becomes a blank frame (:326-331).
"""

from __future__ import annotations

import glob
import json
import os
import random as _random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ewvit_tpu_torch.data.transforms import cv2_module

FF_METHODS = (
    "Deepfakes", "Face2Face", "FaceSwap", "NeuralTextures", "FaceShifter",
)

Transform = Callable[[np.ndarray], np.ndarray]


def _read_image_rgb(path: str) -> Optional[np.ndarray]:
    cv2 = cv2_module()
    if cv2 is None:
        raise RuntimeError("cv2 is required to decode frames")
    img = cv2.imread(path)
    if img is None:
        return None
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _uniform_indices(n_available: int, n_wanted: int) -> List[int]:
    """np.linspace frame selection with last-frame padding (data_loader.py:310-320)."""
    if n_available >= n_wanted:
        return np.linspace(0, n_available - 1, n_wanted, dtype=int).tolist()
    idx = list(range(n_available))
    while len(idx) < n_wanted:
        idx.append(n_available - 1)
    return idx


def _frame_files(frames_dir: str) -> List[str]:
    files = sorted(glob.glob(os.path.join(frames_dir, "*.png")))
    if not files:
        files = sorted(glob.glob(os.path.join(frames_dir, "*.jpg")))
    return files


class VideoFrameDataset:
    """Shared frame-reading machinery for the video datasets.

    Two decode paths:
    - cv2 + ``transform`` per frame (reference-parity; supports face align);
    - ``native_decode=True``: the whole clip decodes through the C++ frameio
      pool (``data/native.py``) into one contiguous buffer — GIL-free,
      scales with host cores. Geometry = center-square crop_frac(=224/450)
      + bilinear resize, i.e. the reference transform chain with face
      detection disabled — use for pre-cropped-face frame dumps.
    """

    frame_count: int
    transform: Optional[Transform]
    native_decode: bool = False
    native_out_size: int = 224
    native_crop_frac: float = 224.0 / 450.0

    def _load_clip(self, frames_dir: str) -> np.ndarray:
        """Read ``frame_count`` uniformly-spaced frames as [T, H, W, 3] uint8."""
        files = _frame_files(frames_dir)
        if not files:
            raise FileNotFoundError(f"No frames found in '{frames_dir}'")
        sel = [files[i] for i in _uniform_indices(len(files), self.frame_count)]
        if self.native_decode:
            from ewvit_tpu_torch.data import native

            if native.available():
                frames, _ok = native.decode_batch(
                    sel, self.native_out_size, self.native_crop_frac)
                return frames
        frames = []
        for path in sel:
            img = _read_image_rgb(path)
            if img is None:
                img = np.zeros((224, 224, 3), np.uint8)  # blank-frame fallback
            if self.transform is not None:
                img = self.transform(img)
            frames.append(img)
        return np.stack(frames)

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, index: int):  # pragma: no cover - abstract
        raise NotImplementedError


class FaceForensicsDataset(VideoFrameDataset):
    """FF++ dataset with method balancing and the epoch curriculum.

    Directory layout (reference README.md:47-95):
      ``{root}/faceforensics/ff++/splits/{split}.json``
      ``{root}/faceforensics/ff++/frames/original/{id}/*.png``
      ``{root}/faceforensics/ff++/frames/{method}/{target}_{source}/*.png``
    """

    def __init__(
        self,
        root: str,
        split: str = "train",
        frame_count: int = 24,
        transform: Optional[Transform] = None,
        compression: str = "C23",
        methods: Sequence[str] = FF_METHODS,
        single_method: Optional[str] = None,
        seed: int = 0,
        native_decode: bool = False,
    ):
        self.root = root
        self.split = split
        self.frame_count = frame_count
        self.transform = transform
        self.native_decode = native_decode
        # stored-never-used, faithful to the reference (data_loader.py:23,
        # :34 assigns self.compression but no code path reads it — the
        # frame-dir layout carries no compression level)
        self.compression = compression
        self.methods = list(methods)
        self.single_method = single_method
        self.current_epoch = 0
        self.fixed_sample_ratio = 1.0
        self.novelty_ratio = 0.0
        self._rng = _random.Random(seed)

        self.split_ids = self._load_split()
        self.video_usage_counts: Dict[str, int] = {}
        self.real_videos, self.fake_videos = self._load_frames_dirs()
        self._init_sampling_strategy()

    # ----- manifest construction ------------------------------------------

    def _load_split(self) -> List[List[str]]:
        path = os.path.join(
            self.root, f"faceforensics/ff++/splits/{self.split}.json")
        if not os.path.exists(path):
            raise FileNotFoundError(f"Split file '{path}' not found")
        with open(path) as f:
            return json.load(f)

    def _load_frames_dirs(self) -> Tuple[List[str], List[Dict]]:
        original_dir = os.path.join(
            self.root, "faceforensics/ff++/frames/original")
        if not os.path.exists(original_dir):
            raise FileNotFoundError(
                f"Original video frames directory '{original_dir}' not found")

        real_dirs = []
        for target, _source in self.split_ids:
            d = os.path.join(original_dir, str(target))
            if not os.path.exists(d):
                raise FileNotFoundError(f"Original video '{d}' not found")
            real_dirs.append(d)

        # All forgery variants available per video pair.
        pair_variants: Dict[str, List[Dict]] = {}
        for method in self.methods:
            fake_root = os.path.join(
                self.root, f"faceforensics/ff++/frames/{method}")
            if not os.path.exists(fake_root):
                raise FileNotFoundError(
                    f"Fake videos directory '{fake_root}' not found")
            for target, source in self.split_ids:
                key = f"{target}_{source}"
                d = os.path.join(fake_root, key)
                if os.path.exists(d):
                    pair_variants.setdefault(key, []).append(
                        {"path": d, "method": method,
                         "target": target, "source": source})

        if self.split == "test" and self.single_method is not None:
            fakes = [v for variants in pair_variants.values()
                     for v in variants if v["method"] == self.single_method]
        else:
            # One fake per real video pair, least-represented method first
            # (data_loader.py:147-155) => 1:1 real/fake with even method mix.
            fakes = []
            counts = {m: 0 for m in self.methods}
            for variants in pair_variants.values():
                pick = min(variants, key=lambda v: counts[v["method"]])
                fakes.append(pick)
                counts[pick["method"]] += 1
        self._rng.shuffle(fakes)
        return real_dirs, fakes

    # ----- curriculum sampling (data_loader.py:171-268) -------------------

    def _init_sampling_strategy(self) -> None:
        for v in self.fake_videos:
            self.video_usage_counts[v["path"]] = 0
        if self.split == "train":
            n_fixed = int(len(self.fake_videos) * self.fixed_sample_ratio)
            self.fixed_fake = self._rng.sample(self.fake_videos, n_fixed)
            fixed_paths = {v["path"] for v in self.fixed_fake}
            self.pool_fake = [
                v for v in self.fake_videos if v["path"] not in fixed_paths]
            self.current_fake = list(self.fixed_fake)
        elif self.split == "val":
            r = _random.Random(42)
            self.core_fake = r.sample(
                self.fake_videos, int(len(self.fake_videos) * 0.8))
            core_paths = {v["path"] for v in self.core_fake}
            self.dynamic_pool_fake = [
                v for v in self.fake_videos if v["path"] not in core_paths]
            r = _random.Random(42)
            self.dynamic_fake = r.sample(
                self.dynamic_pool_fake,
                min(int(len(self.fake_videos) * 0.2),
                    len(self.dynamic_pool_fake)))
            self.current_fake = self.core_fake + self.dynamic_fake
        else:
            self.current_fake = list(self.fake_videos)

    def _refresh_training_samples(self) -> None:
        n_fixed = int(len(self.fake_videos) * self.fixed_sample_ratio)
        selected_fixed = (
            self._rng.sample(self.fixed_fake, min(n_fixed, len(self.fixed_fake)))
            if n_fixed > 0 else [])
        remaining = len(self.fake_videos) - n_fixed
        # least-used fakes first => "novel" samples enter the epoch set
        self.pool_fake.sort(key=lambda v: self.video_usage_counts[v["path"]])
        n_new = int(remaining * self.novelty_ratio)
        n_rand = remaining - n_new
        if n_rand > 0 and len(self.pool_fake) > n_new:
            rand = self._rng.sample(
                self.pool_fake[n_new:],
                min(n_rand, len(self.pool_fake) - n_new))
        else:
            rand = []
        merged = selected_fixed + self.pool_fake[:n_new] + rand
        self.current_fake = list({v["path"]: v for v in merged}.values())
        self._rng.shuffle(self.current_fake)

    def update_sampling_strategy(self, epoch: int, max_epochs: int,
                                 *, verbose: bool = False) -> None:
        """Epoch curriculum (data_loader.py:229-268)."""
        self.current_epoch = epoch
        if self.split == "train":
            early, late = 0.3, 0.7
            if epoch < max_epochs * early:
                self.fixed_sample_ratio, self.novelty_ratio = 1.0, 0.0
            else:
                rel = epoch - max_epochs * early
                trans = max_epochs * (late - early)
                prog = min(1.0, rel / trans)
                self.fixed_sample_ratio = max(0.0, 1.0 - prog)
                self.novelty_ratio = min(1.0, prog)
            if verbose:
                print(f"  - Fixed sample ratio: {self.fixed_sample_ratio:.2f}")
                print(f"  - Novelty ratio: {self.novelty_ratio:.2f}")
            self._refresh_training_samples()
        elif self.split == "val":
            r = _random.Random(42 + epoch)
            self.dynamic_fake = r.sample(
                self.dynamic_pool_fake,
                min(int(len(self.fake_videos) * 0.2),
                    len(self.dynamic_pool_fake)))
            self.current_fake = self.core_fake + self.dynamic_fake

    # ----- indexing --------------------------------------------------------

    def __len__(self) -> int:
        if self.split in ("train", "val"):
            return len(self.real_videos) + len(self.current_fake)
        return len(self.real_videos) + len(self.fake_videos)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        frames_dir, label = self._entry(index)
        return self._load_clip(frames_dir), label

    def mark_used(self, index: int) -> None:
        """What ``__getitem__`` does to the curriculum's usage counts,
        without decoding: a loader sharded over ranks (``BatchLoader(shard=)``)
        calls it for the rows other ranks decode, so every rank's counts, and
        so its next curriculum refresh, are those of the unsplit run."""
        self._entry(index)

    def _entry(self, index: int) -> Tuple[str, int]:
        """(frames directory, label) of ``index``, counting a fake's use."""
        if index < len(self.real_videos):
            frames_dir, label = self.real_videos[index], 0
        else:
            fi = index - len(self.real_videos)
            if self.split in ("train", "val"):
                if fi >= len(self.current_fake):
                    raise IndexError(f"Index '{index}' out of range")
                frames_dir = self.current_fake[fi]["path"]
                self.video_usage_counts[frames_dir] = (
                    self.video_usage_counts.get(frames_dir, 0) + 1)
            else:
                if fi >= len(self.fake_videos):
                    raise IndexError(f"Index '{index}' out of range")
                frames_dir = self.fake_videos[fi]["path"]
            label = 1
        return frames_dir, label

    @property
    def fake_ratio(self) -> float:
        """len(fake)/len(real) — the BCE pos_weight (train.py:268-272)."""
        n_fake = len(self) - len(self.real_videos)
        return n_fake / max(1, len(self.real_videos))


class CelebDFDataset(VideoFrameDataset):
    """Celeb-DF-v2 cross-dataset loader (data_loader.py:342-538).

    Layout: ``{root}/celebdf/frames/{Celeb-real,Celeb-synthesis}/{id}/*.png``;
    ``testing_file`` = List_of_testing_videos.txt (label 1=real, 0=fake).
    """

    def __init__(self, root: str, split: Sequence[str] = ("train", "test"),
                 frame_count: int = 24, transform: Optional[Transform] = None,
                 testing_file: Optional[str] = None,
                 native_decode: bool = False):
        self.root = root
        self.split = list(split)
        self.frame_count = frame_count
        self.transform = transform
        self.native_decode = native_decode
        self.testing_file = testing_file
        self.real_videos, self.synthetic_videos = self._load_frames_dirs()

    def _load_split(self) -> Dict[str, List[str]]:
        if not os.path.exists(self.testing_file):
            raise FileNotFoundError(
                f"Testing file '{self.testing_file}' not found")
        test = {"real": [], "fake": []}
        with open(self.testing_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("//"):
                    continue
                parts = line.split()
                if len(parts) < 2:
                    continue
                label, vpath = parts[0], parts[1]
                if "youtube" in vpath.lower():
                    continue  # YouTube-real excluded (data_loader.py:405-408)
                vid = vpath.split("/")[-1].split(".")[0]
                if label == "1" and "celeb-real" in vpath.lower():
                    test["real"].append(vid)
                elif label == "0" and "celeb-synthesis" in vpath.lower():
                    test["fake"].append(vid)
        return test

    def _load_frames_dirs(self) -> Tuple[List[str], List[str]]:
        real_dir = os.path.join(self.root, "celebdf/frames/Celeb-real")
        synth_dir = os.path.join(self.root, "celebdf/frames/Celeb-synthesis")
        for d in (real_dir, synth_dir):
            if not os.path.exists(d):
                raise FileNotFoundError(f"Frames directory '{d}' not found")

        def subdirs(d):
            return [(v, os.path.join(d, v)) for v in sorted(os.listdir(d))
                    if os.path.isdir(os.path.join(d, v))]

        test = (self._load_split() if self.testing_file
                else {"real": [], "fake": []})
        reals, fakes = [], []
        if "test" in self.split:
            reals = [p for v, p in subdirs(real_dir) if v in test["real"]]
            fakes = [p for v, p in subdirs(synth_dir) if v in test["fake"]]
        else:  # train = complement of the test file (data_loader.py:469-477)
            reals = [p for v, p in subdirs(real_dir) if v not in test["real"]]
            fakes = [p for v, p in subdirs(synth_dir) if v not in test["fake"]]
        return reals, fakes

    def __len__(self) -> int:
        return len(self.real_videos) + len(self.synthetic_videos)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        if index < len(self.real_videos):
            frames_dir, label = self.real_videos[index], 0
        else:
            fi = index - len(self.real_videos)
            if fi >= len(self.synthetic_videos):
                raise IndexError(f"Index '{index}' out of range")
            frames_dir, label = self.synthetic_videos[fi], 1
        return self._load_clip(frames_dir), label


class DiffusionDataset(VideoFrameDataset):
    """Diffusion-generated single-image dataset (data_loader.py:540-711).

    Layout: ``{root}/CelebA-Real/*.jpg`` (label 0) vs ``{root}/{method}/*.png``
    for method in (DDPM, DDIM, LDM) (label 1). T=1 clips.
    """

    METHODS = ("DDPM", "DDIM", "LDM")

    def __init__(self, root: str, frame_count: int = 1,
                 transform: Optional[Transform] = None,
                 methods: Sequence[str] = METHODS,
                 single_method: Optional[str] = None):
        self.root = root
        self.frame_count = frame_count
        self.transform = transform
        self.single_method = single_method
        self.methods = [single_method] if single_method else list(methods)
        self.real_images, self.fake_images = self._load_image_paths()

    def _load_image_paths(self):
        reals: List[str] = []
        real_dir = os.path.join(self.root, "CelebA-Real")
        if os.path.exists(real_dir):
            reals = [os.path.join(real_dir, f)
                     for f in os.listdir(real_dir)
                     if f.endswith((".jpg", ".png"))]
        fakes: List[Dict] = []
        for method in self.methods:
            mdir = os.path.join(self.root, method)
            if not os.path.exists(mdir):
                continue
            for f in os.listdir(mdir):
                if f.endswith((".png", ".jpg")):
                    fakes.append({"path": os.path.join(mdir, f),
                                  "method": method, "filename": f})
        reals.sort()
        fakes.sort(key=lambda x: x["path"])
        return reals, fakes

    def __len__(self) -> int:
        return len(self.real_images) + len(self.fake_images)

    def get_image_info(self, index: int) -> Dict:
        if index < len(self.real_images):
            p = self.real_images[index]
            return {"path": p, "method": "Real", "label": 0,
                    "filename": os.path.basename(p)}
        fi = index - len(self.real_images)
        if fi >= len(self.fake_images):
            raise IndexError(f"Index '{index}' out of range")
        info = self.fake_images[fi]
        return {"path": info["path"], "method": info["method"], "label": 1,
                "filename": info["filename"]}

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        info = self.get_image_info(index)
        img = _read_image_rgb(info["path"])
        if img is None:
            raise FileNotFoundError(
                f"Could not load image from '{info['path']}'")
        if self.transform is not None:
            img = self.transform(img)
        return img[None], info["label"]  # [1, H, W, 3]
