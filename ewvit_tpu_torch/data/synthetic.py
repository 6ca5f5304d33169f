"""Synthetic frame trees in the datasets' layouts, for tests and smoke runs.

:func:`write_ff_tree` writes a FaceForensics++ tree as ``FaceForensicsDataset``
reads it (``splits/{train,val,test}.json``, ``frames/original/{id}``,
``frames/{method}/{target}_{source}``) with seeded frames: a smooth random
image per video, shifted a little from frame to frame, plus noise, saved as
PNG with cv2. Pair ``j`` of the train and val splits has the forgeries of
methods ``j`` and ``j + 1`` (mod 5), so the balancing chooses; every test
pair has all five.

:func:`write_celebdf_tree` writes a Celeb-DF-v2 test set as
``CelebDFDataset`` reads it (``celebdf/frames/{Celeb-real,Celeb-synthesis}/{id}``
and a testing list of ``label path`` lines, 1 for real).

:func:`write_checkerboard_tree` writes the learning proof's FF++ tree
(``cli/learning_proof.py``), the same files byte for byte as the JAX
package's ``tools/make_synthetic_fixture.py`` for the same arguments: real
frames are smooth block images, fakes add a +-``amp`` pixel-scale
checkerboard, a signal the MWT's high-frequency branch can learn.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ewvit_tpu_torch.data.datasets import FF_METHODS
from ewvit_tpu_torch.data.transforms import cv2_module


def _video(rng: np.random.Generator, frames: int, height: int, width: int) -> np.ndarray:
    cv2 = cv2_module()
    base = cv2.resize(rng.integers(0, 256, (max(2, height // 16), max(2, width // 16), 3),
                                   dtype=np.uint8), (width + frames, height),
                      interpolation=cv2.INTER_LINEAR)
    noise = rng.integers(-8, 9, (frames, height, width, 3))
    clip = np.stack([base[:, t:t + width] for t in range(frames)]).astype(np.int64)
    return np.clip(clip + noise, 0, 255).astype(np.uint8)


def _write(directory: str, clip: np.ndarray) -> None:
    cv2 = cv2_module()
    os.makedirs(directory, exist_ok=True)
    for t, frame in enumerate(clip):
        if not cv2.imwrite(os.path.join(directory, f"{t:04d}.png"), frame):
            raise OSError(f"could not write a frame into {directory}")


def write_ff_tree(root: str, *, pairs: Dict[str, int], frames: int = 8, height: int = 40,
                  width: int = 48, seed: int = 0,
                  methods: Sequence[str] = FF_METHODS) -> Dict[str, List[List[str]]]:
    """Write the tree under ``root`` with ``pairs[split]`` video pairs per
    split; returns the splits' ``[target, source]`` lists."""
    if cv2_module() is None:
        raise RuntimeError("writing a synthetic frame tree needs cv2")
    rng = np.random.default_rng(seed)
    ff = os.path.join(root, "faceforensics", "ff++")
    os.makedirs(os.path.join(ff, "splits"), exist_ok=True)
    splits, n = {}, 0
    for split, count in pairs.items():
        ids = []
        for j in range(count):
            target, source = f"{n:03d}", f"{n + 1:03d}"
            n += 2
            ids.append([target, source])
            _write(os.path.join(ff, "frames", "original", target),
                   _video(rng, frames, height, width))
            chosen = (methods if split == "test"
                      else [methods[j % len(methods)], methods[(j + 1) % len(methods)]])
            for method in chosen:
                _write(os.path.join(ff, "frames", method, f"{target}_{source}"),
                       _video(rng, frames, height, width))
        with open(os.path.join(ff, "splits", f"{split}.json"), "w") as f:
            json.dump(ids, f)
        splits[split] = ids
    for method in methods:      # every method's directory exists, as the dataset requires
        os.makedirs(os.path.join(ff, "frames", method), exist_ok=True)
    return splits


def write_celebdf_tree(root: str, *, videos: int = 2, frames: int = 3, height: int = 64,
                       width: int = 64, seed: int = 1) -> str:
    """Write ``videos`` real and ``videos`` fake videos under ``root`` and
    their testing list, ``List_of_testing_videos.txt``; returns its path."""
    if cv2_module() is None:
        raise RuntimeError("writing a synthetic frame tree needs cv2")
    rng = np.random.default_rng(seed)
    lines = []
    for kind, label in (("Celeb-real", 1), ("Celeb-synthesis", 0)):
        for i in range(videos):
            vid = f"id{i}_000" if label else f"id{i}_id{(i + 1) % max(2, videos)}_000"
            _write(os.path.join(root, "celebdf", "frames", kind, vid),
                   _video(rng, frames, height, width))
            lines.append(f"{label} {kind}/{vid}.mp4\n")
    path = os.path.join(root, "List_of_testing_videos.txt")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def _checkerboard_clip(directory: str, frames: int, size: int, amp: int, fake: bool,
                       rng: np.random.Generator, block: int = 30) -> None:
    """``frames`` PNGs of ``size`` px: ``block``-px squares of random colour,
    plus the checkerboard for a fake (tools/make_synthetic_fixture.py:34-48)."""
    cv2 = cv2_module()
    os.makedirs(directory, exist_ok=True)
    yy, xx = np.indices((size, size))
    cb = (((yy + xx) % 2) * 2 - 1).astype(np.int16)
    g = -(-size // block)       # the tiles cover the frame before the cut
    for i in range(frames):
        base = rng.integers(40, 216, (g, g, 3))
        img = np.kron(base, np.ones((block, block, 1)))[:size, :size].astype(np.int16)
        if fake:
            img = img + cb[..., None] * amp
        if not cv2.imwrite(os.path.join(directory, f"{i:03d}.png"),
                           np.clip(img, 0, 255).astype(np.uint8)):
            raise OSError(f"could not write a frame into {directory}")


def write_checkerboard_tree(root: str, *, pairs: int, val_pairs: int, frames: int,
                            size: int = 450, amp: int = 24,
                            methods: Sequence[str] = ("Deepfakes",),
                            spread_methods: bool = False, seed: int = 0) -> Tuple[dict, int]:
    """Write the tree under ``root``: ``pairs`` train pairs, ``val_pairs``
    val and as many test pairs, ``frames`` PNGs of ``size`` px a video.
    Every pair's fake goes under each of ``methods``, or with
    ``spread_methods`` under one, round-robin (every method's directory is
    made all the same). Returns the splits' ``[target, source]`` lists and the
    number of PNGs written."""
    if cv2_module() is None:
        raise RuntimeError("writing a synthetic frame tree needs cv2")
    unknown = [m for m in methods if m not in FF_METHODS]
    if unknown:
        raise ValueError(f"unknown methods {unknown} (use some of {FF_METHODS})")
    base = os.path.join(root, "faceforensics", "ff++")
    os.makedirs(os.path.join(base, "splits"), exist_ok=True)
    rng = np.random.default_rng(seed)
    n_total = pairs + 2 * val_pairs
    ids = [[f"{i:03d}", f"{i + 500:03d}"] for i in range(n_total)]
    splits = {"train": ids[:pairs], "val": ids[pairs:pairs + val_pairs],
              "test": ids[pairs + val_pairs:]}
    for split, ps in splits.items():
        with open(os.path.join(base, "splits", f"{split}.json"), "w") as f:
            json.dump(ps, f)
    n_png = 0
    for t, _ in ids:
        _checkerboard_clip(os.path.join(base, "frames", "original", t), frames, size, amp,
                           False, rng)
        n_png += frames
    if spread_methods:
        for m in methods:
            os.makedirs(os.path.join(base, "frames", m), exist_ok=True)
        fakes = [(methods[j % len(methods)], t, s) for j, (t, s) in enumerate(ids)]
    else:
        fakes = [(m, t, s) for m in methods for t, s in ids]
    for m, t, s in fakes:
        _checkerboard_clip(os.path.join(base, "frames", m, f"{t}_{s}"), frames, size, amp,
                           True, rng)
        n_png += frames
    return splits, n_png
