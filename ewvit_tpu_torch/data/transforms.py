"""Host frame geometry: face alignment, resize, centre crop (ewvit_tpu/data/transforms.py).

The host half of the reference transform chain (config/transforms.py:83-123):
decode -> face-align crop -> resize (shorter side 450) -> centre crop 224 =>
uint8 ``[224, 224, 3]``. The photometric half (jitter, /255, ImageNet
normalisation) runs on the device (``ops/preprocess.py``).

Face alignment reproduces FaceAlignTransform (transforms.py:14-81): the
largest detected face, a square crop of side face + 2 * margin centred on it
and clamped to the image; the centre square when no face is found. The
detector is ``mtcnn`` (facenet_pytorch, imported when asked for), ``haar``
(OpenCV's cascade) or ``none`` (always the centre square: frames that are
already face crops). numpy and cv2 as in the JAX package; cv2 is imported
where it is first needed, so the package imports on a machine without it.
"""

from __future__ import annotations

import functools
import importlib
import os
from typing import Optional

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


@functools.lru_cache(maxsize=None)
def cv2_module():
    """``cv2``, or None where it is not installed."""
    try:
        return importlib.import_module("cv2")
    except ImportError:
        return None


def _require_cv2():
    cv2 = cv2_module()
    if cv2 is None:
        raise RuntimeError("cv2 is required to decode and resize frames")
    return cv2


class FaceAligner:
    """Largest-face square crop with margin (transforms.py:14-81 semantics)."""

    def __init__(self, margin: int = 20, detector: str = "auto",
                 min_face_size: int = 40):
        self.margin = margin
        self.min_face_size = min_face_size
        self._mtcnn = None
        self._cascade = None
        cv2 = cv2_module()
        if detector == "auto":
            detector = "haar" if cv2 is not None else "none"
        if detector == "mtcnn":
            try:
                import torch
                from facenet_pytorch import MTCNN  # type: ignore

                self._mtcnn = MTCNN(
                    margin=margin, keep_all=False, min_face_size=min_face_size,
                    post_process=False, device=torch.device("cpu"))
            except ImportError:
                detector = "haar"
        if detector == "haar" and cv2 is not None:
            path = os.path.join(cv2.data.haarcascades,
                                "haarcascade_frontalface_default.xml")
            if os.path.exists(path):
                self._cascade = cv2.CascadeClassifier(path)
        self.detector = detector

    def _detect(self, image: np.ndarray) -> Optional[np.ndarray]:
        """Return [x1, y1, x2, y2] of the largest face or None."""
        try:
            if self._mtcnn is not None:
                boxes, _ = self._mtcnn.detect(image)
                if boxes is None or len(boxes) == 0:
                    return None
                areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
                return boxes[int(np.argmax(areas))]
            if self._cascade is not None:
                cv2 = cv2_module()
                gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
                faces = self._cascade.detectMultiScale(
                    gray, minSize=(self.min_face_size, self.min_face_size))
                if len(faces) == 0:
                    return None
                x, y, w, h = max(faces, key=lambda f: f[2] * f[3])
                return np.asarray([x, y, x + w, y + h], np.float32)
        except Exception:  # a detector failure means no face: the centre square
            pass
        return None

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """image: RGB uint8 [H, W, 3] -> square face crop (or center square)."""
        h, w = image.shape[:2]
        box = self._detect(image)
        if box is not None:
            cx = (box[0] + box[2]) / 2
            cy = (box[1] + box[3]) / 2
            face = max(box[2] - box[0], box[3] - box[1])
            crop = face + 2 * self.margin
            left = int(max(0, cx - crop / 2))
            top = int(max(0, cy - crop / 2))
            right = int(min(w, cx + crop / 2))
            bottom = int(min(h, cy + crop / 2))
            if right > left and bottom > top:
                return image[top:bottom, left:right]
        side = min(h, w)
        top = (h - side) // 2
        left = (w - side) // 2
        return image[top:top + side, left:left + side]


def resize_shorter_side(image: np.ndarray, target: int) -> np.ndarray:
    """torchvision Resize(int): scale so the shorter side == target (bilinear)."""
    cv2 = _require_cv2()
    h, w = image.shape[:2]
    if h <= w:
        nh, nw = target, max(1, int(round(w * target / h)))
    else:
        nh, nw = max(1, int(round(h * target / w))), target
    return cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)


def center_crop(image: np.ndarray, size: int) -> np.ndarray:
    """torchvision CenterCrop(size), zero-padding if the image is smaller."""
    h, w = image.shape[:2]
    if h < size or w < size:
        ph, pw = max(0, size - h), max(0, size - w)
        image = np.pad(
            image,
            ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), (0, 0)))
        h, w = image.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return image[top:top + size, left:left + size]


class FrameTransform:
    """Host pipeline: face-align -> resize(450) -> center-crop(224) -> uint8.

    The geometric part of get_transforms() (transforms.py:91-117); the
    photometric part runs on the device. ``normalize_on_host=True`` returns
    the reference's float32 normalised frame instead (for comparisons).
    """

    def __init__(self, resize: int = 450, crop: int = 224,
                 aligner: Optional[FaceAligner] = None,
                 normalize_on_host: bool = False):
        self.resize = resize
        self.crop = crop
        self.aligner = aligner if aligner is not None else FaceAligner()
        self.normalize_on_host = normalize_on_host

    def __call__(self, frame: np.ndarray) -> np.ndarray:
        img = self.aligner(frame)
        img = resize_shorter_side(img, self.resize)
        img = center_crop(img, self.crop)
        if self.normalize_on_host:
            x = img.astype(np.float32) / 255.0
            return (x - IMAGENET_MEAN) / IMAGENET_STD
        return img
