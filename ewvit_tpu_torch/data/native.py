"""ctypes binding of the native frame decoder (ewvit_tpu/data/native.py).

``native/frameio.cpp`` decodes PNG/JPEG frames, crops the centre square and
resizes it bilinearly into one contiguous uint8 ``[N, S, S, 3]`` buffer on a
persistent thread pool, without the GIL. The port compiles that source
(read only) with ``g++ -O3 -fPIC -shared ... -ljpeg -lpng`` into the
git-ignored ``ewvit_tpu_torch/_build/`` at first use, under a name that
carries a hash of the source and the flags.

:func:`available` is False when the build or the load fails (no compiler,
no libpng or libjpeg headers), as in the JAX package; the datasets then
decode with cv2. That concerns the host decoder only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "frameio.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
LIBS = ("-ljpeg", "-lpng")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_lock = threading.Lock()


def library_path() -> str:
    """Where the library of the current source and flags is built."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libewvit_frameio-{digest[:16]}.so")


def _build(out: str) -> None:
    """Compile to a temporary name and rename it into place, so that two
    processes building at once never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError):
            _load_failed = True
            return None
        lib.ewvit_decode_batch.restype = ctypes.c_int
        lib.ewvit_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.ewvit_decode_file.restype = ctypes.c_uint64
        lib.ewvit_decode_file.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_batch(paths: List[str], out_size: int, crop_frac: float = 1.0,
                 nthreads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Decode, crop and resize N files -> (frames ``[N, S, S, 3]`` uint8, ok
    ``[N]`` bool).

    ``crop_frac`` keeps the central fraction of the centre square before
    resizing (224/450 is the reference's resize(450) -> crop(224)). A file
    that fails to decode comes back as a blank frame with ok False.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native frameio library unavailable")
    n = len(paths)
    out = np.zeros((n, out_size, out_size, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.ewvit_decode_batch(
        arr, n, out_size, crop_frac,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nthreads)
    return out, ok.astype(bool)


def decode_file(path: str) -> Optional[np.ndarray]:
    """Decode one image file -> RGB uint8 ``[H, W, 3]``, or None on failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native frameio library unavailable")
    hw = lib.ewvit_decode_file(path.encode(), None)
    if hw == 0:
        return None
    h, w = int(hw >> 32), int(hw & 0xFFFFFFFF)
    out = np.empty((h, w, 3), np.uint8)
    lib.ewvit_decode_file(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
