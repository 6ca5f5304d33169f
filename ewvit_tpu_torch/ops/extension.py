"""Build, load and count the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first use
by ``nvcc`` for ``sm_90a`` into its own shared library under
``ewvit_tpu_torch/_build/`` (git-ignored), then loaded with ``ctypes``. The
library name carries a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. :func:`build_all` starts
one ``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: a machine without ``nvcc`` or a GPU (the CPU
tests) imports the package, and the wrappers take their plain PyTorch versions
for CPU tensors without ever reaching this module's build step.

Every wrapper adds one to :data:`LAUNCHES` at the point where it launches its
kernel, and nowhere else, so a caller can show that a run went through the
kernels (``reset_launches`` / ``LAUNCHES``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    # EWVIT_NVCC_EXTRA: more flags for an ablation build (winograd_ablation.py);
    # they enter the library's hash like the rest
    *os.environ.get("EWVIT_NVCC_EXTRA", "").split(),
)

# source stem -> C entry points it exports (argtypes set at load time)
_C_VOID_P, _C_INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "haar": {
        # x, ll, hf, n, c, h, w, dtype, stream
        "ewvit_haar_dwt2d": [_C_VOID_P] * 3 + [_C_INT] * 5 + [_C_VOID_P],
    },
    "dw_se": {
        # x, packed weights, y, mean, n, c, h, w, k, dtype, group, band_rows,
        # stages, strip, grid, stream (ops/dw_se.py DwsePlan)
        "ewvit_dw_bn_silu_mean": [_C_VOID_P] * 4 + [_C_INT] * 11 + [_C_VOID_P],
        # n, c, h, w, k, dtype, group, band_rows, stages, strip -> bytes or -1
        "ewvit_dw_se_smem_bytes": [_C_INT] * 10,
    },
    "fused_attention": {
        # space, freq, packed (ops/fused_attention.py pack_xattn), so, fo, n,
        # depth, heads, dtype, stream
        "ewvit_fused_bidir_xattn_cluster":
            [_C_VOID_P] * 5 + [_C_INT] * 4 + [_C_VOID_P],
        # -> cudaOccupancyMaxActiveClusters of a launch (-cudaError_t on failure)
        "ewvit_xattn_cluster_max_active": [],
        # space, freq, mats, smalls, so, fo, n, d, depth, heads, dtype, stream
        "ewvit_fused_bidir_xattn_general":
            [_C_VOID_P] * 6 + [_C_INT] * 5 + [_C_VOID_P],
    },
    "winograd": {
        # ys (array of level pointers), u, bias, out, n, levels, c, h, w,
        # dtype, stream
        "ewvit_fused_multiscale_winograd":
            [ctypes.POINTER(_C_VOID_P)] + [_C_VOID_P] * 3 + [_C_INT] * 6 + [_C_VOID_P],
        # x, u, out, n, cin, cout, h, w, dtype, stream
        "ewvit_conv3x3_winograd": [_C_VOID_P] * 3 + [_C_INT] * 6 + [_C_VOID_P],
        # x, w: bytes per copy of the bf16 kernel's halo interior (8 or 4)
        "ewvit_winograd_halo_copy_bytes": [_C_VOID_P, _C_INT],
    },
}

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {
    "haar_dwt2d": 0,
    "dw_bn_silu_mean": 0,
    "fused_bidirectional_cross_attention": 0,          # K4's cluster kernel (D = 128)
    "fused_bidirectional_cross_attention_general": 0,  # K4 at other widths
    "fused_multiscale_winograd": 0,
    "conv3x3_winograd": 0,
    # not a kernel: U folds and packs for K3 on the card (models/mwt.py), each
    # several PyTorch launches; the served fused tail keeps U, so a request
    # adds none
    "winograd_u_fold": 0,
    # not a kernel either: K2's BN folds and packs on the card
    # (models/efficientnet.py), kept per model like U
    "dw_se_fold": 0,
    # nor this: K4's weight packs on the card (models/layers.py), kept per
    # model like U
    "xattn_pack": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def find_nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cands:
        path = os.path.join(root, "bin", "nvcc") if root else ""
        if path and os.access(path, os.X_OK):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def _lib_path(stem: str) -> str:
    h = hashlib.sha256()
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname == f"{stem}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(fname.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def _start_build(stem: str, nvcc: str, out: str):
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
           os.path.join(CSRC_DIR, f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return stem, proc, tmp, out


def _finish_build(stem: str, proc: subprocess.Popen, tmp: str, out: str) -> str:
    log, _ = proc.communicate()
    with open(out[:-3] + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{stem}.cu (rc={proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def _load(stem: str, path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, argtypes in _SIGNATURES[stem].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all(stems: Iterable[str] = tuple(_SIGNATURES)) -> Dict[str, str]:
    """Build (in parallel) and load every listed source; returns nvcc logs.

    Sources whose library already exists are loaded without a build and get
    an empty log.
    """
    stems = list(stems)
    logs: Dict[str, str] = {}
    with _LOCK:
        todo = [s for s in stems if s not in _LIBS]
        os.makedirs(BUILD_DIR, exist_ok=True)
        builds: List[tuple] = []
        nvcc = None
        try:
            for s in todo:
                out = _lib_path(s)
                if os.path.exists(out):
                    logs[s] = ""
                    continue
                nvcc = nvcc or find_nvcc()
                builds.append(_start_build(s, nvcc, out))
            for b in builds:
                logs[b[0]] = _finish_build(*b)
        finally:
            for _, proc, _, _ in builds:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for s in todo:
            _LIBS[s] = _load(s, _lib_path(s))
    return logs


def library(stem: str) -> ctypes.CDLL:
    lib = _LIBS.get(stem)
    if lib is None:
        build_all([stem])
        lib = _LIBS[stem]
    return lib


def check_cuda_tensor(t: torch.Tensor, name: str, dtype=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor (of ``dtype``)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def dtype_code(t: torch.Tensor) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {t.dtype} (float32 or bfloat16)")
    return code


def autocast_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a kernel takes ``t`` in: autocast's dtype where autocast is
    on for ``t``'s device (an eval forward of fp32 weights under
    ``torch.autocast``, as the ``Trainer``'s val epoch runs), else ``t``'s
    own. Autocast does not reach a kernel called through ctypes, so its
    wrapper's caller casts."""
    dev = t.device.type
    if t.is_floating_point() and torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return t.dtype


def refuse_autograd(flag: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record a kernel on ``tensors``.

    No kernel here has a backward, and none of the JAX package's kernels does
    either (``jax.grad`` through them fails). So a kernel whose input, or a
    parameter that its kept weights are folded from, requires grad while grad
    is enabled raises instead of cutting the graph and leaving those
    parameters without a gradient. ``flag`` is the config field that routes
    the path through the kernel. Serving runs under ``no_grad``; training
    routes around K2, K3 and K4 and runs K1 on frames, which need no grad.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{flag}: this kernel has no backward, and autograd is recording "
            "a tensor it reads; run it under torch.no_grad() (serving), put "
            f"the module in train mode, or turn {flag} off")


def launch(stem: str, fn: str, counter: str, *args) -> None:
    """Call a C entry point on the current stream and count the launch.

    Pointers and ints arrive already converted; the stream is appended here.
    A nonzero return is the ``cudaError_t`` of the launch, and raises;
    ``cudaErrorInvalidValue`` (1) is also how a kernel refuses a shape it
    does not take (e.g. a plane too large for its shared memory).
    """
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(library(stem), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError_t {rc}")
    LAUNCHES[counter] += 1
