"""The MWT's multiscale_fusion as one Winograd kernel (ewvit_tpu/ops/mwt_tail.py).

The MWT frequency branch ends in (reference mwt.py:60-72, :113-117)::

    y_l   = hf_fusion(level l)                       # L maps [N, C, H, W]
    fused = relu(bn(conv3x3(concat_l y_l) + b))      # multiscale_fusion
    freq  = freq_conv(fused)                         # stride 2

``multiscale_fusion`` is the model's FLOP-dominant conv. In eval mode BN is
an affine per output channel, so the whole op is::

    fused = relu(conv3x3(concat_l y_l; W . scale) + (b . scale + shift))

computed by Winograd F(2x2,3x3) with the BN scale folded into U
(:func:`multiscale_winograd_u`) and one fp32 bias.

The TPU kernel reads and writes phase-split arrays because Mosaic cannot
read stride-2 lanes; the port's kernel reads the level maps dense, NCHW, and
writes the dense output, so the JAX package's ``phase_conv_paddings`` and
``freq_from_phases`` (layout plumbing for Mosaic) have no counterpart here:
``hf_fusion`` and ``freq_conv`` stay ordinary convs.

- :func:`multiscale_winograd_u` -- weight ``[C, L*C, 3, 3]`` and BN scale ->
  U ``[L, 16, C, C]`` in the compute dtype.
- :func:`fused_multiscale_winograd_plain` -- plain PyTorch version.
- :func:`fused_multiscale_winograd` -- K3, the hand-written kernel
  ``csrc/winograd.cu`` (the core it shares with K5) for CUDA tensors; CPU
  tensors take the plain version. It packs U, then calls
- :func:`fused_multiscale_winograd_packed` -- K3 on U and bias prepared once
  by :func:`pack_tail` (the MWT keeps them between calls).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops.winograd import (
    input_transform,
    output_transform,
    pack_u,
    packed_u_shape,
    transform_weights,
)

MAX_LEVELS = 4   # csrc/winograd.cu kMaxLevels


def multiscale_winograd_u(weight: torch.Tensor, bn_scale: torch.Tensor,
                          levels: int, dtype: torch.dtype) -> torch.Tensor:
    """``[C, L*C, 3, 3]`` conv weight (as stored: the compute dtype when
    served) times the fp32 BN scale per output channel, transformed in fp32
    per level, cast to ``dtype`` -> ``[L, 16, C, C]``."""
    c = weight.shape[0]
    w = weight.to(torch.float32) * bn_scale.to(torch.float32)[:, None, None, None]
    us = [transform_weights(w[:, lvl * c:(lvl + 1) * c]).reshape(16, c, c)
          for lvl in range(levels)]
    return torch.stack(us).to(dtype)


def _check(ys: Sequence[torch.Tensor], u: torch.Tensor, bias: torch.Tensor) -> None:
    if not 1 <= len(ys) <= MAX_LEVELS:
        raise ValueError(f"expected 1 to {MAX_LEVELS} level maps, got {len(ys)}")
    shape, dtype = tuple(ys[0].shape), ys[0].dtype
    if len(shape) != 4 or any(tuple(y.shape) != shape or y.dtype != dtype for y in ys):
        raise ValueError("level maps must share one [N, C, H, W] shape and dtype")
    n, c, h, w = shape
    if h % 2 or w % 2:
        raise ValueError(f"Winograd F(2x2,3x3) needs even H and W, got {(h, w)}")
    if tuple(u.shape) != (len(ys), 16, c, c) or tuple(bias.shape) != (c,):
        raise ValueError(f"expected u [{len(ys)}, 16, {c}, {c}] and bias [{c}], got "
                         f"{tuple(u.shape)} and {tuple(bias.shape)}")


def fused_multiscale_winograd_plain(ys: Sequence[torch.Tensor], u: torch.Tensor,
                                    bias: torch.Tensor) -> torch.Tensor:
    """``relu(conv3x3(concat(ys)) . scale + bias)`` with the scale in ``u``.

    ``ys``: L maps ``[N, C, H, W]`` (H, W even); ``u``: ``[L, 16, C, C]``;
    ``bias``: ``[C]`` fp32. V is rounded to the maps' dtype, products and
    sums are fp32, the output is rounded once.
    """
    _check(ys, u, bias)
    n, c, h, w = ys[0].shape
    cdt = ys[0].dtype
    m = None
    for lvl, y in enumerate(ys):
        v = input_transform(y).to(cdt).to(torch.float32)
        ul = u[lvl].to(torch.float32)
        m = torch.bmm(v, ul) if m is None else torch.baddbmm(m, v, ul)
    out = output_transform(m, n, h // 2, w // 2) + bias.to(torch.float32)[:, None, None]
    return torch.relu(out).to(cdt)


def pack_tail(u: torch.Tensor, bias: torch.Tensor):
    """U ``[L, 16, C, C]`` and bias ``[C]`` -> ``(up, b32)`` for
    :func:`fused_multiscale_winograd_packed`: on the card U packed for the
    kernel (:func:`pack_u`), on the CPU U as it is (the plain version's
    layout); the bias in fp32."""
    b32 = bias.to(torch.float32).contiguous()
    return (u if u.device.type == "cpu" else pack_u(u, u.dtype)), b32


def fused_multiscale_winograd_packed(ys: Sequence[torch.Tensor], up: torch.Tensor,
                                     b32: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA tensors with ``(up, b32)`` from :func:`pack_tail`;
    :func:`fused_multiscale_winograd_plain` on CPU tensors."""
    if ys[0].device.type == "cpu":
        return fused_multiscale_winograd_plain(ys, up, b32)
    n, c, h, w = ys[0].shape
    if not 1 <= len(ys) <= MAX_LEVELS or any(
            tuple(y.shape) != (n, c, h, w) or y.dtype != ys[0].dtype for y in ys):
        raise ValueError(f"expected 1 to {MAX_LEVELS} level maps of one shape and dtype")
    if h % 2 or w % 2:
        raise ValueError(f"Winograd F(2x2,3x3) needs even H and W, got {(h, w)}")
    for lvl, y in enumerate(ys):
        extension.check_cuda_tensor(y, f"ys[{lvl}]")
    if tuple(up.shape) != packed_u_shape(len(ys), c, c, ys[0].dtype):
        raise ValueError(f"packed U has shape {tuple(up.shape)}, expected "
                         f"{packed_u_shape(len(ys), c, c, ys[0].dtype)}")
    extension.check_cuda_tensor(up, "up", ys[0].dtype)
    extension.check_cuda_tensor(b32, "b32", torch.float32)
    if tuple(b32.shape) != (c,):
        raise ValueError(f"expected bias [{c}], got {tuple(b32.shape)}")
    out = torch.empty_like(ys[0])
    ptrs = (ctypes.c_void_p * len(ys))(*[y.data_ptr() for y in ys])
    extension.launch("winograd", "ewvit_fused_multiscale_winograd",
                     "fused_multiscale_winograd", ptrs, up.data_ptr(), b32.data_ptr(),
                     out.data_ptr(), n, len(ys), c, h, w, extension.dtype_code(ys[0]))
    return out


def fused_multiscale_winograd(ys: Sequence[torch.Tensor], u: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA tensors, :func:`fused_multiscale_winograd_plain` on CPU tensors."""
    if ys[0].device.type == "cpu":
        return fused_multiscale_winograd_plain(ys, u, bias)
    _check(ys, u, bias)
    return fused_multiscale_winograd_packed(ys, *pack_tail(u.to(ys[0].dtype), bias))
