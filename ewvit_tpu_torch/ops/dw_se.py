"""Fused depthwise conv + BN + SiLU + spatial mean, NCHW (inference).

Counterpart of ewvit_tpu/ops/dw_se.py:dw_bn_silu_mean. In every stride-1
squeeze-excite MBConv of V2-S::

    y = silu(dwconv_kxk_same(x) . w_eff + shift)      (BN folded into w_eff)
    mean = spatial mean of y in fp32                   (the SE squeeze)

y is stored in ``x.dtype`` and the mean is taken over the ROUNDED y, as the
TPU kernel does, so the SE input is the same whichever version ran.

- :func:`dw_bn_silu_mean_plain` -- plain PyTorch (fp32 grouped conv).
- :func:`dw_bn_silu_mean` -- K2, the hand-written kernel ``csrc/dw_se.cu``
  for a CUDA tensor; a CPU tensor takes the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ewvit_tpu_torch.ops import extension


def _check(x: torch.Tensor, w_eff: torch.Tensor, shift: torch.Tensor, kernel: int):
    if kernel not in (3, 5):
        raise ValueError(f"kernel must be 3 or 5 (odd, stride-1 SAME), got {kernel}")
    if x.dim() != 4:
        raise ValueError(f"expected x [N, C, H, W], got {tuple(x.shape)}")
    c = x.shape[1]
    if tuple(w_eff.shape) != (kernel * kernel, c) or tuple(shift.shape) != (c,):
        raise ValueError(
            f"w_eff must be [{kernel * kernel}, {c}] and shift [{c}], got "
            f"{tuple(w_eff.shape)} and {tuple(shift.shape)}")


def dw_bn_silu_mean_plain(x: torch.Tensor, w_eff: torch.Tensor,
                          shift: torch.Tensor, kernel: int = 3
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, w_eff, shift, kernel)
    c = x.shape[1]
    wk = w_eff.to(torch.float32).t().reshape(c, 1, kernel, kernel)
    acc = F.conv2d(x.to(torch.float32), wk, shift.to(torch.float32),
                   padding=kernel // 2, groups=c)
    y = F.silu(acc).to(x.dtype)
    return y, y.to(torch.float32).mean(dim=(2, 3))


def dw_bn_silu_mean(x: torch.Tensor, w_eff: torch.Tensor, shift: torch.Tensor,
                    kernel: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on a CUDA tensor, :func:`dw_bn_silu_mean_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return dw_bn_silu_mean_plain(x, w_eff, shift, kernel)
    _check(x, w_eff, shift, kernel)
    extension.check_cuda_tensor(x, "x")
    extension.check_cuda_tensor(w_eff, "w_eff", torch.float32)
    extension.check_cuda_tensor(shift, "shift", torch.float32)
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(n, c, dtype=torch.float32, device=x.device)
    extension.launch("dw_se", "ewvit_dw_bn_silu_mean", "dw_bn_silu_mean",
                     x.data_ptr(), w_eff.data_ptr(), shift.data_ptr(),
                     y.data_ptr(), mean.data_ptr(), n, c, h, w, kernel,
                     extension.dtype_code(x))
    return y, mean
