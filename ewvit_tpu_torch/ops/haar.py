"""Single-level 2-D Haar DWT, NCHW (counterpart of ewvit_tpu/ops/haar.py).

For each 2x2 block ``[[a, b], [c, d]]`` (rows = H, cols = W)::

    LL = (a + b + c + d) / 2      LH = (a + b - c - d) / 2
    HL = (a - b + c - d) / 2      HH = (a - b - c + d) / 2

``ll`` is ``[N, C, H/2, W/2]``; ``hf`` is ``[N, 3C, H/2, W/2]`` with channel
``c*3 + band`` and band order (LH, HL, HH): the reference's
``hf[0].reshape(B, 3*C, H//2, W//2)`` interleave, so ``hf[:, i*C:(i+1)*C]``
is the reference's per-input-channel slice.

- :func:`haar_dwt2d_plain` -- plain PyTorch, fp32 arithmetic rounded once to
  the input dtype (the TPU kernel's fp32 matmul does the same).
- :func:`haar_dwt2d` -- K1, the hand-written kernel ``csrc/haar.cu`` for a
  CUDA tensor; a CPU tensor takes the plain version. Forward only: an input
  that requires grad raises while grad is enabled, on either device. The
  MWT's DWT reads the frames and their LL bands, which depend on no
  parameter, so K1 runs in the training forward too.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ewvit_tpu_torch.ops import extension


def _check(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected [N, C, H, W], got {tuple(x.shape)}")
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"haar_dwt2d requires even spatial dims, got {tuple(x.shape[2:])}")


def haar_dwt2d_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x)
    n, c, h, w = x.shape
    xf = x.to(torch.float32)
    a = xf[:, :, 0::2, 0::2]
    b = xf[:, :, 0::2, 1::2]
    cc = xf[:, :, 1::2, 0::2]
    d = xf[:, :, 1::2, 1::2]
    ll = (a + b + cc + d) * 0.5
    lh = (a + b - cc - d) * 0.5
    hl = (a - b + cc - d) * 0.5
    hh = (a - b - cc + d) * 0.5
    hf = torch.stack([lh, hl, hh], dim=2).reshape(n, 3 * c, h // 2, w // 2)
    return ll.to(x.dtype), hf.to(x.dtype)


def haar_idwt2d(ll: torch.Tensor, hf: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`haar_dwt2d_plain` (perfect reconstruction)."""
    n, c, h2, w2 = ll.shape
    hf = hf.reshape(n, c, 3, h2, w2)
    lh, hl, hh = hf[:, :, 0], hf[:, :, 1], hf[:, :, 2]
    x = ll.new_empty(n, c, 2 * h2, 2 * w2)
    x[:, :, 0::2, 0::2] = (ll + lh + hl + hh) * 0.5
    x[:, :, 0::2, 1::2] = (ll + lh - hl - hh) * 0.5
    x[:, :, 1::2, 0::2] = (ll - lh + hl - hh) * 0.5
    x[:, :, 1::2, 1::2] = (ll - lh - hl + hh) * 0.5
    return x


def haar_dwt2d(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on a CUDA tensor, :func:`haar_dwt2d_plain` on a CPU tensor."""
    extension.refuse_autograd("use_pallas_dwt", x)
    if x.device.type == "cpu":
        return haar_dwt2d_plain(x)
    _check(x)
    extension.check_cuda_tensor(x, "x")
    n, c, h, w = x.shape
    ll = torch.empty(n, c, h // 2, w // 2, dtype=x.dtype, device=x.device)
    hf = torch.empty(n, 3 * c, h // 2, w // 2, dtype=x.dtype, device=x.device)
    if n == 0:       # a rank's empty share of a training chunk: nothing to launch
        return ll, hf
    extension.launch("haar", "ewvit_haar_dwt2d", "haar_dwt2d",
                     x.data_ptr(), ll.data_ptr(), hf.data_ptr(),
                     n, c, h, w, extension.dtype_code(x))
    return ll, hf
