"""Eval-mode device preprocessing (counterpart of ewvit_tpu/ops/preprocess.py:73).

uint8 clips arrive in the host layout ``[B, K, H, W, 3]``; the model runs
NCHW, so the channel axis moves ahead of the spatial axes in the same pass:
``/255 -> ImageNet normalize -> compute dtype``. Plain PyTorch: this is not a
Pallas kernel in the JAX package either. Colour jitter waits for training.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_batch(frames: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 ``[B, K, H, W, 3]`` -> normalized ``[B, K, 3, H, W]`` in ``dtype``."""
    if frames.dim() != 5 or frames.shape[-1] != 3:
        raise ValueError(f"expected [B, K, H, W, 3] clips, got {tuple(frames.shape)}")
    x = frames.permute(0, 1, 4, 2, 3).to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    x = (x - mean[:, None, None]) / std[:, None, None]
    return x.to(dtype).contiguous()
