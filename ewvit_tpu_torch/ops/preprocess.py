"""Device preprocessing (counterpart of ewvit_tpu/ops/preprocess.py).

uint8 clips arrive in the host layout ``[B, K, H, W, 3]``; the model runs
NCHW, so the channel axis moves ahead of the spatial axes in the same pass:
``/255 -> [train: colour jitter] -> ImageNet normalize -> dtype``, all in
fp32 until the last cast. Plain PyTorch: this is not a Pallas kernel in the
JAX package either.

Colour jitter (train only) is torchvision's ``ColorJitter(brightness=0.01,
contrast=0.01)`` per image, as the JAX package's ``color_jitter``
(preprocess.py:44-71): factors uniform in ``[1-b, 1+b]`` and ``[1-c, 1+c]``,
brightness and contrast in an order drawn per image, contrast blending with
the mean of the ITU-R 601-2 luma, each result clipped to ``[0, 1]``. It is
split into :func:`draw_jitter` (the random draws, from an explicit
``torch.Generator``; under ``models/rows.global_rows`` drawn for the global
batch and this rank's rows taken) and :func:`apply_jitter` (deterministic), so that the
same draws can be replayed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ewvit_tpu_torch.models import rows

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)          # torchvision rgb_to_grayscale


def draw_jitter(batch_shape: Tuple[int, ...], generator: torch.Generator,
                brightness: float = 0.01, contrast: float = 0.01
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image (brightness factor, contrast factor, brightness first?),
    each of ``batch_shape``, on the generator's device."""
    dev = generator.device
    split = rows.current(batch_shape[0])
    if split is not None:         # this rank's rows of the global draws
        return tuple(t.index_select(0, split.index) for t in draw_jitter(
            (split.total, *batch_shape[1:]), generator, brightness, contrast))

    def uniform(r):
        return (1.0 - r) + 2.0 * r * torch.rand(batch_shape, generator=generator, device=dev)

    bf, cf = uniform(brightness), uniform(contrast)
    order = torch.rand(batch_shape, generator=generator, device=dev) < 0.5
    return bf, cf, order


def apply_jitter(x: torch.Tensor, bf: torch.Tensor, cf: torch.Tensor,
                 order: torch.Tensor) -> torch.Tensor:
    """fp32 ``[..., 3, H, W]`` images in ``[0, 1]`` with the draws of
    :func:`draw_jitter` (each of shape ``x.shape[:-3]``): contrast after
    brightness where ``order``, before it elsewhere."""
    bf, cf, order = (t[..., None, None, None] for t in (bf, cf, order))
    luma = torch.tensor(LUMA, dtype=x.dtype, device=x.device)[:, None, None]

    def bright(img):
        return (img * bf).clamp(0.0, 1.0)

    def contr(img):
        mean = (img * luma).sum(dim=-3, keepdim=True).mean(dim=(-2, -1), keepdim=True)
        return (mean + cf * (img - mean)).clamp(0.0, 1.0)

    return torch.where(order, contr(bright(x)), bright(contr(x)))


def preprocess_batch(frames: torch.Tensor, dtype: torch.dtype = torch.bfloat16, *,
                     train: bool = False,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """uint8 ``[B, K, H, W, 3]`` -> normalized ``[B, K, 3, H, W]`` in ``dtype``;
    ``train`` adds the colour jitter, drawn from ``generator``."""
    if frames.dim() != 5 or frames.shape[-1] != 3:
        raise ValueError(f"expected [B, K, H, W, 3] clips, got {tuple(frames.shape)}")
    x = frames.permute(0, 1, 4, 2, 3).to(torch.float32) / 255.0
    if train:
        if generator is None:
            raise ValueError("train preprocessing draws its jitter from a generator")
        x = apply_jitter(x, *draw_jitter(tuple(x.shape[:2]), generator))
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    x = (x - mean[:, None, None]) / std[:, None, None]
    return x.to(dtype).contiguous()
