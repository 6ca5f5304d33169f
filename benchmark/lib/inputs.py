"""Clips and labels made from the seed, on the device, in a few large calls.

A clip is K uint8 frames ``[K, S, S, 3]`` of one scene: a smooth random
image (a coarse grid of random colours, upsampled bilinearly) seen through a
window that pans ``PAN`` grid cells across the scene over the clip, in a
direction of its own, plus pixel noise; each clip has its own scene,
contrast and noise level. So every clip, and every frame, differs: the
detector's outputs differ from clip to clip, and the first half of a clip's
frames does not show what the whole clip shows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GRID = 7          # coarse colour grid cells a frame shows across
PAN = 8           # grid cells a clip's view travels over its frames


def clips(n: int, frames: int, size: int, seed: int, device) -> torch.Tensor:
    """uint8 ``[n, frames, size, size, 3]`` on ``device``, a function of ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    span = GRID + 2 + PAN                       # the scene's grid points
    scene = torch.rand(n, 3, span, span, generator=g, device=device)
    contrast = 0.3 + 0.7 * torch.rand(n, 1, 1, 1, 1, generator=g, device=device)
    noise = 0.02 + 0.08 * torch.rand(n, 1, 1, 1, 1, generator=g, device=device)
    angle = 2 * math.pi * torch.rand(n, generator=g, device=device)
    cell = 2.0 / (span - 1)                     # one grid cell in grid_sample's units
    # the view's centre moves from -PAN/2 to +PAN/2 cells along the clip's
    # direction, frame by frame
    along = (torch.linspace(0.0, 1.0, frames, device=device) - 0.5) * PAN * cell
    way = torch.stack([angle.cos(), angle.sin()], dim=-1)
    centre = along[None, :, None] * way[:, None, :]
    base = torch.linspace(-1.0, 1.0, size, device=device) * GRID / 2 * cell
    gy, gx = torch.meshgrid(base, base, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)[None, None] + centre[:, :, None, None, :]
    img = F.grid_sample(scene.repeat_interleave(frames, 0),
                        grid.reshape(n * frames, size, size, 2), mode="bilinear",
                        align_corners=True).reshape(n, frames, 3, size, size)
    img = 0.5 + contrast * (img - 0.5)
    img = img + noise * torch.randn(img.shape, generator=g, device=device)
    u8 = (img.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
    return u8.permute(0, 1, 3, 4, 2).contiguous()


def balanced_labels(micro_batches: int, batch: int, seed: int, device) -> torch.Tensor:
    """fp32 ``[micro_batches * batch]``: each micro-batch half real (0) and
    half fake (1), in an order drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    one = torch.arange(batch, device=device) % 2
    order = torch.rand(micro_batches, batch, generator=g, device=device).argsort(dim=1)
    return one[order].reshape(-1).float()
