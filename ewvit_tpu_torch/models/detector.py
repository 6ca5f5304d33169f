"""DeepfakeDetector and the eval-mode video forward (ewvit_tpu/models/detector.py).

This slice ports the ``dynamic`` ablation mode: the ``dama`` subtree and the
``classifier`` head (reference names ``classifier.{0,3}``). The B0 SFEs, the
standalone MWT, ``fusion_gate`` (``sfe_only``/``sfe_mwt``) and train mode
come later.

:func:`video_forward` is the chunk loop of the JAX ``video_forward``
(detector.py:171-305) in eval mode: chunk = ``min(frame_chunk, K)``, the
ragged tail chunk is zero-padded to full size and masked out of the sums,
each chunk is flattened B-major (``[B, chunk] -> B*chunk``, so flattened row
``b*chunk + t`` meets positional row ``b*chunk + t`` as in the reference),
per-frame features are summed in fp32, divided by K, and the head runs on
the means.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from ewvit_tpu_torch.configs import ModelConfig
from ewvit_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from ewvit_tpu_torch.models.dama import DAMA
from ewvit_tpu_torch.models.norm import calibrate_batchnorm_
from ewvit_tpu_torch.models.sfe import EfficientViT
from ewvit_tpu_torch.ops.preprocess import preprocess_batch


class DeepfakeDetector(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.backbone_factory is not None:
            raise NotImplementedError("backbone_factory is a JAX-package test hook")
        self.cfg = cfg
        self.dama = DAMA(cfg)
        self.classifier = nn.Sequential(
            nn.Linear(cfg.dama_dim, 64), nn.ReLU(), nn.Dropout(0.3),
            nn.Linear(64, 1))

    def forward(self, frames) -> Dict[str, torch.Tensor]:
        """One flattened chunk ``[N, 3, H, W]`` -> per-frame dynamic features."""
        return self.dama(frames)


@torch.no_grad()
def init_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init on the model's device: lecun-normal conv/linear weights,
    zero biases, identity norms, N(0, 1) positional embedding and CLS token."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        elif isinstance(m, EfficientViT):
            m.pos_embedding.normal_(0.0, 1.0, generator=g)
            m.cls_token.normal_(0.0, 1.0, generator=g)
    return model


def build_detector(cfg: ModelConfig, *, device: DeviceLike = "cuda",
                   seed: int = 0) -> DeepfakeDetector:
    """Build the detector on ``device`` (CUDA unless the caller names the CPU)
    with seeded random weights, in eval mode. Load trained or converted
    weights with ``load_state_dict(..., strict=True)``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = DeepfakeDetector(cfg)
    model.to_empty(device=dev)
    return init_weights_(model, seed).eval()


@torch.no_grad()
def random_detector(cfg: ModelConfig, *, device: DeviceLike = "cuda", seed: int = 0,
                    calib_frames: int = 16) -> DeepfakeDetector:
    """Seeded random weights that keep a full-depth forward well scaled.

    With identity BatchNorm statistics the activations of the V2-S stack
    vanish and every request gets the same answer; so the backbone's BNs are
    calibrated on ``calib_frames`` seeded random uint8 frames (one train-mode
    pass, fp32), and the classifier's output layer is scaled by 0.1 so the
    logits stay O(1) and the probabilities unsaturated. Smoke tests and
    profiling use this; served weights come from ``load_state_dict``.
    """
    model = build_detector(cfg, device=device, seed=seed)
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    s = cfg.arch.image_size
    clips = torch.randint(0, 256, (1, calib_frames, s, s, cfg.in_channels),
                          generator=g, device=dev, dtype=torch.uint8)
    calibrate_batchnorm_(model.dama.sfe.efficient_net,
                         preprocess_batch(clips, torch.float32)[0])
    model.classifier[3].weight.mul_(0.1)
    return model


@torch.no_grad()
def video_forward(model: DeepfakeDetector, x: torch.Tensor, *,
                  frame_chunk: int = 8) -> Dict[str, torch.Tensor]:
    """``dynamic``-mode forward: ``x`` ``[B, K, 3, H, W]`` preprocessed frames
    -> ``{'logits': [B, 1], 'fused', 'space', 'freq': [B, dim]}``."""
    if model.training:
        raise NotImplementedError("train-mode video_forward is not ported yet")
    b, k = x.shape[:2]
    chunk = min(frame_chunk, k)
    d = model.cfg.dama_dim
    sums = {key: torch.zeros(b, d, dtype=torch.float32, device=x.device)
            for key in ("fused", "space", "freq")}
    for start in range(0, k, chunk):
        fr = x[:, start:start + chunk]
        valid = fr.shape[1]
        if valid < chunk:
            pad = fr.new_zeros((b, chunk - valid) + tuple(x.shape[2:]))
            fr = torch.cat([fr, pad], dim=1)
        out = model(fr.reshape(b * chunk, *x.shape[2:]))
        for key in sums:
            sums[key] += out[key].float().reshape(b, chunk, -1)[:, :valid].sum(dim=1)
    dt = compute_dtype(model.cfg.compute_dtype)
    means = {key: (v / k).to(dt) for key, v in sums.items()}
    return {"logits": model.classifier(means["fused"]), **means}
