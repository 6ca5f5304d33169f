"""Seeded weights for both sides, as a reference-layout state dict.

Made on the device from the seed in a few large calls: every convolution and
linear weight from one truncated normal draw (LeCun scaling, ``1/fan_in``
variance: a unit normal cut at +-2 divided by its standard deviation),
zero biases, identity norms, unit normal positional embeddings and CLS
tokens. Then the BatchNorm running statistics of the modules the mode runs
are calibrated: one train-mode forward of the benchmark's own reference
over frames of 32 distinct seeded clips sets each to its batch's
statistics, as trained ones would normalise, so a full-depth stack neither
vanishes nor explodes. (Statistics of one clip's frames alone would be
those of one scene: other clips then land many deviations away in some
channels, and the served outputs swing with the least rounding.) The two
logit heads' output layers are scaled by 0.1 so that the probabilities stay
away from 0 and 1.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from benchmark.lib import inputs
from benchmark.lib.common import derive
from benchmark.reference import model as ref

TRUNC_STD = 0.87962566103423978      # std of a unit normal truncated at +-2
CALIB_CLIPS, CALIB_FRAMES = 32, 2     # 64 rows: the reference's emb_dim cap


def _init_(model: nn.Module, seed: int) -> None:
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    weights = [m.weight for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    sizes = [w.numel() for w in weights]
    flat = torch.empty(sum(sizes), device=dev)
    nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    scale = torch.tensor([1.0 / math.sqrt(w[0].numel()) / TRUNC_STD for w in weights],
                         device=dev).repeat_interleave(torch.tensor(sizes, device=dev))
    flat.mul_(scale)
    with torch.no_grad():
        torch._foreach_copy_(weights, [v.view_as(w) for v, w in
                                       zip(flat.split(sizes), weights)])
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
                m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
        pos = [m for m in model.modules() if isinstance(m, ref.EfficientViT)]
        noise = torch.randn(sum(p.pos_embedding.numel() + p.cls_token.numel() for p in pos),
                            generator=g, device=dev)
        i = 0
        for p in pos:
            for t in (p.pos_embedding, p.cls_token):
                t.copy_(noise[i:i + t.numel()].view_as(t))
                i += t.numel()


@torch.no_grad()
def _calibrate_(model: ref.DeepfakeDetector, mode: str, frames: torch.Tensor,
                seed: int) -> None:
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = None          # cumulative average: one batch -> its statistics
    model.train()
    try:
        with ref.seeded(seed, frames.device):
            model(frames, mode)
    finally:
        model.eval()
        for m, mom in zip(bns, saved):
            m.momentum = mom
            m.num_batches_tracked.zero_()


def make_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of the configuration's detector for ``seed``, on
    ``device``, fp32."""
    model = ref.build(cfg, device)
    _init_(model, derive(seed, 1))
    size = cfg["image_size"]
    clips = inputs.clips(CALIB_CLIPS, CALIB_FRAMES, size, derive(seed, 2), device)
    frames = ref.preprocess(clips).reshape(-1, cfg["in_channels"], size, size)
    _calibrate_(model, cfg["mode"], frames, derive(seed, 3) & 0x7FFFFFFF)
    with torch.no_grad():
        model.classifier[3].weight.mul_(0.1)
        model.sfe_cls.mlp_head[2].weight.mul_(0.1)
    return {k: v.detach() for k, v in model.state_dict().items()}
