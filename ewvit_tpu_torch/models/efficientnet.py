"""EfficientNetV2-S feature extractor, NCHW (ewvit_tpu/models/efficientnet.py).

Module layout is torchvision's ``efficientnet_v2_s().features`` so state
dicts carry the reference names ``features.S.R.block.J...``: stem
``features.0``, one ``nn.Sequential`` per stage, head ``features.{S+1}``.
Convs use symmetric ``(k-1)//2`` padding, BN eps 1e-3 and torch momentum 0.1
(flax 0.9), SiLU, and SE squeeze ``max(1, int(in * 0.25))``.

With ``use_pallas_dwse`` an eval-mode stride-1 SE ``MBConv`` folds its
depthwise BN into ``w_eff``/``shift`` and runs K2 (``ops/dw_se.py``), whose
fp32 spatial mean feeds the SE in place of a second read of y
(efficientnet.py:301-314). Stride-2 SE blocks stay plain. B0 waits for the
``sfe_only``/``sfe_mwt`` slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ewvit_tpu_torch.configs import V2S_FULL, BackboneSpec
from ewvit_tpu_torch.models.norm import BatchNorm2d
from ewvit_tpu_torch.ops.dw_se import dw_bn_silu_mean


class ConvBNAct(nn.Sequential):
    """torchvision Conv2dNormActivation: ``0`` conv, ``1`` BN, ``2`` SiLU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, act: bool = True):
        layers = [nn.Conv2d(cin, cout, kernel, stride, padding=(kernel - 1) // 2,
                            groups=groups, bias=False),
                  BatchNorm2d(cout, eps=1e-3, momentum=0.1)]
        if act:
            layers.append(nn.SiLU())
        super().__init__(*layers)


class SqueezeExcitation(nn.Module):
    """GAP -> fc1 (1x1) -> SiLU -> fc2 (1x1) -> sigmoid gate."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x, mean=None):
        s = x.mean(dim=(2, 3), keepdim=True) if mean is None else mean.to(x.dtype)
        s = self.fc2(F.silu(self.fc1(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Inverted residual: [expand] -> depthwise -> SE -> project (+ residual)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 expand: int, se_ratio: float, use_pallas_dwse: bool = False):
        super().__init__()
        if se_ratio <= 0:
            raise ValueError("V2-S MBConv blocks all carry squeeze-excite (se_ratio > 0)")
        exp = cin * expand
        self.kernel = kernel
        self.use_res = stride == 1 and cin == cout
        self.has_expand = expand != 1
        self.fuse_dwse = use_pallas_dwse and stride == 1
        layers = [ConvBNAct(cin, exp, 1)] if self.has_expand else []
        layers.append(ConvBNAct(exp, exp, kernel, stride, groups=exp))
        layers.append(SqueezeExcitation(exp, max(1, int(cin * se_ratio))))
        layers.append(ConvBNAct(exp, cout, 1, act=False))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        i = int(self.has_expand)
        h = self.block[0](x) if self.has_expand else x
        dw, se, project = self.block[i], self.block[i + 1], self.block[i + 2]
        if self.fuse_dwse and not self.training:
            conv, bn = dw[0], dw[1]
            scale, shift = bn.folded()
            c, k = conv.out_channels, self.kernel
            w_eff = (conv.weight.float().reshape(c, k * k).t() * scale).contiguous()
            y, m = dw_bn_silu_mean(h, w_eff, shift.contiguous(), k)
            h = se(y, mean=m[:, :, None, None])
        else:
            h = se(dw(h))
        h = project(h)
        return x + h if self.use_res else h


class FusedMBConv(nn.Module):
    """V2 early stages: a full k x k conv replaces expand + depthwise."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, expand: int):
        super().__init__()
        self.use_res = stride == 1 and cin == cout
        if expand != 1:
            layers = [ConvBNAct(cin, cin * expand, kernel, stride),
                      ConvBNAct(cin * expand, cout, 1, act=False)]
        else:
            layers = [ConvBNAct(cin, cout, kernel, stride)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        h = self.block(x)
        return x + h if self.use_res else h


class EfficientNetV2S(nn.Module):
    """[N, 3, H, W] -> [N, head_ch, H/32, W/32] (eval; stochastic depth is identity)."""

    def __init__(self, spec: BackboneSpec = V2S_FULL, use_pallas_dwse: bool = False):
        super().__init__()
        stages = [ConvBNAct(3, spec.stem_ch, 3, 2)]
        for cfg in spec.blocks:
            blocks = []
            for r in range(cfg.repeats):
                cin = cfg.in_ch if r == 0 else cfg.out_ch
                stride = cfg.stride if r == 0 else 1
                if cfg.fused:
                    blocks.append(FusedMBConv(cin, cfg.out_ch, cfg.kernel, stride,
                                              cfg.expand))
                else:
                    blocks.append(MBConv(cin, cfg.out_ch, cfg.kernel, stride,
                                         cfg.expand, cfg.se_ratio,
                                         use_pallas_dwse=use_pallas_dwse))
            stages.append(nn.Sequential(*blocks))
        stages.append(ConvBNAct(spec.blocks[-1].out_ch, spec.head_ch, 1))
        self.features = nn.Sequential(*stages)

    def forward(self, x):
        return self.features(x)
