"""EfficientNet-B0 and EfficientNetV2-S feature extractors, NCHW
(ewvit_tpu/models/efficientnet.py).

- :class:`EfficientNetB0` has efficientnet_pytorch's module layout, so state
  dicts carry the reference names: ``_conv_stem``, ``_bn0``, ``_blocks.{i}``
  (``i`` flat across stages) with ``_expand_conv``, ``_bn0``,
  ``_depthwise_conv``, ``_bn1``, ``_se_reduce``, ``_se_expand``,
  ``_project_conv``, ``_bn2``, then ``_conv_head``, ``_bn1``. Convs with
  k > 1 take TensorFlow's 'SAME' padding (:class:`Conv2dSame`: asymmetric
  at stride 2, symmetric at stride 1 for odd k), BN eps 1e-3 and torch
  momentum 0.01 (flax 0.99).
- :class:`EfficientNetV2S` has torchvision's ``efficientnet_v2_s().features``
  layout: names ``features.S.R.block.J...``, stem ``features.0``, one
  ``nn.Sequential`` per stage, head ``features.{S+1}``. Convs use symmetric
  ``(k-1)//2`` padding, BN eps 1e-3 and torch momentum 0.1 (flax 0.9).

Both use SiLU and an SE squeeze of ``max(1, int(in * 0.25))`` from the block
input. Every block records its stochastic-depth rate ``0.2 * idx / total``
(``idx`` flat over the backbone's blocks, efficientnet.py:377-395); in train
mode a residual block drops its branch per row (:func:`stochastic_depth`),
drawing from torch's default generator, which the train forward seeds per
chunk (``models/detector.py``). In train mode BN uses batch statistics and
updates its running ones. With ``use_pallas_dwse`` an eval-mode stride-1 SE
block of either backbone (:class:`DepthwiseSE`) folds its depthwise BN into
``w_eff``/``shift`` and runs K2 (``ops/dw_se.py``), whose fp32 spatial mean
feeds the SE in place of a second read of y (efficientnet.py:301-314). The
fold, packed for the kernel, is kept per model in eval mode (computed at
``serving.cast_for_inference`` or the first call, dropped on ``train()``,
``load_state_dict`` and ``drop_kept_weights()``, and folded again after an
in-place edit of the tensors it reads; ``models/kept.py``), so a request
folds nothing. Stride-2 SE blocks and train mode stay plain (as in the JAX
package, efficientnet.py:301); an eval forward with grad enabled on K2's
path raises (``extension.refuse_autograd``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ewvit_tpu_torch.configs import B0_FULL, V2S_FULL, BackboneSpec
from ewvit_tpu_torch.models.kept import KeepsWeights, version_key
from ewvit_tpu_torch.models import rows
from ewvit_tpu_torch.models.norm import BatchNorm2d
from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops.dw_se import dw_bn_silu_mean_packed, pack_dwse


def same_padding(h: int, w: int, kernel: int, stride: int):
    """TensorFlow 'SAME' padding as ``F.pad``'s ``(left, right, top, bottom)``:
    per side a total of ``max((ceil(n/s) - 1) * s + k - n, 0)``, ``total // 2``
    before and the rest after."""
    def split(n):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        return total // 2, total - total // 2
    return (*split(w), *split(h))


class Conv2dSame(nn.Conv2d):
    """Bias-free conv with TF 'SAME' padding from the input's size
    (efficientnet_pytorch's ``Conv2dStaticSamePadding`` at that size)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1):
        super().__init__(cin, cout, kernel, stride, padding=0, groups=groups, bias=False)

    def forward(self, x):
        pad = same_padding(*x.shape[2:], self.kernel_size[0], self.stride[0])
        return super().forward(F.pad(x, pad) if any(pad) else x)


DROP_CONNECT_RATE = 0.2       # both backbones (ewvit_tpu/models/efficientnet.py:367)


def stochastic_depth(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """Row-mode stochastic depth on a residual branch (efficientnet.py:261-268):
    one Bernoulli(keep) per row; a kept row is ``x / keep``, a dropped row 0.
    Under ``models/rows.global_rows`` the draw is for the global rows."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = rows.draw((x.shape[0],) + (1,) * (x.dim() - 1),
                     lambda shape: torch.empty(shape, device=x.device).bernoulli_(keep))
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def squeeze_excite(x, reduce: nn.Conv2d, expand: nn.Conv2d, mean=None):
    """GAP (or the given fp32 ``mean``) -> reduce (1x1) -> SiLU -> expand
    (1x1) -> sigmoid gate on ``x``."""
    s = x.mean(dim=(2, 3), keepdim=True) if mean is None else mean.to(x.dtype)
    return x * torch.sigmoid(expand(F.silu(reduce(s))))


class DepthwiseSE(KeepsWeights):
    """The depthwise conv + BN + SiLU and SE of an inverted-residual block,
    shared by the V2-S :class:`MBConv` and the B0 :class:`MBConvBlock`:
    with ``fuse_dwse`` (``use_pallas_dwse`` and stride 1) an eval forward runs
    K2 on the kept fold. Subclasses name their modules in
    :meth:`_dw_modules`."""

    def __init__(self, kernel: int, fuse_dwse: bool):
        super().__init__()
        self.kernel, self.fuse_dwse = kernel, fuse_dwse
        self._dwse = None      # (key, packed w_eff and shift) of K2

    def _dw_modules(self):
        """(depthwise conv, its BN, SE reduce conv, SE expand conv)."""
        raise NotImplementedError

    def drop_kept_weights(self) -> None:
        self._dwse = None

    def kept_weights(self, dtype: torch.dtype):
        return self._dwse_weights() if self.fuse_dwse else None

    @torch.no_grad()
    def _dwse_weights(self) -> torch.Tensor:
        """The depthwise conv with its eval BN folded in (fp32 ``w_eff =
        weight * scale``, ``shift``), packed by ``pack_dwse`` on the weights'
        device; computed on the first call and kept (eval only), keyed on
        the conv weight and the four BN tensors (an edit through ``.data``
        bypasses the key: call :meth:`drop_kept_weights` after one)."""
        conv, bn = self._dw_modules()[:2]
        key = (conv.weight.dtype, conv.weight.device,
               *version_key(conv.weight, bn.weight, bn.bias, bn.running_mean,
                            bn.running_var))
        if self._dwse is None or self._dwse[0] != key:
            scale, shift = bn.folded()
            c, k = conv.out_channels, self.kernel
            w_eff = conv.weight.float().reshape(c, k * k).t() * scale
            self._dwse = (key, pack_dwse(w_eff, shift, k))
            if conv.weight.is_cuda:
                extension.LAUNCHES["dw_se_fold"] += 1
        return self._dwse[1]

    def depthwise_se(self, h):
        """SE(SiLU(BN(depthwise(h)))): K2 and the SE on its mean, or the
        plain modules."""
        conv, bn, reduce, expand = self._dw_modules()
        if self.fuse_dwse and not self.training:
            if torch.is_grad_enabled():
                extension.refuse_autograd("use_pallas_dwse", h, conv.weight, bn.weight,
                                          bn.bias)
            h = h.to(extension.autocast_dtype(h))
            y, m = dw_bn_silu_mean_packed(h, self._dwse_weights(), self.kernel)
            return squeeze_excite(y, reduce, expand, mean=m[:, :, None, None])
        return squeeze_excite(F.silu(bn(conv(h))), reduce, expand)


# ------------------------------------------------------------------ V2-S

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
    """torchvision's SE: ``fc1`` (1x1) and ``fc2`` (1x1), as :func:`squeeze_excite`."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x, mean=None):
        return squeeze_excite(x, self.fc1, self.fc2, mean)


class MBConv(DepthwiseSE):
    """V2-S inverted residual: [expand] -> depthwise -> SE -> project (+ residual)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 expand: int, se_ratio: float, drop_rate: float = 0.0,
                 use_pallas_dwse: bool = False):
        super().__init__(kernel, use_pallas_dwse and stride == 1)
        if se_ratio <= 0:
            raise ValueError("V2-S MBConv blocks all carry squeeze-excite (se_ratio > 0)")
        exp = cin * expand
        self.use_res = stride == 1 and cin == cout
        self.drop_rate = drop_rate
        self.has_expand = expand != 1
        layers = [ConvBNAct(cin, exp, 1)] if self.has_expand else []
        layers.append(ConvBNAct(exp, exp, kernel, stride, groups=exp))
        layers.append(SqueezeExcitation(exp, max(1, int(cin * se_ratio))))
        layers.append(ConvBNAct(exp, cout, 1, act=False))
        self.block = nn.Sequential(*layers)

    def _dw_modules(self):
        i = int(self.has_expand)
        dw, se = self.block[i], self.block[i + 1]
        return dw[0], dw[1], se.fc1, se.fc2

    def forward(self, x):
        h = self.block[0](x) if self.has_expand else x
        h = self.block[-1](self.depthwise_se(h))
        return x + stochastic_depth(h, self.drop_rate, self.training) if self.use_res else h


class FusedMBConv(nn.Module):
    """V2 early stages: a full k x k conv replaces expand + depthwise."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, expand: int,
                 drop_rate: float = 0.0):
        super().__init__()
        self.use_res = stride == 1 and cin == cout
        self.drop_rate = drop_rate
        if expand != 1:
            layers = [ConvBNAct(cin, cin * expand, kernel, stride),
                      ConvBNAct(cin * expand, cout, 1, act=False)]
        else:
            layers = [ConvBNAct(cin, cout, kernel, stride)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        h = self.block(x)
        return x + stochastic_depth(h, self.drop_rate, self.training) if self.use_res else h


class EfficientNetV2S(nn.Module):
    """[N, 3, H, W] -> [N, head_ch, H/32, W/32]."""

    def __init__(self, spec: BackboneSpec = V2S_FULL, use_pallas_dwse: bool = False):
        super().__init__()
        stages = [ConvBNAct(3, spec.stem_ch, 3, 2)]
        total, idx = sum(cfg.repeats for cfg in spec.blocks), 0
        for cfg in spec.blocks:
            blocks = []
            for r in range(cfg.repeats):
                cin = cfg.in_ch if r == 0 else cfg.out_ch
                stride = cfg.stride if r == 0 else 1
                rate = DROP_CONNECT_RATE * idx / total
                if cfg.fused:
                    blocks.append(FusedMBConv(cin, cfg.out_ch, cfg.kernel, stride,
                                              cfg.expand, rate))
                else:
                    blocks.append(MBConv(cin, cfg.out_ch, cfg.kernel, stride,
                                         cfg.expand, cfg.se_ratio, rate,
                                         use_pallas_dwse=use_pallas_dwse))
                idx += 1
            stages.append(nn.Sequential(*blocks))
        stages.append(ConvBNAct(spec.blocks[-1].out_ch, spec.head_ch, 1))
        self.features = nn.Sequential(*stages)

    def forward(self, x):
        return self.features(x)


# ------------------------------------------------------------------ B0


def _b0_bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-3, momentum=0.01)


class MBConvBlock(DepthwiseSE):
    """B0 inverted residual (efficientnet_pytorch ``MBConvBlock``): [expand]
    -> depthwise -> SE -> project (no activation) (+ residual where stride is
    1 and cin == cout)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, expand: int,
                 se_ratio: float, drop_rate: float, use_pallas_dwse: bool = False):
        super().__init__(kernel, use_pallas_dwse and stride == 1)
        exp = cin * expand
        self.use_res = stride == 1 and cin == cout
        self.drop_rate = drop_rate
        self.has_expand = expand != 1
        if self.has_expand:
            self._expand_conv = nn.Conv2d(cin, exp, 1, bias=False)
            self._bn0 = _b0_bn(exp)
        self._depthwise_conv = Conv2dSame(exp, exp, kernel, stride, groups=exp)
        self._bn1 = _b0_bn(exp)
        squeeze = max(1, int(cin * se_ratio))
        self._se_reduce = nn.Conv2d(exp, squeeze, 1)
        self._se_expand = nn.Conv2d(squeeze, exp, 1)
        self._project_conv = nn.Conv2d(exp, cout, 1, bias=False)
        self._bn2 = _b0_bn(cout)

    def _dw_modules(self):
        return self._depthwise_conv, self._bn1, self._se_reduce, self._se_expand

    def forward(self, x):
        h = F.silu(self._bn0(self._expand_conv(x))) if self.has_expand else x
        h = self._bn2(self._project_conv(self.depthwise_se(h)))
        return x + stochastic_depth(h, self.drop_rate, self.training) if self.use_res else h


class EfficientNetB0(nn.Module):
    """[N, 3, H, W] -> [N, head_ch, ceil(H/32), ceil(W/32)]."""

    def __init__(self, spec: Optional[BackboneSpec] = None,
                 use_pallas_dwse: bool = False):
        super().__init__()
        spec = spec or B0_FULL
        self._conv_stem = Conv2dSame(3, spec.stem_ch, 3, 2)
        self._bn0 = _b0_bn(spec.stem_ch)
        total = sum(cfg.repeats for cfg in spec.blocks)
        blocks = []
        for cfg in spec.blocks:
            for r in range(cfg.repeats):
                blocks.append(MBConvBlock(
                    cfg.in_ch if r == 0 else cfg.out_ch, cfg.out_ch, cfg.kernel,
                    cfg.stride if r == 0 else 1, cfg.expand, cfg.se_ratio,
                    DROP_CONNECT_RATE * len(blocks) / total,
                    use_pallas_dwse=use_pallas_dwse))
        self._blocks = nn.ModuleList(blocks)
        self._conv_head = nn.Conv2d(spec.blocks[-1].out_ch, spec.head_ch, 1, bias=False)
        self._bn1 = _b0_bn(spec.head_ch)

    def forward(self, x):
        x = F.silu(self._bn0(self._conv_stem(x)))
        for block in self._blocks:
            x = block(x)
        return F.silu(self._bn1(self._conv_head(x)))
