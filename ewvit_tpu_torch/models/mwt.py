"""MWT: multi-level wavelet frequency branch, eval mode, NCHW (ewvit_tpu/models/mwt.py).

Per level: Haar DWT (K1 with ``use_pallas_dwt``) -> hf ``[N, 3C, H', W']`` in
the ``c*3 + band`` interleave -> bilinear upsample to ``(H/2, W/2)``
(``align_corners=False``, the half-pixel centres of ``jax.image.resize``) ->
the three SHARED ``hf_sep_i`` conv+BN+ReLU stacks on the channel slices
``[i*C:(i+1)*C]`` -> concat (18C) -> ``hf_fusion`` -> dama_dim. LL recurses.
Then concat of the levels -> ``multiscale_fusion`` -> stride-2 ``freq_conv``
-> maxpool -> stride-2 ``freq_pool`` conv -> spatial mean ``[N, dim, 1, 1]``.

Form ported: the reference-structured one (conv + bias, then eval BN, then
ReLU), which is the same math as the JAX package's default ``"level"`` fast
path. The three hf_sep convs run as ONE ``groups=3`` conv on the 3C-channel
hf map: group i sees exactly channels ``[i*C:(i+1)*C]``, so the products are
those of the three separate convs. All other convs are plain ``F.conv2d``
except, with ``use_fused_tail``, ``multiscale_fusion``.

``use_fused_tail`` (``ModelConfig.use_fused_mwt_tail``) runs
``multiscale_fusion`` with its conv bias and eval BN folded in as K3, the
Winograd kernel of ``ops/mwt_tail.py``, on the per-level ``hf_fusion``
outputs (never concatenated), under the JAX package's gate
(ewvit_tpu/models/mwt.py:242-245): ``H/2`` and ``W/2`` even and
``H/4 >= 4``; otherwise the direct conv runs. ``freq_conv`` stays the
ordinary stride-2 conv: the JAX package's ``freq_from_phases`` only undoes
its Mosaic phase layout. Same parameters either way.

Module names follow the reference: ``hf_conv.seperate.i.{0,1}``,
``hf_conv.fusion.{0,1}``, ``multiscale_fusion.{0,1}``, ``freq_conv.{0,1}``,
``freq_pool.{1,2}``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ewvit_tpu_torch.models.norm import BatchNorm2d
from ewvit_tpu_torch.ops.haar import haar_dwt2d, haar_dwt2d_plain
from ewvit_tpu_torch.ops.mwt_tail import fused_multiscale_winograd, multiscale_winograd_u


class ConvBNReLU(nn.Sequential):
    """conv3x3 (bias) ``0`` + BN (eps 1e-5) ``1`` + ReLU ``2``."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(nn.Conv2d(cin, cout, 3, stride, padding=1),
                         BatchNorm2d(cout, eps=1e-5, momentum=0.1),
                         nn.ReLU())


class MWT(nn.Module):
    """[N, C, H, W] -> [N, dama_dim, 1, 1] (eval only)."""

    def __init__(self, in_channels: int = 3, dama_dim: int = 128,
                 levels: int = 3, use_pallas_dwt: bool = False,
                 use_fused_tail: bool = False):
        super().__init__()
        c = in_channels
        self.levels, self.use_pallas_dwt = levels, use_pallas_dwt
        self.use_fused_tail = use_fused_tail
        self.hf_conv = nn.ModuleDict({
            "seperate": nn.ModuleList([ConvBNReLU(c, 6 * c) for _ in range(3)]),
            "fusion": ConvBNReLU(18 * c, dama_dim),
        })
        self.multiscale_fusion = ConvBNReLU(levels * dama_dim, dama_dim)
        self.freq_conv = ConvBNReLU(dama_dim, dama_dim, stride=2)
        self.freq_pool = nn.Sequential(
            nn.MaxPool2d(2, 2),
            nn.Conv2d(dama_dim, dama_dim, 3, 2, padding=1),
            BatchNorm2d(dama_dim, eps=1e-5, momentum=0.1),
            nn.ReLU())

    def _hf_sep(self, hf):
        """The three shared hf_sep stacks on their channel slices, as one
        grouped conv followed by each stack's eval BN and ReLU."""
        seps = self.hf_conv["seperate"]
        w = torch.cat([s[0].weight for s in seps])
        b = torch.cat([s[0].bias for s in seps])
        y = F.conv2d(hf, w, b, padding=1, groups=3)
        folded = [s[1].folded() for s in seps]
        scale = torch.cat([f[0] for f in folded]).to(y.dtype)[:, None, None]
        shift = torch.cat([f[1] for f in folded]).to(y.dtype)[:, None, None]
        return F.relu(torch.addcmul(shift, y, scale))

    def _fused_multiscale(self, highs):
        """multiscale_fusion (conv + bias, eval BN, ReLU) as K3 on the level
        maps: BN scale folded into U, conv bias and BN shift into one bias."""
        conv, bn = self.multiscale_fusion[0], self.multiscale_fusion[1]
        scale, shift = bn.folded()
        u = multiscale_winograd_u(conv.weight, scale, self.levels, highs[0].dtype)
        return fused_multiscale_winograd(highs, u, conv.bias.float() * scale + shift)

    def forward(self, x):
        if self.training:
            raise NotImplementedError("the port's MWT is eval-only so far")
        h, w = x.shape[2:]
        target = (h // 2, w // 2)
        dwt = haar_dwt2d if self.use_pallas_dwt else haar_dwt2d_plain
        cur, highs = x, []
        for _ in range(self.levels):
            ll, hf = dwt(cur)
            if self.levels > 1 and tuple(hf.shape[2:]) != target:
                hf = F.interpolate(hf, size=target, mode="bilinear",
                                   align_corners=False)
            highs.append(self.hf_conv["fusion"](self._hf_sep(hf)))
            cur = ll
        if self.use_fused_tail and target[0] % 2 == 0 and target[1] % 2 == 0 \
                and target[0] // 2 >= 4:
            fused = self._fused_multiscale(highs)
        else:
            fused = self.multiscale_fusion(torch.cat(highs, dim=1))
        freq = self.freq_conv(fused)
        freq = self.freq_pool(freq)
        return freq.mean(dim=(2, 3), keepdim=True)
