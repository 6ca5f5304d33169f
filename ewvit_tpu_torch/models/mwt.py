"""MWT: multi-level wavelet frequency branch, NCHW (ewvit_tpu/models/mwt.py).

Per level: Haar DWT (K1 with ``use_pallas_dwt``) -> hf ``[N, 3C, H', W']`` in
the ``c*3 + band`` interleave -> bilinear upsample to ``(H/2, W/2)``
(``align_corners=False``, the half-pixel centres of ``jax.image.resize``) ->
the three SHARED ``hf_sep_i`` conv+BN+ReLU stacks on the channel slices
``[i*C:(i+1)*C]`` -> concat (18C) -> ``hf_fusion`` -> dama_dim. LL recurses.
Then concat of the levels -> ``multiscale_fusion`` -> stride-2 ``freq_conv``
-> maxpool -> stride-2 ``freq_pool`` conv -> spatial mean ``[N, dim, 1, 1]``.

Form ported: the reference-structured one (conv + bias, then BN, then
ReLU), which is the same math as the JAX package's default ``"level"`` fast
path. The three hf_sep convs run as ONE ``groups=3`` conv on the 3C-channel
hf map: group i sees exactly channels ``[i*C:(i+1)*C]``, so the products are
those of the three separate convs. In eval mode each stack's BN is applied
folded; in train mode each hf_sep BN runs on its channel slice with batch
statistics (the JAX package's ``fused_train_pyramid`` form, the same
statistics as its default per-slice convs). The hf_sep stacks and
``hf_fusion`` are shared by the levels, so their running statistics move
once per level, level by level. All other convs are plain ``F.conv2d``
except, with ``use_fused_tail`` in eval mode, ``multiscale_fusion``. K1 runs
in train mode too: its input (the frames, then their LL bands) needs no
gradient.

``use_fused_tail`` (``ModelConfig.use_fused_mwt_tail``) runs
``multiscale_fusion`` with its conv bias and eval BN folded in as K3, the
Winograd kernel of ``ops/mwt_tail.py``, on the per-level ``hf_fusion``
outputs (never concatenated), under the JAX package's gate
(ewvit_tpu/models/mwt.py:242-245): eval mode, ``H/2`` and ``W/2`` even and
``H/4 >= 4``; otherwise the direct conv runs. With grad enabled it raises
(``extension.refuse_autograd``): K3 has no backward. ``freq_conv`` stays the
ordinary stride-2 conv: the JAX package's ``freq_from_phases`` only undoes
its Mosaic phase layout. Same parameters either way. U (BN scale folded in)
and the fp32 bias are computed once in eval mode, at the first call or from
``serving.cast_for_inference``, and kept packed for the kernel
(``_tail_weights``); they are dropped on ``train()``, on
``load_state_dict`` and by ``drop_kept_weights()``, and recomputed when the
compute dtype or the device changes or a tensor they read (conv weight and
bias, the four BN tensors) is replaced or edited in place
(``models/kept.py``). (The JAX package folds U inside its jitted graph.)

``forward(x, return_intermediates=True)`` returns ``(freq, {"hf_level0":
level 0's hf_fusion output [N, dama_dim, H/2, W/2], "freq_out": freq})``, as
ewvit_tpu/models/mwt.py:174-332 does (NHWC there); it takes the direct
``multiscale_fusion`` conv, never K3, as the JAX gate does (:242-247).

Module names follow the reference: ``hf_conv.seperate.i.{0,1}``,
``hf_conv.fusion.{0,1}``, ``multiscale_fusion.{0,1}``, ``freq_conv.{0,1}``,
``freq_pool.{1,2}``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ewvit_tpu_torch.models.kept import KeepsWeights, version_key
from ewvit_tpu_torch.models.norm import BatchNorm2d
from ewvit_tpu_torch.ops.haar import haar_dwt2d, haar_dwt2d_plain
from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops.mwt_tail import (
    fused_multiscale_winograd_packed,
    multiscale_winograd_u,
    pack_tail,
)


class ConvBNReLU(nn.Sequential):
    """conv3x3 (bias) ``0`` + BN (eps 1e-5) ``1`` + ReLU ``2``."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(nn.Conv2d(cin, cout, 3, stride, padding=1),
                         BatchNorm2d(cout, eps=1e-5, momentum=0.1),
                         nn.ReLU())


class MWT(KeepsWeights):
    """[N, C, H, W] -> [N, dama_dim, 1, 1]."""

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
        self._tail = None      # (key, packed U, fp32 bias) of the fused tail

    def drop_kept_weights(self) -> None:
        self._tail = None

    def kept_weights(self, dtype: torch.dtype):
        return self._tail_weights(dtype) if self.use_fused_tail else None

    def _hf_sep(self, hf):
        """The three shared hf_sep stacks on their channel slices, as one
        grouped conv followed by each stack's BN and ReLU (in train mode BN
        ``i`` on output slice ``i``, in the JAX order: slice 0, 1, 2)."""
        seps = self.hf_conv["seperate"]
        w = torch.cat([s[0].weight for s in seps])
        b = torch.cat([s[0].bias for s in seps])
        y = F.conv2d(hf, w, b, padding=1, groups=3)
        if self.training:
            return torch.cat([s[2](s[1](part)) for s, part in zip(seps, y.chunk(3, dim=1))],
                             dim=1)
        folded = [s[1].folded() for s in seps]
        scale = torch.cat([f[0] for f in folded]).to(y.dtype)[:, None, None]
        shift = torch.cat([f[1] for f in folded]).to(y.dtype)[:, None, None]
        return F.relu(torch.addcmul(shift, y, scale))

    @torch.no_grad()
    def _tail_weights(self, dtype: torch.dtype):
        """multiscale_fusion's U (BN scale folded in) in ``dtype`` and its fp32
        bias (conv bias and BN shift), packed by ``pack_tail`` for the
        weights' device; computed on the first call and kept (eval only),
        keyed on every tensor it reads (an edit through ``.data`` bypasses
        the key: call :meth:`drop_kept_weights` after one)."""
        conv, bn = self.multiscale_fusion[0], self.multiscale_fusion[1]
        key = (dtype, conv.weight.device,
               *version_key(conv.weight, conv.bias, bn.weight, bn.bias,
                            bn.running_mean, bn.running_var))
        if self._tail is None or self._tail[0] != key:
            scale, shift = bn.folded()
            u = multiscale_winograd_u(conv.weight, scale, self.levels, dtype)
            self._tail = (key, *pack_tail(u, conv.bias.float() * scale + shift))
            if u.is_cuda:
                extension.LAUNCHES["winograd_u_fold"] += 1
        return self._tail[1], self._tail[2]

    def _fused_multiscale(self, highs):
        """multiscale_fusion (conv + bias, eval BN, ReLU) as K3 on the level
        maps, with the kept U and bias."""
        conv, bn = self.multiscale_fusion[0], self.multiscale_fusion[1]
        if torch.is_grad_enabled():
            extension.refuse_autograd("use_fused_mwt_tail", *highs, conv.weight, conv.bias,
                                      bn.weight, bn.bias)
        dt = extension.autocast_dtype(highs[0])
        highs = [h.to(dt) for h in highs]
        return fused_multiscale_winograd_packed(highs, *self._tail_weights(dt))

    def forward(self, x, return_intermediates: bool = False):
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
        if self.use_fused_tail and not self.training and not return_intermediates \
                and target[0] % 2 == 0 and target[1] % 2 == 0 and target[0] // 2 >= 4:
            fused = self._fused_multiscale(highs)
        else:
            fused = self.multiscale_fusion(torch.cat(highs, dim=1))
        freq = self.freq_conv(fused)
        freq = self.freq_pool(freq).mean(dim=(2, 3), keepdim=True)
        if return_intermediates:
            return freq, {"hf_level0": highs[0], "freq_out": freq}
        return freq
