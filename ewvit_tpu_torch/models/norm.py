"""Normalization layers with the JAX package's eval numerics.

- :class:`BatchNorm2d` is ``nn.BatchNorm2d`` (same parameters, buffers and
  torch running-statistics update in training, which ewvit_tpu's
  ``TorchBatchNorm`` copies, models/norm.py:44-88), plus :meth:`folded` for
  the paths that fold the eval affine into their weights. A bf16 activation
  with fp32 statistics is normalised in fp32 and rounded once (the JAX module
  normalises in the module dtype; the difference is within bf16 rounding).
  Pin the hyperparameters where the module is built: V2-S eps 1e-3 and torch
  momentum 0.1 (flax 0.9, efficientnet.py:433); MWT and fusion gate eps 1e-5
  (mwt.py:106, dama.py:104-105).
- :class:`LayerNorm` is ``nn.LayerNorm`` with flax's eps 1e-6 as default and
  statistics in fp32 whatever the input dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):
    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval affine in fp32: ``y = x * scale + shift``. The fused paths
        fold it into their weights (K2's ``w_eff``, the MWT's grouped hf_sep)."""
        scale = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * scale
        return scale, shift


@torch.no_grad()
def calibrate_batchnorm_(module: nn.Module, *inputs) -> nn.Module:
    """Set every BatchNorm's running statistics to those of one train-mode
    forward over ``inputs``; returns the module in eval mode.

    Randomly initialised weights with identity running statistics let the
    activations of a deep stack vanish or explode; calibrated statistics
    normalise every BN output, as trained ones would.
    """
    bns = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None          # cumulative average: one batch -> its stats
    module.train()
    try:
        module(*inputs)
    finally:
        module.eval()
        for m, mom in zip(bns, momenta):
            m.momentum = mom
    return module


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim: int, eps: float = 1e-6, **kw):
        super().__init__(dim, eps=eps, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)
