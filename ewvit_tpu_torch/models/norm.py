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
- Under :func:`synced_batch_stats` (data parallelism, ``parallel/``) a
  train-mode :class:`BatchNorm2d` takes its statistics over the batch
  group's rows, as the JAX package's BN does over a sharded global batch:
  fp32 sums over the rank's rows are all-reduced: ``Σx`` and the row
  count, then ``Σd`` and ``Σd²`` of ``d = x - mean`` about that mean (the
  corrected two-pass variance: ``Σd/n`` corrects the mean's rounding), so
  a mean far above the spread costs no digits, where ``E[x²] - mean²``
  would cancel them. The
  running statistics move with the global ``n / (n - 1)``, and the
  all-reduces are differentiable, so the backward carries the cross-rank
  terms. Momentum 0 and ``num_batches_tracked`` None (the remat recompute,
  ``models/detector.py``) are honoured as ``nn.BatchNorm2d`` honours them.
- :class:`LayerNorm` is ``nn.LayerNorm`` with flax's eps 1e-6 as default and
  statistics in fp32 whatever the input dtype.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


_SYNC_GROUP: Optional[object] = None


@contextlib.contextmanager
def synced_batch_stats(group):
    """Train-mode :class:`BatchNorm2d` statistics over ``group`` (a
    ``torch.distributed`` process group) in the block."""
    global _SYNC_GROUP
    saved, _SYNC_GROUP = _SYNC_GROUP, group
    try:
        yield
    finally:
        _SYNC_GROUP = saved


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _SYNC_GROUP is None or not self.training:
            return super().forward(x)
        return self._synced(x, _SYNC_GROUP)

    def _synced(self, x: torch.Tensor, group) -> torch.Tensor:
        from ewvit_tpu_torch.parallel.mesh import all_reduce_sum

        c, dims = x.shape[1], (0, 2, 3)
        xf = x.float()
        first = all_reduce_sum(torch.cat([xf.sum(dims), xf.new_full((1,), x.numel() // c)]),
                               group)
        n = first[c]
        mean = first[:c] / n
        d = xf - mean[:, None, None]
        second = all_reduce_sum(torch.cat([d.sum(dims), (d * d).sum(dims)]), group) / n
        shift = second[:c]                           # the first mean's rounding
        mean = mean + shift
        d = d - shift[:, None, None]
        var = (second[c:] - shift * shift).clamp_min(0.0)
        factor = 0.0 if self.momentum is None else self.momentum
        if self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:
                factor = 1.0 / float(self.num_batches_tracked)
        if factor:
            with torch.no_grad():
                unbiased = var * (n / (n - 1).clamp_min(1.0))
                self.running_mean.mul_(1.0 - factor).add_(factor * mean)
                self.running_var.mul_(1.0 - factor).add_(factor * unbiased)
        y = d * torch.rsqrt(var + self.eps)[:, None, None]
        return (y * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)

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
