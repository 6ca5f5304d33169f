"""Optimizer and schedule with the reference's semantics (ewvit_tpu/train/optimizer.py).

- ``torch.optim.Adam(weight_decay=...)``: coupled L2, added to the gradient
  before the moments, as the reference's optimizer (train.py:273) and the
  JAX package's ``add_decayed_weights`` chained before ``scale_by_adam``
  (optimizer.py:78-82); not AdamW. Betas 0.9 and 0.999, eps 1e-8.
- :func:`cosine_annealing_schedule`: ``CosineAnnealingLR(T_max=epochs,
  eta_min)`` stepped once per epoch, as a per-update schedule quantised to
  the epoch (optimizer.py:27-37). Update ``n``, counted from 0, takes
  ``schedule(n)``, as optax's count does: :class:`ScheduledAdam` sets every
  group's ``lr`` before each update.
- The first 6 parameter tensors of each of the three backbones are frozen
  (reference sfe.py:115-119; :func:`detector_frozen_names`): they get
  ``requires_grad=False`` and stay out of the optimizer, so they get neither
  an update nor decay (optax ``set_to_zero``).

Every other parameter is updated on every step, in every mode: the JAX
package's ``jax.grad`` gives the parameters a mode does not use a zero
gradient, which the coupled decay makes nonzero, so its Adam moves them.
``train_step`` gives such parameters a zero gradient to match (the reference,
whose Adam skips a parameter without a gradient, leaves them where they are).
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch
import torch.nn as nn

_V2S_FROZEN = ("features.0.0.weight", "features.0.1.weight", "features.0.1.bias",
               "features.1.0.block.0.0.weight", "features.1.0.block.0.1.weight",
               "features.1.0.block.0.1.bias")
_B0_FROZEN = ("_conv_stem.weight", "_bn0.weight", "_bn0.bias",
              "_blocks.0._depthwise_conv.weight", "_blocks.0._bn1.weight",
              "_blocks.0._bn1.bias")


def cosine_annealing_schedule(base_lr: float, epochs: int, steps_per_epoch: int,
                              eta_min: float = 1e-7) -> Callable[[int], float]:
    """``lr(e) = eta_min + (base_lr - eta_min) * (1 + cos(pi * e / epochs)) / 2``
    with ``e = min(step // steps_per_epoch, epochs)``, in float32 as the JAX
    schedule computes it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, epochs)
        frac = f32(epoch) / f32(epochs)
        cos = f32(math.cos(float(f32(math.pi) * frac)))
        return float(f32(eta_min) + f32(base_lr - eta_min) * f32(0.5) * (f32(1.0) + cos))

    return schedule


def detector_frozen_names() -> List[str]:
    """The 18 frozen tensors: the first 6 of DAMA's V2-S, then of the
    ``sfe`` and ``sfe_cls`` B0s (optimizer.py:40-50, efficientnet.py:438-460),
    by state-dict name."""
    return ([f"dama.sfe.efficient_net.{n}" for n in _V2S_FROZEN]
            + [f"sfe.efficient_net.{n}" for n in _B0_FROZEN]
            + [f"sfe_cls.efficient_net.{n}" for n in _B0_FROZEN])


class ScheduledAdam(torch.optim.Adam):
    """``torch.optim.Adam`` whose update ``n`` (each group's ``count``, kept in
    the state dict) runs at ``schedule(n)``."""

    def __init__(self, params, schedule: Callable[[int], float], **kw):
        super().__init__(params, lr=schedule(0), **kw)
        self.schedule = schedule
        for group in self.param_groups:
            group.setdefault("count", 0)

    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = self.schedule(group["count"])
            group["count"] += 1
        return super().step(closure)


def update_count(optimizer: ScheduledAdam) -> int:
    """Updates taken so far (the first group's ``count``)."""
    return int(optimizer.param_groups[0]["count"])


def make_optimizer(model: nn.Module, *, lr: float = 1e-4, weight_decay: float = 1e-4,
                   epochs: int = 30, steps_per_epoch: int = 1, eta_min: float = 1e-7,
                   freeze_backbone_prefixes: bool = True) -> ScheduledAdam:
    """Adam with coupled decay on the model's parameters; with
    ``freeze_backbone_prefixes`` the frozen tensors get ``requires_grad=False``
    and are left out."""
    frozen = set(detector_frozen_names()) if freeze_backbone_prefixes else set()
    params = dict(model.named_parameters())
    missing = frozen - set(params)
    if missing:
        raise ValueError(f"frozen tensors not in the model: {sorted(missing)}")
    for name in frozen:
        params[name].requires_grad_(False)
    train = [p for name, p in params.items() if name not in frozen]
    return ScheduledAdam(train, cosine_annealing_schedule(lr, epochs, steps_per_epoch, eta_min),
                         betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
