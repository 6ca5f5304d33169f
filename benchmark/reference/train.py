"""Plain PyTorch reference of one training update of the detector.

The reference recipe (its ``train.py``): ``BCEWithLogitsLoss`` plus the
orthogonality term ramped in over the epochs, gradient accumulation over
micro-batches (the mean of their gradients), Adam with coupled L2 weight
decay, and the first six parameter tensors of each backbone frozen. Written
from that description in plain ``torch``; it imports nothing of the measured
program.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.model import (DeepfakeDetector, chunk_seeds, preprocess,
                                       train_video_forward)

_V2S_FROZEN = ("features.0.0.weight", "features.0.1.weight", "features.0.1.bias",
               "features.1.0.block.0.0.weight", "features.1.0.block.0.1.weight",
               "features.1.0.block.0.1.bias")
_B0_FROZEN = ("_conv_stem.weight", "_bn0.weight", "_bn0.bias",
              "_blocks.0._depthwise_conv.weight", "_blocks.0._bn1.weight",
              "_blocks.0._bn1.bias")


def frozen_names() -> List[str]:
    """The 18 frozen tensors (reference sfe.py:115-119: the first six of
    each backbone)."""
    return ([f"dama.sfe.efficient_net.{n}" for n in _V2S_FROZEN]
            + [f"sfe.efficient_net.{n}" for n in _B0_FROZEN]
            + [f"sfe_cls.efficient_net.{n}" for n in _B0_FROZEN])


def bce_with_logits(logits, targets, pos_weight: float = 1.0):
    logits, targets = logits.float(), targets.float()
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits)).mean()


def orthogonal_loss(space, freq):
    space, freq = space.float(), freq.float()
    d = space.shape[1]
    space = space / space.norm(dim=1, keepdim=True).clamp_min(1e-12)
    freq = freq / freq.norm(dim=1, keepdim=True).clamp_min(1e-12)
    off = (space.t() @ freq) * (1.0 - torch.eye(d, device=space.device))
    return (off ** 2).sum() / (d * (d - 1))


def orth_lambda(epoch: float, max_epochs: float, start: float = 0.2, ramp: float = 0.5):
    if epoch < start * max_epochs:
        return 0.0
    return min(max((epoch - start * max_epochs) / (ramp * max_epochs), 0.0), 1.0)


def combined_loss(out, labels, epoch, max_epochs, pos_weight=1.0):
    labels = labels.reshape(-1, 1).float()
    cls = bce_with_logits(out["logits"], labels, pos_weight)
    if "space" in out and "freq" in out:     # only DAMA's two branches
        orth = orthogonal_loss(out["space"], out["freq"])
    else:
        orth = torch.zeros((), device=cls.device)
    return cls + orth_lambda(epoch, max_epochs) * orth, cls, orth


class Adam:
    """``torch.optim.Adam`` semantics written out: coupled decay added to the
    gradient, bias-corrected moments, ``eps`` after the square root."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update; returns the gradients as the moments take them
        (with the decay added)."""
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        taken = {}
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / c2 ** 0.5 + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
        return taken


def train_update(model: DeepfakeDetector, opt: Adam, clips_u8: torch.Tensor,
                 labels: torch.Tensor, *, seed: int, jitter: Optional[torch.Generator],
                 mode: str, frame_chunk: int, accum_steps: int, epoch: float,
                 max_epochs: float, pos_weight: float = 1.0, remat: bool = True) -> dict:
    """One update over ``accum_steps`` micro-batches of ``clips_u8``
    (uint8 ``[accum*B, K, H, W, 3]``): preprocess (with the jitter drawn from
    ``jitter``), the train forward per micro-batch with its seed
    (``chunk_seeds(seed, accum_steps)``), loss, backward; the mean gradient;
    Adam. Returns the mean losses, the clips' logits, the mean gradients of the losses
    (``data``: zero for a parameter the mode does not use) and the gradients
    Adam took (``grads``: with the decay added)."""
    model.train()
    x = preprocess(clips_u8, jitter)
    g = accum_steps
    b = x.shape[0] // g
    params = opt.params
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    losses = torch.zeros(3, device=x.device)
    logits = []
    for i, s in enumerate(chunk_seeds(seed, g)):
        model.zero_grad(set_to_none=True)
        out = train_video_forward(model, x[i * b:(i + 1) * b], mode, frame_chunk, s, remat)
        loss, cls, orth = combined_loss(out, labels[i * b:(i + 1) * b], epoch, max_epochs,
                                        pos_weight)
        loss.backward()
        logits.append(out["logits"].detach().float().reshape(-1))
        with torch.no_grad():
            for k, p in params.items():
                if p.grad is not None:
                    grads[k] += p.grad
            losses += torch.stack([loss.detach(), cls.detach(), orth.detach()])
    for v in grads.values():
        v.div_(g)
    taken = opt.step(grads)
    model.zero_grad(set_to_none=True)
    return {"loss": losses / g, "logits": torch.cat(logits), "data": grads, "grads": taken}
