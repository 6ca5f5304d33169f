"""Losses: weighted BCE, binary focal loss, orthogonality (ewvit_tpu/train/losses.py).

- ``weighted_bce_with_logits``: torch's ``BCEWithLogitsLoss(pos_weight=...)``,
  the reference's training criterion;
- ``binary_focal_loss``: the reference's ``BinaryFocalLoss``, kept for
  parity;
- ``orthogonal_loss``: the off-diagonal penalty on the normalised
  cross-covariance of the space and frequency features;
- ``combined_loss``: the cls loss plus the ramped orthogonality term
  (``orth_lambda``: 0 before 20% of the epochs, then linear to 1 over the
  next 50%), with an optional ``valid_mask`` that keeps pad rows out of
  both terms.

Everything is computed in fp32 whatever the model's compute dtype, also
under an outer ``torch.autocast`` (``combined_loss`` turns it off: the
``Trainer``'s val epoch runs ``eval_step`` under autocast). The eval step
(``evaluation.py``) and the train step (``train/steps.py``, which
backpropagates through them) use the same functions.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def weighted_bce_with_logits(logits, targets, pos_weight: float = 1.0,
                             reduction: str = "mean") -> torch.Tensor:
    """``-[w*y*log(sigmoid(x)) + (1-y)*log(1-sigmoid(x))]``."""
    logits, targets = logits.float(), targets.float()
    loss = -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))
    return _reduce(loss, reduction)


def binary_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0,
                      reduction: str = "mean") -> torch.Tensor:
    """sigmoid -> BCE -> ``(1-p_t)^gamma`` modulation -> per-class alpha weight."""
    logits, targets = logits.float(), targets.float()
    ce = -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))
    p = torch.sigmoid(logits)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_w = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return _reduce(alpha_w * (1.0 - p_t) ** gamma * ce, reduction)


def orthogonal_loss(space_feats, freq_feats) -> torch.Tensor:
    """Off-diagonal Frobenius^2 of the row-normalised cross-covariance, over
    ``D * (D - 1)``."""
    space, freq = space_feats.float(), freq_feats.float()
    d = space.shape[1]
    space = space / space.norm(dim=1, keepdim=True).clamp_min(1e-12)
    freq = freq / freq.norm(dim=1, keepdim=True).clamp_min(1e-12)
    off = (space.t() @ freq) * (1.0 - torch.eye(d, device=space.device))
    return (off ** 2).sum() / (d * (d - 1))


def orth_lambda(epoch, max_epochs, start_frac: float = 0.2,
                ramp_frac: float = 0.5) -> torch.Tensor:
    """fp32 lambda: 0 before ``start_frac * max_epochs``, then linear to 1
    over ``ramp_frac * max_epochs``."""
    e = torch.as_tensor(epoch, dtype=torch.float32)
    m = torch.as_tensor(max_epochs, dtype=torch.float32)
    lam = ((e - start_frac * m) / (ramp_frac * m)).clamp(0.0, 1.0)
    return torch.where(e < start_frac * m, torch.zeros_like(lam), lam)


def combined_loss(outputs: Dict[str, torch.Tensor], labels, criterion: Callable,
                  epoch, max_epochs, valid_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """cls loss + ``orth_lambda`` * orthogonality of ``space``/``freq`` (where
    the outputs have both; 0 otherwise).

    ``criterion(logits, targets, reduction=...)``. ``valid_mask`` (``[B]``
    0/1) keeps rows out of both terms: the cls loss becomes a masked mean,
    and zeroed feature rows add nothing to the cross-covariance, whose
    normaliser is the feature width only; so a mask of ``n`` ones gives the
    loss of the first ``n`` rows alone.
    """
    with torch.autocast(outputs["logits"].device.type, enabled=False):
        return _combined_loss(outputs, labels, criterion, epoch, max_epochs, valid_mask)


def _combined_loss(outputs, labels, criterion, epoch, max_epochs, valid_mask):
    logits = outputs["logits"]
    labels = labels.reshape(-1, 1).float()
    space, freq = outputs.get("space"), outputs.get("freq")
    if valid_mask is None:
        cls_loss = criterion(logits, labels)
    else:
        m = valid_mask.reshape(-1, 1).float()
        cls_loss = (criterion(logits, labels, reduction="none") * m).sum() / m.sum().clamp_min(1.0)
        if space is not None and freq is not None:
            space, freq = space * m, freq * m
    if space is not None and freq is not None:
        loss_orth = orthogonal_loss(space, freq)
    else:
        loss_orth = torch.zeros((), dtype=torch.float32, device=logits.device)
    lam = orth_lambda(epoch, max_epochs).to(logits.device)
    return cls_loss + lam * loss_orth, {"cls_loss": cls_loss, "orth_loss": loss_orth,
                                        "lambda_orth": lam}
