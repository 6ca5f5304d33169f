"""Weights kept folded or packed for a kernel, once per model in eval mode.

MBConv keeps K2's BN fold, the MWT K3's U and bias, and
BidirectionalCrossTransformer K4's packed weights, so that a served request
folds and packs nothing. Each keys what it keeps on :func:`version_key` of
every tensor the fold reads. An in-place change to such a tensor bumps its
``_version``: ``mul_``/``add_``/``copy_`` under ``no_grad``, and a child
module's ``load_state_dict`` (which copies in place and skips the parent's
``_load_from_state_dict``). The next call then folds again, as the JAX
package, which folds inside every ``apply``, reads the current parameters.

An assignment through ``.data`` bypasses the version counter: call the
module's ``drop_kept_weights()`` after one.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def version_key(*tensors: torch.Tensor) -> tuple:
    """``(data_ptr, _version)`` of each tensor: a few integer reads, no launch."""
    return tuple((t.data_ptr(), t._version) for t in tensors)


class KeepsWeights(nn.Module):
    """A module that keeps weights for a kernel: :meth:`kept_weights` computes
    or looks them up, :meth:`drop_kept_weights` clears them, and ``train()``
    and ``_load_from_state_dict`` call it."""

    def drop_kept_weights(self) -> None:
        raise NotImplementedError

    def kept_weights(self, dtype: torch.dtype):
        """What the module keeps for a forward in ``dtype`` (folded now if it
        is not kept yet), or ``None`` if its forward runs no such kernel."""
        raise NotImplementedError

    def train(self, mode: bool = True):
        self.drop_kept_weights()
        return super().train(mode)

    def _load_from_state_dict(self, *args, **kwargs):
        self.drop_kept_weights()
        super()._load_from_state_dict(*args, **kwargs)
