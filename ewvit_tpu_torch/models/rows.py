"""This rank's rows of a global batch, for the draws and row-indexed
parameters that must not depend on how a batch is split over ranks.

Under data parallelism (``parallel/``) a rank holds some rows of a global
batch: of the flattened chunk ``[B*n]`` inside the model, of the clips
``[B]`` at the head, of the ``[B, K]`` images of the colour jitter. Three
things depend on a row's global index, not its local one:

- a dropout or stochastic-depth mask: drawn for the **global** shape with
  the same call (so the generator yields what it yields in the unsplit run),
  then this rank's rows are taken (:class:`Dropout`, :func:`draw`);
- the SFE's positional embedding, indexed by the flattened row
  (``models/sfe.py``);
- the colour jitter's per-image draws (``ops/preprocess.draw_jitter``).

:func:`global_rows` states, for a block, the global row of each local row
and the global row count. Outside it, and where the local rows are the
whole batch, every draw is the plain call.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Rows:
    index: torch.Tensor      # int64 [n]: the global row of each local row
    total: int               # rows of the global batch


_ROWS: Optional[Rows] = None


@contextlib.contextmanager
def global_rows(index: torch.Tensor, total: int):
    """Run the block with this rank's rows stated: ``index`` (int64, on the
    device of the tensors it indexes) holds the global row of each local
    row of a ``total``-row batch."""
    global _ROWS
    saved, _ROWS = _ROWS, Rows(index, int(total))
    try:
        yield
    finally:
        _ROWS = saved


def current(n: int) -> Optional[Rows]:
    """The rows stated for a tensor of ``n`` local rows; None outside
    :func:`global_rows` or where the ``n`` rows are the whole batch."""
    r = _ROWS
    if r is None or r.total == n:
        return None
    if r.index.numel() != n:
        raise ValueError(f"{n} local rows, but {r.index.numel()} rows were stated")
    return r


def draw(shape: Tuple[int, ...], fn: Callable[[Tuple[int, ...]], torch.Tensor]) -> torch.Tensor:
    """``fn(shape)`` for the local rows: ``fn`` of the global shape, then
    this rank's rows."""
    r = current(shape[0])
    if r is None:
        return fn(tuple(shape))
    return fn((r.total, *shape[1:])).index_select(0, r.index)


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask, under :func:`global_rows`, is this rank's
    rows of the global mask: the global mask is ``F.dropout`` of ones (its
    kept entries ``1 / (1-p)``, as ``F.dropout`` scales), so a row is
    multiplied by what the unsplit call multiplies it by."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = current(x.shape[0]) if self.training and self.p > 0 else None
        if r is None:
            return super().forward(x)
        mask = F.dropout(x.new_ones((r.total, *x.shape[1:])), self.p, True)
        return x * mask.index_select(0, r.index)
