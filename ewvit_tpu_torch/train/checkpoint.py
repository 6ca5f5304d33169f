"""Crash-safe, resumable training checkpoints (ewvit_tpu/train/checkpoint.py).

The reference's checkpoint flow (train.py:276-319): a full checkpoint per
epoch, ``checkpoint_{epoch+1}.pth``, and ``best_model.pth`` on a new best
val AUC (the reference's names, SURVEY.md:240). Each file is a ``torch.save``
of ``{"epoch", "best_val_auc", "step", "model_state_dict",
"optimizer_state_dict"}``; the model's names are the reference's, so
``checkpoint.load_model`` and ``InferenceEngine.from_checkpoint`` read it as
it is, and ``ScheduledAdam``'s per-group ``count`` travels in the optimizer's
state dict. :meth:`CheckpointManager.restore` gives back the model, its BN
statistics, the optimizer, the next epoch and the best AUC, and the
``Trainer`` really skips the epochs already done (the reference computes
its start epoch and loops from 0 all the same).

- **Crash-safe overwrites** (``_write_swap``, the JAX package's :96-119):
  write ``<final>.swap-in``, move the previous file to ``<final>.old``,
  move the new one into place and delete ``.old``. A crash between the two
  moves leaves ``.old`` and a complete ``.swap-in`` (``torch.save`` finished
  before the first move) and no final file: the ``.swap-in`` is the newer
  file, so the next save and :meth:`read` promote it and drop ``.old``.
  This diverges on purpose from the JAX package (checkpoint.py:95-119),
  which deletes the ``.swap-in`` and promotes ``.old``, so that a resume
  after such a crash repeated an epoch. A lone ``.old`` (no ``.swap-in``) is
  promoted back before anything is written, and :meth:`read` falls back to
  it.
- **Async saves.** ``_save`` copies every tensor into pinned host memory
  with ``non_blocking`` on the current stream and records an event: stream
  order puts the caller's next in-place ``optimizer.step`` after the copy.
  One worker thread waits on the event, then writes and swaps. At most 2
  saves are in flight; a third waits for the oldest. ``wait_until_finished``
  drains them and re-raises the first worker error.
"""

from __future__ import annotations

import copy
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ewvit_tpu_torch.train.optimizer import update_count


def _host_copy(tree: Any, pinned: bool) -> Any:
    """``tree`` (nested dicts and lists) with every tensor copied to the host:
    a CUDA tensor into pinned memory with ``non_blocking`` (complete once an
    event recorded after this call has), a CPU tensor by ``clone``; other
    leaves deep-copied."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if not t.is_cuda:
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
        out.copy_(t, non_blocking=pinned)
        return out
    if isinstance(tree, dict):
        return {k: _host_copy(v, pinned) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v, pinned) for v in tree)
    return copy.deepcopy(tree)


class CheckpointManager:
    """Epoch checkpoints and best-model snapshots in ``directory``."""

    def __init__(self, directory: str, *, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.async_save = bool(async_save)
        # one worker: best_model then checkpoint_N of one epoch are written in
        # order and never race on the swap paths
        self._pool = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
                      if self.async_save else None)
        self._pending: List[Future] = []
        # each queued save holds a pinned host copy of the model and the
        # optimizer (~1.7 GB at full width): one running and one queued at most
        self._max_pending = 2

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    # ----- crash-safe write ------------------------------------------------

    def _write_swap(self, obj: Dict, final: str) -> None:
        """Write ``obj`` to ``final``, keeping any file already at ``final``
        until the replacement is wholly on disk."""
        tmp, old = final + ".swap-in", final + ".old"
        self._finish_swap(final)
        if os.path.exists(tmp):
            os.remove(tmp)      # a save that crashed while writing it
        if os.path.exists(old):
            if os.path.exists(final):
                os.remove(old)
            else:
                # a save crashed between its two moves: .old is the only copy;
                # promote it back first, so a crash now still leaves it
                os.replace(old, final)
        torch.save(obj, tmp)
        if os.path.exists(final):
            os.replace(final, old)        # the previous stays recoverable at .old
            os.replace(tmp, final)
            os.remove(old)
        else:
            os.replace(tmp, final)

    @staticmethod
    def _finish_swap(final: str) -> None:
        """A swap stopped between its two moves left ``.old`` and a complete
        ``.swap-in`` and no ``final``: move the ``.swap-in`` into place."""
        tmp, old = final + ".swap-in", final + ".old"
        if not os.path.exists(final) and os.path.exists(tmp) and os.path.exists(old):
            os.replace(tmp, final)
            os.remove(old)

    def _save(self, model: nn.Module, optimizer: torch.optim.Optimizer, epoch: int,
              best_val_auc: float, name: str) -> str:
        final = self._path(name)
        pinned = self.async_save and torch.cuda.is_available()
        obj = {"epoch": int(epoch), "best_val_auc": float(best_val_auc),
               "step": update_count(optimizer),
               "model_state_dict": _host_copy(model.state_dict(), pinned),
               "optimizer_state_dict": _host_copy(optimizer.state_dict(), pinned)}
        if not self.async_save:
            self._write_swap(obj, final)
            return final
        copied = None
        if pinned:
            copied = torch.cuda.Event()
            copied.record()

        def worker() -> str:
            if copied is not None:
                copied.synchronize()
            self._write_swap(obj, final)
            return final

        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()    # surface a finished worker's error
        while len(self._pending) >= self._max_pending:     # back-pressure
            self._pending.pop(0).result()
        self._pending.append(self._pool.submit(worker))
        return final

    def save_epoch(self, model, optimizer, epoch: int, best_val_auc: float) -> str:
        return self._save(model, optimizer, epoch, best_val_auc,
                          f"checkpoint_{epoch + 1}.pth")

    def save_best(self, model, optimizer, epoch: int, best_val_auc: float) -> str:
        return self._save(model, optimizer, epoch, best_val_auc, "best_model.pth")

    def wait_until_finished(self) -> None:
        """Drain the saves in flight; re-raises the first worker error (every
        save is still waited for, so none is left half done)."""
        pending, self._pending = self._pending, []
        first_error = None
        for f in pending:
            try:
                f.result()
            except Exception as e:  # re-raised below, after the others finish
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error

    def restore(self, path: str, model: nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None) -> Tuple[int, float]:
        """Load the checkpoint at ``path`` into ``model`` (parameters and BN
        statistics) and ``optimizer`` (moments, step counts and ``count``).
        Returns (the next epoch to run, the best val AUC)."""
        return self.apply(self.read(path), model, optimizer)

    def read(self, path: str) -> Dict:
        """The checkpoint at ``path`` on the host. A swap stopped between its
        two moves is finished first (its ``.swap-in`` is the newer file); if
        ``path`` is still missing but ``<path>.old`` survived, that is read."""
        path = os.path.abspath(path)
        self._finish_swap(path)
        if not os.path.exists(path) and os.path.exists(path + ".old"):
            path = path + ".old"
        return torch.load(path, map_location="cpu", weights_only=True)

    @staticmethod
    def apply(obj: Dict, model: nn.Module,
              optimizer: Optional[torch.optim.Optimizer] = None) -> Tuple[int, float]:
        """Load a checkpoint that :meth:`read` returned; returns (the next
        epoch, the best val AUC)."""
        model.load_state_dict(obj["model_state_dict"], strict=True)
        if optimizer is not None:
            optimizer.load_state_dict(obj["optimizer_state_dict"])
        return int(obj["epoch"]) + 1, float(obj["best_val_auc"])
