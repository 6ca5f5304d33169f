"""Faults planted in the program, to show that ``correct`` catches them.

Each is a context manager that breaks the timed path underneath the
harness, in the program's own modules, and restores it on exit. Used by
``benchmark/calibrate.py`` (readings on the card) and the CPU tests; a
benchmark run plants none.

- ``answer_altered`` (screening): the first clip's served probability of
  every batch halved where the engine produces it;
- ``half_frames`` (screening): every clip scored on the first half of its
  frames only, the mean taken over those;
- ``frozen_state`` (training): the optimizer's step leaves the parameters
  as they are;
- ``half_batch`` (training): each micro-batch's second half of clips left
  out of the loss, its mean taken over the rest; the forward still runs
  over every clip, so every clip still gets its prediction.
"""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def _patched(module: str, owner: str, attr: str, make):
    mod = importlib.import_module(module)
    target = getattr(mod, owner) if owner else mod
    orig = getattr(target, attr)
    setattr(target, attr, make(orig))
    try:
        yield
    finally:
        setattr(target, attr, orig)


def answer_altered():
    def make(orig):
        def _forward(self, clips):
            probs = orig(self, clips).clone()
            probs[0] = probs[0] / 2
            return probs
        return _forward
    return _patched("ewvit_tpu_torch.serving", "InferenceEngine", "_forward", make)


def half_frames():
    def make(orig):
        def _forward(self, clips):
            return orig(self, clips[:, :max(1, clips.shape[1] // 2)])
        return _forward
    return _patched("ewvit_tpu_torch.serving", "InferenceEngine", "_forward", make)


def frozen_state():
    def make(orig):
        def step(self, closure=None):
            for group in self.param_groups:
                group["count"] = group.get("count", 0) + 1
            return None
        return step
    return _patched("ewvit_tpu_torch.train.optimizer", "ScheduledAdam", "step", make)


def half_batch():
    def make(orig):
        def combined_loss(outputs, labels, criterion, epoch, max_epochs, valid_mask=None):
            b = labels.reshape(-1).shape[0]
            keep = torch.zeros(b, device=labels.device)
            keep[:max(1, b // 2)] = 1.0
            return orig(outputs, labels, criterion, epoch, max_epochs, valid_mask=keep)
        return combined_loss
    return _patched("ewvit_tpu_torch.train.steps", "", "combined_loss", make)


FAULTS = {"answer_altered": answer_altered, "half_frames": half_frames,
          "frozen_state": frozen_state, "half_batch": half_batch}
