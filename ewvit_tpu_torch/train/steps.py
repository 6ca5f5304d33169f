"""The train step with gradient accumulation (ewvit_tpu/train/steps.py).

One :func:`train_step` is one optimizer update over ``accum_steps``
micro-batches, as the JAX package's ``train_step`` (steps.py:66-145) and the
reference's eager loop (train.py:93-140):

- ``frames`` ``[accum*B, K, 3, H, W]`` (preprocessed) split into
  ``accum_steps`` micro-batches of ``B`` clips, in order;
- per micro-batch, the train-mode ``video_forward`` (true ragged tail chunk,
  dropout and stochastic depth seeded from the step's ``seed``, per-chunk
  remat) under ``torch.autocast`` to the compute dtype when that is
  bfloat16, then ``combined_loss`` with ``weighted_bce_with_logits`` and the
  backward; parameters, gradients and Adam stay fp32, the losses are fp32;
- BN running statistics carried from chunk to chunk and micro-batch to
  micro-batch;
- the gradients summed in fp32 and divided by ``accum_steps`` (the mean over
  micro-batches, steps.py:133-134); every trainable parameter without a
  gradient (one the mode does not use) gets a zero one, as ``jax.grad``
  gives it; then one optimizer update.

The JAX package's ``remat_policy``, ``grad_dtype`` and ``unroll`` have no
counterpart here (ROADMAP).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from ewvit_tpu_torch.device import compute_dtype
from ewvit_tpu_torch.models.detector import DeepfakeDetector, chunk_seeds, video_forward
from ewvit_tpu_torch.train.losses import combined_loss, weighted_bce_with_logits


def train_step(model: DeepfakeDetector, optimizer: torch.optim.Optimizer,
               frames: torch.Tensor, labels: torch.Tensor, *, seed: int,
               mode: str = "dynamic", frame_chunk: int = 8, accum_steps: int = 1,
               pos_weight: float = 1.0, epoch: int = 0, max_epochs: int = 30,
               remat: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """One update; returns ``{'loss', 'cls_loss', 'orth_loss'}`` (fp32 means
    over the micro-batches) and ``'preds'`` ``[accum*B]`` (the training
    forward's sigmoid), detached, on the model's device.

    ``model`` is put in train mode and must hold fp32 parameters;
    ``optimizer`` comes from ``train.optimizer.make_optimizer``."""
    g = accum_steps
    bt = frames.shape[0]
    if bt % g:
        raise ValueError(f"batch {bt} is not divisible by accum_steps {g}")
    b = bt // g
    dev = next(model.parameters()).device
    if frames.device != dev or labels.device != dev:
        raise ValueError(f"frames and labels must be on the model's device {dev}")
    params = [p for group in optimizer.param_groups for p in group["params"]]
    if any(p.dtype != torch.float32 for p in params):
        raise ValueError("training keeps fp32 parameters (cast_for_inference is for serving)")
    dt = compute_dtype(model.cfg.compute_dtype)
    criterion = functools.partial(weighted_bce_with_logits, pos_weight=pos_weight)
    model.train()
    optimizer.zero_grad(set_to_none=True)

    sums = {k: torch.zeros((), dtype=torch.float32, device=dev)
            for k in ("loss", "cls_loss", "orth_loss")}
    preds = []
    for i, s in enumerate(chunk_seeds(seed, g)):
        fr, lb = frames[i * b:(i + 1) * b], labels[i * b:(i + 1) * b]
        with torch.autocast(dev.type, dtype=dt, enabled=dt != torch.float32):
            out = video_forward(model, fr, mode=mode, frame_chunk=frame_chunk, seed=s,
                                remat=remat)
        loss, parts = combined_loss(out, lb, criterion, epoch, max_epochs)
        loss.backward()
        for k, v in (("loss", loss), ("cls_loss", parts["cls_loss"]),
                     ("orth_loss", parts["orth_loss"])):
            sums[k] += v.detach()
        preds.append(torch.sigmoid(out["logits"].detach().float()).reshape(-1))

    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if g > 1:
        torch._foreach_div_([p.grad for p in params], float(g))
    optimizer.step()
    return {**{k: v / g for k, v in sums.items()}, "preds": torch.cat(preds)}
