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

With ``mesh`` (``parallel.make_mesh``) the rank holds its ``B/W`` clips of
each micro-batch of ``B`` (``Mesh.shard``; every rank of a frames group the
same clips), as the JAX step's batch sharding gives each device its rows,
and the step computes the global one: the forward states its global rows,
runs the rank's share of every chunk on a frames axis (``F > 1``) and syncs
train-mode BN over the ranks holding rows of the chunk
(``models/detector.video_forward``); the video-level outputs are gathered
over the batch group (differentiably: the backward of the gather is a
reduce-scatter) and ``combined_loss`` runs on the global batch on every
rank, so the orthogonality loss is the global cross-covariance's; after the
backward, one all-reduce of the fp32 gradients over the whole mesh divided
by ``W*F``, and the optimizer step, leave every rank's parameters identical.

The divisor follows from the adjoints. The loss is replicated, so each rank's
gradient of the gathered outputs is the whole true one; the gather's
reduce-scatter sums it over the W batch ranks (W times a rank's rows'
share), and the frames all-reduce before the head sums that again over the
F frames ranks: every rank's backbone gradient is ``W*F`` times its rows'
share, and its head gradient is ``W`` times its clips' share, once on each
of F frames ranks. Summed over the mesh, both are ``W*F`` times the true
gradient. The model is not wrapped in ``DistributedDataParallel``:
``video_forward`` calls it once per chunk (and the head once) under
non-reentrant checkpoint before one backward, which DDP's reducer does not
expect.

The JAX package's ``remat_policy``, ``grad_dtype`` and ``unroll`` have no
counterpart here (ROADMAP).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ewvit_tpu_torch.device import compute_dtype
from ewvit_tpu_torch.models.detector import DeepfakeDetector, chunk_seeds, video_forward
from ewvit_tpu_torch.train.losses import combined_loss, weighted_bce_with_logits


def train_step(model: DeepfakeDetector, optimizer: torch.optim.Optimizer,
               frames: torch.Tensor, labels: torch.Tensor, *, seed: int,
               mode: str = "dynamic", frame_chunk: int = 8, accum_steps: int = 1,
               pos_weight: float = 1.0, epoch: int = 0, max_epochs: int = 30,
               remat: Optional[bool] = None, mesh=None) -> Dict[str, torch.Tensor]:
    """One update; returns ``{'loss', 'cls_loss', 'orth_loss'}`` (fp32 means
    over the micro-batches) and ``'preds'`` ``[accum*B]`` (the training
    forward's sigmoid), detached, on the model's device.

    ``model`` is put in train mode and must hold fp32 parameters;
    ``optimizer`` comes from ``train.optimizer.make_optimizer``. With
    ``mesh``, ``frames`` and ``labels`` are this rank's rows
    (``mesh.shard(global, groups=accum_steps)``, all ``K`` frames of them)
    and ``preds`` are the global ones."""
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
                                remat=remat, mesh=mesh, frame_axis=True)
        if mesh is not None:      # the losses of the global batch
            out = {k: mesh.gather(v) for k, v in out.items()}
            lb = mesh.gather(lb)
        loss, parts = combined_loss(out, lb, criterion, epoch, max_epochs)
        loss.backward()
        for k, v in (("loss", loss), ("cls_loss", parts["cls_loss"]),
                     ("orth_loss", parts["orth_loss"])):
            sums[k] += v.detach()
        preds.append(torch.sigmoid(out["logits"].detach().float()).reshape(-1))

    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    if mesh is not None:
        flat = _flatten_dense_tensors(grads)
        mesh.all_reduce_(flat, mesh.world_group).div_(float(g * mesh.world_size))
        torch._foreach_copy_(grads, _unflatten_dense_tensors(flat, grads))
    elif g > 1:
        torch._foreach_div_(grads, float(g))
    optimizer.step()
    return {**{k: v / g for k, v in sums.items()}, "preds": torch.cat(preds)}
