"""The training run: epochs, curriculum, metrics, checkpoints (ewvit_tpu/train/loop.py).

Library form of the reference's train entry point (train.py:93-345), as the
JAX package's ``Trainer``:

- :meth:`Trainer.train_epoch` groups ``accum_steps`` loader batches into one
  super-batch (the tail group with fewer micro-batches, train.py:125-127)
  and takes one :func:`train.steps.train_step` per group, after the train
  preprocessing (colour jitter) on the device. The seeds of a step (jitter
  and dropout) derive from ``(TrainConfig.seed, the optimizer's update
  count)`` (:func:`step_seeds`), not from a stateful generator, so a resumed
  run repeats the uninterrupted one. Train metrics come from the training
  forward's predictions (train.py:121-135).
- :meth:`Trainer.eval_epoch` runs ``evaluation.eval_step`` on the fp32
  training model in eval mode under ``no_grad`` and ``torch.autocast`` to the
  compute dtype, as the JAX package's ``eval_step`` runs fp32 parameters
  with bf16 compute; the kernel flags' K2, K3 and K4 run there. It never
  casts the model (``serving.cast_for_inference`` would turn the training
  weights to bf16 in place). Pad rows of a ``pad_last`` tail batch stay out
  of the losses and the metrics.
- :meth:`Trainer.fit` refreshes the curriculum of both datasets each epoch,
  saves ``best_model.pth`` on a new best finite val AUC and
  ``checkpoint_{epoch+1}.pth`` every ``save_every`` epochs and at the last,
  and drains async saves at the end; :meth:`Trainer.resume` restores a run
  and skips the epochs it had done.

Batches reach the card through ``data.pipeline.DevicePrefetcher`` (the copy
of super-batch N+1 overlaps step N); labels stay on the host. ``fit(viz=)``
feeds a ``utils.visualization.TrainVisualization`` (or anything with its
``update``/``render_all``) the JAX ``fit``'s keys each epoch and renders it
at the end.

``mesh=`` (``parallel.make_mesh``; ewvit_tpu/train/loop.py:66, :94-97,
:128-146) trains data-parallel: the loaders yield this rank's rows of each
global batch (``BatchLoader(shard=mesh.batch_shard)``; the ranks of a frames
group get the same clips, as the JAX ``Trainer`` replicates a batch over
frames),
the weights are broadcast from rank 0 at construction and after
:meth:`Trainer.resume` (which rank 0 reads and broadcasts), the colour
jitter is drawn for the global super-batch (``models/rows.global_rows``),
``train_step(mesh=)`` and ``eval_step(mesh=)`` compute the global step and
outputs, so every rank's epoch metrics are the world-of-one run's, and rank 0
alone logs and writes checkpoints (a barrier after each save and at the end
of :meth:`Trainer.fit`). On a frames axis (``frames > 1``) the train step
splits each chunk's frames over the frames group (``parallel/mesh.py``): BN
syncs over the whole mesh, so the running statistics move once per global
chunk, in the unsplit order, on every rank. The val epoch shards the batch
only, as the JAX ``evaluate`` does; the frames ranks repeat it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ewvit_tpu_torch.configs import ModelConfig, TrainConfig
from ewvit_tpu_torch.data.pipeline import DevicePrefetcher
from ewvit_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from ewvit_tpu_torch.evaluation import eval_step, true_len
from ewvit_tpu_torch.models.detector import DeepfakeDetector, build_detector
from ewvit_tpu_torch.models.rows import global_rows
from ewvit_tpu_torch.ops.preprocess import preprocess_batch
from ewvit_tpu_torch.train.checkpoint import CheckpointManager
from ewvit_tpu_torch.train.optimizer import make_optimizer, update_count
from ewvit_tpu_torch.train.steps import train_step
from ewvit_tpu_torch.utils.metrics import binary_metrics


@dataclasses.dataclass
class EpochResult:
    loss: float
    cls_loss: float
    orth_loss: float
    metrics: Dict[str, Any]
    seconds: float


def step_seeds(seed: int, count: int) -> Tuple[int, int]:
    """(jitter seed, dropout seed) of the update ``count`` of a run seeded
    with ``seed``."""
    jitter, dropout = np.random.SeedSequence([int(seed), int(count)]).generate_state(2)
    return int(jitter), int(dropout)


class Trainer:
    """Owns the model and the optimizer; runs train and val epochs over
    ``BatchLoader``s on ``device`` (CUDA unless the caller names the CPU).

    ``model``: the detector to train (default: ``build_detector`` seeded
    with ``train_cfg.seed``); it is moved to ``device`` and must hold fp32
    parameters. ``mesh``: data-parallel training (the module docstring); the
    device is then ``mesh.device``.
    """

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        *,
        mode: str = "dynamic",
        pos_weight: float = 1.0,
        steps_per_epoch: int = 1,
        checkpoint_dir: Optional[str] = None,
        remat: bool = True,
        save_every: int = 1,
        async_ckpt: bool = False,
        device: DeviceLike = "cuda",
        model: Optional[DeepfakeDetector] = None,
        log: Callable[[str], None] = print,
        mesh=None,
    ):
        if mesh is not None:
            if train_cfg.batch_size % mesh.batch_size:
                raise ValueError(f"batch_size {train_cfg.batch_size} must be divisible by "
                                 f"the mesh's batch axes dcn*data = {mesh.batch_size}")
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0      # logs and writes files
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.mode = mode
        self.pos_weight = float(pos_weight)
        self.remat = remat
        self.log = log if self.lead else (lambda msg: None)
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.dtype = compute_dtype(model_cfg.compute_dtype)
        if model is None:
            model = build_detector(model_cfg, device=self.device, seed=train_cfg.seed)
        self.model = model.to(self.device)
        if mesh is not None:
            mesh.replicate_(self.model)
        self._steps_per_epoch = max(1, steps_per_epoch)
        self.optimizer = make_optimizer(
            self.model, lr=train_cfg.lr, weight_decay=train_cfg.weight_decay,
            epochs=train_cfg.epochs, steps_per_epoch=self._steps_per_epoch,
            eta_min=train_cfg.lr_min)
        self.saves = bool(checkpoint_dir)
        self.ckpt = (CheckpointManager(checkpoint_dir, async_save=async_ckpt)
                     if checkpoint_dir and self.lead else None)
        # save_every=1 keeps the reference's per-epoch checkpoints
        # (train.py:313-319); more spreads the saves of a long run
        self.save_every = max(1, int(save_every))
        self.start_epoch = 0
        self.best_val_auc = 0.0

    # ----- checkpointing ---------------------------------------------------

    def resume(self, path: str) -> None:
        if not self.saves:
            raise ValueError("resume needs a checkpoint_dir")
        if self.mesh is None:
            obj = self.ckpt.read(path)
        else:      # rank 0 reads, every rank loads what it broadcasts
            box = [self.ckpt.read(path) if self.lead else None]
            if dist.get_world_size() > 1:
                dist.broadcast_object_list(box, src=0, device=self.device)
            obj = box[0]
        self.start_epoch, self.best_val_auc = CheckpointManager.apply(obj, self.model,
                                                                      self.optimizer)
        self.log(f"Resumed from {path}: start_epoch={self.start_epoch} "
                 f"best_val_auc={self.best_val_auc:.4f}")

    # ----- single epochs ---------------------------------------------------

    def _frames(self, frames) -> torch.Tensor:
        """A batch's uint8 clips (prefetched to the device, or host numpy)
        on the device."""
        return torch.as_tensor(frames).to(self.device)

    def _host_to_device(self, array, dtype: torch.dtype) -> torch.Tensor:
        """A small host array (labels, a pad mask) on the device; on CUDA
        from pinned memory without blocking (a pageable copy would first
        wait for the stream to drain)."""
        t = torch.as_tensor(np.asarray(array), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def train_epoch(self, loader, epoch: int) -> EpochResult:
        cfg = self.train_cfg
        t0 = time.time()
        sums, preds, all_labels = [], [], []

        def groups():
            """``accum_steps`` loader batches as one host super-batch."""
            group: list = []
            for batch in loader:
                group.append(batch)
                if len(group) == cfg.accum_steps:
                    yield (np.concatenate([b[0] for b in group]),
                           np.concatenate([b[1] for b in group]), len(group))
                    group = []
            if group:  # tail flush (train.py:125-127)
                yield (np.concatenate([b[0] for b in group]),
                       np.concatenate([b[1] for b in group]), len(group))

        for frames, labels, n_micro in DevicePrefetcher(groups(), self.device):
            jitter_seed, seed = step_seeds(cfg.seed, update_count(self.optimizer))
            gen = torch.Generator(device=self.device).manual_seed(jitter_seed)
            with self._jitter_rows(len(labels), n_micro):
                x = preprocess_batch(self._frames(frames), self.dtype, train=True,
                                     generator=gen)
            lb = self._host_to_device(labels, torch.float32)
            m = train_step(self.model, self.optimizer, x, lb, seed=seed, mode=self.mode,
                           frame_chunk=self.model_cfg.frame_chunk, accum_steps=n_micro,
                           pos_weight=self.pos_weight, epoch=epoch, max_epochs=cfg.epochs,
                           remat=self.remat, mesh=self.mesh)
            sums.append(torch.stack([m["loss"], m["cls_loss"], m["orth_loss"]]))
            preds.append(m["preds"])
            if self.mesh is None:
                all_labels.extend(np.asarray(labels).tolist())
            else:
                all_labels.append(self.mesh.gather(
                    self._host_to_device(labels, torch.int32), groups=n_micro))
        if self.mesh is not None and all_labels:
            all_labels = torch.cat(all_labels).tolist()

        # one host sync an epoch: the step losses and predictions
        if sums:
            loss, cls_loss, orth_loss = torch.stack(sums).mean(dim=0).tolist()
        else:
            loss = cls_loss = orth_loss = float("nan")
        all_preds = torch.cat(preds).tolist() if preds else []
        m = binary_metrics(all_labels, all_preds) if all_labels else {}
        return EpochResult(loss=loss, cls_loss=cls_loss, orth_loss=orth_loss, metrics=m,
                           seconds=time.time() - t0)

    def _jitter_rows(self, rows: int, n_micro: int):
        """This rank's rows of the global super-batch of ``n_micro``
        micro-batches, for the jitter's draws (a null context without a
        mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        b = rows // n_micro
        big = b * self.mesh.batch_size
        index = (torch.arange(n_micro, device=self.device)[:, None] * big
                 + self.mesh.batch_index * b + torch.arange(b, device=self.device))
        return global_rows(index.reshape(-1), n_micro * big)

    def eval_epoch(self, loader, epoch: Optional[int] = None,
                   max_epochs: Optional[int] = None) -> EpochResult:
        t0 = time.time()
        self.model.eval()
        remaining = true_len(loader)
        losses, preds, labels = [], [], []
        autocast = torch.autocast(self.device.type, dtype=self.dtype,
                                  enabled=self.dtype != torch.float32)
        w = self.mesh.batch_size if self.mesh is not None else 1
        for frames, lbls in DevicePrefetcher(loader, self.device):
            lbls = np.asarray(lbls)
            rows = len(lbls) * w          # the global batch
            n = rows
            if remaining is not None:
                n = min(n, remaining)
                remaining -= n
            # pad rows are masked out of both loss terms, not only the metrics
            valid = self._host_to_device(np.arange(rows) < n, torch.float32)
            x = preprocess_batch(self._frames(frames), self.dtype)
            lb = self._host_to_device(lbls, torch.float32)
            with autocast:
                out = eval_step(self.model, x, lb, valid, mode=self.mode,
                                frame_chunk=self.model_cfg.frame_chunk,
                                pos_weight=self.pos_weight,
                                epoch=epoch if epoch is not None else 1,
                                max_epochs=max_epochs if max_epochs is not None else 1,
                                mesh=self.mesh)
            if self.mesh is not None:
                lbls = out["labels"].cpu().numpy().astype(lbls.dtype)
            losses.append(out["loss"] * n)
            preds.append(out["preds"][:n])
            labels.extend(lbls[:n].tolist())
        n_total = len(labels)
        loss = float(torch.stack(losses).sum()) / n_total if n_total else None
        m = binary_metrics(labels, torch.cat(preds).tolist() if preds else [], loss=loss)
        m["preds"] = torch.cat(preds).tolist() if preds else []
        m["labels"] = labels
        return EpochResult(loss=m.get("loss", float("nan")), cls_loss=float("nan"),
                           orth_loss=float("nan"), metrics=m, seconds=time.time() - t0)

    # ----- full fit --------------------------------------------------------

    def fit(self, train_loader, val_loader, *, train_dataset=None,
            val_dataset=None, viz=None) -> Dict[str, Any]:
        cfg = self.train_cfg
        history = []
        for epoch in range(self.start_epoch, cfg.epochs):
            # curriculum refresh (train.py:290-291)
            for ds in (train_dataset, val_dataset):
                if ds is not None and hasattr(ds, "update_sampling_strategy"):
                    ds.update_sampling_strategy(epoch, cfg.epochs)

            tr = self.train_epoch(train_loader, epoch)
            va = self.eval_epoch(val_loader, epoch=epoch, max_epochs=cfg.epochs)
            val_auc = va.metrics.get("auc", float("nan"))
            lr = self._current_lr()
            self.log(
                f"Epoch {epoch + 1}/{cfg.epochs}: train_loss={tr.loss:.4f} "
                f"(cls {tr.cls_loss:.4f} orth {tr.orth_loss:.4f}) "
                f"val_loss={va.loss:.4f} val_auc={val_auc:.4f} "
                f"val_acc={va.metrics.get('accuracy', float('nan')):.4f} "
                f"lr={lr:.2e} [{tr.seconds:.1f}s+{va.seconds:.1f}s]")
            if viz is not None and self.lead:
                viz.update(train_loss=tr.loss, train_cls_loss=tr.cls_loss,
                           train_orth_loss=tr.orth_loss, val_loss=va.loss,
                           train_acc=tr.metrics.get("accuracy"),
                           train_auc=tr.metrics.get("auc"),
                           val_acc=va.metrics.get("accuracy"), val_auc=val_auc, lr=lr,
                           epoch_time=tr.seconds + va.seconds)

            if np.isfinite(val_auc) and val_auc > self.best_val_auc:
                self.best_val_auc = float(val_auc)
                if self.saves:
                    self._save(self.ckpt.save_best if self.lead else None, epoch)
            if self.saves and (
                    (epoch + 1) % self.save_every == 0 or epoch == cfg.epochs - 1):
                self._save(self.ckpt.save_epoch if self.lead else None, epoch)

            history.append({"epoch": epoch, "train": dataclasses.asdict(tr),
                            "val": {k: v for k, v in va.metrics.items()
                                    if k not in ("preds", "labels", "confusion_matrix")}})
        if viz is not None and self.lead:
            viz.render_all()
        if self.ckpt is not None:
            # drain the async saves (and surface worker errors)
            self.ckpt.wait_until_finished()
        if self.mesh is not None:
            self.mesh.barrier()
        return {"history": history, "best_val_auc": self.best_val_auc}

    def _save(self, save, epoch: int) -> None:
        """``save`` (rank 0's; None elsewhere), then a barrier on a mesh."""
        if save is not None:
            save(self.model, self.optimizer, epoch, self.best_val_auc)
        if self.mesh is not None:
            self.mesh.barrier()

    def _current_lr(self) -> float:
        """The lr of the next update."""
        return float(self.optimizer.schedule(update_count(self.optimizer)))
