"""Evaluation: checkpoint loading, the eval step, the dataset loaders and a
dataset pass (ewvit_tpu/evaluation.py, ewvit_tpu/train/steps.py:158-186).

- :func:`load_model` (from ``checkpoint.py``) builds the detector and loads
  a ``.pth``/``.pt`` checkpoint in the reference layout.
- :func:`eval_step`: forward, ``combined_loss`` with pos-weighted BCE, and
  sigmoid predictions, without gradients.
- :func:`evaluate` runs :func:`eval_step` over any iterable of
  ``(uint8 [B, K, H, W, 3] clips, labels)`` batches and returns the metric
  suite of ``utils/metrics.py``; pad rows of a padded tail batch (the
  loader's ``true_len()`` or ``len(loader.dataset)``) stay out of the losses
  and the metrics.
- :func:`get_dataloader` builds the FF++, Celeb-DF or diffusion test set
  and its ``pad_last`` loader.

:func:`evaluate` with ``mesh`` (``parallel.make_mesh``) is data-parallel
over the batch axis, as the JAX ``evaluate(mesh=)``: the loader yields this
rank's rows of each global batch (``get_dataloader(shard=mesh.batch_shard)``),
the weights are broadcast from rank 0, and :func:`eval_step` gathers the
video-level outputs and labels over the batch group before the masked losses
and the predictions, so every rank returns the world-of-one result.

:func:`eval_step` also runs under ``torch.autocast`` on fp32 weights (the
``Trainer``'s val epoch); :func:`evaluate` casts the model it is given to
the compute dtype in place, so it is for a loaded model, never for one
that is still training.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ewvit_tpu_torch.checkpoint import load_model  # noqa: F401  (re-exported)
from ewvit_tpu_torch.data.datasets import (
    CelebDFDataset,
    DiffusionDataset,
    FaceForensicsDataset,
)
from ewvit_tpu_torch.data.pipeline import BatchLoader, DevicePrefetcher
from ewvit_tpu_torch.data.transforms import FrameTransform
from ewvit_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from ewvit_tpu_torch.models.detector import DeepfakeDetector, check_mode, video_forward
from ewvit_tpu_torch.ops.preprocess import preprocess_batch
from ewvit_tpu_torch.serving import cast_for_inference
from ewvit_tpu_torch.train.losses import combined_loss, weighted_bce_with_logits
from ewvit_tpu_torch.utils.metrics import binary_metrics


@torch.no_grad()
def eval_step(model: DeepfakeDetector, frames: torch.Tensor, labels: torch.Tensor,
              valid_mask: Optional[torch.Tensor] = None, *, mode: str = "dynamic",
              frame_chunk: int = 8, pos_weight: float = 1.0, epoch: int = 1,
              max_epochs: int = 1, mesh=None) -> Dict[str, torch.Tensor]:
    """``frames`` ``[B, K, 3, H, W]`` preprocessed, ``labels`` ``[B]`` ->
    ``{'loss', 'cls_loss', 'orth_loss'}`` (fp32 scalars) and ``'preds'`` ``[B]``
    (sigmoid probabilities). ``valid_mask`` (``[B]`` 0/1) keeps pad rows out
    of both loss terms.

    With ``mesh``: ``frames`` and ``labels`` are this rank's rows, and
    ``valid_mask``, ``preds`` and the returned ``'labels'`` are the global
    batch's."""
    outputs = video_forward(model, frames, mode=mode, frame_chunk=frame_chunk, mesh=mesh)
    extra = {}
    if mesh is not None:
        outputs = {k: mesh.gather(v) for k, v in outputs.items()}
        labels = extra["labels"] = mesh.gather(labels)
    criterion = functools.partial(weighted_bce_with_logits, pos_weight=pos_weight)
    loss, parts = combined_loss(outputs, labels, criterion, epoch, max_epochs,
                                valid_mask=valid_mask)
    return {"loss": loss, "cls_loss": parts["cls_loss"], "orth_loss": parts["orth_loss"],
            "preds": torch.sigmoid(outputs["logits"].float()).reshape(-1), **extra}


def true_len(loader) -> Optional[int]:
    """The real (not padded) rows a loader yields: its ``true_len()``, else
    ``len(loader.dataset)``, else None (no padding to trim)."""
    if hasattr(loader, "true_len"):
        return loader.true_len()
    if hasattr(loader, "dataset"):
        return len(loader.dataset)
    return None


def get_dataloader(root: str, dataset: str = "ff++", *, split: str = "test",
                   batch_size: int = 8, frame_count: int = 300,
                   single_method: Optional[str] = None, test_list: Optional[str] = None,
                   num_workers: int = 4, transform=None,
                   shard: Optional[Tuple[int, int]] = None) -> Tuple[BatchLoader, object]:
    """Dataset and loader (the reference's eval.py:96-133; the JAX package's
    evaluation.py:113). Returns (loader, dataset); the loader pads the tail
    batch (``pad_last``) and :func:`evaluate` trims the pad rows. ``shard``:
    ``BatchLoader``'s (a rank's rows of each batch)."""
    transform = transform if transform is not None else FrameTransform()
    if dataset == "ff++":
        ds = FaceForensicsDataset(root, split=split, frame_count=frame_count,
                                  transform=transform, single_method=single_method)
    elif dataset == "celeb-df":
        ds = CelebDFDataset(root, split=[split], frame_count=frame_count,
                            transform=transform, testing_file=test_list)
    elif dataset == "diffusion":
        ds = DiffusionDataset(root, transform=transform, single_method=single_method)
    else:
        raise ValueError(f"Unknown dataset '{dataset}'")
    return BatchLoader(ds, batch_size, num_workers=num_workers, pad_last=True,
                       shard=shard), ds


def evaluate(model: DeepfakeDetector, loader, *, mode: str = "dynamic",
             frame_chunk: int = 8, device: DeviceLike = "cuda", mesh=None) -> Dict:
    """Metrics of ``model`` over ``loader``'s ``(clips, labels)`` batches.

    The model is moved to ``device`` and cast to its compute dtype for
    inference in place (``serving.cast_for_inference``). The dataset loss is
    the mean of the per-row losses: each batch's loss is weighted by its
    true size. ``orth_loss`` is the mean over batches and ``orth_losses``
    the per-batch series; ``preds`` and ``labels`` are the true rows'.

    ``mesh``: data-parallel over the batch axis (the module docstring); the
    model runs on ``mesh.device`` and ``loader`` yields this rank's rows.
    """
    check_mode(mode)
    dev = mesh.device if mesh is not None else resolve_device(device)
    dtype = compute_dtype(model.cfg.compute_dtype)
    model = model.to(dev).eval()
    if mesh is not None:
        mesh.replicate_(model)
    model = cast_for_inference(model, dtype)
    w = mesh.batch_size if mesh is not None else 1
    remaining = true_len(loader)
    orth_losses, preds, labels = [], [], []
    loss_sum, n_total = 0.0, 0
    # the copy of batch N+1 overlaps batch N's forward; labels stay on the host
    for clips, lbls in DevicePrefetcher(loader, dev):
        lbls = np.asarray(lbls)
        rows = len(lbls) * w          # the global batch
        n = rows
        if remaining is not None:
            n = min(n, remaining)
            remaining -= n
        valid = torch.as_tensor(np.arange(rows) < n, dtype=torch.float32, device=dev)
        x = preprocess_batch(torch.as_tensor(clips).to(dev), dtype)
        out = eval_step(model, x, torch.as_tensor(lbls, dtype=torch.float32, device=dev),
                        valid, mode=mode, frame_chunk=frame_chunk, mesh=mesh)
        if mesh is not None:
            lbls = out["labels"].cpu().numpy().astype(lbls.dtype)
        loss_sum += float(out["loss"]) * n
        n_total += n
        orth_losses.append(float(out["orth_loss"]))
        preds.extend(out["preds"][:n].cpu().tolist())
        labels.extend(lbls[:n].tolist())
    results = binary_metrics(labels, preds, loss=loss_sum / n_total if n_total else None)
    results["orth_loss"] = float(np.mean(orth_losses)) if orth_losses else 0.0
    results["orth_losses"] = orth_losses
    results["preds"], results["labels"] = preds, labels
    return results


def print_metrics(name: str, m: Dict) -> None:
    """Console report (the reference's eval.py:196-208)."""
    print(f"\n===== {name} =====")
    for k in ("loss", "accuracy", "auc", "eer", "eer_threshold", "ap",
              "precision", "recall", "f1"):
        if k in m and m[k] is not None:
            print(f"  {k:>14}: {m[k]:.4f}")
    if "confusion_matrix" in m:
        cm = m["confusion_matrix"]
        print(f"  confusion: TN={cm[0][0]} FP={cm[0][1]} FN={cm[1][0]} TP={cm[1][1]}")
