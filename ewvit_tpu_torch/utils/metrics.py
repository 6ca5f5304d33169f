"""Metrics: accuracy, AUC, EER, AP, precision, recall, F1, confusion matrix.

Counterpart of ``ewvit_tpu/utils/metrics.py``, written in numpy because the
GPU machine has no sklearn. Each curve follows sklearn's definition, ties
included:

- :func:`roc_curve` is ``sklearn.metrics.roc_curve`` with its default
  ``drop_intermediate=True``: scores sorted descending, one point per
  distinct score (the last row of each tie group), collinear points
  dropped, a first point at threshold ``inf``;
- AUC is the trapezoid under that curve (``roc_auc_score``);
- :func:`precision_recall_curve` is ``sklearn.metrics.precision_recall_curve``
  with its default ``drop_intermediate=False``: one point per distinct
  score, in increasing score order, then the point (recall 0, precision 1);
  recall is 1 throughout when no label is positive;
- AP is the step sum ``-sum(diff(recall) * precision[:-1])`` over that
  curve (``average_precision_score``);
- EER is the fpr at ``nanargmin |fnr - fpr|`` of the ROC (the reference's
  eval.py:79-94), with that point's threshold.

AUC, EER and AP are NaN when the labels hold one class only.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def _clf_curve(labels, scores) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fps, tps, thresholds): counts at or above each distinct score, in
    decreasing score order (sklearn's ``confusion_matrix_at_thresholds``)."""
    y = (np.asarray(labels) == 1).astype(np.float64)
    s = np.asarray(scores, np.float64)
    order = np.argsort(-s, kind="stable")
    s, y = s[order], y[order]
    idx = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, s[idx]


def roc_curve(labels, scores) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) as sklearn's ``roc_curve(drop_intermediate=True)``."""
    fps, tps, thr = _clf_curve(labels, scores)
    if fps.size > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    fps, tps, thr = np.r_[0.0, fps], np.r_[0.0, tps], np.r_[np.inf, thr]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thr


def auc(fpr, tpr) -> float:
    """Trapezoid area under a curve (sklearn's ``auc``)."""
    fpr, tpr = np.asarray(fpr, np.float64), np.asarray(tpr, np.float64)
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def precision_recall_curve(labels, scores) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(precision, recall, thresholds) as sklearn's ``precision_recall_curve``."""
    fps, tps, thr = _clf_curve(labels, scores)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps)
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thr[::-1]


def average_precision(labels, scores) -> float:
    """sklearn's ``average_precision_score``: the step sum over the
    precision-recall curve."""
    precision, recall, _ = precision_recall_curve(labels, scores)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def calculate_eer(labels: Sequence[int], scores: Sequence[float]) -> Tuple[float, float]:
    """(EER, its threshold): the fpr at ``nanargmin |fnr - fpr|``."""
    fpr, tpr, thresholds = roc_curve(labels, scores)
    idx = int(np.nanargmin(np.abs((1 - tpr) - fpr)))
    return float(fpr[idx]), float(thresholds[idx])


def binary_metrics(labels: Sequence[int], scores: Sequence[float],
                   threshold: float = 0.5, loss: Optional[float] = None) -> Dict[str, object]:
    """The reference eval harness's metric dict (eval.py:176-192); precision,
    recall and F1 are 0 where undefined (sklearn's ``zero_division=0``)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, np.float64)
    preds = (scores > threshold).astype(np.int64)
    pos = labels == 1
    tp = int(np.sum(pos & (preds == 1)))
    fp = int(np.sum(~pos & (preds == 1)))
    fn = int(np.sum(pos & (preds == 0)))
    tn = int(np.sum(~pos & (preds == 0)))
    out: Dict[str, object] = {
        "accuracy": float(np.mean(preds == labels)) if labels.size else 0.0,
        "precision": tp / (tp + fp) if tp + fp else 0.0,
        "recall": tp / (tp + fn) if tp + fn else 0.0,
        "f1": 2 * tp / (2 * tp + fp + fn) if tp + fp + fn else 0.0,
    }
    if loss is not None:
        out["loss"] = float(loss)
    if len(np.unique(labels)) > 1:
        out["auc"] = auc(*roc_curve(labels, scores)[:2])
        out["eer"], out["eer_threshold"] = calculate_eer(labels, scores)
        out["ap"] = average_precision(labels, scores)
    else:
        out.update(auc=float("nan"), eer=float("nan"), eer_threshold=float("nan"),
                   ap=float("nan"))
    out["confusion_matrix"] = [[tn, fp], [fn, tp]]
    return out
