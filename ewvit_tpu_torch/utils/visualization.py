"""Training and evaluation plots: PNG dashboards and a history CSV, on the host.

Counterpart of ``ewvit_tpu/utils/visualization.py`` (the reference's
utils/visualization.py): :class:`TrainVisualization` (per-epoch history, EMA
smoothing, loss, metric and lr curves, a dashboard, ``training_history.csv``)
and :class:`EvalVisualization` (confusion heatmap, ROC, precision-recall,
prediction distribution, orthogonality-vs-prediction scatter), with the same
methods, file names and CSV schema.

matplotlib is imported by the plotting methods, never by the module, so the
package imports on a machine without it; a plot asked for there raises
``ImportError`` naming matplotlib. seaborn is optional, as in the JAX
package. The ROC, the precision-recall curve, AUC and AP come from the
port's numpy ``utils/metrics.py``, not from sklearn.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence

import numpy as np

from ewvit_tpu_torch.utils.metrics import (
    auc,
    average_precision,
    precision_recall_curve,
    roc_curve,
)


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend; ``ImportError`` naming
    matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _seaborn():
    try:
        import seaborn
    except ImportError:
        return None
    return seaborn


def _ema(values: Sequence[float], alpha: float = 0.6) -> List[float]:
    """Exponential smoothing (the reference's visualization.py:206)."""
    out: List[float] = []
    for v in values:
        out.append(v if not out else alpha * out[-1] + (1 - alpha) * v)
    return out


def _save(plt, fig, path: str) -> str:
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


class TrainVisualization:
    """Accumulates the per-epoch history; renders curves and a dashboard."""

    KEYS = ("train_loss", "train_cls_loss", "train_orth_loss", "val_loss",
            "train_acc", "val_acc", "train_auc", "val_auc", "lr", "epoch_time")

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.history: Dict[str, List[float]] = {k: [] for k in self.KEYS}

    def update(self, **metrics: float) -> None:
        for k in self.KEYS:
            if k in metrics and metrics[k] is not None:
                self.history[k].append(float(metrics[k]))

    def _epochs(self, key: str):
        return np.arange(1, len(self.history[key]) + 1)

    def plot_losses(self, fname: str = "loss_curves.png") -> str:
        plt = pyplot()
        fig, ax = plt.subplots(figsize=(8, 5))
        for k, label in (("train_loss", "train"), ("val_loss", "val"),
                         ("train_cls_loss", "train cls"), ("train_orth_loss", "train orth")):
            if self.history[k]:
                ax.plot(self._epochs(k), _ema(self.history[k]), label=label)
        ax.set_xlabel("epoch"); ax.set_ylabel("loss"); ax.legend()
        ax.set_title("Training / validation loss")
        return _save(plt, fig, os.path.join(self.output_dir, fname))

    def plot_metrics(self, fname: str = "metric_curves.png") -> str:
        plt = pyplot()
        fig, ax = plt.subplots(figsize=(8, 5))
        for k in ("train_acc", "val_acc", "train_auc", "val_auc"):
            if self.history[k]:
                ax.plot(self._epochs(k), self.history[k], label=k)
        ax.set_xlabel("epoch"); ax.set_ylabel("metric"); ax.set_ylim(0, 1.05)
        ax.legend(); ax.set_title("Accuracy / AUC")
        return _save(plt, fig, os.path.join(self.output_dir, fname))

    def plot_lr(self, fname: str = "lr_schedule.png") -> str:
        plt = pyplot()
        fig, ax = plt.subplots(figsize=(8, 4))
        if self.history["lr"]:
            ax.plot(self._epochs("lr"), self.history["lr"])
        ax.set_xlabel("epoch"); ax.set_ylabel("learning rate")
        ax.set_yscale("log"); ax.set_title("LR schedule")
        return _save(plt, fig, os.path.join(self.output_dir, fname))

    def plot_dashboard(self, fname: str = "dashboard.png") -> str:
        plt = pyplot()
        fig, axes = plt.subplots(2, 2, figsize=(12, 8))
        (a, b), (c, d) = axes
        for k, lbl in (("train_loss", "train"), ("val_loss", "val")):
            if self.history[k]:
                a.plot(self._epochs(k), _ema(self.history[k]), label=lbl)
        a.set_title("loss"); a.legend()
        for k in ("train_auc", "val_auc"):
            if self.history[k]:
                b.plot(self._epochs(k), self.history[k], label=k)
        b.set_title("AUC"); b.set_ylim(0, 1.05); b.legend()
        for k in ("train_acc", "val_acc"):
            if self.history[k]:
                c.plot(self._epochs(k), self.history[k], label=k)
        c.set_title("accuracy"); c.set_ylim(0, 1.05); c.legend()
        if self.history["lr"]:
            d.plot(self._epochs("lr"), self.history["lr"])
            d.set_yscale("log")
        d.set_title("lr")
        return _save(plt, fig, os.path.join(self.output_dir, fname))

    def save_metrics(self, fname: str = "training_history.csv") -> str:
        """CSV with one row per epoch (the reference's visualization.py:367-388)."""
        n = max((len(v) for v in self.history.values()), default=0)
        path = os.path.join(self.output_dir, fname)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["epoch"] + list(self.KEYS))
            for i in range(n):
                w.writerow([i + 1] + [self.history[k][i] if i < len(self.history[k]) else ""
                                      for k in self.KEYS])
        return path

    def render_all(self) -> None:
        self.plot_losses(); self.plot_metrics(); self.plot_lr()
        self.plot_dashboard(); self.save_metrics()


class EvalVisualization:
    """Per-evaluation plots (the reference's visualization.py:9-151)."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    def confusion(self, cm, fname: str = "confusion_matrix.png",
                  labels=("real", "fake")) -> str:
        plt, sns = pyplot(), _seaborn()
        cm = np.asarray(cm)
        fig, ax = plt.subplots(figsize=(5, 4))
        if sns is not None:
            sns.heatmap(cm, annot=True, fmt="d", cmap="Blues",
                        xticklabels=labels, yticklabels=labels, ax=ax)
        else:
            ax.imshow(cm); ax.set_xticks([0, 1], labels); ax.set_yticks([0, 1], labels)
            for i in range(2):
                for j in range(2):
                    ax.text(j, i, int(cm[i, j]), ha="center")
        ax.set_xlabel("predicted"); ax.set_ylabel("true")
        ax.set_title("Confusion matrix")
        return _save(plt, fig, os.path.join(self.output_dir, fname))

    def roc(self, labels, scores, fname: str = "roc_curve.png", name: str = "model") -> str:
        plt = pyplot()
        fpr, tpr, _ = roc_curve(labels, scores)
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.plot(fpr, tpr, label=f"{name} (AUC={auc(fpr, tpr):.4f})")
        ax.plot([0, 1], [0, 1], "k--", lw=0.8)
        ax.set_xlabel("FPR"); ax.set_ylabel("TPR"); ax.legend()
        ax.set_title("ROC")
        return _save(plt, fig, os.path.join(self.output_dir, fname))

    def precision_recall(self, labels, scores, fname: str = "pr_curve.png") -> str:
        plt = pyplot()
        p, r, _ = precision_recall_curve(labels, scores)
        ap = average_precision(labels, scores)
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.plot(r, p, label=f"AP={ap:.4f}")
        ax.set_xlabel("recall"); ax.set_ylabel("precision"); ax.legend()
        ax.set_title("Precision-recall")
        return _save(plt, fig, os.path.join(self.output_dir, fname))

    def prediction_distribution(self, labels, scores,
                                fname: str = "pred_distribution.png") -> str:
        plt, sns = pyplot(), _seaborn()
        labels, scores = np.asarray(labels), np.asarray(scores)
        fig, ax = plt.subplots(figsize=(6, 4))
        for cls, name in ((0, "real"), (1, "fake")):
            vals = scores[labels == cls]
            if len(vals):
                if sns is not None:
                    sns.kdeplot(vals, ax=ax, label=name, fill=True)
                else:
                    ax.hist(vals, bins=20, alpha=0.5, label=name, density=True)
        ax.set_xlabel("predicted probability"); ax.legend()
        ax.set_title("Prediction distribution")
        return _save(plt, fig, os.path.join(self.output_dir, fname))

    def orth_scatter(self, orth_losses, scores, fname: str = "orth_vs_pred.png") -> str:
        plt = pyplot()
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.scatter(orth_losses, scores, s=8, alpha=0.6)
        ax.set_xlabel("orthogonality loss"); ax.set_ylabel("prediction")
        ax.set_title("Orthogonality vs prediction")
        return _save(plt, fig, os.path.join(self.output_dir, fname))
