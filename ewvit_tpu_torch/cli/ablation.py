"""Ablation study on one GPU: ``python -m ewvit_tpu_torch.cli.ablation``.

The JAX package's ``ablation.py`` (the reference's ablation.py:23-33,
:261-418) on the port: a fresh detector per mode, in the order ``sfe_only``,
``sfe_mwt``, ``dynamic``, trained with plain BCE (``pos_weight`` 1, no
gradient accumulation, an orthogonality ramp that never opens, no
curriculum refresh), the best-val-AUC weights kept (a cloned
``state_dict``) and loaded back for the test pass, and saved as
``{mode}_model/best_model.pth``. One timestamped directory under
``--output`` gets ``metrics_comparison.csv``, ``config.yaml``,
``learning_curves.png`` and ``roc_curves.png``.

:func:`run_ablation` does the device work and writes the CSV, the config
and the checkpoints; :func:`plot_ablation` draws the two figures (it needs
matplotlib). ``config.yaml`` is written by hand (the port has no ``yaml``):
a flat mapping of scalars and one list of strings that ``yaml.safe_load``
reads back to the same dict. ``--device`` (default ``cuda``) is the port's
own.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import random
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

MODES = ["sfe_only", "sfe_mwt", "dynamic"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Deepfake Detection Ablation Study (GPU)")
    p.add_argument("--root", type=str, default="/path/to/dataset")
    p.add_argument("--output", type=str, default="./output/ablation")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--frame-count", type=int, default=300)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--frame-chunk", type=int, default=16)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--tiny", action="store_true",
                   help="ModelConfig.tiny() (64px): smoke runs only")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        s = repr(v)
        if "e" in s and "." not in s.split("e")[0]:     # YAML 1.1 floats need the dot
            mantissa, exp = s.split("e")
            s = f"{mantissa}.0e{exp}"
        return s
    if isinstance(v, str):
        return json.dumps(v)        # a JSON string is a YAML double-quoted scalar
    raise TypeError(f"config.yaml holds scalars and lists of strings, not {type(v)}")


def yaml_text(config: Dict) -> str:
    """A flat mapping of scalars and lists of scalars as YAML block text."""
    lines = []
    for k, v in config.items():
        if isinstance(v, (list, tuple)):
            lines.append(f"{k}:")
            lines += [f"- {_yaml_scalar(x)}" for x in v]
        else:
            lines.append(f"{k}: {_yaml_scalar(v)}")
    return "\n".join(lines) + "\n"


def run_ablation(args: argparse.Namespace) -> Tuple[Dict, Dict, Dict, str]:
    """Train, select and test each mode; returns (results, curves, roc_data,
    out_dir): per mode the test accuracy/precision/f1/auc, the per-epoch
    train_loss/val_loss/val_auc, and the test (labels, preds)."""
    random.seed(args.seed)
    np.random.seed(args.seed)
    from ewvit_tpu_torch.configs import ModelConfig, TrainConfig
    from ewvit_tpu_torch.data.datasets import FaceForensicsDataset
    from ewvit_tpu_torch.data.pipeline import BatchLoader
    from ewvit_tpu_torch.data.transforms import FrameTransform
    from ewvit_tpu_torch.device import resolve_device
    from ewvit_tpu_torch.train.loop import Trainer

    device = resolve_device(args.device)
    out_dir = os.path.join(args.output, time.strftime("%Y%m%d_%H%M%S"))
    os.makedirs(out_dir, exist_ok=True)
    model_cfg = (ModelConfig.tiny() if args.tiny
                 else ModelConfig(dama_dim=args.dim, frame_chunk=args.frame_chunk))
    size = model_cfg.arch.image_size
    transform = FrameTransform(resize=max(1, round(size * 450 / 224)), crop=size)
    datasets = {split: FaceForensicsDataset(args.root, split=split,
                                            frame_count=args.frame_count,
                                            transform=transform, seed=args.seed)
                for split in ("train", "val", "test")}
    loaders = {
        "train": BatchLoader(datasets["train"], args.batch_size, shuffle=True, drop_last=True,
                             num_workers=args.num_workers, seed=args.seed),
        "val": BatchLoader(datasets["val"], args.batch_size, pad_last=True,
                           num_workers=args.num_workers),
        "test": BatchLoader(datasets["test"], args.batch_size, pad_last=True,
                            num_workers=args.num_workers),
    }
    # the reference's ablation trains with plain BCE and no extras
    # (ablation.py:352): no accumulation, no orthogonality term
    train_cfg = TrainConfig(batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
                            frame_count=args.frame_count, accum_steps=1, seed=args.seed,
                            orth_start_frac=10.0)

    results, curves, roc_data = {}, {}, {}
    for mode in MODES:
        print(f"\n======== Ablation: {mode} ========")
        trainer = Trainer(model_cfg, train_cfg, mode=mode, pos_weight=1.0,
                          steps_per_epoch=len(loaders["train"]),
                          checkpoint_dir=os.path.join(out_dir, f"{mode}_model"), device=device)
        hist = {"train_loss": [], "val_loss": [], "val_auc": []}
        best_auc, best_state = -1.0, None
        for epoch in range(args.epochs):
            tr = trainer.train_epoch(loaders["train"], epoch)
            va = trainer.eval_epoch(loaders["val"])
            auc = va.metrics.get("auc", float("nan"))
            hist["train_loss"].append(tr.loss)
            hist["val_loss"].append(va.loss)
            hist["val_auc"].append(auc)
            print(f"  epoch {epoch + 1}/{args.epochs}: train {tr.loss:.4f} "
                  f"val {va.loss:.4f} auc {auc:.4f}")
            if np.isfinite(auc) and auc > best_auc:
                best_auc = float(auc)
                best_state = {k: v.detach().clone()
                              for k, v in trainer.model.state_dict().items()}
        if best_state is not None:   # best-val weights for the test pass (:108-113)
            trainer.model.load_state_dict(best_state)
        trainer.ckpt.save_best(trainer.model, trainer.optimizer, args.epochs - 1, best_auc)

        m = trainer.eval_epoch(loaders["test"]).metrics
        results[mode] = {k: m[k] for k in ("accuracy", "precision", "f1", "auc")}
        curves[mode] = hist
        roc_data[mode] = (m["labels"], m["preds"])
        print(f"  test: acc {m['accuracy']:.4f} auc {m['auc']:.4f}")

    with open(os.path.join(out_dir, "metrics_comparison.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["mode", "accuracy", "precision", "f1", "auc"])
        for mode in MODES:
            r = results[mode]
            w.writerow([mode, r["accuracy"], r["precision"], r["f1"], r["auc"]])
    with open(os.path.join(out_dir, "config.yaml"), "w") as f:
        f.write(yaml_text({"root": args.root, "batch_size": args.batch_size,
                           "epochs": args.epochs, "lr": args.lr, "dim": args.dim,
                           "frame_count": args.frame_count, "seed": args.seed,
                           "modes": MODES}))
    return results, curves, roc_data, out_dir


def plot_ablation(curves: Dict, roc_data: Dict, out_dir: str) -> None:
    """``learning_curves.png`` (ablation.py:171-219) and ``roc_curves.png``
    (:221-240)."""
    from ewvit_tpu_torch.utils.metrics import auc, roc_curve
    from ewvit_tpu_torch.utils.visualization import pyplot

    plt = pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, key in zip(axes, ("train_loss", "val_loss", "val_auc")):
        for mode in MODES:
            ax.plot(range(1, len(curves[mode][key]) + 1), curves[mode][key], label=mode)
        ax.set_title(key); ax.set_xlabel("epoch"); ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "learning_curves.png"), dpi=120)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 6))
    for mode in MODES:
        labels, preds = roc_data[mode]
        if len(set(labels)) > 1:
            fpr, tpr, _ = roc_curve(labels, preds)
            ax.plot(fpr, tpr, label=f"{mode} (AUC={auc(fpr, tpr):.4f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("FPR"); ax.set_ylabel("TPR"); ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "roc_curves.png"), dpi=120)
    plt.close(fig)


def main(argv: Optional[Sequence[str]] = None) -> Tuple[Dict, str]:
    """Returns (results, out_dir)."""
    args = parse_args(argv)
    results, curves, roc_data, out_dir = run_ablation(args)
    plot_ablation(curves, roc_data, out_dir)
    print(f"\nAblation results written to {out_dir}")
    for mode, r in results.items():
        print(f"  {mode:>9}: acc {r['accuracy']:.4f} auc {r['auc']:.4f}")
    return results, out_dir


if __name__ == "__main__":
    main()
