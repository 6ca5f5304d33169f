"""Celeb-DF ROC comparison on one GPU: ``python -m ewvit_tpu_torch.cli.plot_celebdf_roc``.

The JAX package's ``plot_celebdf_roc.py`` (the reference's
utils/plot_celebdf_roc.py:15-192) on the port: each ``--model-paths``
checkpoint (``name=path.pth`` or a bare path) is loaded fresh through
``checkpoint.load_model`` (``evaluation.evaluate`` casts the model it is given
in place) and scored on the Celeb-DF-v2 test list, video-level or, with
``--per-frame``, one score per frame of every video (:class:`PerFrameLoader`,
``pos_mode="row0"``, ``frame_chunk`` 1); ``--baseline-scores name=path.csv``
overlays externally computed ``label,score`` CSVs. The ROC curves and their
AUC come from the port's ``utils/metrics.py`` and are drawn into
``celebdf_roc_comparison.png``.

:func:`roc_scores` does the scoring; :func:`plot_roc` draws (it needs
matplotlib). ``--device`` (default ``cuda``) is the port's own.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

Curve = Tuple[str, List[int], List[float], str]     # (name, labels, scores, line style)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Celeb-DF ROC comparison across checkpoints (GPU)")
    p.add_argument("--root", "--r", type=str, default=None,
                   help="dataset root (required unless only baseline CSVs)")
    p.add_argument("--model-paths", "--mp", nargs="*", default=[],
                   help="name=checkpoint_path pairs (or bare paths)")
    p.add_argument("--tiny", action="store_true",
                   help="ModelConfig.tiny() (64px): smoke runs only")
    p.add_argument("--test-list", "--tl", type=str,
                   default="Celeb-DF-v2/List_of_testing_videos.txt")
    p.add_argument("--output", "--o", type=str, default="./output/roc")
    p.add_argument("--batch-size", "--bs", type=int, default=8)
    p.add_argument("--frame-count", "--fc", type=int, default=30)
    p.add_argument("--dim", "--d", type=int, default=128)
    p.add_argument("--per-frame", action="store_true",
                   help="score every frame independently (K=1 clips)")
    p.add_argument("--baseline-scores", nargs="*", default=[],
                   help="name=csv pairs with label,score columns")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


class PerFrameLoader:
    """Clip batches as per-frame clips: ``[B, K, ...] -> [B*K, 1, ...]``.

    One score per frame of every video, as the reference's per-frame mode
    runs each frame as its own one-frame clip (plot_celebdf_roc.py:31-72).
    One forward over all B*K frames is exact because the model runs with
    ``pos_mode='row0'``: every row gets positional row 0, as each frame does
    in the reference's loop. Labels repeat K times; row order is kept, so
    ``evaluate``'s pad-row trimming works against the expanded
    ``true_len()``.
    """

    def __init__(self, loader, frame_count: int):
        self._loader = loader
        self.frame_count = frame_count

    def __len__(self):
        return len(self._loader)

    def true_len(self) -> int:
        return self._loader.true_len() * self.frame_count

    def __iter__(self):
        for frames, labels in self._loader:
            b, k = frames.shape[:2]
            yield (frames.reshape(b * k, 1, *frames.shape[2:]),
                   np.repeat(np.asarray(labels), k))


def _load_baseline_csv(path: str) -> Tuple[List[int], List[float]]:
    labels, scores = [], []
    with open(path) as f:
        for row in csv.DictReader(f):
            labels.append(int(float(row["label"])))
            scores.append(float(row["score"]))
    return labels, scores


def roc_scores(args: argparse.Namespace) -> List[Curve]:
    """(name, labels, scores, style) per checkpoint (solid) and per baseline
    CSV (dashed); prints each checkpoint's AUC and EER."""
    from ewvit_tpu_torch.utils.metrics import auc, roc_curve

    curves: List[Curve] = []
    if args.model_paths:
        from ewvit_tpu_torch.configs import ModelConfig
        from ewvit_tpu_torch.data.transforms import FrameTransform
        from ewvit_tpu_torch.device import resolve_device
        from ewvit_tpu_torch.evaluation import evaluate, get_dataloader, load_model

        if not args.root:
            raise SystemExit("--root is required with --model-paths")
        device = resolve_device(args.device)
        cfg = ModelConfig.tiny() if args.tiny else ModelConfig(dama_dim=args.dim)
        if args.per_frame:
            cfg = cfg.replace(pos_mode="row0")
        size = cfg.arch.image_size
        transform = FrameTransform(resize=max(1, round(size * 450 / 224)), crop=size)
        test_list = (args.test_list if os.path.isabs(args.test_list)
                     else os.path.join(args.root, args.test_list))
        loader, ds = get_dataloader(args.root, "celeb-df", batch_size=args.batch_size,
                                    frame_count=args.frame_count, test_list=test_list,
                                    num_workers=args.num_workers, transform=transform)
        if args.per_frame:
            loader = PerFrameLoader(loader, args.frame_count)
            print(f"Celeb-DF test: {len(ds)} videos x {args.frame_count} frames = "
                  f"{loader.true_len()} per-frame scores")
        else:
            print(f"Celeb-DF test: {len(ds)} videos (video-level)")
        chunk = 1 if args.per_frame else min(cfg.frame_chunk, args.frame_count)
        for spec in args.model_paths:
            name, _, path = spec.rpartition("=")
            name = name or os.path.basename(path.rstrip("/"))
            model = load_model(path, cfg, device=device)
            m = evaluate(model, loader, frame_chunk=chunk, device=device)
            if args.per_frame and len(m["preds"]) != loader.true_len():
                raise RuntimeError(f"per-frame score count {len(m['preds'])} != "
                                   f"{loader.true_len()} total frames")
            fpr, tpr, _ = roc_curve(m["labels"], m["preds"])
            print(f"  {name}: AUC={auc(fpr, tpr):.4f} EER={m['eer']:.4f}")
            curves.append((name, m["labels"], m["preds"], "-"))
    for spec in args.baseline_scores:
        name, _, path = spec.rpartition("=")
        curves.append((name, *_load_baseline_csv(path), "--"))
    return curves


def plot_roc(curves: Sequence[Curve], path: str, title: str) -> str:
    from ewvit_tpu_torch.utils.metrics import auc, roc_curve
    from ewvit_tpu_torch.utils.visualization import pyplot

    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 7))
    for name, labels, scores, style in curves:
        fpr, tpr, _ = roc_curve(labels, scores)
        ax.plot(fpr, tpr, style, label=f"{name} (AUC={auc(fpr, tpr):.4f})")
    ax.plot([0, 1], [0, 1], "k:", lw=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title(title)
    ax.legend(loc="lower right")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def main(argv: Optional[Sequence[str]] = None) -> List[Curve]:
    args = parse_args(argv)
    if not args.model_paths and not args.baseline_scores:
        raise SystemExit("provide --model-paths and/or --baseline-scores")
    os.makedirs(args.output, exist_ok=True)
    curves = roc_scores(args)
    mode = "per-frame" if args.per_frame else "video-level"
    out = plot_roc(curves, os.path.join(args.output, "celebdf_roc_comparison.png"),
                   f"Celeb-DF-v2 ROC ({mode})")
    print(f"Saved {out}")
    return curves


if __name__ == "__main__":
    main()
