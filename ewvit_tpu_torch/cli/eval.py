"""Evaluate a trained detector: ``python -m ewvit_tpu_torch.cli.eval``.

The flags and flow of the JAX package's ``eval.py`` (the reference's eval.py
:30-58, :210-433): the overall pass, then the five-method FF++ loop
(:164-171), or Celeb-DF, or the diffusion per-method loop (all, DDPM, DDIM,
LDM); ``eval_results.csv`` and ``confusion_matrices.json`` in ``--output``
(``_export``). The model comes from a ``.pth``/``.pt`` through
``checkpoint.load_model`` and is evaluated by ``evaluation.evaluate``, which
casts it to the compute dtype for inference. ``--device`` (default
``cuda``) is the port's own; ``--s2d-stem`` is accepted and ignored.
``--visualize`` renders ``EvalVisualization``'s five plots (needs
matplotlib) into ``visualizations/<name>/`` per pass (``all_methods`` for
the overall or "all" pass), or for Celeb-DF into ``--output`` itself, as
the JAX CLI's ``_render_viz`` (eval.py:71-98, :206-216).

``--mesh`` evaluates data-parallel over the batch (``parallel.make_mesh``;
``torchrun --nproc-per-node=N -m ewvit_tpu_torch.cli.eval --mesh ...``, a
world of one without torchrun): each rank decodes its rows of every batch,
``--batch-size`` must be divisible by the ranks (eval.py:143-147), and rank 0
alone prints and writes.

``main(argv, model_cfg=, face_detector=)`` evaluates under the given
``configs.ModelConfig`` in place of the one the flags build, with the
given face detector, as ``cli/train.py`` takes them.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

FF_METHODS = ["Deepfakes", "Face2Face", "FaceSwap", "NeuralTextures", "FaceShifter"]
DIFFUSION_METHODS = ["DDPM", "DDIM", "LDM"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate Deepfake Detector (GPU)")
    p.add_argument("--root", "--r", type=str, default="/path/to/dataset")
    p.add_argument("--model-path", "--mp", type=str, required=True)
    p.add_argument("--output", "--o", type=str, default="./output/eval")
    p.add_argument("--batch-size", "--bs", type=int, default=8)
    p.add_argument("--dim", "--d", type=int, default=128)
    p.add_argument("--frame-count", "--fc", type=int, default=300)
    p.add_argument("--dataset", "--ds", type=str, default="ff++",
                   choices=["ff++", "celeb-df", "diffusion"])
    p.add_argument("--test-list", "--tl", type=str,
                   default="Celeb-DF-v2/List_of_testing_videos.txt")
    p.add_argument("--ablation", "-a", type=str, default="dynamic",
                   choices=["dynamic", "sfe_only", "sfe_mwt"])
    p.add_argument("--visualize", "--v", action="store_true",
                   help="the five evaluation plots per pass")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--frame-chunk", type=int, default=16)
    p.add_argument("--pos-mode", type=str, default="reference",
                   choices=["reference", "tile", "row0"],
                   help="must match the training config of the checkpoint")
    p.add_argument("--s2d-stem", action="store_true",
                   help="accepted for the JAX CLI's sake; the port has one stem")
    p.add_argument("--mesh", "--multi-chip", action="store_true",
                   help="data-parallel eval over the ranks torchrun starts (a world "
                        "of one without torchrun)")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--tiny", action="store_true",
                   help="ModelConfig.tiny() (64px): smoke runs only")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def _row(name: str, m: Dict) -> Dict:
    return {
        "name": name, "loss": m.get("loss"), "accuracy": m["accuracy"],
        "auc": m["auc"], "eer": m["eer"], "ap": m["ap"],
        "precision": m["precision"], "recall": m["recall"], "f1": m["f1"],
    }


def _render_viz(viz_dir: str, m: Dict) -> None:
    """The reference's five eval plots for one result dict: confusion
    heatmap, ROC, precision-recall, prediction distribution, and the
    orth-loss-vs-prediction scatter (per-batch orth losses expanded to one
    point per prediction), as the JAX CLI's ``_render_viz``."""
    from ewvit_tpu_torch.utils.visualization import EvalVisualization

    viz = EvalVisualization(viz_dir)
    viz.confusion(m["confusion_matrix"])
    viz.roc(m["labels"], m["preds"])
    viz.precision_recall(m["labels"], m["preds"])
    viz.prediction_distribution(m["labels"], m["preds"])
    if m.get("orth_losses"):
        per_batch = np.asarray(m["orth_losses"], np.float32)
        bs = max(1, len(m["preds"]) // len(per_batch))
        expanded = np.repeat(per_batch, bs)[:len(m["preds"])]
        if len(expanded) < len(m["preds"]):
            expanded = np.pad(expanded, (0, len(m["preds"]) - len(expanded)), mode="edge")
        viz.orth_scatter(expanded, m["preds"])


def _export(output: str, rows: List[Dict], confusions: Dict) -> None:
    os.makedirs(output, exist_ok=True)
    csv_path = os.path.join(output, "eval_results.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    with open(os.path.join(output, "confusion_matrices.json"), "w") as f:
        json.dump(confusions, f, indent=2)
    print(f"Saved results to {csv_path}")


def main(argv: Optional[Sequence[str]] = None, *, model_cfg: Any = None,
         face_detector: str = "auto") -> Dict:
    """Returns what was exported: ``{"rows": [...], "confusions": {...}}``."""
    args = parse_args(argv)
    random.seed(args.seed)
    np.random.seed(args.seed)
    mesh = None
    if args.mesh:
        from ewvit_tpu_torch.parallel import make_mesh

        mesh = make_mesh(device=args.device)      # every rank on the 'data' axis
    try:
        return _run(args, mesh, model_cfg=model_cfg, face_detector=face_detector)
    finally:
        if mesh is not None:
            mesh.close()


def _run(args: argparse.Namespace, mesh, *, model_cfg=None, face_detector="auto") -> Dict:
    from ewvit_tpu_torch.configs import ModelConfig
    from ewvit_tpu_torch.data.transforms import FaceAligner, FrameTransform
    from ewvit_tpu_torch.device import resolve_device
    from ewvit_tpu_torch.evaluation import evaluate, get_dataloader, load_model, print_metrics

    lead = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if model_cfg is not None:
        cfg = model_cfg
    elif args.tiny:
        cfg = ModelConfig.tiny().replace(pos_mode=args.pos_mode)
    else:
        cfg = ModelConfig(dama_dim=args.dim, frame_chunk=args.frame_chunk,
                          pos_mode=args.pos_mode)
    size = cfg.arch.image_size
    transform = FrameTransform(resize=max(1, round(size * 450 / 224)), crop=size,
                               aligner=FaceAligner(detector=face_detector))
    model = load_model(args.model_path, cfg, device=device)
    ev = dict(mode=args.ablation, frame_chunk=cfg.frame_chunk, device=device)
    loader_kw = dict(batch_size=args.batch_size, num_workers=args.num_workers,
                     transform=transform)
    if mesh is not None:
        dp = mesh.batch_size
        if args.batch_size % dp:
            raise ValueError(f"--batch-size {args.batch_size} must be divisible by the "
                             f"mesh batch axes dcn*data = {dp}")
        ev["mesh"], loader_kw["shard"] = mesh, mesh.batch_shard
        if lead:
            print(f"Data-parallel eval mesh: {mesh.shape}")

    rows, confusions = [], {}
    viz_results = []      # (visualizations/<name>, result) per pass

    def run(name: str, title: str, loader) -> None:
        m = evaluate(model, loader, **ev)
        if lead:
            print_metrics(title, m)
        rows.append(_row(name, m))
        confusions[name] = m["confusion_matrix"]
        viz_results.append(("all_methods" if name in ("overall", "all") else name, m))

    if args.dataset == "ff++":
        loader, _ = get_dataloader(args.root, "ff++", frame_count=args.frame_count,
                                   **loader_kw)
        run("overall", "FF++ overall", loader)
        for method in FF_METHODS:  # per-method loop (eval.py:245-261)
            loader, _ = get_dataloader(args.root, "ff++", frame_count=args.frame_count,
                                       single_method=method, **loader_kw)
            run(method, method, loader)
    elif args.dataset == "celeb-df":
        test_list = (args.test_list if os.path.isabs(args.test_list)
                     else os.path.join(args.root, args.test_list))
        loader, _ = get_dataloader(args.root, "celeb-df", frame_count=args.frame_count,
                                   test_list=test_list, **loader_kw)
        run("celeb-df", "Celeb-DF-v2", loader)
    else:  # diffusion: all, then DDPM, DDIM, LDM (eval.py:366-433)
        for method in [None] + DIFFUSION_METHODS:
            loader, _ = get_dataloader(args.root, "diffusion", single_method=method,
                                       **loader_kw)
            name = method or "all"
            run(name, f"diffusion/{name}", loader)

    if not lead:
        return {"rows": rows, "confusions": confusions}
    _export(args.output, rows, confusions)
    if args.visualize:
        if args.dataset == "celeb-df":      # plots in the output dir itself
            _render_viz(args.output, viz_results[0][1])
        else:
            for name, m in viz_results:
                _render_viz(os.path.join(args.output, "visualizations", name), m)
            print(f"Saved visualizations to {os.path.join(args.output, 'visualizations')}")
    return {"rows": rows, "confusions": confusions}


if __name__ == "__main__":
    main()
