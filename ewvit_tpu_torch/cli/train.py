"""Train the detector: ``python -m ewvit_tpu_torch.cli.train``.

The flags and flow of the JAX package's ``train.py`` (:23-74, :77-161), the
reference trainer's (train.py:27-53, :176-345): FF++ train and val sets with
the curriculum, weighted BCE with the ramped orthogonality loss, gradient
accumulation, the cosine lr, ``best_model.pth`` and per-epoch checkpoints in
``<output>/checkpoints``, ``--resume``. ``--device`` (default ``cuda``; ``cpu``
for a smoke run with ``--tiny``) is the port's own. ``--s2d-stem`` is
accepted and ignored (the port has one stem, ``configs.ModelConfig``);
``--visualize`` writes ``utils.visualization.TrainVisualization``'s plots
and ``training_history.csv`` into ``--output`` (needs matplotlib).

``--mesh`` trains data-parallel (``parallel.make_mesh``: one process per
GPU, the batch split over them): launch ``torchrun --nproc-per-node=N -m
ewvit_tpu_torch.cli.train --mesh ...``; without torchrun's environment it
forms a world of one. ``--batch-size`` must be divisible by the ranks. The
JAX CLI checks only ``batch * accum`` (train.py:136-139), but its val epoch
places each val batch of ``--batch-size`` clips on the ``('dcn', 'data')``
sharding (ewvit_tpu/train/loop.py:143-146, :220-221), and ``jax.device_put``
refuses a batch that the ranks do not divide: the JAX run stops at its
first val epoch where this one refuses to start. Rank 0 alone prints and
writes.

``main(argv, model_cfg=, face_detector=)`` trains the given
``configs.ModelConfig`` in place of the one the flags build (``--dim``,
``--frame-chunk``, ``--pos-mode``, ``--tiny``): a caller turns the kernel
flags on that way, as ``cli/learning_proof.py`` does; the command line has
no kernel flag, as the JAX CLI has none. ``face_detector`` is the frames'
``data.transforms.FaceAligner`` detector (``"auto"``, the CLI's: Haar when
cv2 has its cascade). ``main`` returns ``Trainer.fit``'s result with
``train_losses``, the per-epoch train losses, beside its ``history`` and
``best_val_auc``.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Any, Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train Deepfake Detector (GPU)")
    p.add_argument("--root", "--r", type=str, default="/path/to/dataset",
                   help="Dataset root directory")
    p.add_argument("--output", "--o", type=str, default="./output",
                   help="Output directory")
    p.add_argument("--batch-size", "--bs", type=int, default=8)
    p.add_argument("--epochs", "--e", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dim", "--d", type=int, default=128, help="Feature dimension")
    p.add_argument("--frame-count", "--fc", type=int, default=300,
                   help="Number of frames per video")
    p.add_argument("--visualize", "--v", action="store_true",
                   help="training plots and training_history.csv in --output")
    p.add_argument("--accum-steps", "--as", type=int, default=2,
                   help="Gradient accumulation steps")
    p.add_argument("--mesh", "--multi-chip", action="store_true",
                   help="data-parallel over the ranks torchrun starts (a world of "
                        "one without torchrun)")
    p.add_argument("--resume", type=str, default=None,
                   help="Path to checkpoint to resume from")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--frame-chunk", type=int, default=16,
                   help="Frames per chunk (memory micro-batch)")
    p.add_argument("--mode", type=str, default="dynamic",
                   choices=["dynamic", "sfe_only", "sfe_mwt"])
    p.add_argument("--no-remat", action="store_true",
                   help="disable per-chunk rematerialization")
    p.add_argument("--pos-mode", type=str, default="reference",
                   choices=["reference", "tile"],
                   help="'tile' lifts the flattened<=emb_dim cap (row i %% emb_dim)")
    p.add_argument("--s2d-stem", action="store_true",
                   help="accepted for the JAX CLI's sake; the port has one stem")
    p.add_argument("--num-workers", type=int, default=4, help="Host decode threads")
    p.add_argument("--save-every", type=int, default=1,
                   help="Full checkpoint every N epochs (1 = the reference's "
                        "per-epoch checkpoints)")
    p.add_argument("--sync-ckpt", action="store_true",
                   help="Block the epoch loop on checkpoint saves (default: "
                        "write them on a worker thread; both are crash-safe)")
    p.add_argument("--tiny", action="store_true",
                   help="ModelConfig.tiny() (64px): smoke runs only")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, *, model_cfg: Any = None,
         face_detector: str = "auto") -> dict:
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


def _run(args: argparse.Namespace, mesh, *, model_cfg=None, face_detector="auto") -> dict:
    from ewvit_tpu_torch.configs import ModelConfig, TrainConfig
    from ewvit_tpu_torch.data.datasets import FaceForensicsDataset
    from ewvit_tpu_torch.data.pipeline import BatchLoader
    from ewvit_tpu_torch.data.transforms import FaceAligner, FrameTransform
    from ewvit_tpu_torch.device import resolve_device
    from ewvit_tpu_torch.train.loop import Trainer
    from ewvit_tpu_torch.utils.visualization import TrainVisualization

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    shard = None
    if mesh is not None:
        dp = mesh.batch_size
        if args.batch_size % dp:
            raise ValueError(f"--batch-size {args.batch_size} must be divisible by the "
                             f"mesh batch axes dcn*data = {dp} (the JAX package's val epoch "
                             f"places each batch on the ('dcn', 'data') sharding, which "
                             f"refuses it too)")
        shard = mesh.batch_shard
        say(f"Data-parallel mesh: {mesh.shape}")
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if lead:
        os.makedirs(args.output, exist_ok=True)
    say(f"Device: {device}")

    if model_cfg is None and args.tiny:
        model_cfg = ModelConfig.tiny().replace(pos_mode=args.pos_mode)
    elif model_cfg is None:
        model_cfg = ModelConfig(dama_dim=args.dim, frame_chunk=args.frame_chunk,
                                pos_mode=args.pos_mode)
    size = model_cfg.arch.image_size
    transform = FrameTransform(resize=max(1, round(size * 450 / 224)), crop=size,
                               aligner=FaceAligner(detector=face_detector))
    train_ds = FaceForensicsDataset(args.root, split="train", frame_count=args.frame_count,
                                    transform=transform, seed=args.seed)
    val_ds = FaceForensicsDataset(args.root, split="val", frame_count=args.frame_count,
                                  transform=transform, seed=args.seed)
    train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True, drop_last=True,
                               num_workers=args.num_workers, seed=args.seed, shard=shard)
    val_loader = BatchLoader(val_ds, args.batch_size, pad_last=True,
                             num_workers=args.num_workers, seed=args.seed, shard=shard)

    # pos_weight = fake/real ratio (train.py:268-272)
    pos_weight = train_ds.fake_ratio
    say(f"pos_weight (fake/real): {pos_weight:.3f}")
    train_cfg = TrainConfig(batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
                            frame_count=args.frame_count, accum_steps=args.accum_steps,
                            seed=args.seed)
    steps_per_epoch = max(1, len(train_loader) // args.accum_steps)
    trainer = Trainer(model_cfg, train_cfg, mode=args.mode, pos_weight=pos_weight,
                      steps_per_epoch=steps_per_epoch,
                      checkpoint_dir=os.path.join(args.output, "checkpoints"),
                      remat=not args.no_remat, save_every=args.save_every,
                      async_ckpt=not args.sync_ckpt, device=device, mesh=mesh,
                      log=say)
    if args.resume:
        trainer.resume(args.resume)
    viz = TrainVisualization(args.output) if args.visualize and lead else None
    result = trainer.fit(train_loader, val_loader, train_dataset=train_ds,
                         val_dataset=val_ds, viz=viz)
    say(f"Best val AUC: {result['best_val_auc']:.4f}")
    return {**result, "train_losses": [h["train"]["loss"] for h in result["history"]]}


if __name__ == "__main__":
    main()
