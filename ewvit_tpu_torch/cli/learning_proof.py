"""One-command learning proof: ``python -m ewvit_tpu_torch.cli.learning_proof``.

The counterpart of the JAX package's ``tools/run_learning_proof.py``: it
writes a checkerboard FF++ tree (``data/synthetic.write_checkerboard_tree``:
fakes carry a pixel-scale checkerboard), trains on it with the port's train
CLI, evaluates the run's ``best_model.pth`` with the port's eval CLI (both
in-process, nothing stubbed), and checks that the train loss declined and
stayed under a bound, and that the best val AUC and the held-out test AUC and
accuracy clear theirs. It prints one PASS/FAIL line a check and a JSON
record, and exits 1 if a check failed.

Two profiles, the JAX tool's recipes and thresholds:

- ``--flagship``: 224 px, 48 train pairs spread over the five methods, 8
  frames, 25 epochs x 12 updates (batch 4, accum 2, lr 3e-4, no remat, one
  checkpoint at the end); final loss <= 0.05, best val AUC >= 0.99, test
  AUC >= 0.99, test accuracy >= 0.95;
- default (tiny): ``--tiny`` (64 px) on 129-px frames with amp 32, 12 pairs,
  4 frames, 10 epochs (batch 4, accum 2, lr 1e-3); final loss <= 0.55, val
  and test AUC >= 0.75, test accuracy >= 0.6.

``--device`` (default ``cuda``; ``cpu`` for the tiny profile on a CPU) goes to
both CLIs; ``--seed`` (default 42, the train CLI's) to the train CLI, where it
draws the initial weights, the shuffle, the sampled frames, the jitter and
the dropout. The fixture is the same at every seed. The CLIs build the JAX
package's default config, so no kernel flag is on; :func:`prove` takes a
``ModelConfig`` (``model_cfg=``) for both, which is how a caller runs the
hand-written kernels.

Both CLIs run with the face detector off (:data:`FACE_DETECTOR`). The
fixture holds no faces, and its frames are written at the transform's resize
target so that the centre crop keeps the checkerboard pixel for pixel (the
JAX tool's premise, tools/make_synthetic_fixture.py:9-11). Where cv2 ships
its Haar cascade, the CLIs' default detector finds "faces" in about 1% of
these frames, not the same ones from run to run under cv2's thread pool, and
crops and upsamples them, which wipes the checkerboard out of those frames.

Usage:
  python -m ewvit_tpu_torch.cli.learning_proof [--flagship] [--workdir DIR]
      [--keep] [--epochs N] [--device D] [--seed S]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

from ewvit_tpu_torch.data.datasets import FF_METHODS as METHODS

FACE_DETECTOR = "none"      # the fixture's frames hold no face (module docstring)
SEED = 42                   # cli.train's default --seed


def profile(flagship: bool, epochs: Optional[int] = None) -> Dict[str, Any]:
    """The fixture's arguments, the two CLIs' flags and the thresholds of a
    profile (tools/run_learning_proof.py:72-109)."""
    if flagship:
        epochs = epochs or 25
        return dict(
            epochs=epochs,
            fixture=dict(pairs=48, val_pairs=4, frames=8, methods=METHODS,
                         spread_methods=True),
            train=["--batch-size", "4", "--accum-steps", "2", "--frame-count", "8",
                   "--lr", "3e-4", "--no-remat", "--save-every", str(epochs),
                   "--epochs", str(epochs), "--num-workers", "2"],
            eval=["--batch-size", "4", "--frame-count", "8", "--num-workers", "2"],
            # the JAX recipe reached 0.0014 on a TPU: 0.05 still catches a
            # real optimisation regression
            max_final_loss=0.05, min_val_auc=0.99, min_test_auc=0.99, min_test_acc=0.95)
    epochs = epochs or 10
    return dict(
        epochs=epochs,
        # 129-px sources: a 64-px model resizes to 129 and crops 64, so the
        # crop keeps the pixel-scale signal
        fixture=dict(pairs=12, val_pairs=4, frames=4, size=129, amp=32, methods=METHODS,
                     spread_methods=True),
        train=["--tiny", "--batch-size", "4", "--accum-steps", "2", "--frame-count", "4",
               "--lr", "1e-3", "--epochs", str(epochs), "--num-workers", "0"],
        eval=["--tiny", "--batch-size", "4", "--frame-count", "4", "--num-workers", "0"],
        max_final_loss=0.55, min_val_auc=0.75, min_test_auc=0.75, min_test_acc=0.6)


def prove(workdir: str, *, flagship: bool, epochs: Optional[int] = None,
          model_cfg: Any = None, device: str = "cuda", seed: int = SEED) -> Dict[str, Any]:
    """Fixture, ``cli.train``, ``cli.eval`` on ``best_model.pth``, checks.

    Returns ``record`` (the printed JSON record, the JAX tool's keys),
    ``checks`` (each check's message and whether it passed), ``history``
    (``Trainer.fit``'s), ``rows`` (the eval CLI's exported rows) and
    ``seconds`` (fixture, train and eval wall seconds)."""
    from ewvit_tpu_torch.cli import eval as eval_cli
    from ewvit_tpu_torch.cli import train as train_cli
    from ewvit_tpu_torch.data.synthetic import write_checkerboard_tree

    p = profile(flagship, epochs)
    epochs = p["epochs"]
    fixture = os.path.join(workdir, "fixture")
    train_out, eval_out = os.path.join(workdir, "train"), os.path.join(workdir, "eval")
    seconds = {}

    t = time.perf_counter()
    _, n_png = write_checkerboard_tree(fixture, **p["fixture"])
    seconds["fixture"] = time.perf_counter() - t
    print(f"fixture at {fixture}: {n_png} PNGs in {seconds['fixture']:.1f} s", flush=True)

    train_args = ["--root", fixture, "--output", train_out, *p["train"], "--device", device,
                  "--seed", str(seed)]
    print(f"$ cli.train {' '.join(train_args)}", flush=True)
    t = time.perf_counter()
    trained = train_cli.main(train_args, model_cfg=model_cfg, face_detector=FACE_DETECTOR)
    seconds["train"] = time.perf_counter() - t
    losses, best_val_auc = trained["train_losses"], float(trained["best_val_auc"])
    if len(losses) != epochs:
        raise RuntimeError(f"expected {epochs} epochs, got the losses {losses}")
    final_loss = losses[-1]
    print(f"train loss per epoch: {[round(v, 4) for v in losses]}")
    print(f"val AUC per epoch: {[round(h['val']['auc'], 4) for h in trained['history']]}",
          flush=True)

    best_model = os.path.join(train_out, "checkpoints", "best_model.pth")
    if not os.path.exists(best_model):
        raise RuntimeError(f"cli.train wrote no best_model.pth (best val AUC {best_val_auc})")
    eval_args = ["--root", fixture, "--model-path", best_model, "--output", eval_out,
                 *p["eval"], "--device", device]
    print(f"$ cli.eval {' '.join(eval_args)}", flush=True)
    t = time.perf_counter()
    exported = eval_cli.main(eval_args, model_cfg=model_cfg, face_detector=FACE_DETECTOR)
    seconds["eval"] = time.perf_counter() - t
    with open(os.path.join(eval_out, "eval_results.csv")) as f:
        rows = {r["name"]: r for r in csv.DictReader(f)}
    test_auc = float(rows["overall"]["auc"])
    test_acc = float(rows["overall"]["accuracy"])

    checks = {
        f"final train loss {final_loss:.4f} <= {p['max_final_loss']}":
            final_loss <= p["max_final_loss"],
        f"loss declined {losses[0]:.4f} -> {final_loss:.4f}": final_loss < losses[0],
        f"best val AUC {best_val_auc:.4f} >= {p['min_val_auc']}":
            best_val_auc >= p["min_val_auc"],
        f"test AUC {test_auc:.4f} >= {p['min_test_auc']}": test_auc >= p["min_test_auc"],
        f"test ACC {test_acc:.4f} >= {p['min_test_acc']}": test_acc >= p["min_test_acc"],
    }
    for msg, ok in checks.items():
        print(("PASS  " if ok else "FAIL  ") + msg)
    record = {"metric": "learning_proof", "profile": "flagship" if flagship else "tiny",
              "epochs": epochs, "first_loss": losses[0], "final_loss": final_loss,
              "best_val_auc": best_val_auc, "test_auc": test_auc, "test_acc": test_acc,
              "ok": all(checks.values())}
    print(json.dumps(record), flush=True)
    return dict(record=record, checks=checks, history=trained["history"],
                rows=exported["rows"], seconds=seconds)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Learning proof of the port's train and eval CLIs")
    ap.add_argument("--flagship", action="store_true",
                    help="the 224-px recipe (GPU-scale); default is the tiny 64-px profile")
    ap.add_argument("--workdir", type=str, default=None,
                    help="where the fixture and the run's outputs go (default: a temp dir)")
    ap.add_argument("--keep", action="store_true", help="keep the workdir for inspection")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the profile's epoch count")
    ap.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--seed", type=int, default=SEED, help="the train CLI's --seed")
    args = ap.parse_args(argv)

    work = args.workdir or tempfile.mkdtemp(prefix="ewvit_proof_")
    os.makedirs(work, exist_ok=True)
    try:
        out = prove(work, flagship=args.flagship, epochs=args.epochs, device=args.device,
                    seed=args.seed)
        return 0 if out["record"]["ok"] else 1
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
