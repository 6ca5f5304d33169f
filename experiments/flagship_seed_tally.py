"""The flagship learning proof at many train seeds, in bf16 and fp32, on one CUDA GPU.

    python3 experiments/flagship_seed_tally.py

Runs ``cli.learning_proof.prove(flagship=True, seed=S)`` at each of
:data:`SEEDS` twice: in bf16, the recipe (the CLI's own config, the run
``python -m ewvit_tpu_torch.cli.learning_proof --flagship --seed S``
makes), and in fp32 (``model_cfg=ModelConfig(compute_dtype="float32")``).
Then it repeats :data:`PROBED` in bf16 with a probe after each train
epoch, which leaves the run as it was (it restores the train set's usage
counts and the modules' modes, freezes the BN running statistics and
shuffles with a seed of its own). With that epoch's weights the probe
records the train set's fakes, its loss in eval mode (``Trainer.eval_epoch``:
running BN statistics, no dropout, no jitter) with the share of clips on
the wrong side of 0.5, and its loss with train-mode BN alone (batch
statistics over each micro-batch of 4 clips, as ``train_step`` sees them;
no dropout, stochastic depth, jitter or update), over batches that hold a
fake and over batches of reals only.

Each run is a process of its own, :data:`PARALLEL` at a time on the card.
It writes ``seed_tally_out/<dtype>_seed<S>[_probed].json`` (per-epoch
train loss, val AUC and accuracy; first, peak and final loss; the five
checks; the epoch ``best_model.pth`` came from; seconds; peak device
memory; the probes) and its log beside it. The script prints a line a run
and, last, a JSON summary.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing as mp
import multiprocessing.connection
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn as nn  # noqa: E402

SEEDS = (0, 1, 2, 3, 4, 5, 42)
PROBED = (0, 42)        # a seed that misses and one that passes (PR 12)
PARALLEL = 4            # runs at a time on the card: 4 fp32 runs need ~42 GiB
OUT = "seed_tally_out"  # git-ignored
BATCH = 4               # the flagship's --batch-size


@contextlib.contextmanager
def _bn_only_train_mode(model):
    """Train-mode BN with frozen running statistics, every other module in
    eval mode (no dropout, no stochastic depth); the detector and its MWTs
    stay in train mode, so that ``video_forward`` takes its train path."""
    from ewvit_tpu_torch.models.mwt import MWT

    modes = {m: m.training for m in model.modules()}
    bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    saved = [(bn.momentum, bn.num_batches_tracked.clone()) for bn in bns]
    for m in model.modules():
        m.training = isinstance(m, (nn.modules.batchnorm._BatchNorm, MWT)) or m is model
    for bn in bns:
        bn.momentum = 0.0
    try:
        yield
    finally:
        for m, t in modes.items():
            m.training = t
        for bn, (momentum, tracked) in zip(bns, saved):
            bn.momentum = momentum
            bn.num_batches_tracked.copy_(tracked)


def _probe(trainer, dataset, epoch, workers):
    from ewvit_tpu_torch.data.pipeline import BatchLoader
    from ewvit_tpu_torch.models.detector import video_forward
    from ewvit_tpu_torch.ops.preprocess import preprocess_batch
    from ewvit_tpu_torch.train.losses import combined_loss, weighted_bce_with_logits

    counts, epochs = dict(dataset.video_usage_counts), trainer.train_cfg.epochs
    out = {"epoch": epoch + 1, "fakes": len(dataset) - len(dataset.real_videos)}
    try:
        ev = trainer.eval_epoch(BatchLoader(dataset, BATCH, pad_last=True, num_workers=workers),
                                epoch=epoch, max_epochs=epochs)
        preds, labels = np.asarray(ev.metrics["preds"]), np.asarray(ev.metrics["labels"])
        out["eval_mode_loss"] = float(ev.loss)
        out["eval_mode_wrong"] = float(np.mean((preds > 0.5) != (labels > 0.5)))
        model, dev, dt = trainer.model, trainer.device, trainer.dtype
        criterion = lambda a, b: weighted_bce_with_logits(a, b, pos_weight=trainer.pos_weight)  # noqa: E731
        split = {"with_fakes": [], "reals_only": []}
        loader = BatchLoader(dataset, BATCH, shuffle=True, drop_last=True, num_workers=workers,
                             seed=10_000 + epoch)
        with _bn_only_train_mode(model), torch.no_grad():
            for frames, lbls in loader:
                x = preprocess_batch(torch.as_tensor(frames).to(dev), dt)
                lb = torch.as_tensor(np.asarray(lbls), dtype=torch.float32, device=dev)
                with torch.autocast(dev.type, dtype=dt, enabled=dt != torch.float32):
                    o = video_forward(model, x, mode=trainer.mode, seed=0, remat=False,
                                      frame_chunk=trainer.model_cfg.frame_chunk)
                loss = float(combined_loss(o, lb, criterion, epoch, epochs)[0])
                split["with_fakes" if float(lb.max()) > 0 else "reals_only"].append(loss)
        for k, v in split.items():
            out[f"bn_only_loss_{k}"] = float(np.mean(v)) if v else None
            out[f"batches_{k}"] = len(v)
    finally:
        dataset.video_usage_counts.clear()
        dataset.video_usage_counts.update(counts)
        trainer.model.train()
    return out


def _run(seed, dtype, probed, path):
    """One run in this process, its output into ``path``.log."""
    log = os.open(path + ".log", os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(log, 1)
    os.dup2(log, 2)
    from ewvit_tpu_torch.cli import learning_proof
    from ewvit_tpu_torch.configs import ModelConfig
    from ewvit_tpu_torch.train import loop

    probes = []
    if probed:
        train_epoch = loop.Trainer.train_epoch

        def train_then_probe(self, loader, epoch):
            res = train_epoch(self, loader, epoch)
            probes.append(_probe(self, loader.dataset, epoch, loader.num_workers))
            return res

        loop.Trainer.train_epoch = train_then_probe       # this process only
    cfg = None if dtype == "bfloat16" else ModelConfig(compute_dtype=dtype)
    work = tempfile.mkdtemp(prefix=f"tally_{dtype}_{seed}_")
    t = time.perf_counter()
    try:
        res = learning_proof.prove(work, flagship=True, model_cfg=cfg, seed=seed)
        best = torch.load(os.path.join(work, "train", "checkpoints", "best_model.pth"),
                          map_location="cpu", weights_only=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    losses = [h["train"]["loss"] for h in res["history"]]
    rec = {"seed": seed, "dtype": dtype, "probed": probed, **res["record"],
           "peak_loss": max(losses), "peak_epoch": losses.index(max(losses)) + 1,
           "checks": {k: bool(v) for k, v in res["checks"].items()},
           "best_epoch": int(best["epoch"]) + 1, "train_loss": losses,
           "val_auc": [h["val"].get("auc") for h in res["history"]],
           "val_acc": [h["val"].get("accuracy") for h in res["history"]],
           "seconds": {**res["seconds"], "wall": time.perf_counter() - t},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "probes": probes}
    with open(path + ".json", "w") as f:
        json.dump(rec, f, indent=1)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    os.makedirs(OUT, exist_ok=True)
    # the probed runs (the longest) first
    jobs = [(s, "bfloat16", True) for s in PROBED]
    jobs += [(s, d, False) for s in SEEDS for d in ("bfloat16", "float32")]
    path = {j: os.path.join(OUT, f"{j[1]}_seed{j[0]}{'_probed' if j[2] else ''}") for j in jobs}
    ctx, queue, running, t0 = mp.get_context("spawn"), list(jobs), {}, time.time()
    while queue or running:
        while queue and len(running) < PARALLEL:
            job = queue.pop(0)
            running[job] = ctx.Process(target=_run, args=(*job, path[job]))
            running[job].start()
        multiprocessing.connection.wait([p.sentinel for p in running.values()])
        for job, p in list(running.items()):
            if p.exitcode is not None:
                del running[job]
                print(f"{os.path.basename(path[job])}: exit {p.exitcode}", flush=True)

    runs = []
    for job in jobs:
        try:
            with open(path[job] + ".json") as f:
                r = json.load(f)
        except OSError:
            runs.append({"seed": job[0], "dtype": job[1], "probed": job[2], "error": "no result"})
            continue
        failed = [k for k, ok in r["checks"].items() if not ok]
        print(f"{r['dtype']} seed {r['seed']}{' probed' if r['probed'] else ''}: first "
              f"{r['first_loss']:.4f} peak {r['peak_loss']:.4f} (epoch {r['peak_epoch']}) "
              f"final {r['final_loss']:.4f}, best epoch {r['best_epoch']}, "
              f"{'PASS' if r['ok'] else 'FAIL ' + '; '.join(failed)}, "
              f"{r['seconds']['wall']:.1f} s, {r['peak_mem_gib']:.2f} GiB", flush=True)
        runs.append({k: r[k] for k in ("seed", "dtype", "probed", "first_loss", "peak_loss",
                                       "final_loss", "best_epoch", "test_auc", "test_acc",
                                       "ok")})
    summary = {"card": card.strip(), "seconds": time.time() - t0, "runs": runs}
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0 if all("error" not in r for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
