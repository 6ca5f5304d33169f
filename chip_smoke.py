#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (ewvit_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases (any failure raises and the exit code is nonzero):

1. device  -- the GPU's name and power limit (nvidia-smi);
2. build   -- compiles every kernel in ewvit_tpu_torch/csrc with nvcc for
              sm_90a (one nvcc per source, in parallel), loads them;
3. kernels -- holds each hand-written kernel against its plain PyTorch version
              on the card at the main path's shapes (K5, in no model, at the
              MWT's two stride-1 conv shapes; K2 also at B0's planes and
              ragged cases; K4's cluster kernel at N = 64, 32, 1, 65 and
              its general kernel at D = 256), in float32 (TF32 off) and
              bfloat16, and times kernel, plain version and, where one
              exists, a single PyTorch call computing the same function,
              with CUDA events (K2 also with a cold L2; K4's cluster kernel
              beside its general kernel);
4. serve   -- builds the full-width detector (ModelConfig(): 224 px, V2-S
              and B0 backbones, dama_dim 128, 4 heads, 3 levels) with one
              set of seeded random weights and serves it on four paths:
              dynamic with the three kernel flags on (K1, K2, K4) and with
              all four (use_fused_mwt_tail adds K3); sfe_only (B0 + ViT cls
              head) with use_pallas_dwse (K2); sfe_mwt (B0 SFE + the
              standalone MWT + fusion gate) with use_pallas_dwt,
              use_pallas_dwse and use_fused_mwt_tail (K1, K2, K3). For each
              path it zeroes the launch counters, serves requests of uint8
              clips [2, 40, 224, 224, 3] through InferenceEngine.predict and
              predict_stream (frame_chunk 32: one full chunk and one masked
              tail, 64 flattened rows), reads the counters, checks the
              probabilities, and holds the outputs, in bf16 and in fp32,
              against the same weights served on the plain (direct-conv)
              modules in fp32; a served request must fold or pack no weights
              (U, K2's depthwise weights, K4's weights), the sfe paths must
              not launch K4, and the host cost of the kept weights' key
              check is printed;
5. checkpoint -- saves the weights as a reference-layout .pth
              ({"model_state_dict": ...} with "module." prefixes), serves
              it on every path through InferenceEngine.from_checkpoint (the
              probabilities must equal the served ones bit for bit), and
              runs evaluation.evaluate on labelled in-memory batches with a
              padded tail in each mode (finite metrics; predictions equal
              the served probabilities);
6. train   -- the train step at full width (train/steps.py: bf16 autocast,
              fp32 parameters and Adam, accum_steps 2, frame_chunk 32 so
              chunks of 64 rows and a true tail of 16, per-chunk remat,
              train preprocessing with colour jitter): 8 dynamic steps on
              one batch of uint8 clips [4, 40, 224, 224, 3] with all four
              kernel flags on, timed by CUDA events, one more under
              torch.profiler (the loss falls; the 18 frozen tensors stay
              bit for bit; every other tensor with a nonzero value or
              gradient moves; DAMA's BN running statistics move; K2, K3 and
              K4 launch 0 times and nothing is folded or packed; K1
              launches the derived count per step), then in fp32 on one
              clip of 10 frames (frame_chunk 4, tail 2) one step with K1
              on and off and one with remat on and off (loss 1e-5, each
              gradient 1e-4 of its tensor's max abs, running statistics
              1e-5), the eval-mode forward with grad enabled that must
              raise, 2 steps each of sfe_mwt and sfe_only, and the step
              time, frames trained per second and peak memory;
7. fit     -- the training run (train/loop.py Trainer.fit) at full width
              with all four kernel flags on a synthetic FF++ tree written
              into a temporary directory (data/synthetic.py: 40-frame
              320x256 PNG videos, 4 train, 4 val and 2 test pairs, the test
              pairs with all five methods), decoded on the host with cv2
              (the decode probe found cv2 on the GPU machine; without it the
              phase fails): 2 epochs, batch 2, accum_steps 2 (super-batches
              [4, 40, 224, 224, 3]), frame_chunk 32, remat, async
              checkpoints every epoch. It checks per epoch the K1 launches
              of the train steps (24 per update of 2 micro-batches) and of
              the val epoch, that K2, K3 and K4 launch only in val epochs,
              exactly the derived counts, and that each kept module folds or
              packs once per val epoch; the 18 frozen tensors bit for bit;
              best_model.pth and checkpoint_{1,2}.pth with no swap debris;
              best_model.pth served through InferenceEngine.from_checkpoint
              within OUT_TOL_BF16 of that epoch's val predictions; a resume
              from checkpoint_1.pth that runs epoch 2 only. It prints the ms
              per train step inside the Trainer, the val ms per clip, the
              host decode rate, the time the epoch loop is blocked by an
              async and by a sync save, and peak memory; then runs the two
              CLIs (cli.train, 1 epoch, and cli.eval on its best_model.pth,
              --tiny) on the same tree;
8. dp      -- data parallelism (ewvit_tpu_torch.parallel) as an NCCL world
              of one in this process (make_mesh without torchrun's
              environment; the NCCL version is printed): the three requests
              served on the three_flags and fused_mwt_tail paths with
              mesh= and frame_axis (bit for bit the serve phase's
              probabilities, the same K1-K4 launches, no fold or pack) and
              ms per request with and without the mesh; evaluation.evaluate
              with mesh= on the checkpoint phase's batches (the phase's
              predictions bit for bit); one fp32 step on one clip of 10
              frames (frame_chunk 4, tail 2) with and without the mesh (the
              synced BN against cuDNN's: the train phase's tolerances, each
              at least 4 times the distance of a third step whose BN runs
              on torch's native CUDA kernel instead of cuDNN's); 2
              bf16 dynamic steps of [4, 40, 224, 224, 3], accum 2, with and
              without the mesh (the loss finite and falling, K1 as derived,
              K2-K4 never; ms per step; the bytes of the gradient all-reduce
              per update); then, in one process under `torchrun
              --nproc-per-node=1`, cli.train --mesh --tiny for 1 epoch of
              4-frame clips and cli.eval --mesh on its checkpoint, on the fit
              phase's tree, which is then removed;
9. clis    -- the measuring, ablation and visualisation entry points. It
              prints whether matplotlib imports (with it each step runs the
              CLI's main with its plots, without it the compute half, and
              says that no plot was drawn); cli.test.measure at full width
              with all four kernel flags, dynamic, [1, 30] frames in a chunk
              of 30 (exact K1-K4 launches per call, folds only at the cast),
              then cli.test.main at its defaults (plain modules, no launch);
              cli.bench.measure per mode with the four flags and 2 to 3
              pairs (exact launches per call, no K4 in the sfe modes, no
              fold or pack inside the timed chains, a finite positive
              frames/s; each mode's JSON line); cli.calculate_gflops.main
              for all three modes at [1, 24] frames; the ablation at --tiny
              for 1 epoch on a synthetic FF++ tree (each mode's
              best_model.pth loads); plot_celebdf_roc on the seeded weights
              saved as a reference-layout .pth and a synthetic Celeb-DF tree
              of 2 real and 2 fake 8-frame videos, video-level and
              --per-frame (videos x frames scores); the feature maps of one
              frame (visualize_feature_maps.collect in fp32 with the four
              flags, exact K1-K3 launches, held to the same function on the
              CPU within atol 1e-3); and the phase's wall time;
10. learn  -- the learning proof's flagship recipe
              (cli/learning_proof.prove(flagship=True) with a ModelConfig()
              whose four kernel flags are on): a checkerboard FF++ tree of
              8-frame 450-px PNGs in a temporary directory, decoded with the
              face detector off as prove runs the CLIs, cli.train for 25
              epochs (batch 4, accum 2, lr 3e-4, no remat; K1 in the training
              forward, K1-K4 in the val epochs) and cli.eval on its
              best_model.pth (K1-K4); every one of the five checks must pass
              (final loss <= 0.05, loss declined, best val AUC >= 0.99, test
              AUC >= 0.99, test ACC >= 0.95), and each train epoch, val epoch
              and eval pass launches exactly the derived K1-K4 counts. It
              prints the losses, AUCs and accuracy, the phase's wall time,
              seconds per epoch, ms per update, host decode frames/s and the
              seconds each checkpoint save blocked the loop;
11. report -- one JSON line describing every kernel (with dp_launches and
              learn_launches, the dp and learn phases' counts), then the final
              line {"ok": true, "device": {...}}.

Without a CUDA device, or run outside the repository, it exits nonzero and
prints no result. It imports nothing of JAX or of the ewvit_tpu package.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from ewvit_tpu_torch import InferenceEngine, ModelConfig, build_detector, video_forward
from ewvit_tpu_torch.configs import B0_BLOCKS
from ewvit_tpu_torch.device import resolve_device
from ewvit_tpu_torch.checkpoint import load_model
from ewvit_tpu_torch.cli import ablation as cli_ablation
from ewvit_tpu_torch.cli import bench as cli_bench
from ewvit_tpu_torch.cli import calculate_gflops as cli_calculate_gflops
from ewvit_tpu_torch.cli import eval as cli_eval
from ewvit_tpu_torch.cli import plot_celebdf_roc as cli_roc
from ewvit_tpu_torch.cli import test as cli_test
from ewvit_tpu_torch.cli import train as cli_train
from ewvit_tpu_torch.cli import visualize_feature_maps as cli_fm
from ewvit_tpu_torch.configs import TrainConfig
from ewvit_tpu_torch.data import native
from ewvit_tpu_torch.data.datasets import FaceForensicsDataset
from ewvit_tpu_torch.data.pipeline import BatchLoader
from ewvit_tpu_torch.data.synthetic import write_celebdf_tree, write_ff_tree
from ewvit_tpu_torch.data.transforms import FaceAligner, FrameTransform, cv2_module
from ewvit_tpu_torch.evaluation import evaluate
from ewvit_tpu_torch.models.detector import ABLATION_MODES, random_detector
from ewvit_tpu_torch.models.efficientnet import DepthwiseSE
from ewvit_tpu_torch.models.kept import KeepsWeights
from ewvit_tpu_torch.models.norm import BatchNorm2d
from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops.dw_se import (
    dw_bn_silu_mean,
    dw_bn_silu_mean_packed,
    dw_bn_silu_mean_plain,
    dwse_plan,
    pack_dwse,
)
from ewvit_tpu_torch.ops.fused_attention import (
    CLUSTER_ROWS,
    _launch_cluster,
    _launch_general,
    fused_bidirectional_cross_attention,
    fused_bidirectional_cross_attention_packed,
    fused_cross_attention_plain,
    pack_xattn,
)
from ewvit_tpu_torch.ops.haar import haar_dwt2d, haar_dwt2d_plain
from ewvit_tpu_torch.ops.mwt_tail import (
    fused_multiscale_winograd,
    fused_multiscale_winograd_packed,
    fused_multiscale_winograd_plain,
    multiscale_winograd_u,
    pack_tail,
)
from ewvit_tpu_torch.ops.preprocess import preprocess_batch
from ewvit_tpu_torch.parallel import make_mesh
from ewvit_tpu_torch.train import loop as train_loop
from ewvit_tpu_torch.train.checkpoint import CheckpointManager
from ewvit_tpu_torch.train.loop import Trainer
from ewvit_tpu_torch.train.optimizer import detector_frozen_names, make_optimizer
from ewvit_tpu_torch.train.steps import train_step
from ewvit_tpu_torch.ops.winograd import (
    conv3x3_winograd,
    conv3x3_winograd_packed,
    conv3x3_winograd_plain,
    halo_route,
    pack_u,
    transform_weights,
)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
BF16_MMA_OPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
F32_TOL = dict(atol=1e-5, rtol=1e-5)      # fp32: summation order only
# fp32 K4 against its plain version: the same products summed in another
# order over k = 128, through four dependent blocks of LayerNorm and
# projections
XATTN_F32_TOL = dict(atol=1e-4, rtol=1e-4)
# fp32 Winograd (K3, K5) against its plain version: the same products summed
# in another order over 384 or 54 input channels and 16 transform positions
WINO_F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)   # one bf16 rounding of the output
# End to end, (features, logits) as (atol, rtol): video-mean features
# ('fused'/'space'/'freq' or 'sfe'/'mwt', [B, 128]) and logits [B, 1] of the
# same weights.
OUT_TOL_F32 = ((1e-3, 1e-3), (1e-3, 0.0))     # fp32 kernels vs fp32 plain modules
# bf16 vs fp32 is a sanity check: ~60 layers of bf16 rounding drift the
# features by a few per cent of their range (0.08 of ~2.8 measured on H100).
OUT_TOL_BF16 = ((0.2, 5e-2), (2e-2, 0.0))     # bf16 serving vs fp32 plain modules
N_ROWS = 64                                # B * chunk on the main path
COLD_BYTES = 100 << 20     # cold-L2 timing cycles more than this (L2 is 50 MB)
CYCLES_PER_MS = 2_000_000                  # H100 SM clock is at most ~2 GHz


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_err(got, ref, atol, rtol, what):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if not torch.isfinite(got).all() or bad.any():
        fail(f"{what}: {int(bad.sum())} elements outside atol={atol} rtol={rtol}, "
             f"max abs err {err.max().item():.3e}")
    return err.max().item()


def time_ms(fn, iters=20, warmup=3):
    """(device ms, wall ms) per call, from CUDA events.

    Device: a spin kernel holds the stream while all ``iters`` calls are
    queued, so the events bracket back-to-back device work and the host's
    launch overhead does not show. Wall: the same loop without the spin, so
    each call costs the larger of its device time and its host time.
    """
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_call_ms = (time.perf_counter() - t) * 1e3 / warmup
    # hold the stream for 3x the time the host needs to queue the calls
    spin_cycles = int(CYCLES_PER_MS * max(50.0, 3 * iters * host_call_ms))
    out = []
    for spin in (spin_cycles, 0):
        torch.cuda.synchronize()
        held, start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t = time.perf_counter()
        held.record()
        if spin:
            torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        host_ms = (time.perf_counter() - t) * 1e3
        stop.synchronize()
        if spin and held.elapsed_time(start) < host_ms:
            fail(f"timing spin ({held.elapsed_time(start):.1f} ms) ended before "
                 f"the {iters} calls were queued ({host_ms:.1f} ms)")
        out.append(start.elapsed_time(stop) / iters)
    return tuple(out)


def bound_ms(nbytes, nops, peak=FP32_OPS_PER_S):
    """Least time for the work: bytes over the memory rate or operations over
    ``peak`` (fp32 FMAs by default; the bf16 tensor-core rate for work that
    is matrix products), whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------------ phases


def phase_device():
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
              else f"nvidia-smi failed (rc={smi.returncode})")
    except FileNotFoundError:
        print("nvidia-smi not found")
    dev = resolve_device("cuda")
    print(f"[device] {torch.cuda.get_device_name(0)}  count={torch.cuda.device_count()}  "
          f"capability={torch.cuda.get_device_capability(0)}  torch={torch.__version__}  "
          f"cuda={torch.version.cuda}")
    return dev


def phase_build():
    t = time.perf_counter()
    logs = extension.build_all()
    print(f"[build] {len(logs)} kernel libraries ready in {time.perf_counter() - t:.1f} s")
    for stem, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                fn = line.replace("'", " ").split()[-1 if "properties" in line else -3]
            if "registers" in line or "spill" in line:
                # the bf16 Winograd kernel (namespace hop) must not spill
                label = {"3hop": "bf16 wgmma kernel", "3f32": "fp32 kernel"}.get(
                    next((k for k in ("3hop", "3f32") if k in fn), ""), fn[:48])
                if "dw_bn_silu_mean_kernel" in fn:
                    label = dwse_label(fn)
                elif "xattn_" in fn:
                    label = xattn_label(fn)
                print(f"[build] {stem}: {label}: {line.strip()}")


def dwse_label(mangled):
    """'K2 bf16 k3 strip7 plane7' from K2's mangled instantiation name
    (plane 0: any plane size)."""
    k, sw, hw = re.search(r"Li(\d+)ELi(\d+)ELi(\d+)E", mangled).groups()
    return f"K2 {'bf16' if 'bfloat16' in mangled else 'f32'} k{k} strip{sw} plane{hw}"


def xattn_label(mangled):
    """'K4 cluster bf16' / 'K4 general f32' from K4's mangled names."""
    dtype = "bf16" if "bfloat16" in mangled else "f32"
    return f"K4 {'cluster' if 'xattn_cluster' in mangled else 'general'} {dtype}"


class Timings:
    """Per-chunk totals for one kernel: device and wall ms of the kernel, its
    plain version and (where one exists) the library call, and its bound."""

    def __init__(self, peak=FP32_OPS_PER_S):
        self.t = dict(ms=0.0, wall_ms=0.0, plain_ms=0.0, plain_wall_ms=0.0,
                      library_ms=None, bound_ms=0.0)
        self.nbytes = self.nops = 0
        self.peak = peak

    def add(self, count, kernel, plain, library=None, nb=0, ops=0):
        # the plain versions launch many kernels per call: fewer iterations
        # keep the queued launches inside the device's pending-launch queue
        for key, fn, iters in (("", kernel, 20), ("plain_", plain, 5),
                               ("library_", library, 20)):
            if fn is None:
                continue
            dev_ms, wall_ms = time_ms(fn, iters=iters)
            self.t[f"{key}ms"] = (self.t[f"{key}ms"] or 0.0) + count * dev_ms
            if key != "library_":
                self.t[f"{key}wall_ms"] += count * wall_ms
        self.t["bound_ms"] += count * bound_ms(nb, ops, self.peak)[0]
        self.nbytes += count * nb
        self.nops += count * ops

    def entry(self, **kw):
        return dict(kw, bound_by=bound_ms(self.nbytes, self.nops, self.peak)[1], **self.t)


def phase_kernels(dev):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    report = []
    extension.reset_launches()     # K5's reported launches are this phase's

    # K1: Haar DWT, 3 launches per chunk (one per MWT level, 224/112/56 px)
    errs, tm = [], Timings()
    for dtype, tol in ((torch.float32, dict(atol=1e-6, rtol=0.0)), (torch.bfloat16, BF16_TOL)):
        for side in (224, 112, 56):
            x = torch.randn(N_ROWS, 3, side, side, device=dev, generator=g).to(dtype)
            ll, hf = haar_dwt2d(x)
            ll_p, hf_p = haar_dwt2d_plain(x)
            what = f"haar_dwt2d {tuple(x.shape)} {dtype}"
            errs.append(max(max_err(ll, ll_p, what=what + " ll", **tol),
                            max_err(hf, hf_p, what=what + " hf", **tol)))
            print(f"[kernels] {what}: max abs err {errs[-1]:.3e} (tol {tol})")
            if dtype == torch.bfloat16:
                bank = haar_bank(3, dtype, dev)
                tm.add(1, lambda: haar_dwt2d(x), lambda: haar_dwt2d_plain(x),
                       lambda: F.conv2d(x, bank, stride=2, groups=3),
                       nb=nbytes(x, ll, hf), ops=4 * x.numel())
    report.append(tm.entry(
        name="haar_dwt2d", route="cuda", source="ewvit_tpu_torch/csrc/haar.cu",
        replaces="ewvit_tpu/ops/haar.py:163", max_abs_err=max(errs)))
    # a rank's empty share of a training chunk on a frames axis
    before = extension.LAUNCHES["haar_dwt2d"]
    ll, hf = haar_dwt2d(torch.empty(0, 3, 224, 224, device=dev, dtype=torch.bfloat16))
    if (tuple(ll.shape), tuple(hf.shape)) != ((0, 3, 112, 112), (0, 9, 112, 112)) or \
            extension.LAUNCHES["haar_dwt2d"] != before:
        fail(f"haar_dwt2d on zero rows: {tuple(ll.shape)}, {tuple(hf.shape)}")
    print("[kernels] haar_dwt2d on zero rows: empty outputs, no launch")

    report.append(dwse_kernel(dev, g))

    report.append(xattn_kernel(dev, g))

    report += winograd_kernels(dev, g)
    report[-1]["launches"] = extension.LAUNCHES["conv3x3_winograd"]

    for r in report:
        print(f"[kernels] {r['name']} per chunk (bf16, device ms / wall ms): kernel "
              f"{r['ms']:.4f} / {r['wall_ms']:.4f}, plain {r['plain_ms']:.4f} / "
              f"{r['plain_wall_ms']:.4f}, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
    return report


def xattn_weights(d, depth, dev, g):
    """Seeded K4 weights: mats ``[2*depth, d, 4d]`` (scaled as a lecun
    init), smalls ``[2*depth, 3, d]`` (LayerNorm near identity, small
    biases)."""
    mats = torch.randn(2 * depth, d, 4 * d, device=dev, generator=g) / d ** 0.5
    smalls = torch.stack([1 + 0.1 * torch.randn(2 * depth, d, device=dev, generator=g),
                          0.1 * torch.randn(2 * depth, d, device=dev, generator=g),
                          0.1 * torch.randn(2 * depth, d, device=dev, generator=g)], dim=1)
    return mats, smalls


def xattn_kernel(dev, g):
    """K4 at D = 128 (the served width, 4 heads, depth 2), 1 launch per chunk:
    the cluster kernel against the plain version at N = 64 (the chunk), 32
    (warmup, B = 1), 1 and 65 (a partial last cluster), in fp32 and bf16,
    and at 1 and 8 heads; the packed entry (weights packed once, as the
    served module keeps them) against the public one; two runs bit for bit;
    the general kernel (the first design) at D = 256 and at D = 128; times of
    the cluster kernel and of the general kernel at D = 128 in this call,
    packing outside the timed calls; and how many clusters can be resident
    (cudaOccupancyMaxActiveClusters; a chunk needs 8)."""
    d, heads, depth = 128, 4, 2
    mats, smalls = xattn_weights(d, depth, dev, g)
    packed = pack_xattn(mats, smalls)
    errs, tm = [], Timings()
    for dtype, tol in ((torch.float32, XATTN_F32_TOL), (torch.bfloat16, BF16_TOL)):
        for n, hs in ((N_ROWS, heads), (32, heads), (1, heads), (65, heads),
                      (N_ROWS, 1), (N_ROWS, 8)):
            s = torch.randn(n, d, device=dev, generator=g).to(dtype)
            f = torch.randn(n, d, device=dev, generator=g).to(dtype)
            so, fo = fused_bidirectional_cross_attention(s, f, mats, smalls, heads=hs)
            so_p, fo_p = fused_cross_attention_plain(s, f, mats, smalls, hs)
            what = f"fused_bidirectional_cross_attention cluster {tuple(s.shape)} heads {hs} {dtype}"
            errs.append(max(max_err(so, so_p, what=what + " space", **tol),
                            max_err(fo, fo_p, what=what + " freq", **tol)))
            print(f"[kernels] {what}: max abs err {errs[-1]:.3e} (tol {tol})")
            for again in (fused_bidirectional_cross_attention_packed(s, f, packed, heads=hs),
                          _launch_cluster(s, f, packed, hs)):
                if not (torch.equal(again[0], so) and torch.equal(again[1], fo)):
                    fail(f"{what}: the packed entry or a second run differs")
    print("[kernels] fused_bidirectional_cross_attention: the packed entry and second runs "
          "equal the first bit for bit")

    for dtype, tol in ((torch.float32, XATTN_F32_TOL), (torch.bfloat16, BF16_TOL)):
        for dd, n in ((256, N_ROWS), (256, 5), (128, N_ROWS)):
            m2, s2 = (mats, smalls) if dd == 128 else xattn_weights(dd, depth, dev, g)
            s = torch.randn(n, dd, device=dev, generator=g).to(dtype)
            f = torch.randn(n, dd, device=dev, generator=g).to(dtype)
            if dd == 128:
                so, fo = _launch_general(s, f, m2, s2, heads)
            else:
                so, fo = fused_bidirectional_cross_attention(s, f, m2, s2, heads=heads)
            so_p, fo_p = fused_cross_attention_plain(s, f, m2, s2, heads)
            what = f"fused_bidirectional_cross_attention general {tuple(s.shape)} {dtype}"
            errs.append(max(max_err(so, so_p, what=what + " space", **tol),
                            max_err(fo, fo_p, what=what + " freq", **tol)))
            print(f"[kernels] {what}: max abs err {errs[-1]:.3e} (tol {tol})")

    s = torch.randn(N_ROWS, d, device=dev, generator=g).to(torch.bfloat16)
    f = torch.randn(N_ROWS, d, device=dev, generator=g).to(torch.bfloat16)
    so, fo = fused_bidirectional_cross_attention_packed(s, f, packed, heads=heads)
    # 2*depth blocks, each 2*N*D*(D + 2D + 2D + D) flops of projections
    tm.add(1, lambda: fused_bidirectional_cross_attention_packed(s, f, packed, heads=heads),
           lambda: fused_cross_attention_plain(s, f, mats, smalls, heads),
           nb=nbytes(s, f, so, fo, mats, smalls), ops=2 * depth * 2 * N_ROWS * d * 6 * d)
    general_ms = time_ms(lambda: _launch_general(s, f, mats, smalls, heads))[0]
    active = extension.library("fused_attention").ewvit_xattn_cluster_max_active()
    needed = -(-N_ROWS // CLUSTER_ROWS)
    if active < needed:
        fail(f"cudaOccupancyMaxActiveClusters: {active} clusters resident, a chunk needs "
             f"{needed}")
    print(f"[kernels] fused_bidirectional_cross_attention per chunk (bf16, device ms): "
          f"cluster kernel {tm.t['ms']:.4f}, general kernel (the first design) "
          f"{general_ms:.4f}; clusters of 8 CTAs x {CLUSTER_ROWS} rows resident at once "
          f"(cudaOccupancyMaxActiveClusters): {active}, a chunk needs {needed}")
    entry = tm.entry(name="fused_bidirectional_cross_attention", route="cuda",
                     source="ewvit_tpu_torch/csrc/fused_attention.cu",
                     replaces="ewvit_tpu/ops/fused_attention.py:142", max_abs_err=max(errs))
    entry.update(general_ms=general_ms, max_active_clusters=active)
    return entry


def dwse_check(x, k, g, what):
    """K2 against its plain version on x (fp32 within 1e-5, bf16 y within one
    rounding and the mean within 1e-3), through the public entry; the launch
    plan's shared memory must be the kernel's own. Returns the error, the
    packed weights and the plain version's arguments."""
    c = x.shape[1]
    w_eff = 0.2 * torch.randn(k * k, c, device=x.device, generator=g)
    shift = 0.1 * torch.randn(c, device=x.device, generator=g)
    plan = dwse_plan(*x.shape, k, x.element_size(), torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    smem = extension.library("dw_se").ewvit_dw_se_smem_bytes(
        *x.shape, k, extension.dtype_code(x), plan.group, plan.band_rows, plan.stages,
        plan.strip)
    if smem != plan.smem_bytes:
        fail(f"{what}: the kernel lays out {smem} bytes of shared memory, the plan "
             f"{plan.smem_bytes}")
    y, m = dw_bn_silu_mean(x, w_eff, shift, k)
    y_p, m_p = dw_bn_silu_mean_plain(x, w_eff, shift, k)
    tol = F32_TOL if x.dtype == torch.float32 else BF16_TOL
    mtol = F32_TOL if x.dtype == torch.float32 else dict(atol=1e-3, rtol=1e-3)
    err = max(max_err(y, y_p, what=what + " y", **tol),
              max_err(m, m_p, what=what + " mean", **mtol))
    print(f"[kernels] {what}: max abs err {err:.3e} (tol y {tol}, mean {mtol}; G "
          f"{plan.group}, band rows {plan.band_rows}, stages {plan.stages}, strip "
          f"{plan.strip}, grid {plan.grid}, smem {smem} B)")
    return err, pack_dwse(w_eff, shift, k), (w_eff, shift), (y, m)


def dwse_cold_ms(x, packed, k, nb):
    """Device ms per K2 call with the L2 cold: the calls cycle through copies
    of x, and keep their outputs, over more than COLD_BYTES."""
    copies = -(-COLD_BYTES // nb) + 1
    xs = [x.clone() for _ in range(copies)]
    outs, i = [None] * copies, [0]

    def call():
        outs[i[0] % copies] = dw_bn_silu_mean_packed(xs[i[0] % copies], packed, k)
        i[0] += 1

    for _ in range(copies):        # every output slot allocated before timing
        call()
    ms = time_ms(call, iters=4 * copies)[0]
    del xs, outs
    return ms


def dwse_kernel(dev, g):
    """K2 at V2-S's four served shapes (fp32 and bf16 checked, bf16 timed warm
    and cold with the weights packed outside the timed call, as the served
    MBConv keeps them; two runs must agree bit for bit), then B0's planes
    and ragged cases, checked in fp32 and bf16 and not timed."""
    errs, tm = [], Timings()
    cold = 0.0
    # (channels, side, launches per chunk)
    for dtype in (torch.float32, torch.bfloat16):
        for c, side, count in ((512, 14, 5), (768, 14, 1), (960, 14, 8), (1536, 7, 14)):
            x = torch.randn(N_ROWS, c, side, side, device=dev, generator=g).to(dtype)
            what = f"dw_bn_silu_mean {tuple(x.shape)} k3 {dtype} x{count}/chunk"
            err, packed, plain_args, (y, m) = dwse_check(x, 3, g, what)
            errs.append(err)
            again = dw_bn_silu_mean_packed(x, packed, 3)
            if not (torch.equal(again[0], y) and torch.equal(again[1], m)):
                fail(f"{what}: two runs differ")
            if dtype == torch.bfloat16:
                nb = nbytes(x, y, packed, m)
                before = tm.t["ms"]
                tm.add(count, lambda: dw_bn_silu_mean_packed(x, packed, 3),
                       lambda: dw_bn_silu_mean_plain(x, *plain_args, 3),
                       nb=nb, ops=x.numel() * (2 * 9 + 6))
                one_cold = dwse_cold_ms(x, packed, 3, nbytes(x, y))
                cold += count * one_cold
                print(f"[kernels] {what}: per call warm {(tm.t['ms'] - before) / count:.4f} "
                      f"ms, cold {one_cold:.4f} ms, bound {bound_ms(nb, 0)[0]:.4f} ms")
            del x, y, m, again
    # B0 (ewvit_tpu/models/efficientnet.py:53-61) at N = 4, then ragged cases:
    # N*C not a multiple of the group; 33 planes of 7x7 (bf16: 3,234 bytes,
    # not a multiple of 16, so the last unit goes by ordinary loads); bands
    # with a k5 halo; 150-wide rows (300 bf16 bytes: every band by ordinary
    # loads and stores, and a strip past the row's end)
    for n, c, side, k in ((4, 32, 112, 3), (4, 144, 56, 3), (4, 240, 28, 5),
                          (4, 672, 14, 5), (4, 1152, 7, 5), (4, 1152, 7, 3),
                          (3, 136, 14, 3), (3, 136, 7, 3), (1, 33, 7, 3), (2, 3, 112, 5),
                          (1, 3, 150, 3)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n, c, side, side, device=dev, generator=g).to(dtype)
            errs.append(dwse_check(x, k, g, f"dw_bn_silu_mean {tuple(x.shape)} k{k} "
                                            f"{dtype}")[0])
    entry = tm.entry(name="dw_bn_silu_mean", route="cuda",
                     source="ewvit_tpu_torch/csrc/dw_se.cu",
                     replaces="ewvit_tpu/ops/dw_se.py:52", max_abs_err=max(errs))
    entry["cold_ms"] = cold
    print(f"[kernels] dw_bn_silu_mean per chunk (bf16): warm {entry['ms']:.4f} ms, cold "
          f"{cold:.4f} ms, bound {entry['bound_ms']:.4f} ms")
    return entry


def winograd_kernels(dev, g):
    """K3 at the MWT's full-width multiscale_fusion (3 levels [64, 128, 112,
    112] -> 128), 1 launch per chunk; K5 at the MWT's two stride-1 conv
    shapes (hf_fusion 54 -> 128, multiscale_fusion 384 -> 128), one call
    each; then bf16 edge shapes that the 8 x 8-tile block does not divide,
    on both halo copy widths (8-byte, and 4-byte where W is not a multiple
    of 4).
    U is packed outside the timed calls (the served MWT keeps it), as the
    library yardstick's folded weight is. Bounds use the bf16 tensor-core
    peak: the work is matrix products the tensor cores can do. Operations
    count the 16 transform-domain products only (2*16*tiles*Cin*Cout)."""
    side, c, levels = 112, 128, 3
    tiles = N_ROWS * (side // 2) ** 2
    report = []

    errs, tm = [], Timings(BF16_MMA_OPS_PER_S)
    w = torch.randn(c, levels * c, 3, 3, device=dev, generator=g) / (9 * levels * c) ** 0.5
    conv_b = 0.1 * torch.randn(c, device=dev, generator=g)
    scale = 0.5 + torch.rand(c, device=dev, generator=g)
    shift = 0.1 * torch.randn(c, device=dev, generator=g)
    bias = conv_b * scale + shift
    for dtype, tol in ((torch.float32, WINO_F32_TOL), (torch.bfloat16, BF16_TOL)):
        ys = [torch.randn(N_ROWS, c, side, side, device=dev, generator=g).to(dtype)
              for _ in range(levels)]
        wd = w.to(dtype)
        u = multiscale_winograd_u(wd, scale, levels, dtype)
        out = fused_multiscale_winograd(ys, u, bias)
        ref = fused_multiscale_winograd_plain(ys, u, bias)
        what = f"fused_multiscale_winograd {levels} x {tuple(ys[0].shape)} {dtype}"
        if dtype == torch.bfloat16:
            what += f" ({halo_route(ys[0])} halo)"
        errs.append(max_err(out, ref, what=what, **tol))
        print(f"[kernels] {what}: max abs err {errs[-1]:.3e} (tol {tol}; |ref| max "
              f"{ref.float().abs().max().item():.3e})")
        if dtype == torch.bfloat16:
            cat = torch.cat(ys, dim=1)
            w_fold = (wd.float() * scale[:, None, None, None]).to(dtype)
            b_lib = bias.to(dtype)
            up, b32 = pack_tail(u, bias)
            # library yardstick: one cuDNN conv on the concatenated levels,
            # folded weight and bias; it leaves out the ReLU
            tm.add(1, lambda: fused_multiscale_winograd_packed(ys, up, b32),
                   lambda: fused_multiscale_winograd_plain(ys, u, bias),
                   lambda: F.conv2d(cat, w_fold, b_lib, padding=1),
                   nb=nbytes(*ys, out, u, bias), ops=2 * 16 * levels * tiles * c * c)
            del cat
        del ys, out, ref
    edge_errs = winograd_edges(dev, g)
    errs += edge_errs["k3"]
    report.append(tm.entry(
        name="fused_multiscale_winograd", route="cuda",
        source="ewvit_tpu_torch/csrc/winograd.cu",
        replaces="ewvit_tpu/ops/mwt_tail.py:108", max_abs_err=max(errs)))

    errs, tm = list(edge_errs["k5"]), Timings(BF16_MMA_OPS_PER_S)
    for cin in (54, 384):
        wk = torch.randn(c, cin, 3, 3, device=dev, generator=g) / (9 * cin) ** 0.5
        for dtype, tol in ((torch.float32, WINO_F32_TOL), (torch.bfloat16, BF16_TOL)):
            x = torch.randn(N_ROWS, cin, side, side, device=dev, generator=g).to(dtype)
            wd = wk.to(dtype)
            out = conv3x3_winograd(x, wd)
            ref = conv3x3_winograd_plain(x, wd)
            what = f"conv3x3_winograd {tuple(x.shape)} -> {c} {dtype}"
            errs.append(max_err(out, ref, what=what, **tol))
            print(f"[kernels] {what}: max abs err {errs[-1]:.3e} (tol {tol}; |ref| max "
                  f"{ref.float().abs().max().item():.3e})")
            if dtype == torch.bfloat16:
                up = pack_u(transform_weights(wd).reshape(1, 16, cin, c), dtype)
                before = dict(tm.t)
                tm.add(1, lambda: conv3x3_winograd_packed(x, up, c),
                       lambda: conv3x3_winograd_plain(x, wd),
                       lambda: F.conv2d(x, wd, padding=1),
                       nb=nbytes(x, wd, out), ops=2 * 16 * tiles * cin * c)
                print(f"[kernels] conv3x3_winograd Cin={cin} (bf16, device ms): kernel "
                      f"{tm.t['ms'] - before['ms']:.4f}, plain "
                      f"{tm.t['plain_ms'] - before['plain_ms']:.4f}, library "
                      f"{tm.t['library_ms'] - (before['library_ms'] or 0.0):.4f}, bound "
                      f"{tm.t['bound_ms'] - before['bound_ms']:.4f}")
            del x, out, ref
    report.append(tm.entry(
        name="conv3x3_winograd", route="cuda", source="ewvit_tpu_torch/csrc/winograd.cu",
        replaces="ewvit_tpu/ops/winograd_pallas.py:45", max_abs_err=max(errs)))
    torch.cuda.empty_cache()
    return report


def winograd_edges(dev, g):
    """bf16 K5 and K3 at shapes the 8 x 8-tile, 128-channel block leaves
    ragged (H/2, W/2 not multiples of 8; Cin not a multiple of 64; Cout not
    a multiple of 64), on the halo copy width each is meant to take.
    Returns the errors (one bf16 rounding) of each kernel."""
    errs = {"k5": [], "k3": []}
    for shape, cout, route in (((2, 54, 30, 22), 7, "cp.async 4-byte"),
                               ((2, 54, 30, 24), 7, "cp.async 8-byte")):
        x = torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)
        wk = (torch.randn(cout, shape[1], 3, 3, device=dev, generator=g)
              / (9 * shape[1]) ** 0.5).to(torch.bfloat16)
        if halo_route(x) != route:
            fail(f"conv3x3_winograd {shape}: halo route {halo_route(x)}, expected {route}")
        what = f"conv3x3_winograd {shape} -> {cout} bf16 ({route} halo)"
        errs["k5"].append(max_err(conv3x3_winograd(x, wk), conv3x3_winograd_plain(x, wk),
                                  what=what, **BF16_TOL))
        print(f"[kernels] {what}: max abs err {errs['k5'][-1]:.3e} (tol {BF16_TOL})")
    for shape, route in (((4, 128, 20, 28), "cp.async 8-byte"),
                         ((4, 128, 20, 30), "cp.async 4-byte")):
        c = shape[1]
        ys = [torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16) for _ in range(3)]
        u = multiscale_winograd_u(torch.randn(c, 3 * c, 3, 3, device=dev, generator=g)
                                  / (27 * c) ** 0.5, torch.ones(c, device=dev), 3,
                                  torch.bfloat16)
        bias = 0.1 * torch.randn(c, device=dev, generator=g)
        if halo_route(ys[0]) != route:
            fail(f"fused_multiscale_winograd {shape}: halo route {halo_route(ys[0])}, "
                 f"expected {route}")
        what = f"fused_multiscale_winograd 3 x {shape} bf16 ({route} halo)"
        errs["k3"].append(max_err(fused_multiscale_winograd(ys, u, bias),
                                  fused_multiscale_winograd_plain(ys, u, bias), what=what,
                                  **BF16_TOL))
        print(f"[kernels] {what}: max abs err {errs['k3'][-1]:.3e} (tol {BF16_TOL})")
    return errs


def haar_bank(c, dtype, dev):
    """[4C, 1, 2, 2] filters: one grouped stride-2 conv gives LL, LH, HL, HH
    per channel (library yardstick for K1; channel order c*4 + band)."""
    b = torch.tensor([[[1, 1], [1, 1]], [[1, 1], [-1, -1]],
                      [[1, -1], [1, -1]], [[1, -1], [-1, 1]]], dtype=torch.float32) * 0.5
    return b[:, None].repeat(c, 1, 1, 1).to(dev, dtype)


def serve(cfg, mode, state, requests, *, count):
    """Serve ``requests`` in ``mode`` on a fresh engine holding ``state``; with
    ``count`` the launch counters are zeroed after warmup and read after the
    run. Returns probabilities (predict and predict_stream), per-request
    latency, stream time, the launch counts, and the video-level outputs of
    ``video_forward`` (taken after the counts are read)."""
    model = build_detector(cfg, device="cuda")
    model.load_state_dict(state, strict=True)
    engine = InferenceEngine(model, mode=mode, frame_chunk=32, device="cuda")
    engine.warmup(*requests[0].shape[:2])
    if count:
        extension.reset_launches()
    lat, probs = [], []
    for clips in requests:
        t = time.perf_counter()
        probs.append(engine.predict(clips))
        lat.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    streamed = list(engine.predict_stream(iter(requests)))
    stream_ms = (time.perf_counter() - t) * 1e3
    launches = dict(extension.LAUNCHES) if count else None
    key_us = kept_check_us(engine.model, engine.dtype) if count else None
    outs = [video_forward(engine.model,
                          preprocess_batch(torch.from_numpy(c).cuda(), engine.dtype),
                          mode=mode, frame_chunk=32) for c in requests]
    outputs = {k: torch.cat([o[k].float().cpu() for o in outs]) for k in outs[0]}
    del engine, model
    torch.cuda.empty_cache()
    return dict(probs=probs, streamed=streamed, lat=lat, stream_ms=stream_ms,
                launches=launches, outputs=outputs, key_us=key_us)


def kept_check_us(model, dtype, calls=2000):
    """Host microseconds per call of each kind of kept-weight getter (one
    module per class: MBConv and MBConvBlock keep K2's fold, MWT K3's U,
    BidirectionalCrossTransformer K4's pack) when nothing changed: the key
    check (data_ptr and _version of every tensor the fold reads) and the
    lookup; a getter that folded again would count a fold here and fail the
    serve phase."""
    getters = {}
    for m in model.modules():
        if isinstance(m, KeepsWeights) and m.kept_weights(dtype) is not None:
            getters.setdefault(type(m).__name__, lambda m=m: m.kept_weights(dtype))
    out = {}
    for name, fn in getters.items():
        before = dict(extension.LAUNCHES)
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t) * 1e6 / calls
        if extension.LAUNCHES != before:
            fail(f"{name}: the kept weights were folded again with nothing changed")
    return out


def check_probs(served):
    for p, q in zip(served["probs"], served["streamed"]):
        if p.shape != (2,) or not np.isfinite(p).all() or not ((p > 0) & (p < 1)).all():
            fail(f"bad probabilities {p}")
        if np.abs(p - q).max() > 1e-6:
            fail(f"predict_stream {q} differs from predict {p}")


# (config, mode) of each served path; K4 and K5 are in no sfe path
FLAGS = dict(use_pallas_dwt=True, use_pallas_dwse=True, use_pallas_dama=True)
PATHS = {
    "three_flags": (ModelConfig().replace(**FLAGS), "dynamic"),
    "fused_mwt_tail": (ModelConfig().replace(use_fused_mwt_tail=True, **FLAGS), "dynamic"),
    "sfe_only": (ModelConfig().replace(use_pallas_dwse=True), "sfe_only"),
    "sfe_mwt": (ModelConfig().replace(use_pallas_dwt=True, use_pallas_dwse=True,
                                      use_fused_mwt_tail=True), "sfe_mwt"),
}
MUST_LAUNCH = {
    "three_flags": ("haar_dwt2d", "dw_bn_silu_mean", "fused_bidirectional_cross_attention"),
    "fused_mwt_tail": ("haar_dwt2d", "dw_bn_silu_mean", "fused_bidirectional_cross_attention",
                       "fused_multiscale_winograd"),
    "sfe_only": ("dw_bn_silu_mean",),
    "sfe_mwt": ("haar_dwt2d", "dw_bn_silu_mean", "fused_multiscale_winograd"),
}
# K2 launches once per stride-1 B0 block (all carry SE) per chunk: 12
B0_DWSE_PER_CHUNK = sum(1 for c in B0_BLOCKS for r in range(c.repeats)
                        if (c.stride if r == 0 else 1) == 1)


def phase_serve(requests, state):
    """Serve every path in bf16 with launch counts, then hold it, and its
    fp32 twin, against the fp32 plain (direct-conv) modules in its mode.
    Returns each path's run (probabilities, latency, launch counts)."""
    for cfg, _ in PATHS.values():
        if cfg.compute_dtype != "bfloat16" or cfg.arch.image_size != 224:
            fail(f"unexpected serving config {cfg}")
    # K3 launches once per chunk: predict and predict_stream each serve every
    # request, in ceil(K / frame_chunk) chunks
    chunks = 2 * len(requests) * -(-requests[0].shape[1] // 32)

    served = {}
    for name, (cfg, mode) in PATHS.items():
        run = served[name] = serve(cfg, mode, state, requests, count=True)
        n = run["launches"]
        print(f"[serve] {name} ({mode}) bf16: per-request latency ms "
              f"{[round(v, 3) for v in run['lat']]}, stream of {len(requests)} in "
              f"{run['stream_ms']:.3f} ms; launches {n}")
        # conv3x3_winograd (K5) is in no path: the JAX package wires it into
        # no model, so it is held to its plain version in phase_kernels only
        for k in MUST_LAUNCH[name]:
            if n[k] == 0:
                fail(f"kernel {k} was never launched on the {name} path")
        want_k3 = chunks if "fused_multiscale_winograd" in MUST_LAUNCH[name] else 0
        if n["fused_multiscale_winograd"] != want_k3:
            fail(f"fused_multiscale_winograd launched {n['fused_multiscale_winograd']} "
                 f"times on {name}, expected {want_k3} ({chunks} chunks)")
        if mode != "dynamic":
            want = dict(dw_bn_silu_mean=B0_DWSE_PER_CHUNK * chunks,
                        haar_dwt2d=3 * chunks if mode == "sfe_mwt" else 0,
                        fused_bidirectional_cross_attention=0)
            for k, v in want.items():
                if n[k] != v:
                    fail(f"{k} launched {n[k]} times on {name}, expected {v}")
            if "MBConvBlock" not in run["key_us"]:
                fail(f"{name}: the B0 blocks keep no K2 fold")
        # every kept weight is folded once per model (at cast_for_inference),
        # never per request
        for fold in ("winograd_u_fold", "dw_se_fold", "xattn_pack"):
            if n[fold]:
                fail(f"{fold}: {n[fold]} folds while serving {name}")
        # D = 128 takes the cluster kernel, never the general one
        if n["fused_bidirectional_cross_attention_general"]:
            fail(f"the general cross-attention kernel ran on the {name} path")
        check_probs(run)
        print(f"[serve] {name} probabilities {[p.tolist() for p in run['probs']]}")
        print(f"[serve] {name}: kept-weight key check, host us per call: "
              f"{ {k: round(v, 3) for k, v in run['key_us'].items()} }")
    print(f"[serve] latency ms side by side ({' | '.join(served)}): " + ", ".join(
        " | ".join(f"{v:.3f}" for v in lat)
        for lat in zip(*(r["lat"] for r in served.values()))))
    print(f"[serve] stream of {len(requests)} ms ({' | '.join(served)}): "
          + " | ".join(f"{r['stream_ms']:.3f}" for r in served.values()))

    f32 = dict(compute_dtype="float32")
    plain = {}
    for name, (cfg, mode) in PATHS.items():
        if mode not in plain:
            plain[mode] = serve(ModelConfig().replace(**f32), mode, state, requests,
                                count=False)["outputs"]
            print(f"[serve] {mode} logits: fp32 plain {plain[mode]['logits'].flatten().tolist()}")
        k32 = serve(cfg.replace(**f32), mode, state, requests, count=False)
        for what, run, tols in ((f"fp32 {name} vs fp32 plain path", k32, OUT_TOL_F32),
                                (f"bf16 {name} vs fp32 plain path", served[name],
                                 OUT_TOL_BF16)):
            for key, ref in plain[mode].items():
                atol, rtol = tols[key == "logits"]
                e = max_err(run["outputs"][key], ref, atol, rtol, f"{what}: {key}")
                print(f"[serve] {what}: {key} max abs diff {e:.3e} (|ref| max "
                      f"{ref.abs().max().item():.3e}; atol {atol}, rtol {rtol})")
    return served


class PaddedBatches:
    """In-memory labelled batches of 2 clips, the last one padded with a zero
    clip; ``true_len()`` gives the real count, as the data pipeline's loader
    does."""

    def __init__(self, clips, labels):
        self.clips, self.labels = clips, labels

    def true_len(self):
        return len(self.labels)

    def __iter__(self):
        for i in range(0, len(self.labels), 2):
            c, y = self.clips[i:i + 2], self.labels[i:i + 2]
            if len(y) < 2:
                c = np.concatenate([c, np.zeros_like(c[:1])])
                y = np.concatenate([y, [0]])
            yield c, y


EVAL_PATHS = ("fused_mwt_tail", "sfe_only", "sfe_mwt")
EVAL_LABELS = np.array([0, 1, 1, 0, 1])


def phase_checkpoint(requests, state, served):
    """The weights as a reference-layout .pth: served through
    ``from_checkpoint`` on every path (bit for bit the served probabilities)
    and evaluated in each mode on labelled in-memory batches; returns each
    evaluated path's predictions."""
    evaluated = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "detector.pth")
        torch.save({"model_state_dict": {f"module.{k}": v.cpu() for k, v in state.items()},
                    "epoch": 0}, path)
        for name, (cfg, mode) in PATHS.items():
            engine = InferenceEngine.from_checkpoint(path, cfg, mode=mode, frame_chunk=32,
                                                     device="cuda")
            probs = [engine.predict(c) for c in requests]
            for p, q in zip(probs, served[name]["probs"]):
                if not np.array_equal(p, q):
                    fail(f"{name}: from_checkpoint gives {p}, the served engine {q}")
            del engine
        print(f"[checkpoint] {os.path.getsize(path) / 2**20:.1f} MiB .pth "
              "(model_state_dict, module. prefixes): from_checkpoint probabilities equal "
              "the served ones bit for bit on every path")

        # 5 labelled clips (the 3 requests' 6 less one) in batches of 2, the
        # tail padded; labels of both classes so AUC, EER and AP are defined
        clips = np.concatenate(requests)[:5]
        labels = EVAL_LABELS
        for name in EVAL_PATHS:
            cfg, mode = PATHS[name]
            m = evaluate(load_model(path, cfg, device="cuda"), PaddedBatches(clips, labels),
                         mode=mode, frame_chunk=32, device="cuda")
            if m["labels"] != labels.tolist():
                fail(f"evaluate {mode}: labels {m['labels']}")
            want = np.concatenate(served[name]["probs"])[:5]
            if np.abs(np.asarray(m["preds"]) - want).max() > 1e-6:
                fail(f"evaluate {mode}: predictions {m['preds']} differ from the served "
                     f"probabilities {want.tolist()}")
            report = {k: v for k, v in m.items() if k not in ("preds", "labels")}
            print(f"[checkpoint] evaluate {mode} ({name} flags): {json.dumps(report)}")
            for k in ("loss", "accuracy", "auc", "eer", "eer_threshold", "ap", "precision",
                      "recall", "f1", "orth_loss"):
                if not np.isfinite(m[k]):
                    fail(f"evaluate {mode}: {k} = {m[k]} is not finite")
            evaluated[name] = m["preds"]
            torch.cuda.empty_cache()
    return evaluated


# ------------------------------------------------------------------ train

TRAIN_FLAGS = dict(use_pallas_dwt=True, use_pallas_dwse=True, use_pallas_dama=True,
                   use_fused_mwt_tail=True)
# launched by no train step: K2, K3 and K4 are inference-only, as in the JAX
# package, and a train forward reads no kept weights
NOT_IN_TRAIN = ("dw_bn_silu_mean", "fused_multiscale_winograd",
                "fused_bidirectional_cross_attention",
                "fused_bidirectional_cross_attention_general",
                "dw_se_fold", "winograd_u_fold", "xattn_pack")
TRAIN_LR = 1e-4       # the reference's lr (make_optimizer's default)


def k1_per_step(cfg, mode, frames, accum, frame_chunk, remat=True):
    """K1 launches in one train step: one per MWT level per chunk per
    micro-batch in the forward, and again in each chunk's remat recompute
    (the whole chunk is recomputed: its last saved tensors are at its end)."""
    if mode == "sfe_only" or not cfg.use_pallas_dwt:
        return 0
    chunks = -(-frames // min(frame_chunk, frames))
    return cfg.levels * chunks * accum * (2 if remat else 1)


def train_model(cfg, state):
    model = build_detector(cfg, device="cuda")
    model.load_state_dict(state, strict=True)
    return model.train()


def train_steps(model, clips, labels, *, mode, steps, accum, frame_chunk, remat=True,
                timed_from=None, seed=0, mesh=None):
    """``steps`` train steps of ``model`` on one batch: the uint8 ``clips``
    preprocessed once in train mode (jitter from a generator seeded by
    ``seed``), the same dropout seed every step, so each step descends one
    fixed objective. Returns the losses, per-step device ms of the steps
    from ``timed_from`` on (CUDA events around ``train_step``), the launch
    counts of all steps, the parameters and statistics it started from,
    which parameters ever had a nonzero gradient, the optimizer and a
    function that runs one more step."""
    dt = torch.float32 if model.cfg.compute_dtype == "float32" else torch.bfloat16
    opt = make_optimizer(model, lr=TRAIN_LR, epochs=3, steps_per_epoch=4)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = [p for g in opt.param_groups for p in g["params"]]
    ever = torch.zeros(len(params), dtype=torch.bool, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frames = preprocess_batch(torch.from_numpy(clips).to("cuda"), dt, train=True,
                              generator=gen)
    y = torch.from_numpy(labels).to("cuda")

    if mesh is not None:          # this rank's rows (all of them in a world of one)
        frames, y = mesh.shard(frames, groups=accum), mesh.shard(y, groups=accum)

    def step():
        return train_step(model, opt, frames, y, seed=seed, mode=mode,
                          frame_chunk=frame_chunk, accum_steps=accum, remat=remat, mesh=mesh)

    losses, ms = [], []
    extension.reset_launches()
    for i in range(steps):
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        m = step()
        end.record()
        ever |= torch.stack([p.grad.abs().amax() for p in params]) > 0
        losses.append(m["loss"])
        if timed_from is not None and i >= timed_from:
            end.synchronize()
            ms.append(begin.elapsed_time(end))
    losses = torch.stack(losses).tolist()
    names = {id(p): n for n, p in model.named_parameters()}
    return dict(losses=losses, ms=ms, launches=dict(extension.LAUNCHES), start=start,
                grad_bytes=sum(p.numel() * p.element_size() for p in params),
                ever_grad={names[id(p)] for p, e in zip(params, ever.tolist()) if e},
                opt=opt, step=step)


def profile_step(step):
    """One more step under ``torch.profiler``: the device's busy ms (kernels
    and copies, summed) and how many kernels ran, with the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # kernels and copies; a user annotation (Optimizer.step) spans some of them
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    return busy_ms, sum(e.count for e in device), [
        (e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count) for e in top]


def check_trained(model, run, name, *, bn_prefixes):
    """The checks of a full-width train run: finite losses; the frozen
    tensors bit for bit; every other tensor with a nonzero value or gradient
    moved; the running statistics under ``bn_prefixes`` moved; no K2, K3, K4,
    fold or pack."""
    if not all(np.isfinite(run["losses"])):
        fail(f"train {name}: losses {run['losses']}")
    frozen, start = set(detector_frozen_names()), run["start"]
    still = []
    for n, p in model.named_parameters():
        if n in frozen:
            if not torch.equal(p, start[n]):
                fail(f"train {name}: frozen tensor {n} changed")
        elif (n in run["ever_grad"] or bool((start[n] != 0).any())) and torch.equal(p, start[n]):
            still.append(n)
    if still:
        fail(f"train {name}: {len(still)} tensors with a nonzero value or gradient did "
             f"not move: {still[:8]}")
    stats = [n for n, _ in model.named_buffers()
             if n.endswith(("running_mean", "running_var")) and n.startswith(bn_prefixes)]
    bufs = dict(model.named_buffers())
    unmoved = [n for n in stats if torch.equal(bufs[n], start[n])]
    if not stats or unmoved:
        fail(f"train {name}: running statistics that did not move: {unmoved[:8]}")
    for k in NOT_IN_TRAIN:
        if run["launches"][k]:
            fail(f"train {name}: {k} counted {run['launches'][k]} in train steps")
    return len(stats)


def grads_of(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def fp32_step(cfg, state, clip, label, **kw):
    """One fp32 train step on one short clip, with cuDNN's deterministic
    algorithms; its loss, gradients and BN running statistics."""
    model = train_model(cfg.replace(compute_dtype="float32"), state)
    torch.backends.cudnn.deterministic = True
    try:
        run = train_steps(model, clip, label, mode="dynamic", steps=1, accum=1,
                          frame_chunk=4, **kw)
    finally:
        torch.backends.cudnn.deterministic = False
    stats = {n: b.clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    out = (run["losses"][0], grads_of(model), stats, run["launches"])
    del model, run
    torch.cuda.empty_cache()
    return out


def compare_steps(a, b, what, spread=None):
    """Loss 1e-5, each gradient 1e-4 of its tensor's max abs, running
    statistics 1e-5. ``spread``: a third step that differs from ``a`` only
    in its BN kernel (the dp phase holds two BN implementations, whose
    rounding differs); each of those bounds is then at least 4 times that
    step's distance from ``a`` in the same quantity and tensor."""
    (la, ga, sa, _), (lb, gb, sb, _) = a, b
    ls, gs, ss = (la, ga, sa) if spread is None else spread[:3]
    if abs(la - lb) > max(1e-5, 4 * abs(la - ls)):
        fail(f"{what}: loss {la} vs {lb}")
    if ga.keys() != gb.keys():
        fail(f"{what}: different parameters have gradients")
    worst, spread_worst, wider = 0.0, 0.0, 0
    for n in ga:
        scale = ga[n].abs().max().item()
        err = (ga[n] - gb[n]).abs().max().item()
        base = (ga[n] - gs[n]).abs().max().item()
        if err > max(1e-4 * scale, 4 * base):
            fail(f"{what}: gradient {n} differs by {err:.3e} (max abs {scale:.3e}; "
                 f"the other BN kernel's step by {base:.3e})")
        wider += err > 1e-4 * scale
        worst = max(worst, err / scale if scale else 0.0)
        spread_worst = max(spread_worst, base / scale if scale else 0.0)
    stat_errs = [((sa[n] - sb[n]).abs().max().item(), (sa[n] - ss[n]).abs().max().item())
                 for n in sa]
    for err, base in stat_errs:
        if err > max(1e-5, 4 * base):
            fail(f"{what}: running statistics differ by {err:.3e} (the other BN kernel's "
                 f"step by {base:.3e})")
    print(f"[train] {what}: loss {la:.7f} vs {lb:.7f}, worst gradient difference "
          f"{worst:.3e} of its tensor's max abs, running statistics "
          f"{max(e for e, _ in stat_errs):.3e}" + ("" if spread is None else
          f"; the step on torch's native BN kernel: loss {ls:.7f}, worst gradient "
          f"{spread_worst:.3e} of max, running statistics "
          f"{max(b for _, b in stat_errs):.3e}; {wider} tensors beyond 1e-4 of their max, "
          f"each within 4x the native kernel's distance"))


@contextlib.contextmanager
def native_bn():
    """Train-mode BN on torch's own CUDA kernels (cuDNN off for the BN call
    only, its other flags kept)."""
    real = BatchNorm2d.forward

    def forward(self, x):
        b = torch.backends.cudnn
        with b.flags(enabled=False, benchmark=b.benchmark, deterministic=b.deterministic,
                     allow_tf32=b.allow_tf32):
            return real(self, x)

    BatchNorm2d.forward = forward
    try:
        yield
    finally:
        BatchNorm2d.forward = real


def phase_train(state, cfg, clips, chunk=32):
    """The train step in the three modes (``cfg``, with the kernel flags on),
    with kernel checks, the fp32 K1 and remat comparisons and the repair;
    returns the dynamic step's measurements and launches per step."""
    labels = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    accum, steps = 2, 8

    model = train_model(cfg, state)
    torch.cuda.reset_peak_memory_stats()
    run = train_steps(model, clips, labels, mode="dynamic", steps=steps, accum=accum,
                      frame_chunk=chunk, timed_from=2)
    peak = torch.cuda.max_memory_allocated()
    losses = run["losses"]
    print(f"[train] dynamic, {steps} steps, lr {TRAIN_LR}: losses {[round(v, 5) for v in losses]}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"train dynamic: the loss did not fall ({losses})")
    n_stats = check_trained(model, run, "dynamic", bn_prefixes=("dama.",))
    k1 = k1_per_step(cfg, "dynamic", clips.shape[1], accum, chunk)
    if run["launches"]["haar_dwt2d"] != k1 * steps:
        fail(f"train dynamic: K1 launched {run['launches']['haar_dwt2d']} times in "
             f"{steps} steps, expected {k1} per step")
    step_ms = float(np.mean(run["ms"]))
    frames = clips.shape[0] * clips.shape[1]
    busy_ms, device_ops, top = profile_step(run["step"])
    measured = dict(ms_per_step=step_ms, ms_per_step_each=run["ms"],
                    frames_per_s=frames / (step_ms / 1e3), peak_bytes=peak,
                    device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / step_ms,
                    device_ops_per_step=device_ops, top_device_ops=top,
                    k1_per_step=k1, launches_per_step={
                        k: v / steps for k, v in run["launches"].items()})
    if busy_ms <= 0:
        fail("the profiler saw no device time in a train step")
    print(f"[train] dynamic at full width (bf16 autocast, accum 2 x 2 clips x 40 frames, "
          f"frame_chunk 32, remat): {step_ms:.3f} ms per step (CUDA events, mean of "
          f"{len(run['ms'])} after 2 warm steps: {[round(v, 3) for v in run['ms']]}), "
          f"{measured['frames_per_s']:.1f} frames trained per s, peak "
          f"{peak / 2**30:.3f} GiB allocated; one profiled step: device busy "
          f"{busy_ms:.3f} ms in {device_ops} device operations (idle share "
          f"{measured['idle_share']:.3f} of the timed steps' mean), top {top}; "
          f"hand-written kernel launches per step "
          f"{measured['launches_per_step']}; {n_stats} DAMA running statistics moved; "
          f"the 18 frozen tensors unchanged; lr of the last update "
          f"{run['opt'].param_groups[0]['lr']:.3e}")

    # the repair: an eval forward with grad enabled through the kernels raises
    model.eval()
    x = preprocess_batch(torch.from_numpy(clips[:1, :2]).to("cuda"), torch.float32)[0]
    try:
        with torch.enable_grad():
            model(x, "dynamic")
    except RuntimeError as e:
        if "use_pallas_dwse" not in str(e):
            raise
        print(f"[train] eval forward with grad enabled raises: {e}")
    else:
        fail("an eval-mode forward with grad enabled through K2 did not raise")
    del model, run
    torch.cuda.empty_cache()

    # fp32, one clip of 10 frames: K1 in place and remat, each on and off
    clip, label = clips[:1, :10], labels[:1]
    k1_on = fp32_step(cfg, state, clip, label)
    want = k1_per_step(cfg, "dynamic", 10, 1, 4)
    if k1_on[3]["haar_dwt2d"] != want:
        fail(f"fp32 step: K1 launched {k1_on[3]['haar_dwt2d']} times, expected {want}")
    k1_off = fp32_step(cfg.replace(use_pallas_dwt=False), state, clip, label)
    if k1_off[3]["haar_dwt2d"]:
        fail("use_pallas_dwt off launched K1")
    compare_steps(k1_on, k1_off, "fp32 step, K1 on vs off")
    no_remat = fp32_step(cfg, state, clip, label, remat=False)
    compare_steps(k1_on, no_remat, "fp32 step, remat on vs off")

    # the sfe modes, 2 steps each
    for mode, prefixes in (("sfe_mwt", ("sfe.", "mwt.")), ("sfe_only", ("sfe_cls.",))):
        model = train_model(cfg, state)
        run = train_steps(model, clips, labels, mode=mode, steps=2, accum=accum,
                          frame_chunk=chunk)
        n = check_trained(model, run, mode, bn_prefixes=prefixes)
        want = k1_per_step(cfg, mode, clips.shape[1], accum, chunk)
        if run["launches"]["haar_dwt2d"] != 2 * want:
            fail(f"train {mode}: K1 launched {run['launches']['haar_dwt2d']} times in 2 "
                 f"steps, expected {want} per step")
        print(f"[train] {mode}: losses {[round(v, 5) for v in run['losses']]}, K1 "
              f"{want} per step, {n} running statistics moved, launches {run['launches']}")
        del model, run
        torch.cuda.empty_cache()
    return measured


# ------------------------------------------------------------------ fit

FIT_PAIRS = dict(train=4, val=4, test=2)
FIT_FRAMES, FIT_HEIGHT, FIT_WIDTH = 40, 256, 320
FIT_BATCH, FIT_ACCUM, FIT_CHUNK = 2, 2, 32
# launched and folded only by val epochs: train mode routes around K2-K4
VAL_ONLY = ("dw_bn_silu_mean", "fused_multiscale_winograd",
            "fused_bidirectional_cross_attention", "dw_se_fold", "winograd_u_fold",
            "xattn_pack")


def decode_route():
    """The host decoder of the fit phase, fixed by the decode probe on the
    GPU machine (cv2 importable; no libpng or libjpeg headers, so the native
    frameio library does not build there): cv2, as the JAX CLI decodes."""
    cv2 = cv2_module()
    if cv2 is None:
        fail("cv2 is not importable: the fit phase decodes frames with cv2, which the "
             "decode probe found on the GPU machine")
    print(f"[fit] host decode: cv2 {cv2.__version__} (native frameio library builds: "
          f"{native.available()})")


class StepTimer:
    """Stands in for train/loop.py's ``train_step``: CUDA events around each
    call (as phase_train times the bare step) and its micro-batch count."""

    def __init__(self):
        self.steps = []

    def __call__(self, *a, **kw):
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        out = train_step(*a, **kw)
        end.record()
        self.steps.append((kw["accum_steps"], begin, end))
        return out


class Counted:
    """Wraps a Trainer's epoch methods: each train and val epoch's launch
    counts (zeroed just before it), host seconds, result and, for a train
    epoch, the micro-batches of each of its updates."""

    def __init__(self, trainer, timer):
        self.epochs, self.timer = [], timer
        trainer.train_epoch = self.wrap("train", trainer.train_epoch)
        trainer.eval_epoch = self.wrap("val", trainer.eval_epoch)

    def wrap(self, kind, fn):
        def run(*a, **kw):
            first = len(self.timer.steps)
            extension.reset_launches()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.epochs.append(dict(kind=kind, launches=dict(extension.LAUNCHES),
                                    seconds=time.perf_counter() - t, result=out,
                                    micro=[m for m, _, _ in self.timer.steps[first:]]))
            return out
        return run


class SaveTimer:
    """Host seconds of each call of a CheckpointManager's ``_save``: the time
    the epoch loop is blocked by a save."""

    def __init__(self, mgr):
        self.seconds, self._save = [], mgr._save
        mgr._save = self

    def __call__(self, *a, **kw):
        t = time.perf_counter()
        out = self._save(*a, **kw)
        self.seconds.append(time.perf_counter() - t)
        return out


def fit_data(root, seed=0):
    """The FF++ train and val sets of the tree, at 224 px from 40 frames."""
    tf = FrameTransform(aligner=FaceAligner(detector="none"))
    kw = dict(frame_count=FIT_FRAMES, transform=tf, seed=seed)
    train = FaceForensicsDataset(root, split="train", **kw)
    val = FaceForensicsDataset(root, split="val", **kw)
    return (train, val,
            BatchLoader(train, FIT_BATCH, shuffle=True, drop_last=True, seed=seed),
            BatchLoader(val, FIT_BATCH, pad_last=True, seed=seed))


def fit_trainer(cfg, state, ckpt_dir, train_ds, steps_per_epoch):
    tcfg = TrainConfig(batch_size=FIT_BATCH, epochs=2, lr=TRAIN_LR, accum_steps=FIT_ACCUM,
                       frame_count=FIT_FRAMES, seed=0)
    return Trainer(cfg, tcfg, pos_weight=train_ds.fake_ratio,
                   steps_per_epoch=steps_per_epoch, checkpoint_dir=ckpt_dir, remat=True,
                   save_every=1, async_ckpt=True, device="cuda",
                   model=train_model(cfg, state))


def check_epochs(phase, cfg, model, counted, *, frames, batch, chunk, remat):
    """Every train and val epoch's launches and folds against the derived
    counts: a train epoch launches K1 ``k1_per_step`` times per update and
    nothing of VAL_ONLY; a val epoch launches K1 ``levels`` times, K2 once
    per stride-1 SE block of DAMA's V2-S, K3 and K4 once, per chunk of each
    of its batches, and folds or packs each kept module once. Returns each
    epoch's K1-K4 counts."""
    dwse = sum(1 for m in model.dama.modules() if isinstance(m, DepthwiseSE) and m.fuse_dwse)
    counts = []
    for i, ep in enumerate(counted.epochs):
        if ep["kind"] == "train":
            want = {k: 0 for k in VAL_ONLY}
            want["haar_dwt2d"] = sum(k1_per_step(cfg, "dynamic", frames, m, chunk, remat)
                                     for m in ep["micro"])
            if not ep["micro"]:
                fail(f"{phase}: train epoch {i // 2 + 1} took no step")
        else:
            clips = len(ep["result"].metrics["labels"])
            want = {k: v * -(-clips // batch) * -(-frames // chunk)
                    for k, v in per_chunk(model, "dynamic").items()}
            want.update(dw_se_fold=dwse, winograd_u_fold=1, xattn_pack=1)
        want["fused_bidirectional_cross_attention_general"] = 0
        got = ep["launches"]
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad:
            fail(f"{phase}, {ep['kind']} epoch {i // 2 + 1}: launches (counted, derived) {bad}")
        counts.append({k: want.get(k, 0) for k in KERNELS})
        if phase == "fit":
            print(f"[fit] {ep['kind']} epoch {i // 2 + 1}: launches and folds as derived {want}"
                  + (f", updates of {ep['micro']} micro-batches" if ep["micro"] else "")
                  + f"; {ep['seconds']:.3f} s")
    return counts


def decode_rate(loader, frames):
    """Host frames decoded per second by ``loader`` (its worker threads, no
    model)."""
    t = time.perf_counter()
    n = sum(len(labels) for _, labels in loader)
    return n * frames / (time.perf_counter() - t)


def serve_best(ckpt_dir, cfg, val_loader, counted):
    """best_model.pth through InferenceEngine.from_checkpoint on the val set,
    held to the val predictions of the epoch it was saved at."""
    path = os.path.join(ckpt_dir, "best_model.pth")
    epoch = torch.load(path, map_location="cpu", weights_only=True)["epoch"]
    engine = InferenceEngine.from_checkpoint(path, cfg, mode="dynamic", frame_chunk=FIT_CHUNK,
                                             device="cuda")
    remaining, probs = val_loader.true_len(), []
    for clips, _ in val_loader:
        n = min(len(clips), remaining)
        remaining -= n
        probs.extend(engine.predict(clips)[:n].tolist())
    want = [ep for ep in counted.epochs if ep["kind"] == "val"][epoch]["result"].metrics["preds"]
    atol = OUT_TOL_BF16[1][0]
    err = float(np.abs(np.asarray(probs) - np.asarray(want)).max())
    if len(probs) != len(want) or err > atol:
        fail(f"best_model.pth (epoch {epoch + 1}) served {probs}, its val epoch predicted {want}")
    print(f"[fit] best_model.pth (epoch {epoch + 1}) through from_checkpoint: {len(probs)} val "
          f"probabilities within {err:.3e} of that epoch's val predictions (atol {atol})")
    del engine
    torch.cuda.empty_cache()


def run_clis(root, tmp):
    """cli.train (1 epoch, --tiny) and cli.eval on its best_model.pth."""
    out, ev = os.path.join(tmp, "cli_train"), os.path.join(tmp, "cli_eval")
    common = ["--root", root, "--tiny", "--frame-count", "8", "--batch-size", "2"]
    t = time.perf_counter()
    result = cli_train.main(common + ["--output", out, "--epochs", "1"])
    best = os.path.join(out, "checkpoints", "best_model.pth")
    if not os.path.exists(best):
        fail(f"cli.train wrote no best_model.pth (best val AUC {result['best_val_auc']})")
    exported = cli_eval.main(common + ["--model-path", best, "--output", ev,
                                       "--dataset", "ff++"])
    for name in ("eval_results.csv", "confusion_matrices.json"):
        if not os.path.exists(os.path.join(ev, name)):
            fail(f"cli.eval wrote no {name}")
    with open(os.path.join(ev, "eval_results.csv")) as f:
        rows = f.read().splitlines()
    if len(rows) != 7 or [r["name"] for r in exported["rows"]] != ["overall"] + cli_eval.FF_METHODS:
        fail(f"cli.eval rows {rows}")
    for r in exported["rows"]:
        if not all(np.isfinite(v) for k, v in r.items() if k != "name"):
            fail(f"cli.eval: a metric is not finite in {r}")
    print(f"[fit] cli.train (1 epoch, --tiny) and cli.eval (--dataset ff++) in "
          f"{time.perf_counter() - t:.1f} s; eval_results.csv: {rows}")


def phase_fit(state, cfg, bare_step_ms, tmp):
    """Trainer.fit at full width on a synthetic tree written under ``tmp``
    (left there for the dp phase), with its checks; returns the
    measurements."""
    cfg = cfg.replace(frame_chunk=FIT_CHUNK)      # the Trainer chunks as its config says
    decode_route()
    root = os.path.join(tmp, "data")
    t = time.perf_counter()
    write_ff_tree(root, pairs=FIT_PAIRS, frames=FIT_FRAMES, height=FIT_HEIGHT,
                  width=FIT_WIDTH, seed=0)
    print(f"[fit] wrote a {FIT_PAIRS} pair FF++ tree of {FIT_FRAMES}-frame "
          f"{FIT_WIDTH}x{FIT_HEIGHT} PNG videos in {time.perf_counter() - t:.1f} s")
    train_ds, val_ds, train_loader, val_loader = fit_data(root)
    fps = decode_rate(val_loader, FIT_FRAMES)
    ckpt_dir = os.path.join(tmp, "checkpoints")
    steps_per_epoch = max(1, len(train_loader) // FIT_ACCUM)
    trainer = fit_trainer(cfg, state, ckpt_dir, train_ds, steps_per_epoch)
    timer = StepTimer()
    counted, saves = Counted(trainer, timer), SaveTimer(trainer.ckpt)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with mock.patch.object(train_loop, "train_step", timer):
        result = trainer.fit(train_loader, val_loader, train_dataset=train_ds,
                             val_dataset=val_ds)
    fit_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    check_epochs("fit", cfg, trainer.model, counted, frames=FIT_FRAMES, batch=FIT_BATCH,
                 chunk=FIT_CHUNK, remat=True)
    for n in detector_frozen_names():
        if not torch.equal(trainer.model.state_dict()[n], state[n]):
            fail(f"fit: frozen tensor {n} changed")
    files = sorted(os.listdir(ckpt_dir))
    if files != ["best_model.pth", "checkpoint_1.pth", "checkpoint_2.pth"]:
        fail(f"fit: checkpoint files {files}")
    step_ms = [b.elapsed_time(e) for _, b, e in timer.steps]
    vals = [ep for ep in counted.epochs if ep["kind"] == "val"]
    val_ms_clip = [ep["seconds"] * 1e3 / len(val_ds) for ep in vals]

    # the epoch loop blocked by a save: the async saves above, and sync
    # saves of the same model now
    sync = CheckpointManager(os.path.join(tmp, "sync"))
    sync_s = []
    for epoch in range(2):
        t = time.perf_counter()
        sync.save_epoch(trainer.model, trainer.optimizer, epoch, result["best_val_auc"])
        sync_s.append(time.perf_counter() - t)
    ckpt_mib = os.path.getsize(os.path.join(ckpt_dir, "checkpoint_1.pth")) / 2**20
    # one more train epoch (epoch 2's set, decode included) under the
    # profiler: how busy the device is inside the Trainer's loop
    t = time.perf_counter()
    busy_ms, device_ops, top = profile_step(lambda: trainer.train_epoch(train_loader, 1))
    profiled_ms = (time.perf_counter() - t) * 1e3
    history = [{"epoch": h["epoch"], "train_loss": h["train"]["loss"],
                "val_loss": h["val"]["loss"], "val_auc": h["val"]["auc"]}
               for h in result["history"]]
    del trainer
    torch.cuda.empty_cache()

    serve_best(ckpt_dir, cfg, val_loader, counted)

    train_ds, val_ds, train_loader, val_loader = fit_data(root)
    resumed = fit_trainer(cfg, state, os.path.join(tmp, "resumed"), train_ds,
                          steps_per_epoch)
    resumed.resume(os.path.join(ckpt_dir, "checkpoint_1.pth"))
    again = resumed.fit(train_loader, val_loader, train_dataset=train_ds,
                        val_dataset=val_ds)
    if [h["epoch"] for h in again["history"]] != [1]:
        fail(f"resume from checkpoint_1.pth ran epochs {[h['epoch'] for h in again['history']]}")
    print("[fit] resume from checkpoint_1.pth: start epoch 2, ran epoch 2 only")
    del resumed
    torch.cuda.empty_cache()

    run_clis(root, tmp)
    measured = dict(
        history=history, fit_s=fit_s, ms_per_step=float(np.mean(step_ms)),
        ms_per_step_each=step_ms, bare_train_step_ms=bare_step_ms,
        val_ms_per_clip=val_ms_clip, decode_frames_per_s=fps,
        async_save_blocked_s=saves.seconds, sync_save_blocked_s=sync_s,
        checkpoint_mib=ckpt_mib, peak_bytes=peak,
        profiled_train_epoch=dict(wall_ms=profiled_ms, device_busy_ms=busy_ms,
                                  device_ops=device_ops, top_device_ops=top))
    print(f"[fit] Trainer.fit, 2 epochs at full width: {fit_s:.1f} s; ms per train step "
          f"inside the Trainer {measured['ms_per_step']:.3f} "
          f"({[round(v, 3) for v in step_ms]}) against the bare train_step's "
          f"{bare_step_ms:.3f}; val ms per clip {[round(v, 3) for v in val_ms_clip]} "
          f"({len(val_ds)} clips, epoch 1 then 2); host decode {fps:.1f} frames/s "
          f"(cv2, 4 threads); epoch loop blocked per save: async "
          f"{[round(v, 3) for v in saves.seconds]} s, sync "
          f"{[round(v, 3) for v in sync_s]} s ({ckpt_mib:.1f} MiB a checkpoint); "
          f"peak {peak / 2**30:.3f} GiB allocated; one more train epoch under the "
          f"profiler: {profiled_ms:.1f} ms wall (profiler on), device busy "
          f"{busy_ms:.3f} ms in {device_ops} operations; history {history}")
    return measured


# ------------------------------------------------------------------ dp

DP_PATHS = ("three_flags", "fused_mwt_tail")


def nccl_version() -> str:
    """The NCCL version torch was built with."""
    v = torch.cuda.nccl.version()
    return ".".join(str(x) for x in v) if isinstance(v, tuple) else str(v)
DP_TIMED_ROUNDS = 3


def dp_serve(name, state, requests, served, mesh):
    """The ``name`` path served with and without the mesh: the mesh engine's
    launches over what the serve phase counted (predict, then
    predict_stream, of every request), its probabilities against the serve
    phase's bit for bit, then host ms per request of both engines,
    alternating."""
    cfg, mode = PATHS[name]
    engines = {}
    for kind in ("plain", "mesh"):
        model = build_detector(cfg, device="cuda")
        model.load_state_dict(state, strict=True)
        engines[kind] = InferenceEngine(model, mode=mode, frame_chunk=32, device="cuda",
                                        **(dict(mesh=mesh, frame_axis=True)
                                           if kind == "mesh" else {}))
        engines[kind].warmup(*requests[0].shape[:2])
    engine = engines["mesh"]
    extension.reset_launches()
    probs = [engine.predict(c) for c in requests]
    streamed = list(engine.predict_stream(iter(requests)))
    launches = dict(extension.LAUNCHES)
    for i, (p, q, want) in enumerate(zip(probs, streamed, served[name]["probs"])):
        if not (np.array_equal(p, want) and np.array_equal(q, want)):
            fail(f"dp {name}: request {i} served with the mesh {p} (streamed {q}), "
                 f"without {want}")
    want = served[name]["launches"]
    bad = {k: (launches[k], want[k]) for k in KERNELS + FOLDS if launches[k] != want[k]}
    if bad:
        fail(f"dp {name}: launches (mesh, serve phase) {bad}")
    for fold in FOLDS:
        if launches[fold]:
            fail(f"dp {name}: {fold} counted {launches[fold]} while serving")
    ms = {kind: [] for kind in engines}
    for _ in range(DP_TIMED_ROUNDS):
        for clips in requests:
            for kind, e in engines.items():
                t = time.perf_counter()
                e.predict(clips)
                ms[kind].append((time.perf_counter() - t) * 1e3)
    del engines, engine, model
    torch.cuda.empty_cache()
    return launches, ms


def dp_train(cfg, state, clips, labels, mesh, steps=2, accum=2, chunk=32):
    """``steps`` bf16 dynamic steps from ``state`` without and with the mesh,
    each on a fresh model, and one more mesh step under the profiler; the
    mesh run's checks. Returns (ms per step without, with), the profile,
    the mesh run's launches and the gradient bytes an update all-reduces."""
    ms, runs = {}, {}
    for kind in ("plain", "mesh"):
        model = train_model(cfg, state)
        runs[kind] = train_steps(model, clips, labels, mode="dynamic", steps=steps,
                                 accum=accum, frame_chunk=chunk, timed_from=0,
                                 mesh=mesh if kind == "mesh" else None)
        ms[kind] = runs[kind]["ms"]
        if kind == "mesh":
            launches = dict(runs[kind]["launches"])
            profile = profile_step(runs[kind]["step"])
        del model
        torch.cuda.empty_cache()
    run = dict(runs["mesh"], launches=launches)
    losses = run["losses"]
    print(f"[dp] bf16 dynamic steps with the mesh: losses {losses}; without "
          f"{runs['plain']['losses']}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"dp train: the loss with the mesh is not finite and falling ({losses})")
    k1 = k1_per_step(cfg, "dynamic", clips.shape[1], accum, chunk)
    if run["launches"]["haar_dwt2d"] != k1 * steps:
        fail(f"dp train: K1 launched {run['launches']['haar_dwt2d']} times in {steps} "
             f"steps, expected {k1} per step")
    for k in NOT_IN_TRAIN:
        if run["launches"][k]:
            fail(f"dp train: {k} counted {run['launches'][k]} in train steps")
    return ms, profile, {k: v / steps for k, v in run["launches"].items()}, run["grad_bytes"]


def torchrun(code, tmp, timeout=600):
    """``torchrun --standalone --nproc-per-node=1 --no-python python3 -c
    code`` from the repository root; its process group is its own. Returns
    its stdout."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node=1", "--no-python", sys.executable, "-c", code]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        fail(f"torchrun did not finish in {timeout} s")
    if proc.returncode != 0:
        fail(f"torchrun exited {proc.returncode}:\n{out[-4000:]}")
    return out


def dp_clis(root, tmp):
    """cli.train --mesh (1 epoch, --tiny) and then cli.eval --mesh on its
    checkpoint, in one process under torchrun on one GPU (each CLI forms
    and tears down its own process group from torchrun's environment)."""
    out, ev = os.path.join(tmp, "dp_train"), os.path.join(tmp, "dp_eval")
    ckpt = os.path.join(out, "checkpoints", "checkpoint_1.pth")
    common = ["--root", root, "--tiny", "--mesh", "--frame-count", "4", "--batch-size", "2"]
    code = ("from ewvit_tpu_torch.cli import eval, train\n"
            f"train.main({common + ['--output', out, '--epochs', '1']!r})\n"
            f"eval.main({common + ['--model-path', ckpt, '--output', ev, '--dataset', 'ff++']!r})")
    t = time.perf_counter()
    log = torchrun(code, tmp)
    seconds = time.perf_counter() - t
    if "Data-parallel mesh: {'dcn': 1, 'data': 1, 'frames': 1}" not in log \
            or not os.path.exists(ckpt):
        fail(f"torchrun cli.train --mesh wrote no checkpoint_1.pth:\n{log[-4000:]}")
    if "Data-parallel eval mesh:" not in log:
        fail(f"torchrun cli.eval --mesh printed no mesh:\n{log[-4000:]}")
    with open(os.path.join(ev, "eval_results.csv")) as f:
        rows = f.read().splitlines()
    if len(rows) != 7:
        fail(f"torchrun cli.eval --mesh rows {rows}")
    print(f"[dp] torchrun --nproc-per-node=1: cli.train --mesh --tiny (1 epoch) and cli.eval "
          f"--mesh in {seconds:.1f} s: {[l for l in log.splitlines() if 'Epoch 1/1' in l]}; "
          f"eval_results.csv {rows[:2]}")
    return dict(seconds=seconds)


def phase_dp(state, requests, served, evaluated, train_clips, root, tmp):
    """Data parallelism as an NCCL world of one: serving, evaluation, the
    fp32 and bf16 train steps and the two CLIs under torchrun, each with the
    mesh against the same work without it."""
    t0 = time.perf_counter()
    mesh = make_mesh(device="cuda")
    try:
        backend = torch.distributed.get_backend()
        if backend != "nccl" or mesh.device != torch.device("cuda", 0):
            fail(f"dp: the mesh runs {backend} on {mesh.device}")
        print(f"[dp] NCCL {nccl_version()}, mesh {mesh.shape} on {mesh.device}, backend "
              f"{backend}")
        launches, ms = {}, {}
        for name in DP_PATHS:
            launches[f"serve_{name}"], ms[name] = dp_serve(name, state, requests, served, mesh)
            print(f"[dp] serve {name} with the mesh: probabilities bit for bit the serve "
                  f"phase's, launches {launches[f'serve_{name}']}; host ms per request "
                  f"(x{DP_TIMED_ROUNDS} rounds, alternating): mesh "
                  f"{[round(v, 3) for v in ms[name]['mesh']]}, no mesh "
                  f"{[round(v, 3) for v in ms[name]['plain']]}")

        clips = np.concatenate(requests)[:5]
        for name in EVAL_PATHS:
            cfg, mode = PATHS[name]
            model = build_detector(cfg, device="cuda")
            model.load_state_dict(state, strict=True)
            m = evaluate(model, PaddedBatches(clips, EVAL_LABELS), mode=mode, frame_chunk=32,
                         device="cuda", mesh=mesh)
            if m["labels"] != EVAL_LABELS.tolist() or m["preds"] != evaluated[name]:
                fail(f"dp evaluate {mode}: labels {m['labels']}, preds {m['preds']} against "
                     f"the checkpoint phase's {evaluated[name]}")
            del model
        print(f"[dp] evaluate with the mesh ({', '.join(EVAL_PATHS)}): labels and "
              "predictions equal the checkpoint phase's")
        torch.cuda.empty_cache()

        cfg = ModelConfig().replace(**TRAIN_FLAGS)
        labels = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
        clip, label = train_clips[:1, :10], labels[:1]
        cudnn_step = fp32_step(cfg, state, clip, label)
        with native_bn():
            native_step = fp32_step(cfg, state, clip, label)
        compare_steps(cudnn_step, fp32_step(cfg, state, clip, label, mesh=mesh),
                      "dp fp32 step, no mesh vs mesh (cuDNN BN vs the synced BN)",
                      spread=native_step)
        step_ms, (busy_ms, device_ops, top), per_step, grad_bytes = dp_train(
            cfg, state, train_clips, labels, mesh)
        launches["train_per_step"] = per_step
        print(f"[dp] bf16 dynamic step [4, 40, 224, 224, 3], accum 2: ms per step (CUDA "
              f"events) mesh {[round(v, 3) for v in step_ms['mesh']]}, no mesh "
              f"{[round(v, 3) for v in step_ms['plain']]}; one more mesh step profiled: "
              f"device busy {busy_ms:.3f} ms in {device_ops} device operations, top {top}; "
              f"gradient all-reduce {grad_bytes} bytes ({grad_bytes / 2**20:.1f} MiB) per "
              f"update; launches per step {per_step}")
    finally:
        mesh.close()
    if torch.distributed.is_initialized():
        fail("dp: the process group outlived mesh.close()")
    clis = dp_clis(root, tmp)
    measured = dict(serve_ms=ms, train_ms=step_ms, train_mesh_device_busy_ms=busy_ms,
                    train_mesh_device_ops=device_ops, grad_allreduce_bytes=grad_bytes,
                    nccl=nccl_version(), clis=clis, wall_s=time.perf_counter() - t0)
    return measured, launches


# ------------------------------------------------------------------ clis

CLI_FLAGS = dict(use_pallas_dwt=True, use_pallas_dwse=True, use_pallas_dama=True,
                 use_fused_mwt_tail=True)
KERNELS = ("haar_dwt2d", "dw_bn_silu_mean", "fused_multiscale_winograd",
           "fused_bidirectional_cross_attention")
FOLDS = ("winograd_u_fold", "dw_se_fold", "xattn_pack")
CLI_VIDEOS, CLI_FRAMES = 2, 8          # Celeb-DF: 2 real and 2 fake videos of 8 frames


def matplotlib_probe():
    """Whether matplotlib imports here; printed on its own line, and the
    only place an ImportError of it is caught."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        have = False
    else:
        have = True
    print(f"[clis] matplotlib imports: {have}")
    return have


def per_chunk(model, mode):
    """Kernel launches per chunk of a flags-on eval forward in ``mode``: K1
    per MWT level, K2 per fused depthwise block of the mode's backbone, K3
    and K4 once where the mode has them."""
    dwse = lambda m: sum(1 for b in m.modules()                   # noqa: E731
                         if isinstance(b, DepthwiseSE) and b.fuse_dwse)
    levels = model.cfg.levels
    return {"dynamic": dict(haar_dwt2d=levels, dw_bn_silu_mean=dwse(model.dama),
                            fused_multiscale_winograd=1, fused_bidirectional_cross_attention=1),
            "sfe_only": dict(haar_dwt2d=0, dw_bn_silu_mean=dwse(model.sfe_cls),
                             fused_multiscale_winograd=0, fused_bidirectional_cross_attention=0),
            "sfe_mwt": dict(haar_dwt2d=levels, dw_bn_silu_mean=dwse(model.sfe),
                            fused_multiscale_winograd=1,
                            fused_bidirectional_cross_attention=0)}[mode]


def kept_folds(model):
    """Folds and packs of one cast_for_inference: one per kept module."""
    return dict(dw_se_fold=sum(1 for b in model.modules()
                               if isinstance(b, DepthwiseSE) and b.fuse_dwse),
                winograd_u_fold=2, xattn_pack=1)


def check_counts(what, got, want):
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        fail(f"{what}: launches (counted, derived) {bad}")


def cli_latency(state):
    """cli.test.measure with K1-K4 at [1, 30] frames, chunk 30: exact
    launches per call; then cli.test.main at its defaults (plain modules,
    no launch)."""
    cfg = ModelConfig().replace(**CLI_FLAGS)
    model = build_detector(cfg, device="cuda")
    model.load_state_dict(state, strict=True)
    want = per_chunk(model, "dynamic")
    folds = kept_folds(model)
    extension.reset_launches()
    r = cli_test.measure(model, cfg, mode="dynamic", batch=1, frames=30, frame_chunk=30,
                         runs=40, warmup=5, device="cuda")
    n = dict(extension.LAUNCHES)
    check_counts("cli.test.measure", n, {**{k: v * r["calls"] for k, v in want.items()},
                                         **folds})
    check_counts("cli.test.measure, timed chains", r["chain_launches"],
                 {**{k: v * r["chain_calls"] for k, v in want.items()},
                  **{k: 0 for k in FOLDS}})
    if not (np.isfinite(r["per_call_ms"]) and r["per_call_ms"] > 0):
        fail(f"cli.test.measure: per-call time {r['per_call_ms']}")
    print(f"[clis] cli.test.measure, dynamic, K1-K4, [1, 30] frames, chunk 30: "
          f"{r['per_call_ms']:.3f} ms per call, {r['frames_per_s']:.1f} frames/s, first call "
          f"{r['first_call_s']:.3f} s; {r['calls']} calls, launches {want} per call as "
          f"derived, folds {folds} at the cast only")
    del model
    torch.cuda.empty_cache()
    extension.reset_launches()
    plain = cli_test.main([])
    if any(extension.LAUNCHES.values()):
        fail(f"cli.test.main at its defaults launched {extension.LAUNCHES}")
    print(f"[clis] cli.test.main (defaults: plain modules, no launch): "
          f"{plain['per_call_ms']:.3f} ms per call, {plain['frames_per_s']:.1f} frames/s")
    return dict(kernels=r, plain=plain, launches=n)


def cli_throughput():
    """cli.bench.measure per mode with K1-K4, 2 to 3 pairs: exact launches
    per call, no K4 in the sfe modes, no fold or pack inside the timed
    chains."""
    cfg = ModelConfig().replace(**CLI_FLAGS)
    shapes = build_detector(cfg, device="cuda")
    chunks = -(-cli_bench.FRAMES // cli_bench.FRAME_CHUNK)
    out, launches = {}, {}
    for mode in ABLATION_MODES:
        want = {k: v * chunks for k, v in per_chunk(shapes, mode).items()}
        extension.reset_launches()
        r = cli_bench.measure(cfg, mode, init_pairs=2, max_pairs=3, device="cuda")
        n = launches[mode] = dict(extension.LAUNCHES)
        if "error" in r or not (np.isfinite(r["value"]) and r["value"] > 0):
            fail(f"cli.bench.measure {mode}: {r}")
        check_counts(f"cli.bench.measure {mode}", n,
                     {**{k: v * r["calls"] for k, v in want.items()}, **kept_folds(shapes)})
        check_counts(f"cli.bench.measure {mode}, timed chains", r["chain_launches"],
                     {**{k: v * r["chain_calls"] for k, v in want.items()},
                      **{k: 0 for k in FOLDS}})
        out[mode] = r
        print(f"[clis] cli.bench {mode}, K1-K4: "
              f"{json.dumps({k: r[k] for k in cli_bench.KEYS})}; {r['calls']} calls, "
              f"launches {want} per call as derived, no fold in the timed chains")
    del shapes
    torch.cuda.empty_cache()
    return out, launches


def cli_gflops():
    counted = cli_calculate_gflops.main(["--device", "cuda"])
    for mode in ABLATION_MODES:
        if not counted[mode]["flops"] > 0 or not counted[mode]["bytes"] > 0:
            fail(f"cli.calculate_gflops {mode}: {counted[mode]}")
    return counted


def cli_ablation_run(root, out, plots):
    """--tiny, 1 epoch, on the synthetic FF++ tree; each mode's
    best_model.pth loads through checkpoint.load_model."""
    argv = ["--root", root, "--output", out, "--tiny", "--epochs", "1", "--batch-size", "2",
            "--frame-count", "8"]
    if plots:
        results, out_dir = cli_ablation.main(argv)
    else:
        results, _, _, out_dir = cli_ablation.run_ablation(cli_ablation.parse_args(argv))
        print("[clis] ablation: plots not drawn (no matplotlib)")
    if list(results) != cli_ablation.MODES:
        fail(f"ablation results {list(results)}")
    for mode in cli_ablation.MODES:
        load_model(os.path.join(out_dir, f"{mode}_model", "best_model.pth"),
                   ModelConfig.tiny(), device="cuda")
    with open(os.path.join(out_dir, "metrics_comparison.csv")) as f:
        rows = f.read().splitlines()
    print(f"[clis] ablation --tiny, 1 epoch: the three best_model.pth load; "
          f"metrics_comparison.csv {rows}")


def cli_roc_run(cdf, pth, out, plots):
    """Video-level and --per-frame scores of the .pth at full width; per
    frame gives videos x frames scores."""
    for per_frame in (False, True):
        argv = ["--root", cdf, "--model-paths", f"smoke={pth}", "--output", out,
                "--test-list", "List_of_testing_videos.txt", "--batch-size", "2",
                "--frame-count", str(CLI_FRAMES)] + (["--per-frame"] if per_frame else [])
        curves = (cli_roc.main(argv) if plots
                  else cli_roc.roc_scores(cli_roc.parse_args(argv)))
        want = 2 * CLI_VIDEOS * (CLI_FRAMES if per_frame else 1)
        scores = curves[0][2]
        if len(scores) != want or not np.isfinite(scores).all():
            fail(f"plot_celebdf_roc (per_frame={per_frame}): {len(scores)} scores, "
                 f"expected {want}")
        print(f"[clis] plot_celebdf_roc {'--per-frame' if per_frame else 'video-level'}: "
              f"{len(scores)} scores as expected" + ("" if plots else ", plots not drawn"))


def cli_feature_maps(pth, image_path, out, plots):
    """collect() in fp32 with K1-K3 on the card against the same function on
    the CPU with the same weights (atol 1e-3), exact launches; then the CLI
    at its defaults when matplotlib is there."""
    cv2 = cv2_module()
    image = cv2.cvtColor(cv2.imread(image_path), cv2.COLOR_BGR2RGB)
    cfg = ModelConfig().replace(**CLI_FLAGS)
    model = load_model(pth, cfg, device="cuda")
    extension.reset_launches()
    got = cli_fm.collect(model, cfg, image)
    n = dict(extension.LAUNCHES)
    want = dict(per_chunk(model, "dynamic"), fused_bidirectional_cross_attention=0)
    want["haar_dwt2d"] *= 2                  # DAMA's MWT, then the MWT alone
    check_counts("visualize_feature_maps.collect", n, want)
    ref = cli_fm.collect(load_model(pth, cfg, device="cpu"), cfg, image)
    errs = {}
    for key in ("stem", "hf_level0", "gate_weights", "attention"):
        errs[key] = max_err(torch.from_numpy(got[key]), torch.from_numpy(ref[key]), 1e-3, 0.0,
                            f"feature maps {key}: card vs CPU")
    print(f"[clis] visualize_feature_maps.collect, fp32, K1-K3 on the card ({want}) vs the "
          f"CPU: max abs err {errs} (atol 1e-3); shapes "
          f"{ {k: list(v.shape) for k, v in got.items()} }")
    del model
    torch.cuda.empty_cache()
    if plots:
        cli_fm.main(["--image", image_path, "--model-path", pth, "--output", out])
        for f in ("backbone_stem.png", "mwt_hf_level0.png", "gate_weights.txt",
                  "cross_attention.png"):
            if not os.path.exists(os.path.join(out, f)):
                fail(f"visualize_feature_maps wrote no {f}")
    return errs, n


def phase_clis(state):
    """The measuring, ablation and visualisation entry points; returns their
    numbers and the launch counts of the kernel-flag runs."""
    t0 = time.perf_counter()
    plots = matplotlib_probe()
    latency = cli_latency(state)
    throughput, bench_launches = cli_throughput()
    gflops = cli_gflops()
    tmp = tempfile.mkdtemp(prefix="ewvit_clis_")
    try:
        ff, cdf = os.path.join(tmp, "ff"), os.path.join(tmp, "cdf")
        write_ff_tree(ff, pairs=dict(train=2, val=2, test=1), frames=8, height=80, width=96,
                      seed=1)
        cli_ablation_run(ff, os.path.join(tmp, "ablation"), plots)
        write_celebdf_tree(cdf, videos=CLI_VIDEOS, frames=CLI_FRAMES, height=256, width=320)
        pth = os.path.join(tmp, "detector.pth")
        torch.save({"model_state_dict": {f"module.{k}": v.cpu() for k, v in state.items()}},
                   pth)
        cli_roc_run(cdf, pth, os.path.join(tmp, "roc"), plots)
        image = os.path.join(cdf, "celebdf", "frames", "Celeb-real", "id0_000", "0000.png")
        fm_errs, fm_launches = cli_feature_maps(pth, image, os.path.join(tmp, "fm"), plots)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    print(f"[clis] phase wall time {wall:.1f} s")
    launches = {"test": latency["launches"], "feature_maps": fm_launches,
                **{f"bench_{m}": n for m, n in bench_launches.items()}}
    return dict(
        wall_s=wall, matplotlib=plots, gflops=gflops, feature_map_errs=fm_errs,
        launches=launches,
        test={k: latency["kernels"][k] for k in ("per_call_ms", "frames_per_s", "calls")},
        test_plain={k: latency["plain"][k] for k in ("per_call_ms", "frames_per_s")},
        bench={m: {k: r[k] for k in cli_bench.KEYS} for m, r in throughput.items()})


# ------------------------------------------------------------------ learn

LEARN_FRAMES, LEARN_BATCH = 8, 4       # the flagship recipe's --frame-count, --batch-size


def counting_evaluate(evaluate, passes):
    """``evaluation.evaluate`` that records each call's batches and launch
    counts (zeroed just before it)."""
    def run(model, loader, **kw):
        extension.reset_launches()
        out = evaluate(model, loader, **kw)
        torch.cuda.synchronize()
        passes.append(dict(batches=len(loader), launches=dict(extension.LAUNCHES)))
        return out
    return run


def check_learn_launches(cfg, model, counted, passes):
    """The train and val epochs as ``check_epochs`` derives them (no remat),
    and each pass of cli.eval: K1-K4 ``per_chunk`` times per batch. Returns
    the phase's launches per kernel."""
    epochs = check_epochs("learn", cfg, model, counted, frames=LEARN_FRAMES, batch=LEARN_BATCH,
                          chunk=cfg.frame_chunk, remat=False)
    each = per_chunk(model, "dynamic")
    chunks = -(-LEARN_FRAMES // min(cfg.frame_chunk, LEARN_FRAMES))
    for i, ev in enumerate(passes):
        want = {k: v * ev["batches"] * chunks for k, v in each.items()}
        want["fused_bidirectional_cross_attention_general"] = 0
        check_counts(f"learn, cli.eval pass {i + 1}", ev["launches"], want)
        epochs.append({k: want[k] for k in KERNELS})
    total = {k: sum(c[k] for c in epochs) for k in KERNELS}
    train = [ep for ep in counted.epochs if ep["kind"] == "train"]
    print(f"[learn] launches and folds as derived: a train epoch {epochs[0]} (updates of "
          f"{train[0]['micro']} micro-batches), a val epoch of "
          f"{len(counted.epochs[1]['result'].metrics['labels'])} clips {epochs[1]}, "
          f"cli.eval's {len(passes)} passes of {[ev['batches'] for ev in passes]} batches; "
          f"the phase {total}")
    return total


def phase_learn():
    """The learning proof's flagship recipe through cli.train and cli.eval,
    with K1-K4 on; returns its numbers and launch counts."""
    from ewvit_tpu_torch import evaluation
    from ewvit_tpu_torch.cli.learning_proof import FACE_DETECTOR, prove

    cfg = ModelConfig().replace(**TRAIN_FLAGS)
    decode_route()
    tmp = tempfile.mkdtemp(prefix="ewvit_learn_")
    timer, passes, made = StepTimer(), [], []

    def count(init):
        """The Trainer that cli.train builds, with the fit phase's counters."""
        def run(trainer, *a, **kw):
            init(trainer, *a, **kw)
            made.append((trainer.model, Counted(trainer, timer), SaveTimer(trainer.ckpt)))
        return run

    t0 = time.perf_counter()
    try:
        with mock.patch.object(Trainer, "__init__", count(Trainer.__init__)), \
                mock.patch.object(train_loop, "train_step", timer), \
                mock.patch.object(evaluation, "evaluate",
                                  counting_evaluate(evaluation.evaluate, passes)):
            out = prove(tmp, flagship=True, model_cfg=cfg, device="cuda")
        wall = time.perf_counter() - t0
        tf = FrameTransform(resize=round(cfg.arch.image_size * 450 / 224),
                            crop=cfg.arch.image_size, aligner=FaceAligner(detector=FACE_DETECTOR))
        fixture = os.path.join(tmp, "fixture")
        ds = FaceForensicsDataset(fixture, split="val", frame_count=LEARN_FRAMES,
                                  transform=tf, seed=0)
        fps = decode_rate(BatchLoader(ds, LEARN_BATCH, num_workers=2, seed=0), LEARN_FRAMES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = out["record"]
    failed = [msg for msg, ok in out["checks"].items() if not ok]
    if failed or not rec["ok"]:
        fail(f"learning proof: {failed}; {rec}")
    (model, counted, saves), = made
    launches = check_learn_launches(cfg, model, counted, passes)
    train = [ep for ep in counted.epochs if ep["kind"] == "train"]
    val = [ep for ep in counted.epochs if ep["kind"] == "val"]
    step_ms = [b.elapsed_time(e) for _, b, e in timer.steps]
    measured = dict(
        first_loss=rec["first_loss"], final_loss=rec["final_loss"],
        best_val_auc=rec["best_val_auc"], test_auc=rec["test_auc"], test_acc=rec["test_acc"],
        epochs=rec["epochs"], wall_s=wall, seconds=out["seconds"],
        s_per_epoch=out["seconds"]["train"] / rec["epochs"],
        train_epoch_s=[ep["seconds"] for ep in train], val_epoch_s=[ep["seconds"] for ep in val],
        updates=len(step_ms), ms_per_update=float(np.mean(step_ms)),
        ms_per_update_min_max=[min(step_ms), max(step_ms)],
        decode_frames_per_s=fps, save_blocked_s=saves.seconds,
        losses=[h["train"]["loss"] for h in out["history"]],
        val_auc=[h["val"]["auc"] for h in out["history"]], launches=launches)
    print(f"[learn] flagship proof with K1-K4: loss {rec['first_loss']:.4f} -> "
          f"{rec['final_loss']:.4f}, best val AUC {rec['best_val_auc']:.4f}, test AUC "
          f"{rec['test_auc']:.4f}, test ACC {rec['test_acc']:.4f}; phase {wall:.1f} s "
          f"(fixture {out['seconds']['fixture']:.1f}, train {out['seconds']['train']:.1f}, "
          f"eval {out['seconds']['eval']:.1f}), {measured['s_per_epoch']:.2f} s per epoch, "
          f"{measured['ms_per_update']:.1f} ms per update ({len(step_ms)} updates), host "
          f"decode {fps:.1f} frames/s (the val split, cv2, face detector "
          f"{FACE_DETECTOR!r}, 2 threads), blocked per checkpoint "
          f"{[round(v, 3) for v in saves.seconds]} s")
    return measured


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    walls, mark = {}, [t0]

    def lap(name):
        now = time.perf_counter()
        walls[name], mark[0] = round(now - mark[0], 1), now

    dev = phase_device()
    phase_build()
    lap("build")
    report = phase_kernels(dev)
    lap("kernels")
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 256, (2, 40, 224, 224, 3), dtype=np.uint8)
                for _ in range(3)]
    state = random_detector(PATHS["three_flags"][0], device="cuda", seed=0).state_dict()
    served = phase_serve(requests, state)
    lap("serve")
    evaluated = phase_checkpoint(requests, state, served)
    lap("checkpoint")
    train_clips = rng.integers(0, 256, (4, 40, 224, 224, 3), dtype=np.uint8)
    trained = phase_train(state, ModelConfig().replace(**TRAIN_FLAGS), train_clips)
    print(f"[train] {json.dumps(trained)}")
    lap("train")
    tmp = tempfile.mkdtemp(prefix="ewvit_fit_")
    try:
        fitted = phase_fit(state, ModelConfig().replace(**TRAIN_FLAGS), trained["ms_per_step"],
                           tmp)
        print(f"[fit] {json.dumps(fitted)}")
        lap("fit")
        dp, dp_launches = phase_dp(state, requests, served, evaluated, train_clips,
                                   os.path.join(tmp, "data"), tmp)
        print(f"[dp] {json.dumps(dp)}")
        lap("dp")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    clis = phase_clis(state)
    print(f"[clis] {json.dumps(clis)}")
    lap("clis")
    learned = phase_learn()
    print(f"[learn] {json.dumps(learned)}")
    lap("learn")
    launches = {name: run["launches"] for name, run in served.items()}
    for r in report:
        r["launches_by_path"] = {p: n[r["name"]] for p, n in launches.items()}
        r["train_launches_per_step"] = trained["launches_per_step"][r["name"]]
        if r["name"] != "conv3x3_winograd":   # K5: the kernels phase's count
            r["launches"] = launches["fused_mwt_tail"][r["name"]]
        r["clis_launches"] = {p: n[r["name"]] for p, n in clis["launches"].items()}
        r["dp_launches"] = {p: n[r["name"]] for p, n in dp_launches.items()}
        r["learn_launches"] = learned["launches"].get(r["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "train_launches_per_step", "clis_launches", "dp_launches", "learn_launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "cold_ms", "general_ms", "max_active_clusters")
    print(f"[done] {time.perf_counter() - t0:.1f} s; wall s per phase {walls}")
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys} for r in report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
