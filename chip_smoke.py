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
              MWT's two stride-1 conv shapes), in float32 (TF32 off) and
              bfloat16, and times kernel, plain version and, where one
              exists, a single PyTorch call computing the same function, with
              CUDA events;
4. serve   -- builds the full-width dynamic detector (ModelConfig(): 224 px,
              V2-S, dama_dim 128, 4 heads, 3 levels) with seeded random
              weights and serves it on two paths: the three kernel flags on
              (K1, K2, K4), and all four (use_fused_mwt_tail adds K3). For
              each path it zeroes the launch counters, serves requests of
              uint8 clips [2, 40, 224, 224, 3] through InferenceEngine.predict
              and predict_stream (frame_chunk 32: one full chunk and one
              masked tail, 64 flattened rows), reads the counters, checks the
              probabilities, and holds the outputs against the same weights
              served on the plain (direct-conv) modules in fp32;
5. report  -- one JSON line describing every kernel, then the final line
              {"ok": true, "device": {...}}.

Without a CUDA device, or run outside the repository, it exits nonzero and
prints no result. It imports nothing of JAX or of the ewvit_tpu package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ewvit_tpu_torch import InferenceEngine, ModelConfig, build_detector, video_forward
from ewvit_tpu_torch.models.detector import random_detector
from ewvit_tpu_torch.device import resolve_device
from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops.dw_se import dw_bn_silu_mean, dw_bn_silu_mean_plain
from ewvit_tpu_torch.ops.fused_attention import (
    fused_bidirectional_cross_attention,
    fused_cross_attention_plain,
)
from ewvit_tpu_torch.ops.haar import haar_dwt2d, haar_dwt2d_plain
from ewvit_tpu_torch.ops.mwt_tail import (
    fused_multiscale_winograd,
    fused_multiscale_winograd_plain,
    multiscale_winograd_u,
)
from ewvit_tpu_torch.ops.preprocess import preprocess_batch
from ewvit_tpu_torch.ops.winograd import conv3x3_winograd, conv3x3_winograd_plain

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
BF16_MMA_OPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
F32_TOL = dict(atol=1e-5, rtol=1e-5)      # fp32: summation order only
# fp32 Winograd (K3, K5) against its plain version: the same products summed
# in another order over 384 or 54 input channels and 16 transform positions
WINO_F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-2, rtol=1.6e-2)   # one bf16 rounding of the output
# End to end, (features, logits) as (atol, rtol): video-mean features
# 'fused'/'space'/'freq' [B, 128] and logits [B, 1] of the same weights.
OUT_TOL_F32 = ((1e-3, 1e-3), (1e-3, 0.0))     # fp32 kernels vs fp32 plain modules
# bf16 vs fp32 is a sanity check: ~60 layers of bf16 rounding drift the
# features by a few per cent of their range (0.08 of ~2.8 measured on H100).
OUT_TOL_BF16 = ((0.2, 5e-2), (2e-2, 0.0))     # bf16 serving vs fp32 plain modules
N_ROWS = 64                                # B * chunk on the main path
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {stem}: {line.strip()}")


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

    # K2: depthwise+BN+SiLU+SE mean; (channels, side, launches per chunk)
    errs, tm = [], Timings()
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        mtol = F32_TOL if dtype == torch.float32 else dict(atol=1e-3, rtol=1e-3)
        for c, side, count in ((512, 14, 5), (768, 14, 1), (960, 14, 8), (1536, 7, 14)):
            x = torch.randn(N_ROWS, c, side, side, device=dev, generator=g).to(dtype)
            w_eff = 0.2 * torch.randn(9, c, device=dev, generator=g)
            shift = 0.1 * torch.randn(c, device=dev, generator=g)
            y, m = dw_bn_silu_mean(x, w_eff, shift, 3)
            y_p, m_p = dw_bn_silu_mean_plain(x, w_eff, shift, 3)
            what = f"dw_bn_silu_mean {tuple(x.shape)} {dtype}"
            errs.append(max(max_err(y, y_p, what=what + " y", **tol),
                            max_err(m, m_p, what=what + " mean", **mtol)))
            print(f"[kernels] {what} x{count}/chunk: max abs err {errs[-1]:.3e} "
                  f"(tol y {tol}, mean {mtol})")
            if dtype == torch.bfloat16:
                tm.add(count, lambda: dw_bn_silu_mean(x, w_eff, shift, 3),
                       lambda: dw_bn_silu_mean_plain(x, w_eff, shift, 3),
                       nb=nbytes(x, y, w_eff, shift, m), ops=x.numel() * (2 * 9 + 6))
    report.append(tm.entry(
        name="dw_bn_silu_mean", route="cuda", source="ewvit_tpu_torch/csrc/dw_se.cu",
        replaces="ewvit_tpu/ops/dw_se.py:52", max_abs_err=max(errs)))

    # K4: fused bidirectional cross-attention, 1 launch per chunk
    d, heads, depth = 128, 4, 2
    mats = torch.randn(2 * depth, d, 4 * d, device=dev, generator=g) / d ** 0.5
    smalls = torch.stack([1 + 0.1 * torch.randn(2 * depth, d, device=dev, generator=g),
                          0.1 * torch.randn(2 * depth, d, device=dev, generator=g),
                          0.1 * torch.randn(2 * depth, d, device=dev, generator=g)], dim=1)
    errs, tm = [], Timings()
    for dtype, tol in ((torch.float32, dict(atol=1e-4, rtol=1e-4)), (torch.bfloat16, BF16_TOL)):
        s = torch.randn(N_ROWS, d, device=dev, generator=g).to(dtype)
        f = torch.randn(N_ROWS, d, device=dev, generator=g).to(dtype)
        so, fo = fused_bidirectional_cross_attention(s, f, mats, smalls, heads=heads)
        so_p, fo_p = fused_cross_attention_plain(s, f, mats, smalls, heads)
        what = f"fused_bidirectional_cross_attention {tuple(s.shape)} {dtype}"
        errs.append(max(max_err(so, so_p, what=what + " space", **tol),
                        max_err(fo, fo_p, what=what + " freq", **tol)))
        print(f"[kernels] {what}: max abs err {errs[-1]:.3e} (tol {tol})")
    # 2*depth blocks, each 2*N*D*(D + 2D + 2D + D) flops of projections
    tm.add(1, lambda: fused_bidirectional_cross_attention(s, f, mats, smalls, heads=heads),
           lambda: fused_cross_attention_plain(s, f, mats, smalls, heads),
           nb=nbytes(s, f, so, fo, mats, smalls),
           ops=2 * depth * 2 * N_ROWS * d * 6 * d)
    report.append(tm.entry(
        name="fused_bidirectional_cross_attention", route="cuda",
        source="ewvit_tpu_torch/csrc/fused_attention.cu",
        replaces="ewvit_tpu/ops/fused_attention.py:142", max_abs_err=max(errs)))

    report += winograd_kernels(dev, g)
    report[-1]["launches"] = extension.LAUNCHES["conv3x3_winograd"]

    for r in report:
        print(f"[kernels] {r['name']} per chunk (bf16, device ms / wall ms): kernel "
              f"{r['ms']:.4f} / {r['wall_ms']:.4f}, plain {r['plain_ms']:.4f} / "
              f"{r['plain_wall_ms']:.4f}, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
    return report


def winograd_kernels(dev, g):
    """K3 at the MWT's full-width multiscale_fusion (3 levels [64, 128, 112,
    112] -> 128), 1 launch per chunk; K5 at the MWT's two stride-1 conv
    shapes (hf_fusion 54 -> 128, multiscale_fusion 384 -> 128), one call
    each. Bounds use the bf16 tensor-core peak: the work is matrix products
    the tensor cores can do. Operations count the 16 transform-domain
    products only (2*16*tiles*Cin*Cout)."""
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
        errs.append(max_err(out, ref, what=what, **tol))
        print(f"[kernels] {what}: max abs err {errs[-1]:.3e} (tol {tol}; |ref| max "
              f"{ref.float().abs().max().item():.3e})")
        if dtype == torch.bfloat16:
            cat = torch.cat(ys, dim=1)
            w_fold = (wd.float() * scale[:, None, None, None]).to(dtype)
            b_lib = bias.to(dtype)
            # library yardstick: one cuDNN conv on the concatenated levels,
            # folded weight and bias; it leaves out the ReLU
            tm.add(1, lambda: fused_multiscale_winograd(ys, u, bias),
                   lambda: fused_multiscale_winograd_plain(ys, u, bias),
                   lambda: F.conv2d(cat, w_fold, b_lib, padding=1),
                   nb=nbytes(*ys, out, u, bias), ops=2 * 16 * levels * tiles * c * c)
            del cat
        del ys, out, ref
    report.append(tm.entry(
        name="fused_multiscale_winograd", route="cuda",
        source="ewvit_tpu_torch/csrc/winograd.cu",
        replaces="ewvit_tpu/ops/mwt_tail.py:108", max_abs_err=max(errs)))

    errs, tm = [], Timings(BF16_MMA_OPS_PER_S)
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
                before = dict(tm.t)
                tm.add(1, lambda: conv3x3_winograd(x, wd),
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


def haar_bank(c, dtype, dev):
    """[4C, 1, 2, 2] filters: one grouped stride-2 conv gives LL, LH, HL, HH
    per channel (library yardstick for K1; channel order c*4 + band)."""
    b = torch.tensor([[[1, 1], [1, 1]], [[1, 1], [-1, -1]],
                      [[1, -1], [1, -1]], [[1, -1], [-1, 1]]], dtype=torch.float32) * 0.5
    return b[:, None].repeat(c, 1, 1, 1).to(dev, dtype)


def serve(cfg, state, requests, *, count):
    """Serve ``requests`` on a fresh engine holding ``state``; with ``count``
    the launch counters are zeroed after warmup and read after the run.
    Returns probabilities (predict and predict_stream), per-request latency,
    stream time, the launch counts, and the video-level outputs of
    ``video_forward`` (taken after the counts are read)."""
    model = build_detector(cfg, device="cuda")
    model.load_state_dict(state, strict=True)
    engine = InferenceEngine(model, frame_chunk=32, device="cuda")
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
    outs = [video_forward(engine.model,
                          preprocess_batch(torch.from_numpy(c).cuda(), engine.dtype),
                          frame_chunk=32) for c in requests]
    outputs = {k: torch.cat([o[k].float().cpu() for o in outs]) for k in outs[0]}
    del engine, model
    torch.cuda.empty_cache()
    return dict(probs=probs, streamed=streamed, lat=lat, stream_ms=stream_ms,
                launches=launches, outputs=outputs)


def check_probs(served):
    for p, q in zip(served["probs"], served["streamed"]):
        if p.shape != (2,) or not np.isfinite(p).all() or not ((p > 0) & (p < 1)).all():
            fail(f"bad probabilities {p}")
        if np.abs(p - q).max() > 1e-6:
            fail(f"predict_stream {q} differs from predict {p}")


def phase_serve():
    """Serve both paths in bf16 with launch counts, then hold them, and their
    fp32 twins, against the fp32 plain (direct-conv) modules. Returns the
    launch counts of each path."""
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 256, (2, 40, 224, 224, 3), dtype=np.uint8)
                for _ in range(3)]
    flags = dict(use_pallas_dwt=True, use_pallas_dwse=True, use_pallas_dama=True)
    paths = {"three_flags": ModelConfig().replace(**flags),
             "fused_mwt_tail": ModelConfig().replace(use_fused_mwt_tail=True, **flags)}
    for cfg in paths.values():
        if cfg.compute_dtype != "bfloat16" or cfg.arch.image_size != 224:
            fail(f"unexpected serving config {cfg}")
    state = random_detector(paths["three_flags"], device="cuda", seed=0).state_dict()
    # K3 launches once per chunk: predict and predict_stream each serve every
    # request, in ceil(K / frame_chunk) chunks
    chunks = 2 * len(requests) * -(-requests[0].shape[1] // 32)
    must_launch = {"three_flags": ("haar_dwt2d", "dw_bn_silu_mean",
                                   "fused_bidirectional_cross_attention"),
                   "fused_mwt_tail": ("haar_dwt2d", "dw_bn_silu_mean",
                                      "fused_bidirectional_cross_attention",
                                      "fused_multiscale_winograd")}

    served, launches = {}, {}
    for name, cfg in paths.items():
        run = served[name] = serve(cfg, state, requests, count=True)
        launches[name] = run["launches"]
        print(f"[serve] {name} bf16: per-request latency ms "
              f"{[round(v, 3) for v in run['lat']]}, stream of {len(requests)} in "
              f"{run['stream_ms']:.3f} ms; launches {run['launches']}")
        # conv3x3_winograd (K5) is in no path: the JAX package wires it into
        # no model, so it is held to its plain version in phase_kernels only
        for k in must_launch[name]:
            if run["launches"][k] == 0:
                fail(f"kernel {k} was never launched on the {name} path")
        check_probs(run)
        print(f"[serve] {name} probabilities {[p.tolist() for p in run['probs']]}")
    n_k3 = launches["fused_mwt_tail"]["fused_multiscale_winograd"]
    if n_k3 != chunks:
        fail(f"fused_multiscale_winograd launched {n_k3} times for {chunks} chunks")
    if launches["three_flags"]["fused_multiscale_winograd"]:
        fail("fused_multiscale_winograd launched on the three-flag path")
    print("[serve] latency ms side by side (three_flags | fused_mwt_tail): " + ", ".join(
        f"{a:.3f} | {b:.3f}" for a, b in zip(served["three_flags"]["lat"],
                                             served["fused_mwt_tail"]["lat"])))
    print(f"[serve] stream of {len(requests)} ms (three_flags | fused_mwt_tail): "
          f"{served['three_flags']['stream_ms']:.3f} | "
          f"{served['fused_mwt_tail']['stream_ms']:.3f}")

    f32 = dict(compute_dtype="float32")
    p32 = serve(ModelConfig().replace(**f32), state, requests, count=False)
    print(f"[serve] logits: fp32 plain {p32['outputs']['logits'].flatten().tolist()}")
    for name, cfg in paths.items():
        k32 = serve(cfg.replace(**f32), state, requests, count=False)
        for what, run, tols in ((f"fp32 {name} vs fp32 plain path", k32, OUT_TOL_F32),
                                (f"bf16 {name} vs fp32 plain path", served[name],
                                 OUT_TOL_BF16)):
            for key, ref in p32["outputs"].items():
                atol, rtol = tols[key == "logits"]
                e = max_err(run["outputs"][key], ref, atol, rtol, f"{what}: {key}")
                print(f"[serve] {what}: {key} max abs diff {e:.3e} (|ref| max "
                      f"{ref.abs().max().item():.3e}; atol {atol}, rtol {rtol})")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    dev = phase_device()
    phase_build()
    report = phase_kernels(dev)
    launches = phase_serve()
    for r in report:
        r["launches_by_path"] = {p: n[r["name"]] for p, n in launches.items()}
        if r["name"] != "conv3x3_winograd":   # K5: the kernels phase's count
            r["launches"] = launches["fused_mwt_tail"][r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
