"""Inference latency harness on one GPU: ``python -m ewvit_tpu_torch.cli.test``.

The flags and report of the JAX package's ``test.py`` (the reference's
test.py:16-28, :30-113): load weights (``--weights PATH`` reads a ``.pth``
through ``checkpoint.load_model``; ``none`` keeps the seeded random
weights of ``build_detector``), count parameters, cast the weights for
inference (``serving.cast_for_inference``), and time the eval
``video_forward`` on a random ``[B, K, 3, H, W]`` clip in the compute dtype,
printing ``Parameters:``, ``Average inference time:`` and ``Throughput:``.

Timing keeps the JAX harness's serial chain (:class:`SerialChain`): call
N+1's input depends on call N's output, the chain ends in one host pull,
and chains of two lengths give the per-call time as the slope, so the fixed
cost of the pull drops out. A call costs the larger of its device time and
its host time (kernel launches are queued asynchronously). ``--profile DIR``
writes a ``torch.profiler`` Chrome trace of 5 calls to ``DIR/trace.json``.

:func:`measure` is the harness as a function; it runs whatever kernels the
model's config turns on (the CLI's ``ModelConfig`` keeps them off, as the
JAX CLI's does). ``--device`` (default ``cuda``) is the port's own;
``--s2d-stem`` is accepted and ignored (the port has one stem).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Benchmark DeepfakeDetector inference time (GPU)")
    p.add_argument("--weights", type=str, default="none",
                   help="Checkpoint path (.pth/.pt), or 'none' for seeded random weights")
    p.add_argument("--batch-size", "--bs", type=int, default=1)
    p.add_argument("--frame-count", "--fc", type=int, default=30)
    p.add_argument("--dim", "--d", type=int, default=128)
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--mode", type=str, default="dynamic",
                   choices=["dynamic", "sfe_only", "sfe_mwt"])
    p.add_argument("--frame-chunk", type=int, default=30)
    p.add_argument("--pos-mode", type=str, default="reference",
                   choices=["reference", "tile"],
                   help="'tile' lifts the flattened<=emb_dim cap (row i %% emb_dim)")
    p.add_argument("--s2d-stem", action="store_true",
                   help="accepted for the JAX CLI's sake; the port has one stem")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of 5 runs to DIR/trace.json")
    p.add_argument("--tiny", action="store_true",
                   help="ModelConfig.tiny() (64px): smoke runs only")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


class SerialChain:
    """``chain(n)``: n serially dependent calls of ``forward`` and one host
    pull; returns the seconds from the first call to the end of the pull.
    Call N+1 gets ``clip + acc`` where ``acc`` sums call N's output (times
    1e-9, so the values stay those of ``clip``). ``calls`` counts the
    forwards made."""

    def __init__(self, forward: Callable[[torch.Tensor], torch.Tensor], clip: torch.Tensor):
        self.forward, self.clip, self.calls = forward, clip, 0

    def __call__(self, n: int) -> float:
        if self.clip.is_cuda:
            torch.cuda.synchronize(self.clip.device)
        acc = torch.zeros((), dtype=torch.float32, device=self.clip.device)
        t0 = time.perf_counter()
        for _ in range(n):
            out = self.forward(self.clip + acc.to(self.clip.dtype))
            acc = acc + out.float().sum() * 1e-9
        float(acc)                                  # the one host pull
        self.calls += n
        return time.perf_counter() - t0


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Kernel launches and weight folds counted since ``before``."""
    from ewvit_tpu_torch.ops import extension

    return {k: v - before.get(k, 0) for k, v in extension.LAUNCHES.items()}


def measure(model, cfg, *, mode: str = "dynamic", batch: int = 1, frames: int = 30,
            frame_chunk: int = 30, runs: int = 100, warmup: int = 10, device="cuda",
            profile: Optional[str] = None) -> Dict:
    """Per-call latency of the eval ``video_forward`` of ``model`` (built for
    ``cfg``) on a seeded random ``[batch, frames, 3, S, S]`` clip.

    Returns ``first_call_s`` (kernel builds included), ``per_call_ms``,
    ``frames_per_s``, ``calls`` (every forward made, warmup and profile
    included) and ``chain_calls`` /
    ``chain_launches``: the calls of the timed chains and the kernel
    launches and weight folds counted during them."""
    from ewvit_tpu_torch.device import compute_dtype, resolve_device
    from ewvit_tpu_torch.models.detector import video_forward
    from ewvit_tpu_torch.ops import extension
    from ewvit_tpu_torch.serving import cast_for_inference

    dev = resolve_device(device)
    dtype = compute_dtype(cfg.compute_dtype)
    model = cast_for_inference(model.to(dev).eval(), dtype)
    size = cfg.arch.image_size
    g = torch.Generator(device=dev).manual_seed(0)
    clip = torch.randn((batch, frames, cfg.in_channels, size, size), generator=g,
                       device=dev).to(dtype)
    chunk = min(frame_chunk, frames)
    chain = SerialChain(lambda x: video_forward(model, x, mode=mode,
                                                frame_chunk=chunk)["logits"], clip)

    first_s = chain(1)
    if profile:
        os.makedirs(profile, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            chain(5)
        prof.export_chrome_trace(os.path.join(profile, "trace.json"))
    chain(1)
    for _ in range(max(1, warmup // 5)):
        chain(2)
    n_short = max(2, runs // 10)
    n_long = max(runs, n_short + 1)
    before, calls_before = dict(extension.LAUNCHES), chain.calls
    t_short = min(chain(n_short) for _ in range(2))
    t_long = min(chain(n_long) for _ in range(2))
    per_call = (t_long - t_short) / (n_long - n_short)
    return dict(first_call_s=first_s, per_call_ms=per_call * 1e3,
                frames_per_s=batch * frames / per_call, calls=chain.calls, chain_calls=chain.calls - calls_before,
                chain_launches=launches_since(before))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    from ewvit_tpu_torch.checkpoint import load_model
    from ewvit_tpu_torch.configs import ModelConfig
    from ewvit_tpu_torch.device import resolve_device
    from ewvit_tpu_torch.models.detector import build_detector

    dev = resolve_device(args.device)
    if args.tiny:
        cfg = ModelConfig.tiny().replace(pos_mode=args.pos_mode)
    else:
        cfg = ModelConfig(dama_dim=args.dim, frame_chunk=args.frame_chunk,
                          pos_mode=args.pos_mode)
    if args.weights in ("none", ""):
        model = build_detector(cfg, device=dev, seed=0)
    else:
        model = load_model(args.weights, cfg, device=dev)
    print(f"Parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    print(f"Device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    size = cfg.arch.image_size
    chunk = min(args.frame_chunk, args.frame_count)
    n_chunks = -(-args.frame_count // chunk)
    if n_chunks * chunk != args.frame_count:
        print(f"Note: frame_count={args.frame_count} runs in {n_chunks} chunks of {chunk} "
              f"(last one padded): compute is proportional to {n_chunks * chunk} frames; "
              f"pick --frame-chunk dividing frame_count for peak throughput")
    r = measure(model, cfg, mode=args.mode, batch=args.batch_size, frames=args.frame_count,
                frame_chunk=args.frame_chunk, runs=args.runs, warmup=args.warmup,
                device=dev, profile=args.profile)
    print(f"First run (kernel builds included): {r['first_call_s']:.1f}s")
    if args.profile:
        print(f"Profiler trace written to {os.path.join(args.profile, 'trace.json')}")
    print(f"Average inference time: {r['per_call_ms']:.2f} ms "
          f"({args.batch_size}x{args.frame_count} frames @ {size}px)")
    print(f"Throughput: {r['frames_per_s']:.1f} frames/sec")
    return r


if __name__ == "__main__":
    main()
