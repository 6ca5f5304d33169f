"""Throughput headline on one GPU: ``python -m ewvit_tpu_torch.cli.bench``.

The JAX package's ``bench.py`` on the port: full-width ``ModelConfig()``
with seeded random weights cast for inference, a random bf16 clip of
``[BATCH, FRAMES, 3, 224, 224]`` run as the eval ``video_forward`` in
chunks of ``FRAME_CHUNK``, timed by serial chains (``cli.test.SerialChain``)
of ``N_SHORT`` and ``N_LONG`` calls collected in interleaved pairs; a pair
whose slope is not positive is discarded. The headline is the min-of-minima
slope with the median fallback (:func:`headline_estimate`), and the spread
is that of the three fastest per-pair slopes (:func:`fast_spread`). Prints
one JSON line with the JAX bench's keys.

No north star. The JAX bench's 5,000 frames/s line is a TPU v5e target, and
the port takes no TPU number as a target, so ``vs_baseline`` and
``verdict`` are ``null`` and the stop rule has no margin term
(:func:`should_collect_more`): at least ``INIT_PAIRS`` pairs, then more
until the spread is below ``SPREAD_TARGET`` or ``MAX_PAIRS`` were taken.

:func:`measure` is the bench as a function of the config, so callers can
turn the kernel flags on (the CLI keeps the JAX CLI's defaults, all off)
and take fewer pairs. ``--device`` (default ``cuda``) is the port's own.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BATCH = 2
FRAMES = 64        # 2 chunks a call
FRAME_CHUNK = 32   # flattened chunk = BATCH * FRAME_CHUNK = 64 == emb_dim cap
N_SHORT, N_LONG = 2, 12
INIT_PAIRS = 8     # interleaved (short, long) pairs before the stop rule is read
MAX_PAIRS = 32     # cap when the fast cluster does not settle
SPREAD_TARGET = 0.04
KEYS = ("metric", "mode", "value", "unit", "vs_baseline", "spread_pct", "pairs", "verdict",
        "estimator")


# --- measurement policy: pure functions, tested without a device ----------

def fast_spread(slopes: List[float]) -> float:
    """Relative spread of the 3 fastest per-pair slopes (1.0 until 2 exist)."""
    fast = sorted(slopes)[:3]
    return (fast[-1] - fast[0]) / fast[0] if len(fast) >= 2 else 1.0


def headline_estimate(shorts: List[float], longs: List[float], slopes: List[float],
                      dn: int) -> Tuple[float, str]:
    """Best per-call estimate and the estimator that gave it: min-of-minima,
    unless that lands >20% below the median per-pair slope (a deflated
    outlier), then the median."""
    per_call = (min(longs) - min(shorts)) / dn
    med = float(np.median(slopes))
    if per_call < 0.8 * med:
        return med, "median (min deflated)"
    return per_call, "min-of-minima"


def should_collect_more(attempts: int, slopes: List[float], *, init_pairs: int = INIT_PAIRS,
                        max_pairs: int = MAX_PAIRS) -> bool:
    """At least ``init_pairs`` attempts; then more until the fast cluster's
    spread is below ``SPREAD_TARGET``, at most ``max_pairs``."""
    if attempts < init_pairs:
        return True
    if attempts >= max_pairs:
        return False
    return fast_spread(slopes) >= SPREAD_TARGET


def error_result(mode: str, msg: str) -> Dict:
    return {"metric": "inference_throughput", "mode": mode, "value": 0.0,
            "unit": "frames/sec", "vs_baseline": None, "spread_pct": None, "pairs": 0,
            "verdict": None, "error": msg}


def measure(cfg, mode: str = "dynamic", *, init_pairs: int = INIT_PAIRS,
            max_pairs: int = MAX_PAIRS, device="cuda") -> Dict:
    """The headline dict (:data:`KEYS`) for ``cfg`` in ``mode``, plus
    ``calls`` (every forward made), ``chain_calls`` and ``chain_launches``
    (the forwards of the timed pairs and the kernel launches and weight
    folds counted during them) and ``discarded`` (pairs with a
    non-positive slope)."""
    import torch

    from ewvit_tpu_torch.cli.test import SerialChain, launches_since
    from ewvit_tpu_torch.device import compute_dtype, resolve_device
    from ewvit_tpu_torch.models.detector import build_detector, video_forward
    from ewvit_tpu_torch.ops import extension
    from ewvit_tpu_torch.serving import cast_for_inference

    dev = resolve_device(device)
    dtype = compute_dtype(cfg.compute_dtype)
    model = cast_for_inference(build_detector(cfg, device=dev, seed=0), dtype)
    size = cfg.arch.image_size
    g = torch.Generator(device=dev).manual_seed(1)
    base = torch.randn((BATCH, FRAMES, cfg.in_channels, size, size), generator=g,
                       device=dev).to(dtype)
    chain = SerialChain(lambda x: video_forward(model, x, mode=mode,
                                                frame_chunk=FRAME_CHUNK)["logits"], base)
    chain(1)          # kernel builds, first launches
    chain(N_SHORT)    # warm

    shorts, longs, slopes, discarded = [], [], [], 0
    before, calls_before = dict(extension.LAUNCHES), chain.calls
    attempts = 0
    while should_collect_more(attempts, slopes, init_pairs=init_pairs, max_pairs=max_pairs):
        t_s, t_l = chain(N_SHORT), chain(N_LONG)
        slope = (t_l - t_s) / (N_LONG - N_SHORT)
        attempts += 1
        if slope <= 0:
            print(f"# discarded pair with a non-positive slope (t_short={t_s:.3f}s "
                  f"t_long={t_l:.3f}s)", file=sys.stderr)
            discarded += 1
            continue
        shorts.append(t_s)
        longs.append(t_l)
        slopes.append(slope)
    counts = dict(calls=chain.calls, chain_calls=chain.calls - calls_before,
                  chain_launches=launches_since(before), discarded=discarded)
    if not slopes:
        return {**error_result(mode, "every timing pair had a non-positive slope"), **counts}
    per_call, estimator = headline_estimate(shorts, longs, slopes, N_LONG - N_SHORT)
    if per_call <= 0:
        return {**error_result(mode, "non-positive headline slope"), **counts}
    return {"metric": "inference_throughput", "mode": mode,
            "value": round(BATCH * FRAMES / per_call, 2), "unit": "frames/sec",
            "vs_baseline": None, "spread_pct": round(fast_spread(slopes) * 100, 2),
            "pairs": len(slopes), "verdict": None, "estimator": estimator, **counts}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Inference throughput headline (GPU)")
    ap.add_argument("--mode", default="dynamic", choices=["dynamic", "sfe_only", "sfe_mwt"])
    ap.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--tiny", action="store_true",
                    help="ModelConfig.tiny() (64px): smoke runs only")
    args = ap.parse_args(argv)

    import torch

    from ewvit_tpu_torch.configs import ModelConfig
    from ewvit_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    cfg = ModelConfig.tiny() if args.tiny else ModelConfig()
    print(f"# device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          file=sys.stderr)
    r = measure(cfg, args.mode, init_pairs=INIT_PAIRS, max_pairs=MAX_PAIRS, device=dev)
    print(json.dumps({k: r[k] for k in KEYS + ("error",) if k in r}))
    return 1 if "error" in r else 0


if __name__ == "__main__":
    sys.exit(main())
