"""Where a served request's time goes on the GPU.

    python3 -m ewvit_tpu_torch.serve_profile [--requests 3] [--trace PATH]
                                             [--fused-mwt-tail]

Builds the full-width dynamic detector (``ModelConfig()`` with the three
kernel flags on, bf16; ``--fused-mwt-tail`` adds ``use_fused_mwt_tail``, so
the MWT's multiscale_fusion runs as K3) with seeded, BN-calibrated random
weights
(``random_detector``), serves ``[2, 40, 224, 224, 3]`` uint8 requests and
prints:

- wall ms per request (host clock around ``predict``, which ends in a sync);
- per component of one 64-frame chunk, device ms from CUDA events: V2-S
  backbone, the rest of the SFE, MWT, cross-attention, gates;
- from ``torch.profiler`` over ``--requests`` requests: device busy ms (sum
  of kernel time on the one stream), the idle share of the wall time, and the
  top kernels by device time.

Needs a CUDA GPU; writes the Chrome trace to ``--trace`` when given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ewvit_tpu_torch.configs import ModelConfig
from ewvit_tpu_torch.models.detector import random_detector
from ewvit_tpu_torch.ops.preprocess import preprocess_batch
from ewvit_tpu_torch.serving import InferenceEngine


def _device_ms(fn, iters=5):
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


@torch.no_grad()
def components(engine: InferenceEngine, clips: np.ndarray) -> dict:
    """Device ms of each DAMA component on one full chunk of ``clips``."""
    m = engine.model.dama
    b, chunk = clips.shape[0], min(engine.frame_chunk, clips.shape[1])
    x = preprocess_batch(torch.from_numpy(clips[:, :chunk]).cuda(), engine.dtype)
    x = x.reshape(b * chunk, *x.shape[2:])
    space, freq = m.sfe(x), m.mwt(x)
    s_tok = space.flatten(2).transpose(1, 2)
    f_tok = freq.reshape(b * chunk, -1, 1).transpose(1, 2)
    s_out, f_out = m.cross_att(s_tok, f_tok)
    concat = torch.cat([s_out.transpose(1, 2)[..., None],
                        f_out.transpose(1, 2)[..., None]], dim=1)
    out = {
        "frames": b * chunk,
        "v2s_backbone": _device_ms(lambda: m.sfe.efficient_net(x)),
        "sfe_total": _device_ms(lambda: m.sfe(x)),
        "mwt": _device_ms(lambda: m.mwt(x)),
        "cross_att": _device_ms(lambda: m.cross_att(s_tok, f_tok)),
        "gates": _device_ms(lambda: (m.fusion_gate(concat), m.gate_net(concat))),
        "dama_total": _device_ms(lambda: m(x)),
    }
    out["sfe_after_backbone"] = out["sfe_total"] - out["v2s_backbone"]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    ap.add_argument("--fused-mwt-tail", action="store_true",
                    help="serve with use_fused_mwt_tail (K3) on")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("serve_profile needs a CUDA GPU")

    cfg = ModelConfig().replace(use_pallas_dwt=True, use_pallas_dwse=True,
                                use_pallas_dama=True,
                                use_fused_mwt_tail=args.fused_mwt_tail)
    engine = InferenceEngine(random_detector(cfg, device="cuda", seed=0),
                             frame_chunk=32, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, 256, (2, 40, 224, 224, 3), dtype=np.uint8)
            for _ in range(args.requests)]
    engine.warmup(2, 40)
    print(f"[profile] {torch.cuda.get_device_name(0)}; use_fused_mwt_tail="
          f"{cfg.use_fused_mwt_tail}")

    lat = []
    for clips in reqs:
        t = time.perf_counter()
        engine.predict(clips)
        lat.append((time.perf_counter() - t) * 1e3)
    print(f"[profile] wall ms per request: {[round(v, 3) for v in lat]}")
    print(f"[profile] device ms per chunk component: "
          f"{ {k: round(v, 3) for k, v in components(engine, reqs[0]).items()} }")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for clips in reqs:
            engine.predict(clips)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages()        # device-side events only
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_self_device_us(e) for e in events) / 1e3
    launches = sum(e.count for e in events if not e.key.startswith("Memcpy"))
    print(f"[profile] {len(reqs)} requests: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{launches / len(reqs):.0f} kernel launches per request")
    events.sort(key=_self_device_us, reverse=True)
    for e in events[:25]:
        print(f"[profile] {_self_device_us(e) / 1e3:10.3f} ms  {e.count:6d}x  {e.key[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"[profile] trace written to {args.trace}")


if __name__ == "__main__":
    main()
