"""Ablation of the depthwise+SE kernel (K2, csrc/dw_se.cu) on the GPU.

    python3 -m ewvit_tpu_torch.dwse_ablation [--variants NAME ...]

Builds ``csrc/dw_se.cu`` once per variant (``EWVIT_NVCC_EXTRA``, a separate
library), in a process of its own, and times K2 per 64-row chunk of V2-S
(bf16, weights packed outside the timed calls: 5 x [64, 512, 14, 14],
1 x 768, 8 x 960 and 14 x [64, 1536, 7, 7], k3) with CUDA events, warm
(one input, read again and again) and cold (the calls cycle through copies
of the input, and keep their outputs, over more than 100 MB). Variants:

- ``served`` -- the kernel as it is served; this process also times other
  launch plans (ring stage bytes and depth) and the plain version;
- ``loads_only`` -- the loads and the pipeline, no compute, no y store
  (``EWVIT_DWSE_ABLATE=1``);
- ``loads_stores`` -- loads and stores, y = x, no taps (``=2``);
- ``no_silu`` -- the taps without SiLU (``=3``).

A variant that drops work computes a wrong result; only its time is read.
Prints the card, then per variant the ptxas lines of the main path's
instantiations (bf16, k3, 14 x 14 and 7 x 7 compiled in) and the times. Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

VARIANTS = {
    "served": "",
    "loads_only": "-DEWVIT_DWSE_ABLATE=1",
    "loads_stores": "-DEWVIT_DWSE_ABLATE=2",
    "no_silu": "-DEWVIT_DWSE_ABLATE=3",
}
# (channels, side, launches per chunk) of V2-S's stride-1 SE MBConvs
SHAPES = ((512, 14, 5), (768, 14, 1), (960, 14, 8), (1536, 7, 14))
# (stage bytes, stages) of the served process's other plans
PLANS = ((4096, 4), (16384, 4), (8192, 2), (8192, 6))
COLD_BYTES = 100 << 20


def _events_ms(fn, iters):
    """Device ms per call; a spin kernel holds the stream while the calls
    are queued, so the host's launch overhead does not show."""
    import torch
    for _ in range(3):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)     # ~50 ms at up to 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _chunk_ms(inputs, plan_kw=None, cold=False):
    """Per-chunk ms of K2 (sum over the shapes, times launches per chunk),
    and the ms per call of each shape."""
    from ewvit_tpu_torch.ops.dw_se import dw_bn_silu_mean_packed, dwse_plan
    total, each = 0.0, []
    for (c, side, count), (xs, packed) in zip(SHAPES, inputs):
        plan = None
        if plan_kw is not None:
            plan = dwse_plan(*xs[0].shape, 3, xs[0].element_size(), **plan_kw)
        copies = len(xs) if cold else 1
        outs, i = [None] * copies, [0]

        def call():
            outs[i[0] % copies] = dw_bn_silu_mean_packed(xs[i[0] % copies], packed, 3, plan)
            i[0] += 1

        for _ in range(copies):    # every output slot allocated before timing
            call()
        each.append(_events_ms(call, iters=max(20, 4 * copies)))
        total += count * each[-1]
    return total, each


def _one(name: str) -> dict:
    import torch

    from ewvit_tpu_torch.ops import extension
    from ewvit_tpu_torch.ops.dw_se import dw_bn_silu_mean_plain, pack_dwse, unpack_dwse

    log = extension.build_all(["dw_se"]).get("dw_se", "")
    ptxas, fn = "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line
        if ("registers" in line or "spill" in line) and re.search(
                r"bfloat16Li3ELi(14ELi14|7ELi7)E", fn):
            ptxas += line.strip() + "; "
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    inputs = []
    for c, side, _ in SHAPES:
        x = torch.randn(64, c, side, side, device="cuda", generator=g).to(torch.bfloat16)
        packed = pack_dwse(0.2 * torch.randn(9, c, device="cuda", generator=g),
                           0.1 * torch.randn(c, device="cuda", generator=g), 3)
        copies = -(-COLD_BYTES // (2 * x.numel() * x.element_size())) + 1
        inputs.append(([x] + [x.clone() for _ in range(copies - 1)], packed))
    def timed(kw=None):
        (warm, warm_each), (cold, cold_each) = (_chunk_ms(inputs, kw, c) for c in (0, 1))
        return dict(warm_ms=warm, cold_ms=cold, warm_each=warm_each, cold_each=cold_each)

    out = dict(variant=name, ptxas=ptxas, **timed())
    if name == "served":
        out["plans"] = {}
        for stage_bytes, stages in PLANS:
            kw = dict(sm_count=sms, stage_bytes=stage_bytes, stages=stages)
            out["plans"][f"{stage_bytes} B x {stages}"] = timed(kw)
        plain = 0.0
        for (c, side, count), (xs, packed) in zip(SHAPES, inputs):
            w_eff, shift = unpack_dwse(packed, 3)
            plain += count * _events_ms(lambda: dw_bn_silu_mean_plain(xs[0], w_eff, shift, 3),
                                        iters=5)
        out["plain_ms"] = plain
    return out


def _fmt(t):
    each = ", ".join(f"{w:.4f}/{c:.4f}" for w, c in zip(t["warm_each"], t["cold_each"]))
    return (f"warm {t['warm_ms']:.4f} ms, cold {t['cold_ms']:.4f} ms (per call, warm/cold, "
            f"C = {', '.join(str(s[0]) for s in SHAPES)}: {each})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(_one(args.one)))
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("dwse_ablation needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[ablation] {smi.stdout.strip()}")
    for name in args.variants:
        env = dict(os.environ, EWVIT_NVCC_EXTRA=VARIANTS[name])
        r = subprocess.run([sys.executable, "-m", "ewvit_tpu_torch.dwse_ablation",
                            "--one", name], env=env, capture_output=True, text=True)
        if r.returncode != 0:
            print(f"[ablation] {name}: failed (rc={r.returncode})\n{r.stderr[-2000:]}")
            continue
        res = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"[ablation] {name:15s} K2 per chunk: {_fmt(res)}; ptxas: {res['ptxas']}")
        for plan, t in res.get("plans", {}).items():
            print(f"[ablation]   plan {plan:14s}: {_fmt(t)}")
        if "plain_ms" in res:
            print(f"[ablation]   plain version: {res['plain_ms']:.4f} ms per chunk")


if __name__ == "__main__":
    main()
