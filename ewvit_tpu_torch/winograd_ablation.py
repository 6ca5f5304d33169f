"""Ablation of the bf16 Winograd kernel (K3, csrc/winograd.cu) on the GPU.

    python3 -m ewvit_tpu_torch.winograd_ablation [--variants NAME ...]

Builds ``csrc/winograd.cu`` once per variant, each with its own switches
(``EWVIT_NVCC_EXTRA``, a separate library), in a process of its own, and
times K3 at the MWT's full-width shape (3 levels ``[64, 128, 112, 112]`` ->
128, bf16, U packed outside the timed calls) with CUDA events. Variants:

- ``served`` -- the kernel as it is served;
- ``no_mma`` -- without the wgmmas (``EWVIT_WINOGRAD_ABLATE_MMA``);
- ``no_transform`` -- without forming V (``EWVIT_WINOGRAD_ABLATE_TRANSFORM``);
- ``copies_only`` -- both off: the halo and U copies and the pipeline.

A variant that drops work computes a wrong result; only its time is read.
Prints, per variant, the ptxas line of the bf16 kernel and the device ms per
call, then the cuDNN conv on the concatenated levels as the yardstick. Needs
a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

VARIANTS = {
    "served": "",
    "no_mma": "-DEWVIT_WINOGRAD_ABLATE_MMA",
    "no_transform": "-DEWVIT_WINOGRAD_ABLATE_TRANSFORM",
    "copies_only": "-DEWVIT_WINOGRAD_ABLATE_MMA -DEWVIT_WINOGRAD_ABLATE_TRANSFORM",
}


def _events_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _one(name: str) -> dict:
    """Run in the variant's own process: build, time K3 (and, for the served
    build, the cuDNN yardstick)."""
    import torch
    import torch.nn.functional as F

    from ewvit_tpu_torch.ops import extension
    from ewvit_tpu_torch.ops.mwt_tail import (
        fused_multiscale_winograd_packed,
        multiscale_winograd_u,
        pack_tail,
    )

    log = extension.build_all(["winograd"]).get("winograd", "")
    ptxas, fn = "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line
        if "spill" in line and "3hop" in fn:
            ptxas = line.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    n, c, side, levels = 64, 128, 112, 3
    ys = [torch.randn(n, c, side, side, device="cuda", generator=g).to(torch.bfloat16)
          for _ in range(levels)]
    w = torch.randn(c, levels * c, 3, 3, device="cuda", generator=g) / (9 * levels * c) ** 0.5
    scale = 0.5 + torch.rand(c, device="cuda", generator=g)
    bias = 0.1 * torch.randn(c, device="cuda", generator=g)
    up, b32 = pack_tail(multiscale_winograd_u(w.to(torch.bfloat16), scale, levels,
                                              torch.bfloat16), bias)
    out = {"variant": name, "ptxas": ptxas,
           "k3_ms": _events_ms(lambda: fused_multiscale_winograd_packed(ys, up, b32))}
    if name == "served":
        cat = torch.cat(ys, dim=1)
        wf = (w * scale[:, None, None, None]).to(torch.bfloat16)
        bb = bias.to(torch.bfloat16)
        out["cudnn_ms"] = _events_ms(lambda: F.conv2d(cat, wf, bb, padding=1))
    return out


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
        raise SystemExit("winograd_ablation needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[ablation] {smi.stdout.strip()}")
    for name in args.variants:
        env = dict(os.environ, EWVIT_NVCC_EXTRA=VARIANTS[name])
        r = subprocess.run([sys.executable, "-m", "ewvit_tpu_torch.winograd_ablation",
                            "--one", name], env=env, capture_output=True, text=True)
        if r.returncode != 0:
            print(f"[ablation] {name}: failed (rc={r.returncode})\n{r.stderr[-2000:]}")
            continue
        res = json.loads(r.stdout.strip().splitlines()[-1])
        extra = f", cuDNN conv {res['cudnn_ms']:.4f} ms" if "cudnn_ms" in res else ""
        print(f"[ablation] {name:13s} K3 {res['k3_ms']:.4f} ms per call{extra}; "
              f"ptxas: {res['ptxas']}")


if __name__ == "__main__":
    main()
