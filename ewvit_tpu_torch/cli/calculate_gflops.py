"""Parameters and FLOPs per ablation mode: ``python -m ewvit_tpu_torch.cli.calculate_gflops``.

The JAX package's ``calculate_gflops.py`` (the reference's
utils/calculate_gflops.py:6-61) on the port. Per mode, one eval
``video_forward`` of a zero ``[batch, frames, 3, S, S]`` clip in the compute
dtype runs under two counters:

- FLOPs from ``torch.utils.flop_counter.FlopCounterMode``: 2 per
  multiply-add of every convolution, matrix product and linear layer;
- bytes: the sum of the input and output tensor bytes of every aten op that
  is not a view (:class:`ByteCounter`). Every op reads and writes memory
  here, so this is an **unfused upper bound** on memory traffic, not the
  post-fusion traffic that XLA's cost model gives the JAX CLI.

The hand-written kernels launch through ``ctypes``, outside the dispatcher,
so neither counter would see them: :func:`count` refuses a config with a
kernel flag on instead of undercounting, and the CLI counts on the plain
modules (the JAX CLI's flags are off too). ``--device`` (default ``cuda``) is
the port's own.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

MODES = ["dynamic", "sfe_only", "sfe_mwt"]
KERNEL_FLAGS = ("use_pallas_dwt", "use_pallas_dwse", "use_pallas_dama", "use_fused_mwt_tail")


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor an aten op reads or writes (views
    excepted: they move nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def count(model, cfg, mode: str, *, batch: int = 1, frames: int = 24,
          frame_chunk: int = 24) -> Tuple[int, int]:
    """(FLOPs, unfused bytes) of one eval ``video_forward`` of ``model``
    (built for ``cfg``, on its device) in ``mode``."""
    from torch.utils.flop_counter import FlopCounterMode

    from ewvit_tpu_torch.device import compute_dtype
    from ewvit_tpu_torch.models.detector import video_forward

    on = [f for f in KERNEL_FLAGS if getattr(cfg, f)]
    if on:
        raise ValueError(f"the FLOP and byte counters cannot see the CUDA kernels of {on}: "
                         "count on the plain modules (kernel flags off)")
    dev = next(model.parameters()).device
    size = cfg.arch.image_size
    clip = torch.zeros((batch, frames, cfg.in_channels, size, size),
                       dtype=compute_dtype(cfg.compute_dtype), device=dev)
    flops, nbytes = FlopCounterMode(display=False), ByteCounter()
    with torch.no_grad(), flops, nbytes:
        video_forward(model, clip, mode=mode, frame_chunk=min(frame_chunk, frames))
    return flops.get_total_flops(), nbytes.bytes


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Calculate GFLOPs for model ablations (GPU)")
    p.add_argument("--ablation", type=str, default="all", choices=MODES + ["all"])
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--frame-count", type=int, default=24)
    p.add_argument("--frame-chunk", type=int, default=24)
    p.add_argument("--tiny", action="store_true",
                   help="ModelConfig.tiny() (64px): smoke runs only")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Returns ``{"params": n, mode: {"flops": f, "bytes": b}, ...}``."""
    args = parse_args(argv)
    from ewvit_tpu_torch.configs import ModelConfig
    from ewvit_tpu_torch.device import compute_dtype, resolve_device
    from ewvit_tpu_torch.models.detector import build_detector
    from ewvit_tpu_torch.serving import cast_for_inference

    dev = resolve_device(args.device)
    cfg = ModelConfig.tiny() if args.tiny else ModelConfig(frame_chunk=args.frame_chunk)
    model = build_detector(cfg, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    model = cast_for_inference(model, compute_dtype(cfg.compute_dtype))
    size = cfg.arch.image_size
    print(f"Parameters: {n_params / 1e6:.2f}M "
          f"(input {args.batch_size}x{args.frame_count}x{size}x{size}x3)")
    out: Dict = {"params": n_params}
    for mode in MODES if args.ablation == "all" else [args.ablation]:
        flops, nbytes = count(model, cfg, mode, batch=args.batch_size,
                              frames=args.frame_count, frame_chunk=args.frame_chunk)
        out[mode] = {"flops": flops, "bytes": nbytes}
        print(f"  {mode:>9}: {flops / 1e9:.2f} GFLOPs, {nbytes / 1e9:.3f} GB of op inputs "
              f"and outputs (unfused upper bound, not post-fusion traffic) "
              f"({flops / max(nbytes, 1):.1f} FLOPs/byte)")
    return out


if __name__ == "__main__":
    main()
