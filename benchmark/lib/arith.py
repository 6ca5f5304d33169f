"""The yardstick's arithmetic: peaks, FLOPs a frame, kernels' work, rates.

- Peaks of one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s bf16 on the
  tensor cores, 67 TFLOP/s fp32 outside them, 3.35 TB/s of HBM.
- FLOPs a frame: ``FlopCounterMode`` over one eval forward of the
  benchmark's own reference (on the meta device: shapes only), so they are
  the same whatever implements the work: 2 per multiply-add of every
  convolution and matrix product.
- The work of a kernel's calls, from the shapes of the work: operations and
  bytes, each input read once and each output written once.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, ops: float, peak: float) -> float:
    """The least time for the work: bytes over the memory rate or
    operations over ``peak``, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def forward_flops(cfg: dict, mode: str, clips: int, frames: int, frame_chunk: int) -> int:
    """FLOPs of one eval forward of ``[clips, frames]`` through the reference."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import model as ref

    m = ref.build(cfg, "meta").eval()
    s = cfg["image_size"]
    x = torch.zeros(clips, frames, cfg["in_channels"], s, s, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        ref.eval_video_forward(m, x, mode, frame_chunk)
    return int(counter.get_total_flops())


def flops_per_frame(cfg: dict, mode: str, frame_chunk: int) -> float:
    """FLOPs of one frame's forward, from one chunk of one clip."""
    return forward_flops(cfg, mode, 1, frame_chunk, frame_chunk) / frame_chunk


# ------------------------------------------------------------ K2


def dwse_shapes(spec: dict, image_size: int) -> List[Tuple[int, int, int]]:
    """(channels, side, kernel) of every stride-1 squeeze-excite depthwise
    block of a backbone's block table (the blocks K2 serves), in order."""
    side = math.ceil(image_size / 2)           # the stride-2 stem
    out = []
    for repeats, kernel, stride, expand, cin0, cout, se, fused in spec["blocks"]:
        for r in range(repeats):
            cin, s = (cin0, stride) if r == 0 else (cout, 1)
            side = math.ceil(side / s)
            if not fused and se > 0 and s == 1:
                out.append((cin * expand, side, kernel))
    return out


def dwse_packed_width(kernel: int) -> int:
    return -(-(kernel * kernel + 1) // 4) * 4


def dwse_work(rows: int, channels: int, side: int, kernel: int, itemsize: int = 2
              ) -> Tuple[int, int]:
    """(bytes, operations) of one depthwise k x k + BN + SiLU + SE mean over
    ``[rows, channels, side, side]``: x read, y written in ``itemsize``
    bytes, the packed fp32 weights read, the fp32 means written; a
    multiply-add per tap, and 6 for the shift, SiLU and mean, per output."""
    n = rows * channels * side * side
    nbytes = 2 * n * itemsize + channels * dwse_packed_width(kernel) * 4 + rows * channels * 4
    return nbytes, n * (2 * kernel * kernel + 6)


# ------------------------------------------------------------ K3


def mwt_tail_work(rows: int, channels: int, side: int, levels: int, itemsize: int = 2
                  ) -> Tuple[int, int]:
    """(bytes, operations) of multiscale_fusion on ``levels`` maps of
    ``[rows, channels, side, side]``: the maps read, the output written, the
    transformed weights ``[levels, 16, C, C]`` and the fp32 bias read; the
    operations are the F(2x2, 3x3) Winograd products, 2 * 16 per 2x2 output
    tile per input and output channel: 2.25 times fewer than a direct
    convolution's, which an F(2x2, 3x3) kernel could exceed its bound by."""
    tiles = rows * (side // 2) * (side // 2)
    nbytes = ((levels + 1) * rows * channels * side * side * itemsize
              + levels * 16 * channels * channels * itemsize + channels * 4)
    return nbytes, 2 * 16 * levels * tiles * channels * channels


# ------------------------------------------------------------ shares


def share_pct(useful: float, spent: float) -> float:
    return 100.0 * useful / spent
