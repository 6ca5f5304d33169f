"""k3_roofline.serve: the fused MWT tail (multiscale_fusion: 3x3 conv over
the concatenated levels, bias, eval BN, ReLU) against its roofline, in %.

The least time for the work of one served chunk (``lib/arith.mwt_tail_work``
at the chunk's rows, ``dama_dim`` channels, half the image side, every
level; bound by the larger of bytes over 3.35 TB/s and the F(2x2, 3x3)
products over 989 TFLOP/s bf16) over its device time: the op below called
alone on seeded bf16 maps of that shape, two sets of maps in turn (1.2 GB,
beyond the 50 MB L2), its weights folded and packed outside the timed
calls as the served module keeps them, every device kernel a call launches
summed from the profiler.
"""

import torch

from benchmark.lib import arith, layers, program
from benchmark.lib.common import derive

OP = "ewvit_tpu_torch.ops.mwt_tail:fused_multiscale_winograd_packed"
FOLD = "ewvit_tpu_torch.ops.mwt_tail:multiscale_winograd_u"
PACK = "ewvit_tpu_torch.ops.mwt_tail:pack_tail"
CALLS = 10


def read(run, drv):
    cfg, t = run.cfg, run.traffic
    if not run.on_card or not cfg["kernels"].get("use_fused_mwt_tail"):
        return None
    op, fold, pack = (program.function(p) for p in (OP, FOLD, PACK))
    rows, c, side, levels = (t["clips_per_batch"] * t["frame_chunk"], cfg["dama_dim"],
                             cfg["image_size"] // 2, cfg["levels"])
    dev, bf16 = run.device, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(derive(run.seed, 40))
    maps = [[torch.randn(rows, c, side, side, generator=g, device=dev).to(bf16)
             for _ in range(levels)] for _ in range(2)]
    w = torch.randn(c, levels * c, 3, 3, generator=g, device=dev) / (9 * levels * c) ** 0.5
    scale = 0.5 + torch.rand(c, generator=g, device=dev)
    bias = 0.1 * torch.randn(c, generator=g, device=dev)
    up, b32 = pack(fold(w.to(bf16), scale, levels, bf16), bias)
    seconds = layers.device_seconds(lambda i: op(maps[i % 2], up, b32), CALLS)
    least = arith.least_seconds(*arith.mwt_tail_work(rows, c, side, levels), arith.BF16_FLOPS)
    del maps
    torch.cuda.empty_cache()
    return arith.share_pct(least, seconds)
