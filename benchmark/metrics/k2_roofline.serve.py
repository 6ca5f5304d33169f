"""k2_roofline.serve: the fused depthwise k x k + BN + SiLU + SE mean of
every stride-1 squeeze-excite block of the configuration's SFE backbone
(``modules.dwse_backbone``'s block table) against its roofline, in %.

The least time for the work of one served chunk (``lib/arith.dwse_work``
per block at the chunk's rows, bf16 in and out; bound by the larger of
bytes over 3.35 TB/s and operations over 67 TFLOP/s fp32) over its device
time: the op below called alone at each shape, on seeded inputs cycled over
more than 100 MB (beyond the 50 MB L2) so that each call reads from memory,
its weights packed outside the timed calls as the served block keeps them,
every device kernel a call launches summed from the profiler, times the
shape's blocks per chunk.
"""

from collections import Counter

import torch

from benchmark.lib import arith, layers, program
from benchmark.lib.common import derive

OP = "ewvit_tpu_torch.ops.dw_se:dw_bn_silu_mean_packed"
PACK = "ewvit_tpu_torch.ops.dw_se:pack_dwse"
CALLS = 12
COLD_BYTES = 100 << 20


def read(run, drv):
    cfg, t = run.cfg, run.traffic
    if not run.on_card or not cfg["kernels"].get("use_pallas_dwse"):
        return None
    op, pack = program.function(OP), program.function(PACK)
    rows = t["clips_per_batch"] * t["frame_chunk"]
    shapes = Counter(arith.dwse_shapes(cfg[cfg["modules"]["dwse_backbone"]], cfg["image_size"]))
    dev = run.device
    g = torch.Generator(device=dev).manual_seed(derive(run.seed, 41))
    least = spent = 0.0
    for (c, side, k), count in sorted(shapes.items()):
        x0 = torch.randn(rows, c, side, side, generator=g, device=dev).to(torch.bfloat16)
        copies = -(-COLD_BYTES // (2 * x0.numel() * x0.element_size())) + 1
        xs = [x0] + [x0.clone() for _ in range(copies - 1)]
        packed = pack(0.2 * torch.randn(k * k, c, generator=g, device=dev),
                      0.1 * torch.randn(c, generator=g, device=dev), k)
        outs = [None] * copies

        def call(i):
            outs[i % copies] = op(xs[i % copies], packed, k)

        spent += count * layers.device_seconds(call, max(CALLS, copies))
        least += count * arith.least_seconds(*arith.dwse_work(rows, c, side, k),
                                             arith.FP32_FLOPS)
        del xs, outs
    torch.cuda.empty_cache()
    return arith.share_pct(least, spent)
