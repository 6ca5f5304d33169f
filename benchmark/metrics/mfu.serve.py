"""mfu.serve: the window's served frames times the FLOPs of a frame's
forward, over the window's seconds times 989 TFLOP/s (H100 bf16, dense),
in %. The FLOPs a frame are counted once on the benchmark's own reference
(``lib/arith.flops_per_frame``), so they are the same whatever implements
the work; padded tail slots are not frames."""

from benchmark.lib import arith


def read(run, drv):
    w = run.window
    f = arith.flops_per_frame(run.cfg, run.cfg["mode"], run.traffic["frame_chunk"])
    return arith.share_pct(w["frames"] * f, w["seconds"] * arith.BF16_FLOPS)
