"""mfu.train: the window's trained frames times three forwards' FLOPs (the
forward, and a backward of twice its work; remat's recompute is not
counted), over the window's seconds times 989 TFLOP/s (H100 bf16, dense),
in %. FLOPs from the benchmark's own reference (``lib/arith``)."""

from benchmark.lib import arith


def read(run, drv):
    w = run.window
    f = arith.flops_per_frame(run.cfg, run.cfg["mode"], run.traffic["frame_chunk"])
    return arith.share_pct(3 * w["frames"] * f, w["seconds"] * arith.BF16_FLOPS)
