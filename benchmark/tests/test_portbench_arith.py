"""The yardstick's arithmetic on the CPU: FLOPs a frame, the K2 and K3
per-chunk bounds, and the reduction of traces to busy, idle and launches."""

from __future__ import annotations

import math
import os

import pytest

from benchmark.lib import arith, manifest, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cfg(name):
    return manifest.read_json(os.path.join(ROOT, "benchmark", "configs", f"{name}.json"))


@pytest.mark.parametrize("name, gflop", [("dynamic", 543.86), ("sfe_mwt", 425.55)])
def test_flops_of_a_clip_of_24_frames(name, gflop):
    """The program's own count (``cli/calculate_gflops``, at [1, 24]) on the
    benchmark's reference, shapes only."""
    cfg = _cfg(name)
    flops = arith.forward_flops(cfg, cfg["mode"], 1, 24, 24)
    assert round(flops / 1e9, 2) == gflop
    assert arith.flops_per_frame(cfg, cfg["mode"], 24) == pytest.approx(flops / 24)


def test_flops_a_frame_do_not_depend_on_the_chunk():
    cfg = _cfg("sfe_mwt")
    assert arith.flops_per_frame(cfg, "sfe_mwt", 8) == pytest.approx(
        arith.flops_per_frame(cfg, "sfe_mwt", 24), rel=1e-6)


def test_k3_bound_of_a_chunk():
    """PERF.md's kernel table: 0.3192 ms (operations, bf16 tensor cores) for
    the 64-row chunk's multiscale_fusion."""
    nbytes, ops = arith.mwt_tail_work(64, 128, 112, 3)
    assert ops == 2 * 16 * 3 * 64 * 56 * 56 * 128 * 128
    assert round(arith.least_seconds(nbytes, ops, arith.BF16_FLOPS) * 1e3, 4) == 0.3192
    assert nbytes / arith.HBM_BYTES_PER_S < ops / arith.BF16_FLOPS


def test_k2_bound_of_a_v2s_chunk():
    """PERF.md's kernel table: 0.2483 ms (bytes) for V2-S's 28 launches a
    64-row chunk: 512 x 14^2 (5), 768 x 14^2 (1), 960 x 14^2 (8), 1536 x 7^2 (14)."""
    cfg = _cfg("dynamic")
    shapes = arith.dwse_shapes(cfg["v2s"], 224)
    counts = {s: shapes.count(s) for s in set(shapes)}
    assert counts == {(512, 14, 3): 5, (768, 14, 3): 1, (960, 14, 3): 8, (1536, 7, 3): 14}
    total = sum(arith.least_seconds(*arith.dwse_work(64, c, s, k), arith.FP32_FLOPS)
                for c, s, k in shapes)
    assert round(total * 1e3, 4) == 0.2483


def test_k2_shapes_of_b0():
    """B0's 12 stride-1 blocks a chunk (PERF.md: 12 launches a chunk)."""
    shapes = arith.dwse_shapes(_cfg("sfe_mwt")["b0"], 224)
    assert shapes == [(32, 112, 3), (144, 56, 3), (240, 28, 5), (480, 14, 3), (480, 14, 3),
                      (480, 14, 5), (672, 14, 5), (672, 14, 5), (1152, 7, 5), (1152, 7, 5),
                      (1152, 7, 5), (1152, 7, 3)]


def test_union_merges_overlaps_and_clips_to_the_window():
    got = trace.union([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (-1.0, 0.5), (9.0, 12.0)], 0.0, 10.0)
    assert got == [(0.0, 3.0), (5.0, 6.0), (9.0, 10.0)]
    assert trace.gaps(got, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]


def test_reduce_busy_idle_launches_and_breakdown():
    device = [("k1", 1.0, 2.0), ("k2", 1.5, 2.5), ("k1", 4.0, 5.0), ("memcpy", 7.0, 8.0),
              ("k1", 11.0, 12.0)]                          # the last lies outside
    host = [("step", 0.0, 10.0), ("cudaLaunchKernel", 0.9, 0.95),
            ("cudaLaunchKernel", 3.9, 3.95), ("cudaGraphLaunch", 6.9, 6.95),
            ("cudaLaunchKernel", 10.5, 10.6), ("aten::item", 2.6, 3.9),
            ("cudaStreamSynchronize", 5.1, 6.8)]
    r = trace.reduce(device, host, 0.0, 10.0)
    assert r["busy_s"] == pytest.approx(1.5 + 1.0 + 1.0)
    assert r["window_s"] == 10.0
    assert r["launches"] == 3
    assert r["device_ops"][0] == ["k1", 2.0]
    gaps = dict(r["idle_gaps"])
    # gaps: 0-1 (step), 2.5-4 (aten::item at 3.25), 5-7 (sync at 6), 8-10 (step)
    assert gaps == pytest.approx({"step": 3.0, "aten::item": 1.5,
                                  "cudaStreamSynchronize": 2.0})
    assert 100 * (1 - r["busy_s"] / r["window_s"]) == pytest.approx(65.0)


def test_shares():
    assert arith.share_pct(1.0, 4.0) == 25.0
    assert math.isclose(arith.least_seconds(3.35e12, 0, 1.0), 1.0)
