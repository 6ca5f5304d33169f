"""K2's host side on the CPU: the launch plan, the packed weights, and the
MBConv's kept fold (ewvit_tpu_torch/ops/dw_se.py, models/efficientnet.py).

The kernel itself runs only on the card (chip_smoke.py holds it against the
plain version there); these tests check what surrounds it. The plan is
checked at every plane size K2's callers use: V2-S's four (the served
path) and B0's (the ``sfe_only``/``sfe_mwt`` backbone, ewvit_tpu/models/
efficientnet.py:53-61), in both storage types.
"""

import numpy as np
import pytest
import torch

from ewvit_tpu_torch.models.efficientnet import MBConv
from ewvit_tpu_torch.models.norm import calibrate_batchnorm_
from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops.dw_se import (
    SMEM_LIMIT,
    THREADS,
    dw_bn_silu_mean,
    dw_bn_silu_mean_packed,
    dw_bn_silu_mean_plain,
    dwse_plan,
    pack_dwse,
    packed_width,
)

# (N, C, H, W, k): V2-S per 64-row chunk, B0 at N = 4, and ragged cases
# (N*C not a multiple of the group; a 7x7 plane count whose bytes are not a
# multiple of 16)
SHAPES = [
    (64, 512, 14, 14, 3), (64, 768, 14, 14, 3), (64, 960, 14, 14, 3), (64, 1536, 7, 7, 3),
    (4, 32, 112, 112, 3), (4, 144, 56, 56, 3), (4, 240, 28, 28, 5), (4, 480, 14, 14, 3),
    (4, 480, 14, 14, 5), (4, 672, 14, 14, 5), (4, 1152, 7, 7, 5), (4, 1152, 7, 7, 3),
    (3, 136, 14, 14, 3), (1, 33, 7, 7, 3),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes that share the cores, and torch's default of
    one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_fits_and_covers(shape, itemsize):
    """Shared memory within 227 KB; every bulk copy 16-byte aligned and a
    multiple of 16 bytes; only the last unit may go by ordinary loads and
    stores; the units' outputs tile y exactly once, ragged tail included;
    each unit holds the input rows its outputs need."""
    n, c, h, w, k = shape
    plan = dwse_plan(n, c, h, w, k, itemsize)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert 1 <= plan.grid <= plan.units and plan.group * plan.units >= n * c
    assert plan.band_rows == h or plan.group == 1
    p, total, end = k // 2, n * c * h * w * itemsize, 0
    for s in plan.steps():
        assert s["y_off"] == end          # in order, no gap, no overlap
        end += s["y_bytes"]
        if s["unit"] != plan.units - 1:
            assert s["x_bulk"] and s["y_bulk"], s
        for off, nb, bulk in ((s["x_off"], s["x_bytes"], s["x_bulk"]),
                              (s["y_off"], s["y_bytes"], s["y_bulk"])):
            assert bulk == (off % 16 == 0 and nb % 16 == 0)
        sr0, sr1 = s["src_rows"]
        assert sr0 <= max(0, s["r0"] - p) and sr1 >= min(h, s["r0"] + s["rows"] + p)
        assert s["x_bytes"] <= plan.layout()["x_stage"]
        assert s["y_bytes"] <= plan.layout()["y_tile"]
    assert end == total


def test_plan_main_path_fills_the_block_and_ragged_tail():
    """At V2-S's served shapes (bf16) the plane size is compiled in, every
    unit is a bulk copy and its work items fill the 224 threads exactly; 33
    planes of 7x7 bf16 leave a last unit whose bytes are not a multiple of
    16, which the plan routes to ordinary loads."""
    for n, c, h, w, k in SHAPES[:4]:
        plan = dwse_plan(n, c, h, w, k, 2)
        assert plan.path == {14: "rows14", 7: "planes7"}[h]
        assert plan.lanes % THREADS == 0
        assert all(s["x_bulk"] and s["y_bulk"] for s in plan.steps())
    assert dwse_plan(4, 32, 112, 112, 3, 2).path == "strips"
    last = list(dwse_plan(1, 33, 7, 7, 3, 2).steps())[-1]
    assert last["x_bytes"] % 16 and not last["x_bulk"] and not last["y_bulk"]


def test_pack_dwse_layout_and_packed_cpu_entry():
    g = np.random.default_rng(7)
    for k, c in ((3, 6), (5, 3)):
        w_eff = g.standard_normal((k * k, c)).astype(np.float32)
        shift = g.standard_normal(c).astype(np.float32)
        packed = pack_dwse(torch.from_numpy(w_eff), torch.from_numpy(shift), k)
        want = np.zeros((c, packed_width(k)), np.float32)
        for ch in range(c):
            want[ch, :k * k] = w_eff[:, ch]
            want[ch, k * k] = shift[ch]
        assert packed.dtype == torch.float32 and packed.shape[1] * 4 % 16 == 0
        np.testing.assert_array_equal(packed.numpy(), want)
        x = torch.from_numpy(g.standard_normal((2, c, 9, 7)).astype(np.float32))
        before = dict(extension.LAUNCHES)
        for dtype in (torch.float32, torch.bfloat16):
            y, m = dw_bn_silu_mean_packed(x.to(dtype), packed, k)
            y_p, m_p = dw_bn_silu_mean_plain(x.to(dtype), torch.from_numpy(w_eff),
                                             torch.from_numpy(shift), k)
            torch.testing.assert_close(y, y_p, atol=0, rtol=0)
            torch.testing.assert_close(m, m_p, atol=0, rtol=0)
        assert extension.LAUNCHES == before          # a CPU tensor launches nothing
    with pytest.raises(ValueError):
        dw_bn_silu_mean_packed(x, packed[:, :-4], 5)


def _mbconv(seed=0):
    torch.manual_seed(seed)
    mb = MBConv(8, 8, 3, 1, 4, 0.25, use_pallas_dwse=True)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 8, 9, 9)).astype(np.float32))
    return calibrate_batchnorm_(mb, x), x


def _per_call_fold(mb):
    """The fold as the MBConv did it on every call before it was kept."""
    dw = mb.block[1]
    conv, bn = dw[0], dw[1]
    scale, shift = bn.folded()
    w_eff = (conv.weight.float().reshape(32, 9).t() * scale).contiguous()
    return pack_dwse(w_eff, shift.contiguous(), 3)


@torch.no_grad()
def test_mbconv_keeps_fold_and_drops_it():
    """The kept fold gives the per-call fold's output bit for bit; it is
    dropped on train(), load_state_dict and calibrate_batchnorm_, and
    recomputed after .to(dtype)."""
    mb, x = _mbconv()
    assert mb._dwse is None
    kept = mb(x)
    assert mb._dwse is not None
    torch.testing.assert_close(mb._dwse[1], _per_call_fold(mb), atol=0, rtol=0)
    mb._dwse_weights = lambda: _per_call_fold(mb)
    try:
        fresh = mb(x)
    finally:
        del mb._dwse_weights
    torch.testing.assert_close(kept, fresh, atol=0, rtol=0)
    # and both equal the public per-call entry
    h = mb.block[0](x)
    conv, bn = mb.block[1][0], mb.block[1][1]
    scale, shift = bn.folded()
    y, m = dw_bn_silu_mean(h, conv.weight.float().reshape(32, 9).t() * scale, shift, 3)
    ref = x + mb.block[3](mb.block[2](y, mean=m[:, :, None, None]))
    torch.testing.assert_close(kept, ref, atol=0, rtol=0)

    mb.train()
    assert mb._dwse is None
    mb.eval()
    mb(x)
    sd = {k: v.clone() for k, v in mb.state_dict().items()}
    mb.load_state_dict(sd)
    assert mb._dwse is None
    mb(x)
    calibrate_batchnorm_(mb, 2 * x)
    assert mb._dwse is None
    after = mb(x)
    torch.testing.assert_close(mb._dwse[1], _per_call_fold(mb), atol=0, rtol=0)
    assert not torch.equal(after, kept)           # new statistics, new fold
    mb._dwse_weights()
    key = mb._dwse[0]
    mb.to(torch.bfloat16)
    mb._dwse_weights()
    assert mb._dwse[0] != key and mb._dwse[0][0] == torch.bfloat16
    torch.testing.assert_close(mb._dwse[1], _per_call_fold(mb), atol=0, rtol=0)
