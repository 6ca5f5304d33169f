"""The port's Winograd ops and fused MWT tail held against the JAX package (CPU, fp32).

Inputs come from ``np.random.default_rng``; NHWC/HWIO (JAX) and NCHW/OIHW
(port) are transposed at the comparison. On a CPU tensor the K3 and K5
wrappers run their plain PyTorch versions, which these tests hold against
the Pallas kernels in interpret mode. Tolerances: the weight transforms are
the same fp32 arithmetic in another order (1e-6); the convolutions sum over
input channels and transform positions in another order (1e-4, as
tests/test_winograd_pallas.py; 2e-4 for the multi-level kernel, as
tests/test_mwt_tail.py); the MWT features 1e-4 and the detector's logits
1e-3 (BASELINE.json's logit tolerance), as tests/test_torch_port_model.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewvit_tpu.models.detector import init_detector_fast
from ewvit_tpu.models.detector import video_forward as jax_video_forward
from ewvit_tpu.models.mwt import MWT as JaxMWT
from ewvit_tpu.ops import winograd as jw
from ewvit_tpu.ops.mwt_tail import fused_multiscale_winograd as jax_fused_tail
from ewvit_tpu.ops.mwt_tail import multiscale_winograd_u as jax_multiscale_u
from ewvit_tpu.ops.winograd_pallas import conv3x3_winograd_pallas
from ewvit_tpu_torch import build_detector, video_forward
from ewvit_tpu_torch.models.mwt import MWT
from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops import winograd as pw
from ewvit_tpu_torch.ops.mwt_tail import (
    fused_multiscale_winograd,
    fused_multiscale_winograd_packed,
    fused_multiscale_winograd_plain,
    multiscale_winograd_u,
    pack_tail,
)
from ewvit_tpu_torch.utils import convert
from test_torch_port_model import B, CHUNK, JCFG, K, PCFG, _fill


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes that share the cores, and torch's default of
    one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


def _phase_split(dense):
    """Dense NHWC -> the TPU kernel's 4 phase arrays, PC[p][q][n, k, m] =
    dense[n, 2k + (1 - p), 2m + (1 - q)] (ewvit_tpu/ops/mwt_tail.py:38)."""
    return [dense[:, (1 - p)::2, (1 - q)::2, :] for p in (0, 1) for q in (0, 1)]


def _interleave(ph):
    """The TPU kernel's output phases fused[r][s][n, t, b] = out[n, 2t+r, 2b+s]
    -> dense NHWC."""
    n, a, b, c = ph[0].shape
    dense = np.stack([np.stack([ph[0], ph[1]], -2), np.stack([ph[2], ph[3]], -2)], 2)
    return dense.reshape(n, 2 * a, 2 * b, c)


# ------------------------------------------------------------ (a) transforms


def test_transforms_and_multiscale_u_match_jax():
    g = np.random.default_rng(0)
    for mine, ref in ((pw.BT, jw._BT), (pw.G, jw._G), (pw.AT, jw._AT)):
        np.testing.assert_array_equal(mine.numpy(), ref)
    w = g.standard_normal((3, 3, 5, 7)).astype(np.float32)          # HWIO
    np.testing.assert_allclose(pw.transform_weights(_oihw(w)).numpy(),
                               np.asarray(jw.transform_weights(jnp.asarray(w))),
                               atol=1e-6, rtol=1e-6)
    levels, c = 3, 4
    k = g.standard_normal((3, 3, levels * c, c)).astype(np.float32)
    scale = g.uniform(0.5, 1.5, c).astype(np.float32)
    got = multiscale_winograd_u(_oihw(k), torch.from_numpy(scale), levels, torch.float32)
    ref = jax_multiscale_u(jnp.asarray(k), jnp.asarray(scale), levels, jnp.float32)
    assert got.shape == (levels, 16, c, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------- (b) K5's plain version


@pytest.mark.parametrize("shape,cout,tile_rows", [((2, 16, 12, 5), 7, 4),
                                                  ((1, 8, 8, 3), 4, 2)])
def test_conv3x3_winograd_plain_matches_pallas(shape, cout, tile_rows):
    g = np.random.default_rng(1)
    x = g.standard_normal(shape).astype(np.float32)
    w = g.standard_normal((3, 3, shape[-1], cout)).astype(np.float32)
    ref = conv3x3_winograd_pallas(jnp.asarray(x), jnp.asarray(w), tile_rows=tile_rows,
                                  interpret=True)
    got = pw.conv3x3_winograd_plain(_nchw(x), _oihw(w))
    assert got.shape == (shape[0], cout, shape[1], shape[2])
    np.testing.assert_allclose(got.numpy(), _nchw(ref).numpy(), atol=1e-4, rtol=1e-4)
    direct = torch.nn.functional.conv2d(_nchw(x), _oihw(w), padding=1)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------- (c) K3's plain version


@pytest.mark.parametrize("n,h,w,c,levels,tile_rows", [(2, 16, 12, 4, 1, 4),
                                                      (1, 16, 16, 8, 3, 4)])
def test_fused_multiscale_plain_matches_pallas(n, h, w, c, levels, tile_rows):
    g = np.random.default_rng(2)
    ys = [g.standard_normal((n, h, w, c)).astype(np.float32) for _ in range(levels)]
    k = g.standard_normal((3, 3, levels * c, c)).astype(np.float32)
    scale = g.uniform(0.5, 1.5, c).astype(np.float32)
    bias = g.standard_normal(c).astype(np.float32)
    u = jax_multiscale_u(jnp.asarray(k), jnp.asarray(scale), levels, jnp.float32)
    phases = [p for y in ys for p in _phase_split(jnp.asarray(y))]
    ref = _interleave([np.asarray(p) for p in jax_fused_tail(
        phases, u, jnp.asarray(bias), tile_rows=tile_rows, interpret=True)])
    got = fused_multiscale_winograd_plain(
        [_nchw(y) for y in ys], torch.from_numpy(np.array(u)), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), _nchw(ref).numpy(), atol=2e-4, rtol=2e-4)


# ------------------------------------- (d), (e): one set of JAX variables

JCFG_TAIL = JCFG.replace(use_fused_mwt_tail=True)
PCFG_TAIL = dataclasses.replace(PCFG, use_fused_mwt_tail=True)


@pytest.fixture(scope="module")
def detector_vars():
    """The micro detector of tests/test_torch_port_model.py with the fused
    tail: shapes from ``init_detector_fast`` (``jax.eval_shape``), values from
    numpy. The fused tail has the direct path's parameter tree
    (tests/test_mwt_tail.py), so the port loads the same state dict."""
    jmodel, shapes = init_detector_fast(JCFG_TAIL, seed=0)
    return jmodel, _fill(shapes, seed=1)


def test_mwt_fused_tail_matches_jax_and_direct(detector_vars):
    _, jvars = detector_vars
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    sub = {k: v["dama"]["mwt"] for k, v in jvars.items()}
    jmwt = JaxMWT(dama_dim=JCFG.dama_dim, levels=JCFG.levels, use_fused_tail=True)
    ref = np.asarray(jax.jit(jmwt.apply)(sub, jnp.asarray(x)))[:, 0, 0]

    b = convert._Builder(jvars)
    convert._mwt(b, "m", ("dama", "mwt"))
    sd = {k[len("m."):]: v for k, v in b.sd.items()}
    xt = _nchw(x)
    outs = {}
    for fused in (True, False):
        m = MWT(3, JCFG.dama_dim, JCFG.levels, use_pallas_dwt=True,
                use_fused_tail=fused).eval()
        m.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs[fused] = m(xt)[:, :, 0, 0].numpy()
    np.testing.assert_allclose(outs[True], ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(outs[True], outs[False], atol=1e-4, rtol=1e-4)


def test_video_forward_fused_tail_matches_jax(detector_vars):
    jmodel, jvars = detector_vars
    port = build_detector(PCFG_TAIL, device="cpu", seed=0)
    port.load_state_dict(convert.jax_to_state_dict(jvars, PCFG_TAIL), strict=True)
    assert port.dama.mwt.use_fused_tail
    x = np.random.default_rng(2).standard_normal((B, K, 32, 32, 3)).astype(np.float32)
    ref, _ = jax_video_forward(jmodel, jvars, jnp.asarray(x), mode="dynamic",
                               frame_chunk=CHUNK, remat=False)
    got = video_forward(port, torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 1, 4, 2, 3))), frame_chunk=CHUNK)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(ref["logits"]),
                               atol=1e-3, rtol=0)
    for key in ("fused", "space", "freq"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)


# ------------------------------------------------ (f) the CPU wrappers


def test_cpu_wrappers_are_plain_and_reject_odd_sizes():
    g = np.random.default_rng(5)
    x = torch.from_numpy(g.standard_normal((1, 6, 8, 10)).astype(np.float32))
    w = torch.from_numpy(g.standard_normal((4, 6, 3, 3)).astype(np.float32))
    ys = [torch.from_numpy(g.standard_normal((1, 4, 8, 10)).astype(np.float32))
          for _ in range(2)]
    u = multiscale_winograd_u(torch.from_numpy(g.standard_normal(
        (4, 8, 3, 3)).astype(np.float32)), torch.ones(4), 2, torch.float32)
    bias = torch.zeros(4)
    before = dict(extension.LAUNCHES)
    torch.testing.assert_close(pw.conv3x3_winograd(x, w), pw.conv3x3_winograd_plain(x, w),
                               atol=0, rtol=0)
    torch.testing.assert_close(fused_multiscale_winograd(ys, u, bias),
                               fused_multiscale_winograd_plain(ys, u, bias), atol=0, rtol=0)
    assert extension.LAUNCHES == before      # no kernel launch for a CPU tensor
    with pytest.raises(ValueError, match="even"):
        pw.conv3x3_winograd(x[:, :, :7], w)
    with pytest.raises(ValueError, match="even"):
        fused_multiscale_winograd([y[:, :, :, :9] for y in ys], u, bias)
    with pytest.raises(ValueError, match="u \\["):
        fused_multiscale_winograd(ys[:1], u, bias)

    # the kernel's U layout: [L, 16, Cout_pad128, Cin_pad32], zero-padded, the
    # pairs of each 16 input channels in the order (0,1), (8,9), (2,3), ...
    packed = pw.pack_u(u, torch.float32)
    assert packed.shape == (2, 16, 128, 32) and packed.is_contiguous()
    order = [16 * grp + 8 * half + 2 * pair + e for grp in range(2) for pair in range(4)
             for half in range(2) for e in range(2)]           # stored position -> k
    logical = torch.zeros(2, 16, 128, 32)
    logical[:, :, :4, :4] = u.transpose(2, 3)         # [L, 16, Cout, Cin]
    torch.testing.assert_close(packed, logical[..., order], atol=0, rtol=0)


# ------------------------------------- (g) the bf16 kernel's packed U layout


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("cin,cout", [(54, 7), (54, 128), (128, 7), (128, 128)])
def test_pack_u_bf16_layout(levels, cin, cout):
    """pack_u's bf16 layout against an index formula written out here: per
    (level, chunk of 64 input channels, transform position, block of 128
    output channels) a 128 x 64 tile, row = output channel; channel
    8g + 4e + q of a chunk at position 2q + e of the row's 16-byte chunk g,
    which is stored at chunk g ^ (row % 8); zeros in the padding."""
    g = np.random.default_rng(7)
    u = g.standard_normal((levels, 16, cin, cout)).astype(np.float32)
    got = pw.pack_u(torch.from_numpy(u), torch.bfloat16)
    kch, nco = -(-cin // 64), -(-cout // 128)
    assert tuple(got.shape) == (levels, kch, 16, nco, 128, 64) and got.is_contiguous()
    ub = torch.from_numpy(u).to(torch.bfloat16).float().numpy()
    want = np.zeros((levels, kch, 16, nco, 128 * 64), np.float32)
    ci, co = np.meshgrid(np.arange(cin), np.arange(cout), indexing="ij")
    grp, r = (ci % 64) // 8, ci % 8
    row = co % 128
    pos = row * 64 + (grp ^ (row % 8)) * 8 + 2 * (r % 4) + r // 4
    for lvl in range(levels):
        for uv in range(16):
            want[lvl, ci // 64, uv, co // 128, pos] = ub[lvl, uv]
    np.testing.assert_array_equal(got.float().numpy().reshape(want.shape), want)


# --------------------------------------------- (h) the MWT's kept U and bias


def test_mwt_keeps_tail_weights(detector_vars):
    """The fused tail folds U once per model: the kept U and bias equal the
    per-call fold, the logits equal those of a per-call fold (1e-6; on the
    CPU both run the same plain arithmetic), and train() and load_state_dict
    drop them."""
    _, jvars = detector_vars
    sd = convert.jax_to_state_dict(jvars, PCFG_TAIL)
    port = build_detector(PCFG_TAIL, device="cpu", seed=0)
    port.load_state_dict(sd, strict=True)
    mwt = port.dama.mwt
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 3, 3, 32, 32)).astype(np.float32))
    assert mwt._tail is None
    kept = video_forward(port, x, frame_chunk=CHUNK)["logits"]
    assert mwt._tail is not None
    conv, bn = mwt.multiscale_fusion[0], mwt.multiscale_fusion[1]
    scale, shift = bn.folded()
    u = multiscale_winograd_u(conv.weight, scale, mwt.levels, torch.float32)
    _, up, b32 = mwt._tail
    torch.testing.assert_close(up, u, atol=0, rtol=0)
    torch.testing.assert_close(b32, conv.bias.float() * scale + shift, atol=0, rtol=0)

    def per_call(dtype):
        sc, sh = bn.folded()
        return pack_tail(multiscale_winograd_u(conv.weight, sc, mwt.levels, dtype),
                         conv.bias.float() * sc + sh)

    mwt._tail_weights = per_call
    try:
        fresh = video_forward(port, x, frame_chunk=CHUNK)["logits"]
    finally:
        del mwt._tail_weights
    np.testing.assert_allclose(kept.numpy(), fresh.numpy(), atol=1e-6, rtol=0)

    port.train()
    assert mwt._tail is None
    port.eval()
    video_forward(port, x, frame_chunk=CHUNK)
    assert mwt._tail is not None
    port.load_state_dict(sd, strict=True)
    assert mwt._tail is None


def test_cpu_packed_wrappers_launch_nothing():
    g = np.random.default_rng(6)
    ys = [torch.from_numpy(g.standard_normal((1, 4, 8, 6)).astype(np.float32))
          for _ in range(3)]
    u = multiscale_winograd_u(torch.from_numpy(g.standard_normal(
        (4, 12, 3, 3)).astype(np.float32)), torch.ones(4), 3, torch.float32)
    bias = torch.from_numpy(g.standard_normal(4).astype(np.float32))
    before = dict(extension.LAUNCHES)
    up, b32 = pack_tail(u, bias)
    assert up is u and b32.dtype == torch.float32     # the CPU keeps the plain layout
    torch.testing.assert_close(fused_multiscale_winograd_packed(ys, up, b32),
                               fused_multiscale_winograd_plain(ys, u, bias), atol=0, rtol=0)
    assert extension.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        pw.conv3x3_winograd_packed(ys[0], pw.pack_u(u[:1], torch.float32), 4)
