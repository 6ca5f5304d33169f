"""The port's ops (ewvit_tpu_torch.ops) held against the JAX package on the CPU.

Inputs come from ``np.random.default_rng`` and go through both packages;
NHWC (JAX) and NCHW (port) are transposed at the comparison. On a CPU tensor
each kernel wrapper runs its plain PyTorch version, so these tests hold the
plain versions (the on-card oracles of chip_smoke.py) against the Pallas
kernels run in interpret mode. Tolerances are fp32: the Haar butterfly is
exact up to one rounding (1e-6); the depthwise and attention paths sum in a
different order (1e-5).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewvit_tpu.ops.dw_se import dw_bn_silu_mean as jax_dw_bn_silu_mean
from ewvit_tpu.ops.fused_attention import (
    fused_bidirectional_cross_attention as jax_fused_xattn,
    params_from_module_tree as jax_params_from_module_tree,
)
from ewvit_tpu.ops.haar import haar_dwt2d as jax_haar_dwt2d
from ewvit_tpu.ops.haar import haar_dwt2d_pallas as jax_haar_dwt2d_pallas
from ewvit_tpu.ops.preprocess import preprocess_batch as jax_preprocess_batch
from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops.dw_se import dw_bn_silu_mean, dw_bn_silu_mean_plain
from ewvit_tpu_torch.ops.fused_attention import (
    fused_bidirectional_cross_attention,
    pack_params,
    params_from_module_tree,
    supports,
)
from ewvit_tpu_torch.ops.haar import haar_dwt2d, haar_dwt2d_plain, haar_idwt2d
from ewvit_tpu_torch.ops.preprocess import preprocess_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------- K1: Haar


@pytest.mark.parametrize("shape", [(2, 16, 12, 3), (1, 8, 8, 5)])
def test_haar_plain_matches_jax_and_pallas(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ll, hf = haar_dwt2d_plain(_nchw(x))
    assert ll.shape == (shape[0], shape[3], shape[1] // 2, shape[2] // 2)
    assert hf.shape == (shape[0], 3 * shape[3], shape[1] // 2, shape[2] // 2)
    for ref in (jax_haar_dwt2d(jnp.asarray(x)),
                jax_haar_dwt2d_pallas(jnp.asarray(x), interpret=True)):
        np.testing.assert_allclose(ll.numpy(), _nchw(ref[0]).numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(hf.numpy(), _nchw(ref[1]).numpy(), atol=1e-6, rtol=0)


def test_haar_wrapper_on_cpu_is_plain_and_inverts():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 10, 6)).astype(np.float32))
    before = dict(extension.LAUNCHES)
    ll, hf = haar_dwt2d(x)
    assert extension.LAUNCHES == before      # no kernel launch for a CPU tensor
    ll_p, hf_p = haar_dwt2d_plain(x)
    torch.testing.assert_close(ll, ll_p, atol=0, rtol=0)
    torch.testing.assert_close(hf, hf_p, atol=0, rtol=0)
    torch.testing.assert_close(haar_idwt2d(ll, hf), x, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="even"):
        haar_dwt2d(x[:, :, :9])


# ------------------------------------------------- K2: depthwise + SE mean


@pytest.mark.parametrize("shape,k", [
    ((3, 14, 14, 256), 3),
    ((2, 7, 7, 384), 3),
    ((2, 14, 14, 136), 3),   # channels not a multiple of 128
    ((2, 14, 14, 192), 5),   # 5x5 depthwise
    ((1, 2, 2, 128), 3),     # plane smaller than the halo
])
def test_dw_bn_silu_mean_plain_matches_jax_kernel(shape, k):
    g = np.random.default_rng(2)
    n, h, w, c = shape
    x = g.standard_normal(shape).astype(np.float32)
    w_eff = (g.standard_normal((k * k, c)) * 0.2).astype(np.float32)
    shift = (g.standard_normal(c) * 0.1).astype(np.float32)
    yj, mj = jax_dw_bn_silu_mean(jnp.asarray(x), jnp.asarray(w_eff),
                                 jnp.asarray(shift), kernel=k, interpret=True)
    y, m = dw_bn_silu_mean_plain(_nchw(x), torch.from_numpy(w_eff),
                                 torch.from_numpy(shift), k)
    assert y.shape == (n, c, h, w) and m.shape == (n, c) and m.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), _nchw(yj).numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), atol=1e-5, rtol=1e-5)
    y2, m2 = dw_bn_silu_mean(_nchw(x), torch.from_numpy(w_eff),
                             torch.from_numpy(shift), k)
    torch.testing.assert_close(y2, y, atol=0, rtol=0)
    torch.testing.assert_close(m2, m, atol=0, rtol=0)


def test_dw_bn_silu_mean_bf16_mean_is_of_rounded_y():
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.standard_normal((2, 16, 7, 7)).astype(np.float32))
    w_eff = torch.from_numpy(g.standard_normal((9, 16)).astype(np.float32))
    shift = torch.zeros(16)
    y, m = dw_bn_silu_mean(x.bfloat16(), w_eff, shift, 3)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(m, y.float().mean(dim=(2, 3)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("bad", ["kernel", "w_shape"])
def test_dw_bn_silu_mean_rejects_bad_arguments(bad):
    x = torch.zeros(1, 4, 5, 5)
    w_eff, shift, k = torch.zeros(9, 4), torch.zeros(4), 3
    if bad == "kernel":
        k = 4
    else:
        w_eff = torch.zeros(9, 5)
    with pytest.raises(ValueError):
        dw_bn_silu_mean(x, w_eff, shift, k)


# ------------------------------------------- K4: fused cross-attention stack


@pytest.fixture(scope="module")
def xattn_case():
    from ewvit_tpu.models.layers import BidirectionalCrossTransformer

    d, heads, depth, n = 128, 4, 2, 8
    g = np.random.default_rng(4)
    s = g.standard_normal((n, 1, d)).astype(np.float32)
    f = g.standard_normal((n, 1, d)).astype(np.float32)
    m = BidirectionalCrossTransformer(dim=d, depth=depth, heads=heads,
                                      dim_head=d // heads)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), s, f)

    def fill(path, sds):   # non-trivial LayerNorm params and biases
        name = path[-1].key
        if name == "scale":
            a = 1.0 + 0.1 * g.standard_normal(sds.shape)
        elif name == "bias":
            a = 0.1 * g.standard_normal(sds.shape)
        else:
            a = g.standard_normal(sds.shape) / np.sqrt(sds.shape[0])
        return np.asarray(a, np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    so_ref, fo_ref = m.apply(v, s, f, deterministic=True)
    return dict(d=d, heads=heads, depth=depth, s=s, f=f, params=v["params"],
                so_ref=np.asarray(so_ref)[:, 0], fo_ref=np.asarray(fo_ref)[:, 0])


def test_fused_attention_plain_matches_jax_kernel(xattn_case):
    c = xattn_case
    flat_j = jax_params_from_module_tree(c["params"], c["depth"])
    so_j, fo_j = jax_fused_xattn(jnp.asarray(c["s"][:, 0]), jnp.asarray(c["f"][:, 0]),
                                 flat_j, depth=c["depth"], heads=c["heads"],
                                 interpret=True)
    tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a)),
                                  c["params"])
    mats, smalls = pack_params(params_from_module_tree(tree, c["depth"]), c["depth"])
    assert mats.shape == (4, 128, 512) and smalls.shape == (4, 3, 128)
    so, fo = fused_bidirectional_cross_attention(
        torch.from_numpy(c["s"][:, 0]), torch.from_numpy(c["f"][:, 0]),
        mats, smalls, heads=c["heads"])
    for got, ref in ((so, so_j), (fo, fo_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # the JAX unfused module: same math, other summation order
    np.testing.assert_allclose(so.numpy(), c["so_ref"], atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(fo.numpy(), c["fo_ref"], atol=2e-5, rtol=1e-5)


def test_supports_gating_matches_jax():
    from ewvit_tpu.ops.fused_attention import supports as jax_supports

    for args in [(128, 1, True), (128, 2, True), (96, 1, True), (128, 1, False),
                 (256, 1, True)]:
        assert supports(*args) == jax_supports(*args)


def test_fused_attention_rejects_bad_shapes():
    s = torch.zeros(2, 128)
    mats, smalls = torch.zeros(4, 128, 512), torch.zeros(4, 3, 128)
    with pytest.raises(ValueError):
        fused_bidirectional_cross_attention(s, torch.zeros(3, 128), mats, smalls)
    with pytest.raises(ValueError):
        fused_bidirectional_cross_attention(s, s, mats[:, :, :256], smalls)


# ------------------------------------------------------- preprocess, configs


def test_preprocess_matches_jax():
    clips = np.random.default_rng(5).integers(0, 256, (2, 3, 8, 6, 3), np.uint8)
    ref = np.asarray(jax_preprocess_batch(jnp.asarray(clips), dtype_name="float32"))
    got = preprocess_batch(torch.from_numpy(clips), torch.float32)
    assert got.shape == (2, 3, 3, 8, 6)
    np.testing.assert_allclose(got.numpy(), ref.transpose(0, 1, 4, 2, 3),
                               atol=1e-6, rtol=0)


def test_config_copies_match_jax():
    from ewvit_tpu import configs as jc
    from ewvit_tpu.models import efficientnet as je
    from ewvit_tpu_torch import configs as pc

    for make in (lambda m: m(), lambda m: m.tiny(), lambda m: m.micro()):
        dj = dataclasses.asdict(make(jc.ModelConfig))
        dp = dataclasses.asdict(make(pc.ModelConfig))
        dj.pop("backbone_spec"), dp.pop("backbone_spec")
        assert dp == dj
    assert [dataclasses.asdict(b) for b in je.V2S_BLOCKS] == \
        [dataclasses.asdict(b) for b in pc.V2S_BLOCKS]
    assert dataclasses.asdict(je.V2S_MICRO) == dataclasses.asdict(pc.V2S_MICRO)


# ------------------------------------------------------------ package rules


def test_port_imports_no_jax():
    code = (
        "import sys, ewvit_tpu_torch, ewvit_tpu_torch.utils.convert, "
        "ewvit_tpu_torch.ops.extension\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ewvit_tpu', 'yaml')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_entry_points_refuse_missing_gpu():
    from ewvit_tpu_torch import InferenceEngine, ModelConfig, build_detector
    from ewvit_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path needs none")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(ModelConfig.micro())
    model = build_detector(ModelConfig.micro(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model)
    assert InferenceEngine(model, device="cpu").device.type == "cpu"
