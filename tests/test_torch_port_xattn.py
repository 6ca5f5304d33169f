"""K4's packed weights on the CPU (ewvit_tpu_torch/ops/fused_attention.py,
models/layers.py): the cluster kernel's layout, the module's kept pack, and
the fused module path held against the JAX kernel in interpret mode (1e-5,
as test_torch_port_ops.py::test_fused_attention_plain_matches_jax_kernel).

The cluster kernel itself runs only on the card; chip_smoke.py holds it
against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewvit_tpu.ops.fused_attention import (
    fused_bidirectional_cross_attention as jax_fused_xattn,
    params_from_module_tree as jax_params_from_module_tree,
)
from ewvit_tpu_torch.models.layers import BidirectionalCrossTransformer
from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops.fused_attention import (
    CLUSTER,
    cluster_route,
    fused_bidirectional_cross_attention,
    fused_bidirectional_cross_attention_packed,
    pack_params,
    pack_xattn,
    unpack_xattn,
)
from test_torch_port_ops import xattn_case  # noqa: F401  (fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes that share the cores, and torch's default of
    one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(d, blocks, seed=0):
    g = np.random.default_rng(seed)
    mats = torch.from_numpy(g.standard_normal((blocks, d, 4 * d)).astype(np.float32))
    smalls = torch.from_numpy(g.standard_normal((blocks, 3, d)).astype(np.float32))
    return mats, smalls


@pytest.mark.parametrize("d,blocks", [(128, 4), (256, 2), (16, 2)])
def test_pack_xattn_layout_and_round_trip(d, blocks):
    """Each (block, CTA) run holds, for every input row k, the CTA's w = D/8
    columns of Wq, Wk, Wv and Wo, then the LayerNorm scale and bias and its
    w out-bias columns; unpack_xattn gives pack_params' output back bit for
    bit."""
    mats, smalls = _weights(d, blocks)
    packed = pack_xattn(mats, smalls)
    w = d // CLUSTER
    assert packed.shape == (blocks, CLUSTER, 4 * d * w + 2 * d + w) and packed.is_contiguous()
    m, s = mats.numpy(), smalls.numpy()
    for b in range(blocks):
        for c in range(CLUSTER):
            run = packed[b, c].numpy()
            cols = np.concatenate([np.arange(c * w, (c + 1) * w) + p * d for p in range(4)])
            np.testing.assert_array_equal(run[:4 * d * w].reshape(d, 4 * w), m[b][:, cols])
            np.testing.assert_array_equal(run[4 * d * w:4 * d * w + 2 * d], s[b, :2].ravel())
            np.testing.assert_array_equal(run[4 * d * w + 2 * d:], s[b, 2, c * w:(c + 1) * w])
    mats2, smalls2 = unpack_xattn(packed, d)
    torch.testing.assert_close(mats2, mats, atol=0, rtol=0)
    torch.testing.assert_close(smalls2, smalls, atol=0, rtol=0)


def test_cluster_route():
    assert [h for h in (1, 2, 4, 8, 16) if cluster_route(128, h)] == [1, 2, 4, 8]
    assert not cluster_route(256, 4) and not cluster_route(64, 4)


def _module(c):
    """The port's module holding the JAX case's weights (kernels [in, out])."""
    m = BidirectionalCrossTransformer(c["d"], depth=c["depth"], heads=c["heads"],
                                      dim_head=c["d"] // c["heads"], use_fused=True)
    p = c["params"]
    sd = {}
    for i in range(c["depth"]):
        for j, ln, att in ((0, f"space_norm_{i}", f"space_attend_freq_{i}"),
                           (2, f"freq_norm_{i}", f"freq_attend_space_{i}")):
            sd[f"layers.{i}.{j}.weight"] = p[ln]["scale"]
            sd[f"layers.{i}.{j}.bias"] = p[ln]["bias"]
            a = p[att]
            sd[f"layers.{i}.{j + 1}.to_q.weight"] = a["to_q"]["kernel"].T
            sd[f"layers.{i}.{j + 1}.to_kv.weight"] = a["to_kv"]["kernel"].T
            sd[f"layers.{i}.{j + 1}.to_out.0.weight"] = a["to_out"]["kernel"].T
            sd[f"layers.{i}.{j + 1}.to_out.0.bias"] = a["to_out"]["bias"]
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return m.eval()


@torch.no_grad()
def test_module_fused_path_matches_jax_kernel(xattn_case):  # noqa: F811
    """The module's kept pack and the packed entry give the JAX kernel's
    output (interpret mode) within 1e-5, and launch nothing on the CPU."""
    c = xattn_case
    flat_j = jax_params_from_module_tree(c["params"], c["depth"])
    refs = jax_fused_xattn(jnp.asarray(c["s"][:, 0]), jnp.asarray(c["f"][:, 0]),
                           flat_j, depth=c["depth"], heads=c["heads"], interpret=True)
    m = _module(c)
    before = dict(extension.LAUNCHES)
    s, f = torch.from_numpy(c["s"]), torch.from_numpy(c["f"])
    so, fo = m(s, f)
    assert so.shape == s.shape and fo.shape == f.shape
    packed = m._xattn_weights()
    torch.testing.assert_close(packed, pack_xattn(*pack_params(m.flat_params(), c["depth"])),
                               atol=0, rtol=0)
    direct = fused_bidirectional_cross_attention_packed(s[:, 0], f[:, 0], packed,
                                                        heads=c["heads"])
    for got, again, ref in zip((so[:, 0], fo[:, 0]), direct, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(again, got, atol=0, rtol=0)
    assert extension.LAUNCHES == before


@torch.no_grad()
def test_module_keeps_pack_and_drops_it(xattn_case):  # noqa: F811
    """The pack is kept across calls; train(), load_state_dict and an
    in-place LayerNorm edit drop it or make the next call pack again."""
    m = _module(xattn_case)
    s, f = torch.from_numpy(xattn_case["s"]), torch.from_numpy(xattn_case["f"])
    assert m._xattn is None
    m(s, f)
    kept = m._xattn
    m(s, f)
    assert m._xattn is kept
    m.train()
    assert m._xattn is None
    m.eval()
    m(s, f)
    m.load_state_dict({k: v.clone() for k, v in m.state_dict().items()})
    assert m._xattn is None
    m(s, f)
    kept = m._xattn
    m.layers[1][2].weight.mul_(2.0)
    out = m(s, f)
    assert m._xattn is not kept and m._xattn[0] != kept[0]
    unfused = BidirectionalCrossTransformer(128, depth=2, heads=xattn_case["heads"],
                                            dim_head=128 // xattn_case["heads"])
    unfused.load_state_dict(m.state_dict())
    for a, b in zip(out, unfused.eval()(s, f)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5)
    m.drop_kept_weights()
    assert m._xattn is None


def test_packed_entry_rejects_bad_shapes():
    s = torch.zeros(2, 128)
    packed = pack_xattn(*_weights(128, 4))
    with pytest.raises(ValueError, match="packed"):
        fused_bidirectional_cross_attention_packed(s, s, packed[:, :, :-4], heads=4)
    with pytest.raises(ValueError, match="packed"):
        fused_bidirectional_cross_attention_packed(s, s, packed[:3], heads=4)
    with pytest.raises(ValueError, match="heads"):
        fused_bidirectional_cross_attention_packed(s, s, packed, heads=3)
    # D = 256 has no cluster kernel: its module keeps mats/smalls for the general one
    m = BidirectionalCrossTransformer(256, depth=1, heads=4, dim_head=64, use_fused=True)
    mats, smalls = m.eval()._xattn_weights()
    assert mats.shape == (2, 256, 1024) and smalls.shape == (2, 3, 256)
    x = torch.randn(3, 1, 256)
    with torch.no_grad():
        so, fo = m(x, x)
    ref = fused_bidirectional_cross_attention(x[:, 0], x[:, 0], mats, smalls, heads=4)
    torch.testing.assert_close(so[:, 0], ref[0], atol=0, rtol=0)
