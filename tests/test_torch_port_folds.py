"""Kept folds stay true to the weights they fold (CPU, fp32).

MBConv keeps K2's packed BN fold, the MWT K3's U and bias, and
BidirectionalCrossTransformer K4's packed weights, once per model in eval
mode. An in-place edit of a tensor a fold reads (under ``no_grad``, or a
child module's ``load_state_dict``, which copies in place and skips the
parent's ``_load_from_state_dict``) must make the next call fold again, as
the JAX package, which folds inside every ``apply``, always reads the
current parameters. Each case edits the kept-fold module and a twin on the
plain path the same way and holds them together with the kernel's
tolerance: K2 1e-5, K3 2e-4 (Winograd against the direct conv), K4 2e-5 /
1e-5 (fused stack against the unfused modules, as
test_torch_port_ops.py::test_fused_attention_plain_matches_jax_kernel).
"""

import numpy as np
import pytest
import torch

from ewvit_tpu_torch.models.efficientnet import MBConv
from ewvit_tpu_torch.models.layers import BidirectionalCrossTransformer
from ewvit_tpu_torch.models.mwt import MWT
from ewvit_tpu_torch.models.norm import calibrate_batchnorm_


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes that share the cores, and torch's default of
    one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edit(module, what):
    """Apply edit ``what`` in place to ``module``'s tensor of that name (or,
    for ``load:<child>``, load a changed state dict into that child)."""
    with torch.no_grad():
        if what.startswith("load:"):
            child = module.get_submodule(what[5:])
            sd = {k: v * 1.5 + 0.25 for k, v in child.state_dict().items()}
            child.load_state_dict(sd)
            return
        path, op = what.rsplit(".", 1)
        t = dict(module.named_parameters()).get(path)
        if t is None:
            t = module.get_buffer(path)
        {"mul": lambda: t.mul_(4.0), "add": lambda: t.add_(1.0),
         "copy": lambda: t.copy_(torch.flip(t, dims=[0]))}[op]()


def _twins(make, **flag):
    """(kept-fold module, plain twin) with the same weights, in eval mode."""
    fused = make(**flag)
    plain = make(**{k: False for k in flag})
    plain.load_state_dict(fused.state_dict())
    return fused.eval(), plain.eval()


# ------------------------------------------------------------- K2: MBConv

def _mbconv(use_pallas_dwse):
    torch.manual_seed(0)
    mb = MBConv(16, 16, 3, 1, 2, 0.25, use_pallas_dwse=use_pallas_dwse)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 9, 9)).astype(np.float32))
    return calibrate_batchnorm_(mb, x)


MB_X = torch.from_numpy(np.random.default_rng(1).standard_normal(
    (2, 16, 9, 9)).astype(np.float32))


@pytest.mark.parametrize("what", [
    "block.1.0.weight.mul", "block.1.1.weight.mul", "block.1.1.bias.add",
    "block.1.1.running_var.mul", "block.1.1.running_mean.add",
    "block.1.1.running_var.copy", "load:block.1.1", "load:block.1.0"])
@torch.no_grad()
def test_mbconv_fold_follows_in_place_edits(what):
    fused, plain = _twins(_mbconv, use_pallas_dwse=True)
    torch.testing.assert_close(fused(MB_X), plain(MB_X), atol=1e-5, rtol=1e-5)
    assert fused._dwse is not None
    for m in (fused, plain):
        _edit(m, what)
    torch.testing.assert_close(fused(MB_X), plain(MB_X), atol=1e-5, rtol=1e-5)


@torch.no_grad()
def test_mbconv_does_not_refold_without_an_edit():
    fused, _ = _twins(_mbconv, use_pallas_dwse=True)
    fused(MB_X)
    kept = fused._dwse
    bn = fused.block[1][1]
    versions = [t._version for t in (bn.weight, bn.running_var)]
    fused(MB_X)
    assert fused._dwse is kept
    assert [t._version for t in (bn.weight, bn.running_var)] == versions
    fused.drop_kept_weights()
    assert fused._dwse is None
    fused(MB_X)
    torch.testing.assert_close(fused._dwse[1], kept[1], atol=0, rtol=0)


# ----------------------------------------------------- K3: the MWT's tail

def _mwt(use_fused_tail):
    torch.manual_seed(1)
    mwt = MWT(3, dama_dim=16, levels=2, use_fused_tail=use_fused_tail)
    g = np.random.default_rng(2)
    with torch.no_grad():
        for m in mwt.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(0.1 * g.standard_normal(c)))
                m.running_var.copy_(torch.from_numpy(g.uniform(0.5, 1.5, c)))
                m.weight.copy_(torch.from_numpy(g.uniform(0.5, 1.5, c)))
                m.bias.copy_(torch.from_numpy(0.1 * g.standard_normal(c)))
    return mwt


MWT_X = torch.from_numpy(np.random.default_rng(3).standard_normal(
    (2, 3, 32, 32)).astype(np.float32))


@pytest.mark.parametrize("what", [
    "multiscale_fusion.0.weight.mul", "multiscale_fusion.0.bias.add",
    "multiscale_fusion.1.weight.mul", "multiscale_fusion.1.running_var.mul",
    "multiscale_fusion.1.running_mean.add", "load:multiscale_fusion"])
@torch.no_grad()
def test_mwt_tail_follows_in_place_edits(what):
    fused, plain = _twins(_mwt, use_fused_tail=True)
    torch.testing.assert_close(fused(MWT_X), plain(MWT_X), atol=2e-4, rtol=2e-4)
    assert fused._tail is not None
    for m in (fused, plain):
        _edit(m, what)
    torch.testing.assert_close(fused(MWT_X), plain(MWT_X), atol=2e-4, rtol=2e-4)


@torch.no_grad()
def test_mwt_does_not_refold_without_an_edit():
    fused, _ = _twins(_mwt, use_fused_tail=True)
    fused(MWT_X)
    kept = fused._tail
    fused(MWT_X)
    assert fused._tail is kept
    fused.drop_kept_weights()
    assert fused._tail is None


# ------------------------------------------- K4: the cross-attention stack

def _xattn(use_fused):
    torch.manual_seed(2)
    m = BidirectionalCrossTransformer(128, depth=2, heads=4, dim_head=32,
                                      use_fused=use_fused)
    g = np.random.default_rng(4)
    with torch.no_grad():      # LayerNorms away from their identity init
        for ln in (mod for mod in m.modules() if isinstance(mod, torch.nn.LayerNorm)):
            ln.weight.copy_(torch.from_numpy(1 + 0.1 * g.standard_normal(128)))
            ln.bias.copy_(torch.from_numpy(0.1 * g.standard_normal(128)))
    return m


_g = np.random.default_rng(5)
XA_S, XA_F = (torch.from_numpy(_g.standard_normal((6, 1, 128)).astype(np.float32))
              for _ in range(2))


@pytest.mark.parametrize("what", [
    "layers.0.0.weight.mul", "layers.1.2.bias.add", "layers.0.1.to_q.weight.mul",
    "layers.1.3.to_kv.weight.copy", "layers.0.3.to_out.0.bias.add", "load:layers.1.1"])
@torch.no_grad()
def test_xattn_pack_follows_in_place_edits(what):
    fused, plain = _twins(_xattn, use_fused=True)
    for a, b in zip(fused(XA_S, XA_F), plain(XA_S, XA_F)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5)
    assert fused._xattn is not None
    for m in (fused, plain):
        _edit(m, what)
    for a, b in zip(fused(XA_S, XA_F), plain(XA_S, XA_F)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5)
