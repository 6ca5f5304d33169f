"""The port's dynamic detector held against the JAX package on the CPU (fp32).

One set of JAX variables (shapes from ``init_detector_fast``, values refilled
from ``np.random.default_rng`` so every BatchNorm, LayerNorm and bias is
non-trivial) is converted by ``ewvit_tpu_torch.utils.convert`` and loaded
into the port with ``strict=True``. The config is ``ModelConfig.micro()``
widened where the kernels need it: ``dama_dim`` 128 with 4 heads, so the
fused cross-attention path (K4) engages, and a fourth V2-S block that is a
stride-1 squeeze-excite MBConv, so the fused depthwise path (K2) engages.
The JAX side runs its kernels as its own tests do: K2 and K4 in interpret
mode; ``use_pallas_dwt`` off there (its conv reference runs), on in the port.
Tolerances: backbone, MWT and DAMA features 1e-4; logits 1e-3 (BASELINE.json's
logit tolerance); probabilities 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ewvit_tpu.configs import ModelConfig as JaxConfig
from ewvit_tpu.models import efficientnet as je
from ewvit_tpu.models.dama import DAMA as JaxDAMA
from ewvit_tpu.models.detector import init_detector_fast
from ewvit_tpu.models.detector import video_forward as jax_video_forward
from ewvit_tpu.models.mwt import MWT as JaxMWT
from ewvit_tpu.serving import InferenceEngine as JaxEngine
from ewvit_tpu_torch import InferenceEngine, build_detector, video_forward
from ewvit_tpu_torch import configs as pc
from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.utils.convert import jax_to_state_dict

SE_S1 = dict(repeats=1, kernel=3, stride=1, expand=2, in_ch=16, out_ch=16,
             se_ratio=0.25)
FLAGS = dict(dama_dim=128, num_heads=4, use_pallas_dwse=True, use_pallas_dama=True)
B, K, CHUNK = 2, 5, 2          # K % CHUNK != 0: a ragged, masked tail chunk

JCFG = JaxConfig.micro().replace(
    backbone_spec=(je.B0_MICRO, je.BackboneSpec(
        je.V2S_MICRO.blocks + (je.BlockCfg(**SE_S1),), stem_ch=8, head_ch=32)),
    **FLAGS)
PCFG = pc.ModelConfig.micro().replace(
    backbone_spec=(None, pc.BackboneSpec(
        pc.V2S_MICRO.blocks + (pc.BlockCfg(**SE_S1),), stem_ch=8, head_ch=32)),
    use_pallas_dwt=True, **FLAGS)


def _fill(variables, seed):
    g = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "var":
            a = g.uniform(0.5, 1.5, shape)
        elif name in ("mean", "bias"):
            a = 0.1 * g.standard_normal(shape)
        elif name == "scale":
            a = 1.0 + 0.1 * g.standard_normal(shape)
        elif name in ("pos_embedding", "cls_token"):
            a = g.standard_normal(shape)
        else:                       # conv HWIO / dense [in, out] kernels
            a = g.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(fill, variables)


@pytest.fixture(scope="module")
def pair():
    jmodel, shapes = init_detector_fast(JCFG, seed=0)
    jvars = _fill(shapes, seed=1)
    port = build_detector(PCFG, device="cpu", seed=0)
    port.load_state_dict(jax_to_state_dict(jvars, PCFG), strict=True)
    return jmodel, jvars, port


@pytest.fixture(scope="module")
def frames():
    x = np.random.default_rng(2).standard_normal(
        (B, K, 32, 32, 3)).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3)))


def _sub(jvars, *path):
    out = {}
    for coll in ("params", "batch_stats"):
        node = jvars[coll]
        for p in path:
            node = node[p]
        out[coll] = node
    return out


def test_state_dict_keys_match_reference_names(pair):
    _, jvars, port = pair
    sd = jax_to_state_dict(jvars, PCFG)
    assert set(sd) == set(port.state_dict())
    for name in ("dama.sfe.efficient_net.features.0.0.weight",
                 "dama.sfe.efficient_net.features.4.0.block.3.1.running_var",
                 "dama.sfe.efficient_net.features.4.0.block.2.fc1.weight",
                 "dama.sfe.transformer.layers.0.0.fn.to_qkv.weight",
                 "dama.mwt.hf_conv.seperate.2.0.weight", "dama.mwt.freq_pool.2.bias",
                 "dama.cross_att.layers.1.3.to_kv.weight", "dama.fusion_gate.1.running_mean",
                 "dama.gate_net.5.weight", "classifier.3.bias"):
        assert name in sd, name


def test_v2s_micro_features(pair, frames):
    _, jvars, port = pair
    x, xt = frames
    sub = _sub(jvars, "dama", "sfe", "efficient_net")
    net = je.EfficientNetV2S(use_pallas_dwse=True, spec=JCFG.backbone_spec[1])
    ref = np.asarray(net.apply(sub, jnp.asarray(x[:, 0])))
    with torch.no_grad():
        got = port.dama.sfe.efficient_net(xt[:, 0])
    np.testing.assert_allclose(got.numpy(), ref.transpose(0, 3, 1, 2),
                               atol=1e-4, rtol=1e-4)


def test_mwt(pair, frames):
    _, jvars, port = pair
    x, xt = frames
    mwt = JaxMWT(in_channels=3, dama_dim=JCFG.dama_dim, levels=JCFG.levels)
    ref = np.asarray(mwt.apply(_sub(jvars, "dama", "mwt"), jnp.asarray(x[:, 0])))
    with torch.no_grad():
        got = port.dama.mwt(xt[:, 0])
    assert got.shape == (B, JCFG.dama_dim, 1, 1)
    np.testing.assert_allclose(got.numpy()[:, :, 0, 0], ref[:, 0, 0],
                               atol=1e-4, rtol=1e-4)


def test_dama(pair, frames):
    _, jvars, port = pair
    x, xt = frames
    dama = JaxDAMA(arch=JCFG.arch, dim=JCFG.dama_dim, num_heads=JCFG.num_heads,
                   levels=JCFG.levels, use_pallas_dama=True, use_pallas_dwse=True,
                   backbone_spec=JCFG.backbone_spec)
    flat = x[:, :CHUNK].reshape(B * CHUNK, 32, 32, 3)
    ref = dama.apply(_sub(jvars, "dama"), jnp.asarray(flat))
    with torch.no_grad():
        got = port.dama(xt[:, :CHUNK].reshape(B * CHUNK, 3, 32, 32))
    for key in ("fused", "space", "freq"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)


def test_video_forward_dynamic_ragged_logits(pair, frames):
    jmodel, jvars, port = pair
    x, xt = frames
    ref, _ = jax_video_forward(jmodel, jvars, jnp.asarray(x), mode="dynamic",
                               frame_chunk=CHUNK, remat=False)
    got = video_forward(port, xt, frame_chunk=CHUNK)
    assert got["logits"].shape == (B, 1)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(ref["logits"]),
                               atol=1e-3, rtol=0)
    for key in ("fused", "space", "freq"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)


def test_inference_engine_matches_jax(pair):
    jmodel, jvars, port = pair
    clips = np.random.default_rng(3).integers(0, 256, (B, K, 32, 32, 3), np.uint8)
    want = JaxEngine(jmodel, jvars, frame_chunk=CHUNK).predict(clips)
    engine = InferenceEngine(port, frame_chunk=CHUNK, device="cpu")
    before = dict(extension.LAUNCHES)
    got = engine.predict(clips)
    assert extension.LAUNCHES == before     # CPU tensors never launch a kernel
    assert got.shape == (B,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    streamed = list(engine.predict_stream(iter([clips, clips[:, ::-1], clips])))
    assert len(streamed) == 3
    np.testing.assert_array_equal(streamed[0], got)
    np.testing.assert_array_equal(streamed[2], got)
    np.testing.assert_allclose(streamed[1], engine.predict(clips[:, ::-1]),
                               atol=1e-6, rtol=0)


def test_unfused_paths_match_fused(pair, frames):
    """Kernel flags off (plain modules) == flags on (plain kernel versions)."""
    _, jvars, port = pair
    _, xt = frames
    plain_cfg = dataclasses.replace(PCFG, use_pallas_dwse=False,
                                    use_pallas_dama=False, use_pallas_dwt=False)
    plain = build_detector(plain_cfg, device="cpu")
    plain.load_state_dict(port.state_dict(), strict=True)
    a = video_forward(port, xt, frame_chunk=CHUNK)
    b = video_forward(plain, xt, frame_chunk=CHUNK)
    for key in a:
        torch.testing.assert_close(a[key], b[key], atol=1e-4, rtol=1e-4)


def test_calibrated_random_detector_is_well_scaled():
    """random_detector's BN calibration normalises the backbone's BNs, so a
    random full-depth model answers differently for different inputs."""
    from ewvit_tpu_torch.models.detector import random_detector
    from ewvit_tpu_torch.models.efficientnet import ConvBNAct
    from ewvit_tpu_torch.models.norm import calibrate_batchnorm_

    block = ConvBNAct(3, 8, 3, act=False)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 3, 8, 8)).astype(np.float32)) * 5 + 2
    calibrate_batchnorm_(block, x)
    assert not block.training
    with torch.no_grad():
        y = block(x)
    torch.testing.assert_close(y.mean(dim=(0, 2, 3)), torch.zeros(8), atol=1e-5, rtol=0)
    # eps 1e-3 against a variance of ~25 leaves a 1e-4 relative shortfall
    torch.testing.assert_close(y.var(dim=(0, 2, 3)), torch.ones(8), atol=1e-3, rtol=0)

    model = random_detector(PCFG, device="cpu", seed=0, calib_frames=4)
    clips = np.random.default_rng(5).integers(0, 256, (2, 2, 32, 32, 3), np.uint8)
    probs = InferenceEngine(model, frame_chunk=CHUNK, device="cpu").predict(clips)
    assert np.isfinite(probs).all() and ((probs > 0) & (probs < 1)).all()
    assert abs(probs[0] - probs[1]) > 1e-4


@pytest.mark.parametrize("pos_mode", ["reference", "tile", "row0"])
def test_sfe_pos_modes(pair, pos_mode):
    """Flattened row i gets pos row i (reference, capped at emb_dim), i %
    emb_dim (tile) or 0 (row0): identical frames at rows that share a pos
    row give identical features."""
    from ewvit_tpu_torch.models.sfe import EfficientViT

    _, _, port = pair
    sfe = EfficientViT(PCFG.arch, feat_dim=PCFG.dama_dim, pos_mode=pos_mode,
                       backbone_spec=PCFG.v2s_spec).eval()
    sfe.load_state_dict(port.dama.sfe.state_dict(), strict=True)
    emb = PCFG.arch.emb_dim
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (emb + 2, 3, 32, 32)).astype(np.float32))
    x[emb:] = x[:2]                         # rows emb, emb+1 repeat rows 0, 1
    x[2] = x[0]                             # row 2 repeats row 0
    with torch.no_grad():
        if pos_mode == "reference":
            with pytest.raises(ValueError, match="emb_dim"):
                sfe(x)
            out = sfe(x[:emb])
            # port.dama.sfe runs K2's plain version, this one the unfused modules
            torch.testing.assert_close(out, port.dama.sfe(x[:emb]), atol=1e-5, rtol=1e-5)
            assert not torch.allclose(out[2], out[0])   # other pos rows
            return
        out = sfe(x)
    torch.testing.assert_close(out[emb:], out[:2], atol=1e-5, rtol=1e-5)
    assert torch.allclose(out[2], out[0], atol=1e-5) == (pos_mode == "row0")
