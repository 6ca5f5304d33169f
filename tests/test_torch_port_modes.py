"""The port's three ablation modes held against the JAX package on the CPU (fp32).

Covers the B0 backbone (TF 'SAME' padding, efficientnet_pytorch names, K2 on
its stride-1 SE blocks), the ``sfe``/``sfe_cls`` EfficientViTs, the
standalone MWT, the ``fusion_gate`` head, ``video_forward`` and
``InferenceEngine`` in ``dynamic``, ``sfe_only`` and ``sfe_mwt``, and the
full reference weight layout.

One set of JAX variables (``init_detector_fast`` shapes, refilled from a
seeded ``np.random.default_rng`` as in ``test_torch_port_model.py``) is
converted by ``ewvit_tpu_torch.utils.convert`` and loaded with
``strict=True``. The config is ``ModelConfig.micro()`` with ``dama_dim``
128 and 4 heads (so K4 engages), a stride-1 SE MBConv appended to the V2-S
stack and a k5 stride-1 SE block appended to the B0 stack (so K2 engages
at k3 and k5 in both backbones), and the fused MWT tail (K3, under its gate
at 32 px). The JAX side runs its kernels as its own tests do: K2 and K4 in
interpret mode, K3 under its gate, and the conv reference for K1 (its
``use_pallas_dwt`` off); the port runs with every kernel flag on (their
plain versions on the CPU) and with every flag off. Tolerances: backbone
and SFE outputs 1e-4; video features 1e-4; logits 1e-3 (BASELINE.json's
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
from ewvit_tpu.models.detector import init_detector_fast
from ewvit_tpu.models.detector import video_forward as jax_video_forward
from ewvit_tpu.models.sfe import EfficientViT as JaxEfficientViT
from ewvit_tpu.serving import InferenceEngine as JaxEngine
from ewvit_tpu.utils.torch_convert import conversion_plan
from ewvit_tpu_torch import ABLATION_MODES, InferenceEngine, build_detector, video_forward
from ewvit_tpu_torch import configs as pc
from ewvit_tpu_torch.models.detector import DeepfakeDetector, random_detector
from ewvit_tpu_torch.models.efficientnet import EfficientNetB0, MBConvBlock, same_padding
from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops.mwt_tail import multiscale_winograd_u
from ewvit_tpu_torch.utils import convert
from ewvit_tpu_torch.utils.convert import jax_to_state_dict

from test_torch_port_model import SE_S1, _fill, _sub

B, K, CHUNK = 2, 5, 2          # K % CHUNK != 0: a ragged, masked tail chunk
B0_K5_S1 = dict(repeats=1, kernel=5, stride=1, expand=2, in_ch=16, out_ch=16)
B0_K5_S2 = dict(repeats=1, kernel=5, stride=2, expand=2, in_ch=16, out_ch=24)
B0_K5_S1_24 = dict(repeats=1, kernel=5, stride=1, expand=2, in_ch=24, out_ch=24)
FLAGS = dict(dama_dim=128, num_heads=4, use_pallas_dwse=True, use_pallas_dama=True,
             use_fused_mwt_tail=True)
OFF = dict(use_pallas_dwse=False, use_pallas_dama=False, use_fused_mwt_tail=False,
           use_pallas_dwt=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes that share the cores, and torch's default of
    one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(mod, base, *extra):
    return mod.BackboneSpec(base.blocks + tuple(mod.BlockCfg(**e) for e in extra),
                            stem_ch=base.stem_ch, head_ch=base.head_ch)


JCFG = JaxConfig.micro().replace(
    backbone_spec=(_spec(je, je.B0_MICRO, B0_K5_S1), _spec(je, je.V2S_MICRO, SE_S1)),
    **FLAGS)
PCFG = pc.ModelConfig.micro().replace(
    backbone_spec=(_spec(pc, pc.B0_MICRO, B0_K5_S1), _spec(pc, pc.V2S_MICRO, SE_S1)),
    use_pallas_dwt=True, **FLAGS)


@pytest.fixture(scope="module")
def pair():
    jmodel, shapes = init_detector_fast(JCFG, seed=0)
    jvars = _fill(shapes, seed=11)
    sd = jax_to_state_dict(jvars, PCFG)
    ports = {}
    for flags, cfg in (("on", PCFG), ("off", PCFG.replace(**OFF))):
        ports[flags] = build_detector(cfg, device="cpu", seed=0)
        ports[flags].load_state_dict(sd, strict=True)
    return jmodel, jvars, ports


@pytest.fixture(scope="module")
def frames():
    x = np.random.default_rng(12).standard_normal((B, K, 32, 32, 3)).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3)))


@pytest.fixture(scope="module")
def jax_outputs(pair, frames):
    """JAX ``video_forward`` per mode, computed once."""
    jmodel, jvars, _ = pair
    x, _ = frames
    cache = {}

    def get(mode):
        if mode not in cache:
            out, _ = jax_video_forward(jmodel, jvars, jnp.asarray(x), mode=mode,
                                       frame_chunk=CHUNK, remat=False)
            cache[mode] = {k: np.asarray(v) for k, v in out.items()}
        return cache[mode]
    return get


# ------------------------------------------------------------------ tables


def test_b0_tables_match_jax():
    for a, b in ((je.B0_BLOCKS, pc.B0_BLOCKS), (je.B0_MICRO.blocks, pc.B0_MICRO.blocks)):
        assert [dataclasses.asdict(x) for x in a] == [dataclasses.asdict(x) for x in b]
    assert (pc.B0_MICRO.stem_ch, pc.B0_MICRO.head_ch) == (je.B0_MICRO.stem_ch,
                                                          je.B0_MICRO.head_ch)
    assert pc.B0_FULL == pc.BackboneSpec(pc.B0_BLOCKS, stem_ch=32, head_ch=1280)
    assert pc.ModelConfig().b0_spec == pc.B0_FULL
    assert pc.ModelConfig.micro().b0_spec == pc.B0_MICRO
    assert pc.ModelConfig.micro().replace(backbone_spec=(None, pc.V2S_MICRO)).b0_spec \
        == pc.B0_FULL


@pytest.mark.parametrize("side,k,s,want", [
    (224, 3, 2, (0, 1)), (56, 5, 2, (1, 2)), (14, 5, 2, (1, 2)), (35, 3, 2, (1, 1)),
    (9, 3, 2, (1, 1)), (18, 3, 2, (0, 1)), (14, 5, 1, (2, 2)), (7, 3, 1, (1, 1)),
    (5, 5, 2, (2, 2)), (4, 5, 2, (1, 2))])
def test_same_padding_matches_tf(side, k, s, want):
    """TF 'SAME': total max((ceil(n/s)-1)*s + k - n, 0), the smaller half
    before; checked against the padded size JAX's 'SAME' conv gives."""
    assert same_padding(side, side, k, s) == (*want, *want)
    out = jax.lax.conv_general_dilated(
        jnp.zeros((1, side, side, 1)), jnp.ones((k, k, 1, 1)), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert out.shape[1] == -(-side // s) == (side + sum(want) - k) // s + 1


# ------------------------------------------------------------------ B0


@pytest.mark.parametrize("side", [32, 35])
@pytest.mark.parametrize("dwse", [True, False])
def test_b0_backbone_matches_jax(side, dwse):
    """B0 alone with a k5 stride-2 block and a k5 stride-1 SE block (K2 at
    k3 and k5), at an even and an odd input side."""
    jspec = _spec(je, je.B0_MICRO, B0_K5_S2, B0_K5_S1_24)
    pspec = _spec(pc, pc.B0_MICRO, B0_K5_S2, B0_K5_S1_24)
    net = je.EfficientNetB0(use_pallas_dwse=True, spec=jspec)
    x = np.random.default_rng(side).standard_normal((3, side, side, 3)).astype(np.float32)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.asarray(x))
    jvars = _fill(shapes, seed=13)
    ref = np.asarray(jax.jit(net.apply)(jvars, jnp.asarray(x)))

    builder = convert._Builder(jvars)
    convert._b0(builder, "m", (), pc.ModelConfig().replace(backbone_spec=(pspec, None)))
    port = EfficientNetB0(pspec, use_pallas_dwse=dwse).eval()
    port.load_state_dict({k[2:]: v for k, v in builder.sd.items()}, strict=True)
    fused = [blk.fuse_dwse for blk in port._blocks]
    assert fused == [dwse, False, False, False, dwse]
    assert [blk.drop_rate for blk in port._blocks] == [0.2 * i / 5 for i in range(5)]
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert got.shape == (3, 32, -(-side // 16), -(-side // 16))   # four stride-2 convs
    np.testing.assert_allclose(got.numpy(), ref.transpose(0, 3, 1, 2), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("head", ["sfe_cls", "sfe"])
def test_b0_sfe_matches_jax(pair, frames, head):
    jmodel, jvars, ports = pair
    x, xt = frames
    mode = "cls" if head == "sfe_cls" else "feature_map"
    sfe = JaxEfficientViT(arch=JCFG.arch, channels=1280, selected_efficient_net=0,
                          feat_dim=JCFG.dama_dim, output_mode=mode, use_pallas_dwse=True,
                          backbone_spec=JCFG.backbone_spec)
    flat = x[:, :CHUNK].reshape(B * CHUNK, 32, 32, 3)
    ref = np.asarray(jax.jit(sfe.apply)(_sub(jvars, head), jnp.asarray(flat)))
    with torch.no_grad():
        got = getattr(ports["on"], head)(xt[:, :CHUNK].reshape(B * CHUNK, 3, 32, 32))
    if mode == "feature_map":
        ref = ref.transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------ modes


@pytest.mark.parametrize("flags", ["on", "off"])
@pytest.mark.parametrize("mode", ABLATION_MODES)
def test_video_forward_modes_match_jax(pair, frames, jax_outputs, mode, flags):
    _, _, ports = pair
    _, xt = frames
    ref = jax_outputs(mode)
    got = video_forward(ports[flags], xt, mode=mode, frame_chunk=CHUNK)
    assert set(got) == set(ref)
    assert got["logits"].shape == (B, 1)
    np.testing.assert_allclose(got["logits"].numpy(), ref["logits"], atol=1e-3, rtol=0)
    for key in set(ref) - {"logits"}:
        np.testing.assert_allclose(got[key].numpy(), ref[key], atol=1e-4, rtol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("mode", ABLATION_MODES)
def test_inference_engine_modes_match_jax(pair, mode):
    jmodel, jvars, ports = pair
    clips = np.random.default_rng(14).integers(0, 256, (B, K, 32, 32, 3), np.uint8)
    want = JaxEngine(jmodel, jvars, mode=mode, frame_chunk=CHUNK).predict(clips)
    port = build_detector(PCFG, device="cpu")
    port.load_state_dict(ports["on"].state_dict(), strict=True)
    before = dict(extension.LAUNCHES)
    engine = InferenceEngine(port, mode=mode, frame_chunk=CHUNK, device="cpu")
    # cast_for_inference kept every fold: the B0 blocks' and both MWTs'
    assert all(m._dwse is not None for m in port.modules()
               if isinstance(m, MBConvBlock) and m.fuse_dwse)
    assert port.mwt._tail is not None and port.dama.mwt._tail is not None
    got = engine.predict(clips)
    assert extension.LAUNCHES == before     # CPU tensors never launch a kernel
    assert got.shape == (B,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_modes_refused():
    model = build_detector(pc.ModelConfig.micro(), device="cpu")
    with pytest.raises(ValueError, match="ablation"):
        InferenceEngine(model, mode="both", device="cpu")
    with pytest.raises(ValueError, match="ablation"):
        video_forward(model, torch.zeros(1, 1, 3, 32, 32), mode="sfe")


def test_two_mwts_keep_their_own_tail(pair, frames):
    """The standalone MWT and DAMA's each fold U and bias from their own
    weights and keep them apart."""
    _, _, ports = pair
    _, xt = frames
    port = build_detector(PCFG, device="cpu")
    port.load_state_dict(ports["on"].state_dict(), strict=True)
    video_forward(port, xt, mode="sfe_mwt", frame_chunk=CHUNK)
    assert port.mwt._tail is not None and port.dama.mwt._tail is None
    video_forward(port, xt, mode="dynamic", frame_chunk=CHUNK)
    for mwt in (port.mwt, port.dama.mwt):
        conv, bn = mwt.multiscale_fusion[0], mwt.multiscale_fusion[1]
        scale, shift = bn.folded()
        u = multiscale_winograd_u(conv.weight, scale, mwt.levels, torch.float32)
        torch.testing.assert_close(mwt._tail[1], u, atol=0, rtol=0)
        torch.testing.assert_close(mwt._tail[2], conv.bias.float() * scale + shift,
                                   atol=0, rtol=0)
    assert not torch.equal(port.mwt._tail[1], port.dama.mwt._tail[1])


# ------------------------------------------------------------------ layout


def test_full_config_keys_equal_conversion_plan():
    """``ModelConfig()`` built on the meta device: its state dict carries the
    reference names of ``conversion_plan()``, ``num_batches_tracked`` aside."""
    with torch.device("meta"):
        model = DeepfakeDetector(pc.ModelConfig())
    keys = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    plan = {entry[0] for entry in conversion_plan()}
    assert keys == plan
    for name in ("sfe.efficient_net._conv_stem.weight",
                 "sfe_cls.efficient_net._blocks.15._bn2.running_var",
                 "sfe.efficient_net._bn1.weight", "mwt.freq_pool.2.bias",
                 "fusion_gate.0.weight", "sfe_cls.mlp_head.2.bias"):
        assert name in keys, name
    assert "sfe.efficient_net._blocks.0._expand_conv.weight" not in keys


def test_random_detector_modes_depend_on_input():
    """random_detector calibrates both B0 backbones: requests with other
    frames get other answers in sfe_only and sfe_mwt."""
    model = random_detector(pc.ModelConfig.micro(), device="cpu", seed=0, calib_frames=4)
    clips = np.random.default_rng(15).integers(0, 256, (2, 2, 32, 32, 3), np.uint8)
    for mode in ("sfe_only", "sfe_mwt"):
        probs = InferenceEngine(model, mode=mode, frame_chunk=CHUNK,
                                device="cpu").predict(clips)
        assert np.isfinite(probs).all() and ((probs > 0) & (probs < 1)).all(), mode
        assert abs(probs[0] - probs[1]) > 1e-4, mode
