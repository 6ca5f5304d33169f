"""JAX variables -> the port's ``state_dict`` (reference torch names).

Input: the JAX package's DeepfakeDetector variables as numpy trees
``{'params': ..., 'batch_stats': ...}`` (e.g. ``jax.tree_util.tree_map(
np.asarray, variables)``). Output: a ``{name: torch.Tensor}`` dict for the
port's whole ``DeepfakeDetector`` (``dama``, ``mwt``, ``sfe``, ``sfe_cls``,
``fusion_gate``, ``classifier``), which loads with ``strict=True``. Own copy
of the name mapping of ewvit_tpu/utils/torch_convert.py:130-296; the
backbone stacks follow ``ModelConfig.b0_spec``/``v2s_spec``, so truncated
(micro) configs convert too.

Layout transforms: Linear kernel ``[in, out]`` -> weight ``[out, in]``; Conv
HWIO -> OIHW (depthwise too); BatchNorm ``scale/bias`` + ``mean/var`` ->
``weight/bias/running_mean/running_var`` (+ ``num_batches_tracked = 0``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ewvit_tpu_torch.configs import ModelConfig

Path = Tuple[str, ...]


class _Builder:
    def __init__(self, variables: Mapping):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: Dict[str, torch.Tensor] = {}

    @staticmethod
    def _get(tree, path: Path) -> np.ndarray:
        node = tree
        for p in path:
            node = node[p]
        return np.asarray(node, dtype=np.float32)

    def _has(self, path: Path) -> bool:
        node = self.params
        for p in path:
            if not isinstance(node, Mapping) or p not in node:
                return False
            node = node[p]
        return True

    def _put(self, name: str, arr: np.ndarray):
        self.sd[name] = torch.from_numpy(np.ascontiguousarray(arr))

    def raw(self, name: str, path: Path):
        self._put(name, self._get(self.params, path))

    def linear(self, name: str, path: Path, bias: bool = True):
        self._put(f"{name}.weight", self._get(self.params, path + ("kernel",)).T)
        if bias:
            self._put(f"{name}.bias", self._get(self.params, path + ("bias",)))

    def conv(self, name: str, path: Path, bias: bool = False):
        k = self._get(self.params, path + ("kernel",))
        self._put(f"{name}.weight", k.transpose(3, 2, 0, 1))
        if bias:
            self._put(f"{name}.bias", self._get(self.params, path + ("bias",)))

    def layernorm(self, name: str, path: Path):
        self._put(f"{name}.weight", self._get(self.params, path + ("scale",)))
        self._put(f"{name}.bias", self._get(self.params, path + ("bias",)))

    def bn(self, name: str, path: Path):
        self.layernorm(name, path)
        self._put(f"{name}.running_mean", self._get(self.stats, path + ("mean",)))
        self._put(f"{name}.running_var", self._get(self.stats, path + ("var",)))
        self.sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def conv_bn(self, name: str, path: Path):
        """torchvision Conv2dNormActivation ``{name}.{0,1}`` <- ConvBN."""
        self.conv(f"{name}.0", path + ("conv",))
        self.bn(f"{name}.1", path + ("bn",))


def _v2s(b: _Builder, t: str, f: Path, cfg: ModelConfig):
    n = f + ("net",)
    b.conv_bn(f"{t}.features.0", n + ("stem",))
    blocks = cfg.v2s_spec.blocks
    for si, bc in enumerate(blocks):
        for r in range(bc.repeats):
            blk = f"{t}.features.{si + 1}.{r}.block"
            fb = n + (f"block_{si}_{r}",)
            if bc.fused:
                b.conv_bn(f"{blk}.0", fb + ("fused_expand",))
                if bc.expand != 1:
                    b.conv_bn(f"{blk}.1", fb + ("project",))
                continue
            j = 0
            if bc.expand != 1:
                b.conv_bn(f"{blk}.0", fb + ("expand_conv",))
                j = 1
            b.conv_bn(f"{blk}.{j}", fb + ("depthwise",))
            b.conv(f"{blk}.{j + 1}.fc1", fb + ("se", "reduce"), bias=True)
            b.conv(f"{blk}.{j + 1}.fc2", fb + ("se", "expand"), bias=True)
            b.conv_bn(f"{blk}.{j + 2}", fb + ("project",))
    b.conv_bn(f"{t}.features.{len(blocks) + 1}", n + ("head",))


def _b0(b: _Builder, t: str, f: Path, cfg: ModelConfig):
    """efficientnet_pytorch names; ``_blocks.{i}`` runs flat across stages."""
    n = f + ("net",)
    b.conv(f"{t}._conv_stem", n + ("stem", "conv"))
    b.bn(f"{t}._bn0", n + ("stem", "bn"))
    idx = 0
    for si, bc in enumerate(cfg.b0_spec.blocks):
        for r in range(bc.repeats):
            blk, fb = f"{t}._blocks.{idx}", n + (f"block_{si}_{r}",)
            if bc.expand != 1:
                b.conv(f"{blk}._expand_conv", fb + ("expand_conv", "conv"))
                b.bn(f"{blk}._bn0", fb + ("expand_conv", "bn"))
            b.conv(f"{blk}._depthwise_conv", fb + ("depthwise", "conv"))
            b.bn(f"{blk}._bn1", fb + ("depthwise", "bn"))
            b.conv(f"{blk}._se_reduce", fb + ("se", "reduce"), bias=True)
            b.conv(f"{blk}._se_expand", fb + ("se", "expand"), bias=True)
            b.conv(f"{blk}._project_conv", fb + ("project", "conv"))
            b.bn(f"{blk}._bn2", fb + ("project", "bn"))
            idx += 1
    b.conv(f"{t}._conv_head", n + ("head", "conv"))
    b.bn(f"{t}._bn1", n + ("head", "bn"))


def _efficientvit(b: _Builder, t: str, f: Path, cfg: ModelConfig, backbone: str):
    net = {"b0": _b0, "v2s": _v2s}[backbone]
    net(b, f"{t}.efficient_net", f + ("efficient_net",), cfg)
    b.raw(f"{t}.pos_embedding", f + ("pos_embedding",))
    b.raw(f"{t}.cls_token", f + ("cls_token",))
    b.linear(f"{t}.patch_to_embedding", f + ("patch_to_embedding",))
    tf = f + ("transformer",)
    for i in range(cfg.arch.depth):
        L = f"{t}.transformer.layers.{i}"
        b.layernorm(f"{L}.0.norm", tf + (f"attn_norm_{i}",))
        b.linear(f"{L}.0.fn.to_qkv", tf + (f"attn_{i}", "to_qkv"), bias=False)
        if b._has(tf + (f"attn_{i}", "to_out")):
            b.linear(f"{L}.0.fn.to_out.0", tf + (f"attn_{i}", "to_out"))
        b.layernorm(f"{L}.1.norm", tf + (f"ff_norm_{i}",))
        b.linear(f"{L}.1.fn.net.0", tf + (f"ff_{i}", "fc1"))
        b.linear(f"{L}.1.fn.net.3", tf + (f"ff_{i}", "fc2"))
    b.linear(f"{t}.mlp_head.0", f + ("mlp_head_fc1",))
    b.linear(f"{t}.mlp_head.2", f + ("mlp_head_fc2",))
    b.linear(f"{t}.feat_map.0", f + ("feat_map",))


def _mwt(b: _Builder, t: str, f: Path):
    for i in range(3):
        b.conv(f"{t}.hf_conv.seperate.{i}.0", f + (f"hf_sep_{i}", "conv"), bias=True)
        b.bn(f"{t}.hf_conv.seperate.{i}.1", f + (f"hf_sep_{i}", "bn"))
    for tname, fname in (("hf_conv.fusion", "hf_fusion"),
                         ("multiscale_fusion", "multiscale_fusion"),
                         ("freq_conv", "freq_conv")):
        b.conv(f"{t}.{tname}.0", f + (fname, "conv"), bias=True)
        b.bn(f"{t}.{tname}.1", f + (fname, "bn"))
    b.conv(f"{t}.freq_pool.1", f + ("freq_pool_conv", "conv"), bias=True)
    b.bn(f"{t}.freq_pool.2", f + ("freq_pool_conv", "bn"))


def _cross(b: _Builder, t: str, f: Path, depth: int = 2):
    for i in range(depth):
        L = f"{t}.layers.{i}"
        for j, norm, att in ((0, f"space_norm_{i}", f"space_attend_freq_{i}"),
                             (2, f"freq_norm_{i}", f"freq_attend_space_{i}")):
            b.layernorm(f"{L}.{j}", f + (norm,))
            b.linear(f"{L}.{j + 1}.to_q", f + (att, "to_q"), bias=False)
            b.linear(f"{L}.{j + 1}.to_kv", f + (att, "to_kv"), bias=False)
            b.linear(f"{L}.{j + 1}.to_out.0", f + (att, "to_out"))


def jax_to_state_dict(variables: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX DeepfakeDetector variables (numpy trees) -> port ``state_dict``."""
    b = _Builder(variables)
    _efficientvit(b, "dama.sfe", ("dama", "sfe"), cfg, "v2s")
    _mwt(b, "dama.mwt", ("dama", "mwt"))
    _cross(b, "dama.cross_att", ("dama", "cross_att"))
    b.conv("dama.fusion_gate.0", ("dama", "fusion_gate_conv"), bias=True)
    b.bn("dama.fusion_gate.1", ("dama", "fusion_gate_bn"))
    b.linear("dama.gate_net.2", ("dama", "gate_fc1"))
    b.linear("dama.gate_net.5", ("dama", "gate_fc2"))
    _mwt(b, "mwt", ("mwt",))
    _efficientvit(b, "sfe", ("sfe",), cfg, "b0")
    _efficientvit(b, "sfe_cls", ("sfe_cls",), cfg, "b0")
    b.linear("fusion_gate.0", ("fusion_gate_fc",))
    b.linear("classifier.0", ("classifier_fc1",))
    b.linear("classifier.3", ("classifier_fc2",))
    return b.sd
