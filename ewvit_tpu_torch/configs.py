"""Typed configuration for the PyTorch port of the Efficient Wavelet ViT.

Own copy of ``ewvit_tpu/configs.py`` (``ArchConfig``, ``ModelConfig``) and of
the backbone block tables of ``ewvit_tpu/models/efficientnet.py``
(``BlockCfg``, ``V2S_BLOCKS``, ``V2S_MICRO``, ``BackboneSpec``). The port
imports nothing of the JAX package, so the values are repeated here and the
CPU tests hold the two copies equal. ``TrainConfig`` and the B0 tables arrive
with the slices that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """ViT hyperparameters (reference config/architecture.yaml)."""

    image_size: int = 224
    patch_size: int = 7
    num_classes: int = 1
    dim: int = 512
    depth: int = 2
    dim_head: int = 64
    heads: int = 8
    mlp_dim: int = 2048
    emb_dim: int = 64          # quirk: also the max supported flattened batch
    dropout: float = 0.15
    emb_dropout: float = 0.15


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    repeats: int
    kernel: int
    stride: int
    expand: int
    in_ch: int
    out_ch: int
    se_ratio: float = 0.25
    fused: bool = False


# torchvision efficientnet_v2_s inverted_residual_setting
V2S_BLOCKS: Tuple[BlockCfg, ...] = (
    BlockCfg(2, 3, 1, 1, 24, 24, se_ratio=0.0, fused=True),
    BlockCfg(4, 3, 2, 4, 24, 48, se_ratio=0.0, fused=True),
    BlockCfg(4, 3, 2, 4, 48, 64, se_ratio=0.0, fused=True),
    BlockCfg(6, 3, 2, 4, 64, 128, se_ratio=0.25),
    BlockCfg(9, 3, 1, 6, 128, 160, se_ratio=0.25),
    BlockCfg(15, 3, 2, 6, 160, 256, se_ratio=0.25),
)


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    """Override for a backbone's block stack (used by :meth:`ModelConfig.micro`)."""

    blocks: Tuple[BlockCfg, ...]
    stem_ch: int
    head_ch: int


V2S_FULL = BackboneSpec(V2S_BLOCKS, stem_ch=24, head_ch=1280)

# 3 real blocks: FusedMBConv, fused stride-2, MBConv + SE; a 32px input lands
# on a 4x4 map, so patch_size 4 keeps the 1-patch invariant.
V2S_MICRO = BackboneSpec(
    blocks=(
        BlockCfg(1, 3, 1, 1, 8, 8, se_ratio=0.0, fused=True),
        BlockCfg(1, 3, 2, 2, 8, 16, se_ratio=0.0, fused=True),
        BlockCfg(1, 3, 2, 2, 16, 16, se_ratio=0.25),
    ),
    stem_ch=8, head_ch=32,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """DeepfakeDetector configuration (fields as in ewvit_tpu.configs).

    The kernel flags select the hand-written CUDA kernels of
    ``ewvit_tpu_torch.ops``; each runs only on CUDA tensors, and a CPU tensor
    takes the kernel's plain PyTorch version. ``backbone_factory`` (a JAX
    test hook) is refused by ``DeepfakeDetector``.
    ``param_dtype``, ``remat_frames``, ``fused_eval_pyramid``,
    ``fused_train_pyramid`` and ``use_s2d_stem`` choose among formulations of
    the same math in the JAX package; the port has one formulation each and
    reads them nowhere. ``frame_chunk`` is, as in the JAX package, a default
    for callers: ``video_forward`` and ``InferenceEngine`` take their own.
    """

    arch: ArchConfig = dataclasses.field(default_factory=ArchConfig)
    in_channels: int = 3
    dama_dim: int = 128
    num_heads: int = 4
    levels: int = 3
    frame_chunk: int = 16
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat_frames: bool = True
    use_pallas_dwt: bool = False      # K1: Haar DWT kernel (ops/haar.py)
    use_pallas_dama: bool = False     # K4: fused cross-attention kernel
    use_fused_mwt_tail: bool = False  # K3: Winograd multiscale_fusion (ops/mwt_tail.py)
    fused_eval_pyramid: Any = "level"
    fused_train_pyramid: bool = False
    use_pallas_dwse: bool = False     # K2: depthwise+BN+SiLU+mean kernel
    use_s2d_stem: bool = False
    pos_mode: str = "reference"       # "reference" | "tile" | "row0"
    # Optional (b0_spec, v2s_spec) pair overriding the backbone stacks.
    backbone_spec: Any = None
    backbone_factory: Any = None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def v2s_spec(self) -> BackboneSpec:
        return self.backbone_spec[1] if self.backbone_spec else V2S_FULL

    @classmethod
    def tiny(cls) -> "ModelConfig":
        """Every module at tiny shapes (64px, one patch of 2x2)."""
        arch = ArchConfig(
            image_size=64, patch_size=2, dim=64, depth=1, dim_head=16,
            heads=2, mlp_dim=64, emb_dim=64, dropout=0.1, emb_dropout=0.1,
        )
        return cls(arch=arch, dama_dim=32, num_heads=2, levels=2,
                   frame_chunk=2, compute_dtype="float32")

    @classmethod
    def micro(cls) -> "ModelConfig":
        """Truncated 3-block backbones at 32px (compile-time-bounded tests).

        The first element of ``backbone_spec`` is the B0 stack, which the port
        does not build yet; it is kept as ``None`` so the V2-S slot lines up
        with the JAX package's ``(B0_MICRO, V2S_MICRO)`` pair.
        """
        arch = ArchConfig(
            image_size=32, patch_size=4, dim=32, depth=1, dim_head=16,
            heads=2, mlp_dim=32, emb_dim=64, dropout=0.1, emb_dropout=0.1,
        )
        return cls(arch=arch, dama_dim=16, num_heads=2, levels=2,
                   frame_chunk=2, compute_dtype="float32",
                   backbone_spec=(None, V2S_MICRO))
