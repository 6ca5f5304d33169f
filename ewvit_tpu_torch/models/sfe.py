"""SFE: EfficientViT spatial feature extractor, V2-S flavour (ewvit_tpu/models/sfe.py).

Backbone -> patchify -> linear embed -> prepend CLS -> add the batch-indexed
positional embedding -> ViT -> head. Both heads are built (the reference's
checkpoints carry both); only the requested one runs.

Patchify flattens each patch in NHWC order ``(p1, p2, c)``, the reference's
``rearrange('b c (h p1) (w p2) -> b (h w) (p1 p2 c)')``: the NCHW map is
permuted to NHWC before flattening, or ``patch_to_embedding`` would see its
inputs scrambled.

Positional embedding quirk (reference sfe.py:158-159): ``pos_embedding`` is
``[emb_dim, 1, dim]`` and row ``i`` of the FLATTENED batch gets
``pos_embedding[i]``. ``pos_mode``: ``"reference"`` caps the flattened batch
at ``emb_dim``; ``"tile"`` uses row ``i % emb_dim``; ``"row0"`` gives every
row ``pos_embedding[0]``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ewvit_tpu_torch.configs import V2S_FULL, ArchConfig, BackboneSpec
from ewvit_tpu_torch.models.efficientnet import EfficientNetV2S
from ewvit_tpu_torch.models.layers import Transformer


class EfficientViT(nn.Module):
    """[N, 3, H, W] -> ``[N, num_classes]`` (``output_mode='cls'``) or the
    feature map ``[N, feat_dim, side, side]``."""

    def __init__(self, arch: ArchConfig, feat_dim: int = 128,
                 output_mode: str = "feature_map", use_pallas_dwse: bool = False,
                 pos_mode: str = "reference", backbone_spec: BackboneSpec = V2S_FULL):
        super().__init__()
        if pos_mode not in ("reference", "tile", "row0"):
            raise ValueError(f"unknown pos_mode {pos_mode!r}")
        a = arch
        self.arch, self.feat_dim = a, feat_dim
        self.output_mode, self.pos_mode = output_mode, pos_mode
        self.efficient_net = EfficientNetV2S(backbone_spec, use_pallas_dwse)
        patch_dim = a.patch_size * a.patch_size * backbone_spec.head_ch
        self.pos_embedding = nn.Parameter(torch.empty(a.emb_dim, 1, a.dim))
        self.patch_to_embedding = nn.Linear(patch_dim, a.dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, a.dim))
        self.dropout = nn.Dropout(a.emb_dropout)
        self.transformer = Transformer(a.dim, a.depth, a.heads, a.dim_head,
                                       a.mlp_dim, a.dropout)
        self.mlp_head = nn.Sequential(nn.Linear(a.dim, a.mlp_dim), nn.ReLU(),
                                      nn.Linear(a.mlp_dim, a.num_classes))
        self.feat_map = nn.Sequential(nn.Linear(a.dim, feat_dim), nn.ReLU())

    def forward(self, img):
        a, p = self.arch, self.arch.patch_size
        feats = self.efficient_net(img)
        n, fc, fh, fw = feats.shape
        gh, gw = fh // p, fw // p
        y = feats.permute(0, 2, 3, 1).reshape(n, gh, p, gw, p, fc)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, gh * gw, p * p * fc)
        y = self.patch_to_embedding(y)
        x = torch.cat([self.cls_token.expand(n, 1, a.dim).to(y.dtype), y], dim=1)

        if n > a.emb_dim and self.pos_mode == "reference":
            raise ValueError(
                f"flattened batch {n} exceeds emb_dim={a.emb_dim}: the "
                "reference's batch-indexed positional embedding only supports "
                "up to emb_dim rows (pos_mode='tile' lifts the cap)")
        pos = self.pos_embedding
        if self.pos_mode == "row0":
            pos = pos[0:1]
        elif n > a.emb_dim:
            pos = pos[torch.arange(n, device=pos.device) % a.emb_dim]
        else:
            pos = pos[:n]
        x = self.transformer(self.dropout(x + pos.to(x.dtype)))

        if self.output_mode == "cls":
            return self.mlp_head(x[:, 0])
        tokens = x[:, 1:]
        f = self.feat_map(tokens)
        side = int(round(tokens.shape[1] ** 0.5))
        return f.reshape(n, side, side, self.feat_dim).permute(0, 3, 1, 2)
