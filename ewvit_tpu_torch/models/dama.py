"""DAMA: dynamic adaptive cross-attention fusion, per frame (ewvit_tpu/models/dama.py).

V2-S EfficientViT (feature-map head) and MWT give one token each; the
bidirectional cross-attention mixes them; a conv fusion gate and a 3-way
softmax gate (fp32) blend {space, freq, fused}. Input is one flattened chunk
``[N, 3, H, W]`` (N = batch * chunk); output ``{'fused','space','freq'}``,
each ``[N, dim]``. Module names follow the reference: ``sfe``, ``mwt``,
``cross_att``, ``fusion_gate.{0,1}``, ``gate_net.{2,5}``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ewvit_tpu_torch.configs import ModelConfig
from ewvit_tpu_torch.models.layers import BidirectionalCrossTransformer
from ewvit_tpu_torch.models.mwt import MWT
from ewvit_tpu_torch.models.norm import BatchNorm2d
from ewvit_tpu_torch.models.sfe import EfficientViT


class DAMA(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.dama_dim
        self.dim = d
        self.sfe = EfficientViT(cfg.arch, feat_dim=d, output_mode="feature_map",
                                use_pallas_dwse=cfg.use_pallas_dwse,
                                pos_mode=cfg.pos_mode,
                                backbone_spec=cfg.v2s_spec)
        self.mwt = MWT(cfg.in_channels, d, cfg.levels,
                       use_pallas_dwt=cfg.use_pallas_dwt,
                       use_fused_tail=cfg.use_fused_mwt_tail)
        self.cross_att = BidirectionalCrossTransformer(
            d, depth=2, heads=cfg.num_heads, dim_head=d // cfg.num_heads,
            dropout=0.1, use_fused=cfg.use_pallas_dama)
        self.fusion_gate = nn.Sequential(
            nn.Conv2d(2 * d, d, 3, padding=1),
            BatchNorm2d(d, eps=1e-5, momentum=0.1), nn.ReLU())
        self.gate_net = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(2 * d, d // 2),
            nn.ReLU(), nn.Dropout(0.1), nn.Linear(d // 2, 3))

    def forward(self, frames) -> Dict[str, torch.Tensor]:
        n, d = frames.shape[0], self.dim
        space = self.sfe(frames)                       # [N, d, h, w]
        freq = self.mwt(frames)                        # [N, d, 1, 1]
        h, w = space.shape[2:]
        s_tok = space.flatten(2).transpose(1, 2)       # [N, h*w, d]
        f_tok = freq.reshape(n, d, h * w).transpose(1, 2)
        s_tok, f_tok = self.cross_att(s_tok, f_tok)
        space = s_tok.transpose(1, 2).reshape(n, d, h, w)
        freq = f_tok.transpose(1, 2).reshape(n, d, h, w)

        concat = torch.cat([space, freq], dim=1)
        fused = self.fusion_gate(concat)
        gate = self.gate_net(concat).float().softmax(dim=-1).to(fused.dtype)
        g = gate[:, :, None, None]
        weighted = g[:, 0:1] * space + g[:, 1:2] * freq + g[:, 2:3] * fused
        return {"fused": weighted.mean(dim=(2, 3)),
                "space": space.mean(dim=(2, 3)),
                "freq": freq.mean(dim=(2, 3))}
