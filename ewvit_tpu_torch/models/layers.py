"""Transformer blocks: self- and cross-attention (ewvit_tpu/models/layers.py).

Module names follow the reference torch code, so state dicts carry the
reference names: ``Transformer.layers.i.{0,1}.{norm,fn}``, ``Attention.to_qkv``
/ ``to_out.0``, ``FeedForward.net.{0,3}``, ``BidirectionalCrossTransformer
.layers.i.{0: LN, 1: CrossAttention, 2: LN, 3: CrossAttention}``.

GELU is the exact erf form; LayerNorm eps is 1e-6 (flax's default, which the
JAX package uses throughout). Attention logits are scaled and soft-maxed in
fp32, then cast back to the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ewvit_tpu_torch.models.norm import LayerNorm
from ewvit_tpu_torch.ops.fused_attention import (
    fused_bidirectional_cross_attention,
    pack_params,
    supports,
)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            nn.Linear(dim, hidden_dim), nn.GELU(), nn.Dropout(dropout),
            nn.Linear(hidden_dim, dim), nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


def _mha(q, k, v, heads: int):
    """q, k, v: [B, N, inner] -> [B, N, inner]."""
    b, n, inner = q.shape
    dh = inner // heads
    q = q.reshape(b, n, heads, dh).transpose(1, 2)
    k = k.reshape(b, k.shape[1], heads, dh).transpose(1, 2)
    v = v.reshape(b, v.shape[1], heads, dh).transpose(1, 2)
    dots = (q @ k.transpose(-1, -2)).float() * dh ** -0.5
    attn = dots.softmax(dim=-1).to(v.dtype)
    return (attn @ v).transpose(1, 2).reshape(b, n, inner)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        project_out = not (heads == 1 and dim_head == dim)
        self.to_out = (nn.Sequential(nn.Linear(inner, dim), nn.Dropout(dropout))
                       if project_out else nn.Identity())

    def forward(self, x):
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        return self.to_out(_mha(q, k, v, self.heads))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class Transformer(nn.Module):
    """Pre-norm encoder; FeedForward dropout is 0 as in the reference."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([
                PreNorm(dim, Attention(dim, heads, dim_head, dropout)),
                PreNorm(dim, FeedForward(dim, mlp_dim, 0.0)),
            ]) for _ in range(depth)])

    def forward(self, x):
        for attn, ff in self.layers:
            x = x + attn(x)
            x = x + ff(x)
        return x


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        project_out = not (heads == 1 and dim_head == dim)
        self.to_out = (nn.Sequential(nn.Linear(inner, dim), nn.Dropout(dropout))
                       if project_out else nn.Identity())

    def forward(self, x, context=None, kv_include_self: bool = False):
        context = x if context is None else context
        if kv_include_self:
            context = torch.cat([x, context], dim=1)
        k, v = self.to_kv(context).chunk(2, dim=-1)
        return self.to_out(_mha(self.to_q(x), k, v, self.heads))


class BidirectionalCrossTransformer(nn.Module):
    """Per layer: space += CA(LN(space), freq); freq += CA(LN(freq), space').

    ``use_fused`` routes the stack through K4 (ops/fused_attention.py) when
    :func:`supports` allows it: eval mode, one token, ``dim % 128 == 0``.
    """

    def __init__(self, dim: int, depth: int = 1, heads: int = 8,
                 dim_head: int = 64, dropout: float = 0.0,
                 use_fused: bool = False):
        super().__init__()
        self.dim, self.depth, self.heads = dim, depth, heads
        self.inner = dim_head * heads
        self.use_fused = use_fused
        self.layers = nn.ModuleList([
            nn.ModuleList([
                LayerNorm(dim), CrossAttention(dim, heads, dim_head, dropout),
                LayerNorm(dim), CrossAttention(dim, heads, dim_head, dropout),
            ]) for _ in range(depth)])

    def flat_params(self):
        """Weights in the flat layout of ops.fused_attention (kernels [in, out])."""
        p = {}
        for i, (sn, sa, fn, fa) in enumerate(self.layers):
            for side, norm, ln, att in (("s", "sn", sn, sa), ("f", "fn", fn, fa)):
                p[f"{norm}{i}_scale"], p[f"{norm}{i}_bias"] = ln.weight, ln.bias
                p[f"{side}{i}_wq"] = att.to_q.weight.t()
                p[f"{side}{i}_wkv"] = att.to_kv.weight.t()
                p[f"{side}{i}_wo"] = att.to_out[0].weight.t()
                p[f"{side}{i}_bo"] = att.to_out[0].bias
        return p

    def forward(self, space, freq):
        n, t, d = space.shape
        if (self.use_fused and self.inner == d
                and supports(d, t, not self.training)):
            mats, smalls = pack_params(self.flat_params(), self.depth)
            so, fo = fused_bidirectional_cross_attention(
                space[:, 0].contiguous(), freq[:, 0].contiguous(), mats, smalls,
                heads=self.heads)
            return so[:, None], fo[:, None]
        for s_norm, s_att, f_norm, f_att in self.layers:
            space = space + s_att(s_norm(space), freq, kv_include_self=True)
            freq = freq + f_att(f_norm(freq), space, kv_include_self=True)
        return space, freq
