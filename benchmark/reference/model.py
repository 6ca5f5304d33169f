"""Plain PyTorch reference of the Efficient Wavelet ViT ``DeepfakeDetector``.

A frozen, self-contained copy of the detector's mathematics (the reference
repository's ``network/model.py`` with its EfficientNet-B0 and
EfficientNetV2-S SFEs, the MWT and DAMA), written with plain ``torch``
operations only. It imports nothing of the measured program, so a later
change to the program cannot move it. Module and parameter names follow the
reference checkpoints (``dama.sfe.efficient_net.features.0.0.weight``, ...),
so one state dict loads into it and into the program with ``strict=True``.

Departures, each deliberate:

- The three hf_sep stacks of the MWT run as three convs on their channel
  slices, as published (the program may group them).
- ``set_precision(model, "fp8" | "int8")`` computes one precision below the
  configured model's bf16, with one scale per tensor: every convolution's
  and linear layer's input, weight and output, and every other layer's
  output, rounded through float8 e4m3 (the gradients coming back through
  e5m2) or int8 (both ways); products and sums stay fp32. It is the lower
  precision control of the benchmark's correctness check, never the
  reference itself.
- Dropout draws its keep mask with ``F.dropout`` on a tensor of ones of
  ``draw_dtype`` (:func:`set_draw_dtype`: the dtype in which the configured
  model computes), so that a seeded run keeps the rows the configured model
  keeps; the kept values are scaled in fp32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

DROP_CONNECT_RATE = 0.2
FP8, FP8_MAX = torch.float8_e4m3fn, 448.0             # values
FP8_BWD, FP8_BWD_MAX = torch.float8_e5m2, 57344.0     # gradients


# ------------------------------------------------------------ precision


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` through ``dtype`` with one scale per tensor (its largest
    magnitude maps to ``top``), back in ``t``'s dtype."""
    amax = t.abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


def _round_int8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through symmetric int8 with one scale per tensor (its largest
    magnitude maps to 127), back in ``t``'s dtype."""
    scale = t.abs().amax().float().clamp_min(1e-30) / 127.0
    return ((t.float() / scale).round().clamp(-127, 127) * scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    """Forward values in e4m3, the gradient coming back in e5m2, as fp8
    training keeps them."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, FP8, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, FP8_BWD, FP8_BWD_MAX)


class _Int8(torch.autograd.Function):
    """Forward values and the gradient coming back both in int8."""

    @staticmethod
    def forward(ctx, t):
        return _round_int8(t)

    @staticmethod
    def backward(ctx, g):
        return _round_int8(g)


class _Bf16(torch.autograd.Function):
    """Forward values and the gradient coming back both in bf16: the
    configuration's own rounding, a witness of what it alone does."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


LOWER = {"fp8": (_Fp8, lambda t: _round(t, FP8, FP8_MAX)), "int8": (_Int8, _round_int8),
         "bf16": (_Bf16, lambda t: t.to(torch.bfloat16).to(t.dtype))}


def lower_round(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` rounded through ``precision`` (``"fp8"``: e4m3, its gradient
    e5m2; ``"int8"``: both int8), one scale per tensor."""
    fn, plain = LOWER[precision]
    return fn.apply(t) if t.requires_grad else plain(t)


class Conv2d(nn.Conv2d):
    quant: Optional[str] = None

    def forward(self, x):
        if self.quant:
            q = self.quant
            return lower_round(self._conv_forward(lower_round(x, q),
                                                  lower_round(self.weight, q), self.bias), q)
        return super().forward(x)


class Linear(nn.Linear):
    quant: Optional[str] = None

    def forward(self, x):
        if self.quant:
            q = self.quant
            return lower_round(F.linear(lower_round(x, q), lower_round(self.weight, q),
                                        self.bias), q)
        return super().forward(x)


class Dropout(nn.Module):
    """Dropout whose keep mask is drawn as ``F.dropout`` draws it for a
    tensor of ``draw_dtype``; kept values are ``x / (1 - p)``."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.draw_dtype = torch.float32

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        ones = torch.ones(x.shape, dtype=self.draw_dtype, device=x.device)
        keep = F.dropout(ones, self.p, True) != 0
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def _lower_output(module, args, out):
    if isinstance(out, torch.Tensor) and out.is_floating_point():
        return lower_round(out, module._lower)
    return out


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    """``"fp32"`` (the reference), or a precision below the configuration's
    bf16 for the control (``"fp8"``, ``"int8"``): every conv and linear
    computed in it, and every other layer's output, norms and activations
    included, stored in it, as the configured model stores every one in
    bf16."""
    if precision not in ("fp32", *LOWER):
        raise ValueError(f"unknown precision {precision!r}")
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.quant = None if precision == "fp32" else precision
        elif not list(m.children()):
            handle = m.__dict__.pop("_lower_hook", None)
            if handle is not None:
                handle.remove()
            if precision != "fp32":
                m.__dict__["_lower"] = precision
                m.__dict__["_lower_hook"] = m.register_forward_hook(_lower_output)
    return model


def set_draw_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.draw_dtype = dtype
    return model


def stochastic_depth(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """One Bernoulli(keep) per row, drawn in fp32; kept rows ``x / keep``."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device).bernoulli_(keep)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def bn(channels: int, eps: float, momentum: float) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=eps, momentum=momentum)


# ------------------------------------------------------------ EfficientNetV2-S


class ConvBNAct(nn.Sequential):
    def __init__(self, cin, cout, kernel, stride=1, groups=1, act=True):
        layers = [Conv2d(cin, cout, kernel, stride, padding=(kernel - 1) // 2,
                         groups=groups, bias=False), bn(cout, 1e-3, 0.1)]
        if act:
            layers.append(nn.SiLU())
        super().__init__(*layers)


class SqueezeExcitation(nn.Module):
    def __init__(self, channels, squeeze):
        super().__init__()
        self.fc1 = Conv2d(channels, squeeze, 1)
        self.fc2 = Conv2d(squeeze, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.silu(self.fc1(s))))


class MBConv(nn.Module):
    def __init__(self, cin, cout, kernel, stride, expand, se_ratio, drop_rate):
        super().__init__()
        exp = cin * expand
        self.use_res = stride == 1 and cin == cout
        self.drop_rate = drop_rate
        layers = [ConvBNAct(cin, exp, 1)] if expand != 1 else []
        layers += [ConvBNAct(exp, exp, kernel, stride, groups=exp),
                   SqueezeExcitation(exp, max(1, int(cin * se_ratio))),
                   ConvBNAct(exp, cout, 1, act=False)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        h = self.block(x)
        return x + stochastic_depth(h, self.drop_rate, self.training) if self.use_res else h


class FusedMBConv(nn.Module):
    def __init__(self, cin, cout, kernel, stride, expand, drop_rate):
        super().__init__()
        self.use_res = stride == 1 and cin == cout
        self.drop_rate = drop_rate
        if expand != 1:
            layers = [ConvBNAct(cin, cin * expand, kernel, stride),
                      ConvBNAct(cin * expand, cout, 1, act=False)]
        else:
            layers = [ConvBNAct(cin, cout, kernel, stride)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        h = self.block(x)
        return x + stochastic_depth(h, self.drop_rate, self.training) if self.use_res else h


class EfficientNetV2S(nn.Module):
    """torchvision ``efficientnet_v2_s().features`` layout."""

    def __init__(self, spec: dict):
        super().__init__()
        blocks = spec["blocks"]
        stages = [ConvBNAct(3, spec["stem_ch"], 3, 2)]
        total, idx = sum(b[0] for b in blocks), 0
        for repeats, kernel, stride, expand, cin0, cout, se, fused in blocks:
            stage = []
            for r in range(repeats):
                cin, s = (cin0, stride) if r == 0 else (cout, 1)
                rate = DROP_CONNECT_RATE * idx / total
                stage.append(FusedMBConv(cin, cout, kernel, s, expand, rate) if fused
                             else MBConv(cin, cout, kernel, s, expand, se, rate))
                idx += 1
            stages.append(nn.Sequential(*stage))
        stages.append(ConvBNAct(blocks[-1][5], spec["head_ch"], 1))
        self.features = nn.Sequential(*stages)

    def forward(self, x):
        return self.features(x)


# ------------------------------------------------------------ EfficientNet-B0


def same_padding(h, w, kernel, stride):
    def split(n):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        return total // 2, total - total // 2
    return (*split(w), *split(h))


class Conv2dSame(Conv2d):
    """Bias-free conv with TensorFlow's 'SAME' padding."""

    def __init__(self, cin, cout, kernel, stride=1, groups=1):
        super().__init__(cin, cout, kernel, stride, padding=0, groups=groups, bias=False)

    def forward(self, x):
        pad = same_padding(*x.shape[2:], self.kernel_size[0], self.stride[0])
        return super().forward(F.pad(x, pad) if any(pad) else x)


class MBConvBlock(nn.Module):
    """efficientnet_pytorch ``MBConvBlock``."""

    def __init__(self, cin, cout, kernel, stride, expand, se_ratio, drop_rate):
        super().__init__()
        exp = cin * expand
        self.use_res = stride == 1 and cin == cout
        self.drop_rate = drop_rate
        self.has_expand = expand != 1
        if self.has_expand:
            self._expand_conv = Conv2d(cin, exp, 1, bias=False)
            self._bn0 = bn(exp, 1e-3, 0.01)
        self._depthwise_conv = Conv2dSame(exp, exp, kernel, stride, groups=exp)
        self._bn1 = bn(exp, 1e-3, 0.01)
        squeeze = max(1, int(cin * se_ratio))
        self._se_reduce = Conv2d(exp, squeeze, 1)
        self._se_expand = Conv2d(squeeze, exp, 1)
        self._project_conv = Conv2d(exp, cout, 1, bias=False)
        self._bn2 = bn(cout, 1e-3, 0.01)

    def forward(self, x):
        h = F.silu(self._bn0(self._expand_conv(x))) if self.has_expand else x
        h = F.silu(self._bn1(self._depthwise_conv(h)))
        s = h.mean(dim=(2, 3), keepdim=True)
        h = h * torch.sigmoid(self._se_expand(F.silu(self._se_reduce(s))))
        h = self._bn2(self._project_conv(h))
        return x + stochastic_depth(h, self.drop_rate, self.training) if self.use_res else h


class EfficientNetB0(nn.Module):
    def __init__(self, spec: dict):
        super().__init__()
        blocks = spec["blocks"]
        self._conv_stem = Conv2dSame(3, spec["stem_ch"], 3, 2)
        self._bn0 = bn(spec["stem_ch"], 1e-3, 0.01)
        total = sum(b[0] for b in blocks)
        out = []
        for repeats, kernel, stride, expand, cin0, cout, se, _ in blocks:
            for r in range(repeats):
                out.append(MBConvBlock(cin0 if r == 0 else cout, cout, kernel,
                                       stride if r == 0 else 1, expand, se,
                                       DROP_CONNECT_RATE * len(out) / total))
        self._blocks = nn.ModuleList(out)
        self._conv_head = Conv2d(blocks[-1][5], spec["head_ch"], 1, bias=False)
        self._bn1 = bn(spec["head_ch"], 1e-3, 0.01)

    def forward(self, x):
        x = F.silu(self._bn0(self._conv_stem(x)))
        for block in self._blocks:
            x = block(x)
        return F.silu(self._bn1(self._conv_head(x)))


# ------------------------------------------------------------ transformer


def layer_norm(dim):
    return nn.LayerNorm(dim, eps=1e-6)


def mha(q, k, v, heads):
    b, n, inner = q.shape
    dh = inner // heads
    q = q.reshape(b, n, heads, dh).transpose(1, 2)
    k = k.reshape(b, k.shape[1], heads, dh).transpose(1, 2)
    v = v.reshape(b, v.shape[1], heads, dh).transpose(1, 2)
    attn = ((q @ k.transpose(-1, -2)) * dh ** -0.5).softmax(dim=-1)
    return (attn @ v).transpose(1, 2).reshape(b, n, inner)


class FeedForward(nn.Module):
    def __init__(self, dim, hidden, dropout=0.0):
        super().__init__()
        self.net = nn.Sequential(Linear(dim, hidden), nn.GELU(), Dropout(dropout),
                                 Linear(hidden, dim), Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head, dropout):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.to_qkv = Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), Dropout(dropout))

    def forward(self, x):
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        return self.to_out(mha(q, k, v, self.heads))


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = layer_norm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class Transformer(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, dropout):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            PreNorm(dim, Attention(dim, heads, dim_head, dropout)),
            PreNorm(dim, FeedForward(dim, mlp_dim, 0.0))]) for _ in range(depth)])

    def forward(self, x):
        for attn, ff in self.layers:
            x = x + attn(x)
            x = x + ff(x)
        return x


class CrossAttention(nn.Module):
    def __init__(self, dim, heads, dim_head, dropout):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), Dropout(dropout))

    def forward(self, x, context):
        context = torch.cat([x, context], dim=1)          # kv_include_self
        k, v = self.to_kv(context).chunk(2, dim=-1)
        return self.to_out(mha(self.to_q(x), k, v, self.heads))


class BidirectionalCrossTransformer(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, dropout):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            layer_norm(dim), CrossAttention(dim, heads, dim_head, dropout),
            layer_norm(dim), CrossAttention(dim, heads, dim_head, dropout)])
            for _ in range(depth)])

    def forward(self, space, freq):
        for s_norm, s_att, f_norm, f_att in self.layers:
            space = space + s_att(s_norm(space), freq)
            freq = freq + f_att(f_norm(freq), space)
        return space, freq


# ------------------------------------------------------------ SFE, MWT, DAMA


class EfficientViT(nn.Module):
    def __init__(self, cfg: dict, backbone: str, feat_dim: int):
        super().__init__()
        self.cfg, self.feat_dim = cfg, feat_dim
        spec = cfg[backbone]
        self.efficient_net = EfficientNetB0(spec) if backbone == "b0" else EfficientNetV2S(spec)
        dim, p = cfg["dim"], cfg["patch_size"]
        self.pos_embedding = nn.Parameter(torch.empty(cfg["emb_dim"], 1, dim))
        self.patch_to_embedding = Linear(p * p * spec["head_ch"], dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.dropout = Dropout(cfg["emb_dropout"])
        self.transformer = Transformer(dim, cfg["depth"], cfg["heads"], cfg["dim_head"],
                                       cfg["mlp_dim"], cfg["dropout"])
        self.mlp_head = nn.Sequential(Linear(dim, cfg["mlp_dim"]), nn.ReLU(),
                                      Linear(cfg["mlp_dim"], cfg["num_classes"]))
        self.feat_map = nn.Sequential(Linear(dim, feat_dim), nn.ReLU())

    def forward(self, img, output_mode: str = "feature_map"):
        cfg, p = self.cfg, self.cfg["patch_size"]
        feats = self.efficient_net(img)
        n, fc, fh, fw = feats.shape
        gh, gw = fh // p, fw // p
        y = feats.permute(0, 2, 3, 1).reshape(n, gh, p, gw, p, fc)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, gh * gw, p * p * fc)
        y = self.patch_to_embedding(y)
        x = torch.cat([self.cls_token.expand(n, 1, cfg["dim"]), y], dim=1)
        if n > cfg["emb_dim"]:
            raise ValueError(f"flattened batch {n} exceeds emb_dim={cfg['emb_dim']}")
        # the reference's quirk: row i of the flattened batch gets pos_embedding[i]
        x = self.transformer(self.dropout(x + self.pos_embedding[:n]))
        if output_mode == "cls":
            return self.mlp_head(x[:, 0])
        tokens = x[:, 1:]
        side = int(round(tokens.shape[1] ** 0.5))
        f = self.feat_map(tokens)
        return f.reshape(n, side, side, self.feat_dim).permute(0, 3, 1, 2)


def haar_dwt2d(x):
    """One Haar level: ``ll [N, C, H/2, W/2]`` and ``hf [N, 3C, H/2, W/2]``
    with channel ``c*3 + band``, bands (LH, HL, HH)."""
    n, c, h, w = x.shape
    a, b = x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2]
    cc, d = x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2]
    ll = (a + b + cc + d) * 0.5
    lh = (a + b - cc - d) * 0.5
    hl = (a - b + cc - d) * 0.5
    hh = (a - b - cc + d) * 0.5
    return ll, torch.stack([lh, hl, hh], dim=2).reshape(n, 3 * c, h // 2, w // 2)


class ConvBNReLU(nn.Sequential):
    def __init__(self, cin, cout, stride=1):
        super().__init__(Conv2d(cin, cout, 3, stride, padding=1), bn(cout, 1e-5, 0.1),
                         nn.ReLU())


class MWT(nn.Module):
    def __init__(self, c: int, dim: int, levels: int):
        super().__init__()
        self.c, self.levels = c, levels
        self.hf_conv = nn.ModuleDict({
            "seperate": nn.ModuleList([ConvBNReLU(c, 6 * c) for _ in range(3)]),
            "fusion": ConvBNReLU(18 * c, dim)})
        self.multiscale_fusion = ConvBNReLU(levels * dim, dim)
        self.freq_conv = ConvBNReLU(dim, dim, stride=2)
        self.freq_pool = nn.Sequential(nn.MaxPool2d(2, 2), Conv2d(dim, dim, 3, 2, padding=1),
                                       bn(dim, 1e-5, 0.1), nn.ReLU())

    def forward(self, x):
        target = (x.shape[2] // 2, x.shape[3] // 2)
        cur, highs, c = x, [], self.c
        for _ in range(self.levels):
            ll, hf = haar_dwt2d(cur)
            if self.levels > 1 and tuple(hf.shape[2:]) != target:
                hf = F.interpolate(hf, size=target, mode="bilinear", align_corners=False)
            seps = [sep(hf[:, i * c:(i + 1) * c])
                    for i, sep in enumerate(self.hf_conv["seperate"])]
            highs.append(self.hf_conv["fusion"](torch.cat(seps, dim=1)))
            cur = ll
        freq = self.freq_conv(self.multiscale_fusion(torch.cat(highs, dim=1)))
        return self.freq_pool(freq).mean(dim=(2, 3), keepdim=True)


class DAMA(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["dama_dim"]
        self.dim = d
        self.sfe = EfficientViT(cfg, "v2s", d)
        self.mwt = MWT(cfg["in_channels"], d, cfg["levels"])
        self.cross_att = BidirectionalCrossTransformer(d, 2, cfg["num_heads"],
                                                       d // cfg["num_heads"], 0.1)
        self.fusion_gate = nn.Sequential(Conv2d(2 * d, d, 3, padding=1), bn(d, 1e-5, 0.1),
                                         nn.ReLU())
        self.gate_net = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                                      Linear(2 * d, d // 2), nn.ReLU(), Dropout(0.1),
                                      Linear(d // 2, 3))

    def forward(self, frames):
        n, d = frames.shape[0], self.dim
        space = self.sfe(frames)
        freq = self.mwt(frames)
        h, w = space.shape[2:]
        s_tok, f_tok = self.cross_att(space.flatten(2).transpose(1, 2),
                                      freq.reshape(n, d, h * w).transpose(1, 2))
        space = s_tok.transpose(1, 2).reshape(n, d, h, w)
        freq = f_tok.transpose(1, 2).reshape(n, d, h, w)
        concat = torch.cat([space, freq], dim=1)
        fused = self.fusion_gate(concat)
        g = self.gate_net(concat).softmax(dim=-1)[:, :, None, None]
        weighted = g[:, 0:1] * space + g[:, 1:2] * freq + g[:, 2:3] * fused
        return {"fused": weighted.mean(dim=(2, 3)), "space": space.mean(dim=(2, 3)),
                "freq": freq.mean(dim=(2, 3))}


class DeepfakeDetector(nn.Module):
    """Every mode's modules, as the reference checkpoints carry them."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        d = cfg["dama_dim"]
        self.dama = DAMA(cfg)
        self.mwt = MWT(cfg["in_channels"], d, cfg["levels"])
        self.sfe = EfficientViT(cfg, "b0", d)
        self.sfe_cls = EfficientViT(cfg, "b0", d)
        self.fusion_gate = nn.Sequential(Linear(2 * d, 2), nn.ReLU(), Dropout(0.1))
        self.classifier = nn.Sequential(Linear(d, 64), nn.ReLU(), Dropout(0.3), Linear(64, 1))

    def forward(self, frames, mode: str):
        if mode == "dynamic":
            return self.dama(frames)
        if mode == "sfe_only":
            return {"logits": self.sfe_cls(frames, "cls")}
        return {"sfe": self.sfe(frames).mean(dim=(2, 3)),
                "mwt": self.mwt(frames).reshape(frames.shape[0], -1)}

    def head(self, feats, mode: str):
        if mode == "dynamic":
            return {"logits": self.classifier(feats["fused"]), **feats}
        if mode == "sfe_only":
            return {"logits": feats["logits"]}
        s, m = feats["sfe"], feats["mwt"]
        gate = self.fusion_gate(torch.cat([s, m], dim=-1)).softmax(dim=-1)
        return {"logits": self.classifier(s * gate[:, 0:1] + m * gate[:, 1:2]),
                "sfe": s, "mwt": m}


def feat_dims(cfg: dict, mode: str) -> Dict[str, int]:
    d = cfg["dama_dim"]
    return {"dynamic": {"fused": d, "space": d, "freq": d}, "sfe_only": {"logits": 1},
            "sfe_mwt": {"sfe": d, "mwt": d}}[mode]


# ------------------------------------------------------------ video loops


def chunk_seeds(seed: int, n: int) -> List[int]:
    """``n`` seeds derived from ``seed`` by numpy's SeedSequence."""
    return [int(v) for v in np.random.SeedSequence(int(seed)).generate_state(n)]


@contextlib.contextmanager
def seeded(seed: int, device: torch.device):
    """torch's default generators (the CPU's and ``device``'s) seeded to
    ``seed`` in the block, restored after."""
    devices = [device.index if device.index is not None else torch.cuda.current_device()] \
        if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.random.default_generator.manual_seed(seed)
        if devices:
            with torch.cuda.device(devices[0]):
                torch.cuda.manual_seed(seed)
        yield


@torch.no_grad()
def eval_video_forward(model: DeepfakeDetector, x: torch.Tensor, mode: str,
                       frame_chunk: int) -> Dict[str, torch.Tensor]:
    """``x [B, K, 3, H, W]`` -> head outputs; chunks of ``min(frame_chunk, K)``
    frames flattened clip-major, the ragged tail zero-padded to a full chunk
    and masked out of the per-clip sums, which are divided by K."""
    b, k = x.shape[:2]
    chunk = min(frame_chunk, k)
    sums = {key: x.new_zeros(b, d, dtype=torch.float32)
            for key, d in feat_dims(model.cfg, mode).items()}
    for start in range(0, k, chunk):
        fr = x[:, start:start + chunk]
        valid = fr.shape[1]
        if valid < chunk:
            fr = torch.cat([fr, fr.new_zeros((b, chunk - valid) + tuple(x.shape[2:]))], dim=1)
        out = model(fr.reshape(b * chunk, *x.shape[2:]), mode)
        for key in sums:
            sums[key] += out[key].float().reshape(b, chunk, -1)[:, :valid].sum(dim=1)
    return model.head({key: v / k for key, v in sums.items()}, mode)


def train_video_forward(model: DeepfakeDetector, x: torch.Tensor, mode: str,
                        frame_chunk: int, seed: int, remat: bool = True
                        ) -> Dict[str, torch.Tensor]:
    """The train-mode loop: the tail is a true, smaller chunk; each chunk
    runs under :func:`seeded` with its own seed (``chunk_seeds(seed, n+1)``,
    the last for the head); ``remat`` recomputes each chunk in the backward
    (memory only: the seeded chunk draws the same masks again)."""
    b, k = x.shape[:2]
    chunk = min(frame_chunk, k)
    starts = range(0, k, chunk)
    seeds = chunk_seeds(seed, len(starts) + 1)

    def run(flat, s):
        with seeded(s, flat.device):
            return model(flat, mode)

    sums = {key: x.new_zeros(b, d, dtype=torch.float32)
            for key, d in feat_dims(model.cfg, mode).items()}
    for start, s in zip(starts, seeds):
        fr = x[:, start:start + chunk]
        n = fr.shape[1]
        flat = fr.reshape(b * n, *x.shape[2:])
        out = checkpoint(run, flat, s, use_reentrant=False) if remat else run(flat, s)
        sums = {key: v + out[key].float().reshape(b, n, -1).sum(dim=1)
                for key, v in sums.items()}
    with seeded(seeds[-1], x.device):
        return model.head({key: v / k for key, v in sums.items()}, mode)


# ------------------------------------------------------------ preprocessing

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)


def draw_jitter(shape: Sequence[int], generator: torch.Generator,
                brightness: float = 0.01, contrast: float = 0.01):
    """Per image: brightness factor, contrast factor, brightness first?"""
    dev = generator.device

    def uniform(r):
        return (1.0 - r) + 2.0 * r * torch.rand(tuple(shape), generator=generator, device=dev)

    bf, cf = uniform(brightness), uniform(contrast)
    order = torch.rand(tuple(shape), generator=generator, device=dev) < 0.5
    return bf, cf, order


def apply_jitter(x, bf, cf, order):
    """torchvision ``ColorJitter(brightness, contrast)`` with the given draws
    on fp32 ``[..., 3, H, W]`` images in ``[0, 1]``."""
    bf, cf, order = (t[..., None, None, None] for t in (bf, cf, order))
    luma = torch.tensor(LUMA, dtype=x.dtype, device=x.device)[:, None, None]

    def bright(img):
        return (img * bf).clamp(0.0, 1.0)

    def contr(img):
        mean = (img * luma).sum(dim=-3, keepdim=True).mean(dim=(-2, -1), keepdim=True)
        return (mean + cf * (img - mean)).clamp(0.0, 1.0)

    return torch.where(order, contr(bright(x)), bright(contr(x)))


def preprocess(frames_u8: torch.Tensor, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
    """uint8 ``[B, K, H, W, 3]`` -> fp32 ``[B, K, 3, H, W]``, ImageNet
    normalised; with ``generator``, the training colour jitter first."""
    x = frames_u8.permute(0, 1, 4, 2, 3).to(torch.float32) / 255.0
    if generator is not None:
        x = apply_jitter(x, *draw_jitter(x.shape[:2], generator))
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return ((x - mean) / std).contiguous()


def build(cfg: dict, device="cpu") -> DeepfakeDetector:
    """The detector with uninitialised parameters on ``device`` (load a state
    dict into it)."""
    with torch.device("meta"):
        model = DeepfakeDetector(cfg)
    return model.to_empty(device=device) if str(device) != "meta" else model
