"""DAMA's bidirectional cross-attention stack over one token, fused.

Counterpart of ewvit_tpu/ops/fused_attention.py. With one token per branch
(the SFE emits a single patch) each CrossAttention with ``kv_include_self``
reduces, per head, to a scalar gate between the self and the context values::

    gate_h = softmax([q.k_self, q.k_ctx] * dh^-0.5)_0
    out_h  = gate_h * v_self_h + (1 - gate_h) * v_ctx_h

Blocks run layer-major: space attends freq, then freq attends the UPDATED
space. LayerNorm eps is 1e-6 (flax default). All math is fp32.

- :func:`params_from_module_tree` / :func:`pack_params` -- weights of a
  ``BidirectionalCrossTransformer`` -> ``mats [2*depth, D, 4D]`` (Wq | Wkv |
  Wo, [in, out] layout) and ``smalls [2*depth, 3, D]`` (ln scale, ln bias,
  out bias), the TPU kernel's packing.
- :func:`fused_cross_attention_plain` -- plain PyTorch version.
- :func:`fused_bidirectional_cross_attention` -- K4, the hand-written kernel
  ``csrc/fused_attention.cu`` for CUDA tensors; CPU tensors take the plain
  version.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from ewvit_tpu_torch.ops import extension

LN_EPS = 1e-6


def supports(dim: int, tokens: int, deterministic: bool) -> bool:
    """Configurations the fused path covers (as ewvit_tpu's ``supports``)."""
    return deterministic and tokens == 1 and dim % 128 == 0


def params_from_module_tree(tree: Mapping[str, Mapping], depth: int
                            ) -> Dict[str, torch.Tensor]:
    """Flatten a JAX-named param tree (``space_norm_i``, ``space_attend_freq_i``
    {to_q, to_kv, to_out}, ``freq_...``; kernels ``[in, out]``) to the flat
    dict of ewvit_tpu's ``params_from_module_tree``."""
    p = {}
    for i in range(depth):
        for side, norm, ln, att in (
                ("s", "sn", f"space_norm_{i}", f"space_attend_freq_{i}"),
                ("f", "fn", f"freq_norm_{i}", f"freq_attend_space_{i}")):
            p[f"{norm}{i}_scale"] = tree[ln]["scale"]
            p[f"{norm}{i}_bias"] = tree[ln]["bias"]
            a = tree[att]
            p[f"{side}{i}_wq"] = a["to_q"]["kernel"]
            p[f"{side}{i}_wkv"] = a["to_kv"]["kernel"]
            p[f"{side}{i}_wo"] = a["to_out"]["kernel"]
            p[f"{side}{i}_bo"] = a["to_out"]["bias"]
    return p


def pack_params(flat: Mapping[str, torch.Tensor], depth: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat params -> (mats ``[2*depth, D, 4D]``, smalls ``[2*depth, 3, D]``), fp32."""
    mats, smalls = [], []
    for i in range(depth):
        for side, norm in (("s", "sn"), ("f", "fn")):
            mats.append(torch.cat([flat[f"{side}{i}_wq"], flat[f"{side}{i}_wkv"],
                                   flat[f"{side}{i}_wo"]], dim=1).float())
            smalls.append(torch.stack([flat[f"{norm}{i}_scale"],
                                       flat[f"{norm}{i}_bias"],
                                       flat[f"{side}{i}_bo"]]).float())
    return torch.stack(mats).contiguous(), torch.stack(smalls).contiguous()


def _check(space, freq, mats, smalls, heads):
    n, d = space.shape
    if freq.shape != space.shape:
        raise ValueError(f"space {tuple(space.shape)} and freq {tuple(freq.shape)} differ")
    if mats.dim() != 3 or mats.shape[1:] != (d, 4 * d) or mats.shape[0] % 2:
        raise ValueError(f"mats must be [2*depth, {d}, {4 * d}], got {tuple(mats.shape)}")
    if tuple(smalls.shape) != (mats.shape[0], 3, d):
        raise ValueError(f"smalls must be [{mats.shape[0]}, 3, {d}], got {tuple(smalls.shape)}")
    if d % heads:
        raise ValueError(f"dim {d} not divisible by heads {heads}")


def fused_cross_attention_plain(space: torch.Tensor, freq: torch.Tensor,
                                mats: torch.Tensor, smalls: torch.Tensor,
                                heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(space, freq, mats, smalls, heads)
    n, d = space.shape
    dh = d // heads
    scale = dh ** -0.5
    s = space.to(torch.float32)
    f = freq.to(torch.float32)
    mats = mats.to(torch.float32)
    smalls = smalls.to(torch.float32)

    def block(j, x, ctx):
        wq, wkv, wo = mats[j, :, :d], mats[j, :, d:3 * d], mats[j, :, 3 * d:]
        ln_s, ln_b, bo = smalls[j]
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        xn = (x - mu) * torch.rsqrt(var + LN_EPS) * ln_s + ln_b
        q = xn @ wq
        kv_s, kv_c = xn @ wkv, ctx @ wkv
        ks, vs = kv_s[:, :d], kv_s[:, d:]
        kc, vc = kv_c[:, :d], kv_c[:, d:]
        ds = (q * ks).reshape(n, heads, dh).sum(-1) * scale
        dc = (q * kc).reshape(n, heads, dh).sum(-1) * scale
        m = torch.maximum(ds, dc)
        es, ec = torch.exp(ds - m), torch.exp(dc - m)
        gate = (es / (es + ec)).repeat_interleave(dh, dim=1)
        attn = gate * vs + (1.0 - gate) * vc
        return x + (attn @ wo + bo)

    for i in range(mats.shape[0] // 2):
        s = block(2 * i, s, f)
        f = block(2 * i + 1, f, s)
    return s.to(space.dtype), f.to(freq.dtype)


def fused_bidirectional_cross_attention(space: torch.Tensor, freq: torch.Tensor,
                                        mats: torch.Tensor, smalls: torch.Tensor,
                                        *, heads: int = 4
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on CUDA tensors, :func:`fused_cross_attention_plain` on CPU tensors.

    ``space``, ``freq``: ``[N, D]`` tokens; returns the updated pair.
    """
    if space.device.type == "cpu":
        return fused_cross_attention_plain(space, freq, mats, smalls, heads)
    _check(space, freq, mats, smalls, heads)
    for name, t in (("space", space), ("freq", freq)):
        extension.check_cuda_tensor(t, name, space.dtype)
    extension.check_cuda_tensor(mats, "mats", torch.float32)
    extension.check_cuda_tensor(smalls, "smalls", torch.float32)
    n, d = space.shape
    so, fo = torch.empty_like(space), torch.empty_like(freq)
    extension.launch("fused_attention", "ewvit_fused_bidir_xattn",
                     "fused_bidirectional_cross_attention",
                     space.data_ptr(), freq.data_ptr(), mats.data_ptr(),
                     smalls.data_ptr(), so.data_ptr(), fo.data_ptr(),
                     n, d, mats.shape[0] // 2, heads,
                     extension.dtype_code(space))
    return so, fo
