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
- :func:`pack_xattn` / :func:`unpack_xattn` -- ``(mats, smalls)`` <-> the
  cluster kernel's layout, one contiguous run per (block, CTA).
- :func:`fused_cross_attention_plain` -- plain PyTorch version.
- :func:`fused_bidirectional_cross_attention` -- K4 for CUDA tensors, the
  hand-written kernels of ``csrc/fused_attention.cu``; CPU tensors take the
  plain version. At D = 128 with a head width that is a multiple of 16
  (:func:`cluster_route`) it packs the weights and runs the cluster kernel;
  any other shape runs the general kernel on ``mats``/``smalls``.
- :func:`fused_bidirectional_cross_attention_packed` -- the cluster kernel
  on weights packed once (``BidirectionalCrossTransformer`` keeps them).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from ewvit_tpu_torch.ops import extension

LN_EPS = 1e-6
CLUSTER = 8          # CTAs per cluster; CTA c owns columns [c*D/8, (c+1)*D/8)
CLUSTER_D = 128      # the one width the cluster kernel compiles in
CLUSTER_ROWS = 8     # token rows per cluster (kR in csrc/fused_attention.cu)


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


def cluster_route(dim: int, heads: int) -> bool:
    """Shapes the cluster kernel takes: D = 128, each CTA's 16 columns
    inside one head (``dh % 16 == 0``: heads 1, 2, 4 or 8)."""
    return dim == CLUSTER_D and dim % heads == 0 and (dim // heads) % (dim // CLUSTER) == 0


def pack_xattn(mats: torch.Tensor, smalls: torch.Tensor) -> torch.Tensor:
    """``mats [B, D, 4D]``, ``smalls [B, 3, D]`` (B = 2*depth blocks) -> the
    cluster kernel's ``[B, 8, D*4w + 2D + w]`` fp32, w = D/8: for block b
    and CTA c, rows k of ``[Wq | Wk | Wv | Wo][k, c*w:(c+1)*w]`` (4w floats
    each), then the LayerNorm scale and bias (all D) and the out bias's w
    columns. Each (b, c) is one contiguous run, copied by one bulk copy."""
    b, d, _ = mats.shape
    w = d // CLUSTER
    m = mats.float().reshape(b, d, 4, CLUSTER, w).permute(0, 3, 1, 2, 4)
    ln = smalls[:, :2].float().reshape(b, 1, 2 * d).expand(b, CLUSTER, 2 * d)
    bo = smalls[:, 2].float().reshape(b, CLUSTER, w)
    return torch.cat([m.reshape(b, CLUSTER, 4 * d * w), ln, bo], dim=2).contiguous()


def unpack_xattn(packed: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_xattn`: ``(mats, smalls)``."""
    b, w = packed.shape[0], dim // CLUSTER
    n = 4 * dim * w
    mats = packed[:, :, :n].reshape(b, CLUSTER, dim, 4, w).permute(0, 2, 3, 1, 4)
    ln = packed[:, 0, n:n + 2 * dim].reshape(b, 2, dim)
    bo = packed[:, :, n + 2 * dim:].reshape(b, 1, dim)
    return mats.reshape(b, dim, 4 * dim).contiguous(), torch.cat([ln, bo], dim=1)


def _check_packed(space, freq, packed, heads):
    n, d = space.shape
    w = d // CLUSTER
    if freq.shape != space.shape:
        raise ValueError(f"space {tuple(space.shape)} and freq {tuple(freq.shape)} differ")
    if d % CLUSTER or packed.dim() != 3 or packed.shape[0] % 2 or \
            tuple(packed.shape[1:]) != (CLUSTER, 4 * d * w + 2 * d + w):
        raise ValueError(f"packed must be [2*depth, {CLUSTER}, {4 * d * w + 2 * d + w}] "
                         f"(pack_xattn) for D = {d}, got {tuple(packed.shape)}")
    if d % heads:
        raise ValueError(f"dim {d} not divisible by heads {heads}")


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


def _check_tokens(space, freq):
    for name, t in (("space", space), ("freq", freq)):
        extension.check_cuda_tensor(t, name, space.dtype)


def _launch_cluster(space, freq, packed, heads):
    """The cluster kernel on checked CUDA tensors."""
    if not cluster_route(space.shape[1], heads):
        raise ValueError(f"the cluster kernel takes D = {CLUSTER_D} with a head width "
                         f"that is a multiple of 16, got D = {space.shape[1]}, heads {heads}")
    extension.check_cuda_tensor(packed, "packed", torch.float32)
    so, fo = torch.empty_like(space), torch.empty_like(freq)
    extension.launch("fused_attention", "ewvit_fused_bidir_xattn_cluster",
                     "fused_bidirectional_cross_attention",
                     space.data_ptr(), freq.data_ptr(), packed.data_ptr(),
                     so.data_ptr(), fo.data_ptr(), space.shape[0],
                     packed.shape[0] // 2, heads, extension.dtype_code(space))
    return so, fo


def _launch_general(space, freq, mats, smalls, heads):
    """The general kernel (the first design, any D % 4 == 0) on checked CUDA
    tensors."""
    n, d = space.shape
    so, fo = torch.empty_like(space), torch.empty_like(freq)
    extension.launch("fused_attention", "ewvit_fused_bidir_xattn_general",
                     "fused_bidirectional_cross_attention_general",
                     space.data_ptr(), freq.data_ptr(), mats.data_ptr(),
                     smalls.data_ptr(), so.data_ptr(), fo.data_ptr(),
                     n, d, mats.shape[0] // 2, heads,
                     extension.dtype_code(space))
    return so, fo


def fused_bidirectional_cross_attention_packed(space: torch.Tensor, freq: torch.Tensor,
                                               packed: torch.Tensor, *, heads: int = 4
                                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's cluster kernel with weights from :func:`pack_xattn` on CUDA
    tensors (D = 128, :func:`cluster_route`; anything else raises), the
    plain version on CPU tensors."""
    _check_packed(space, freq, packed, heads)
    if space.device.type == "cpu":
        return fused_cross_attention_plain(space, freq, *unpack_xattn(packed, space.shape[1]),
                                           heads)
    _check_tokens(space, freq)
    return _launch_cluster(space, freq, packed, heads)


def fused_bidirectional_cross_attention(space: torch.Tensor, freq: torch.Tensor,
                                        mats: torch.Tensor, smalls: torch.Tensor,
                                        *, heads: int = 4
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on CUDA tensors, :func:`fused_cross_attention_plain` on CPU tensors.

    ``space``, ``freq``: ``[N, D]`` tokens; returns the updated pair. On the
    card, shapes of :func:`cluster_route` pack the weights (a few launches
    per call; :func:`fused_bidirectional_cross_attention_packed` takes them
    packed once) and run the cluster kernel; others run the general kernel.
    """
    if space.device.type == "cpu":
        return fused_cross_attention_plain(space, freq, mats, smalls, heads)
    _check(space, freq, mats, smalls, heads)
    _check_tokens(space, freq)
    extension.check_cuda_tensor(mats, "mats", torch.float32)
    extension.check_cuda_tensor(smalls, "smalls", torch.float32)
    if cluster_route(space.shape[1], heads):
        return _launch_cluster(space, freq, pack_xattn(mats, smalls), heads)
    return _launch_general(space, freq, mats, smalls, heads)
