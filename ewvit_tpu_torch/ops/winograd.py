"""Winograd F(2x2, 3x3) convolution, NCHW (ewvit_tpu/ops/winograd.py).

Standard minimal filtering, per 4x4 input tile ``d`` and 2x2 output tile::

    Y = A^T [ (G g G^T) . (B^T d B) ] A

with the matrices :data:`BT`, :data:`G` and :data:`AT` (own copies of
``ewvit_tpu/ops/winograd.py:40-50``). The input transform is +-1 adds, the
16 transform-domain products contract over input channels, and the output
transform is +-1 adds again: 16 multiplies per tile and channel pair instead
of the direct conv's 36.

Arithmetic (as ``ewvit_tpu/ops/winograd.py:58-121`` and
``winograd_pallas.py:116-156``): V in fp32, rounded to the input dtype before
the products; U cast to the input dtype; products accumulated in fp32; the
inverse transform in fp32; one rounding of the output.

- :func:`transform_weights` -- OIHW ``[Cout, Cin, 3, 3]`` -> U
  ``[4, 4, Cin, Cout]`` fp32 (the JAX package's layout).
- :func:`input_transform` / :func:`output_transform` -- the plain versions'
  +-1 transforms, shared with ``ops/mwt_tail.py``.
- :func:`conv3x3_winograd_plain` -- plain PyTorch version of K5.
- :func:`conv3x3_winograd` -- K5, the hand-written kernel ``csrc/winograd.cu``
  for a CUDA tensor; a CPU tensor takes the plain version.
- :func:`pack_u` -- U ``[L, 16, Cin, Cout]`` -> the kernel's layout
  ``[L, 16, Cout_pad, Cin_pad]`` (input channel innermost, permuted in 16s;
  Cout padded to a multiple of 128 and Cin to 32 with zeros).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ewvit_tpu_torch.ops import extension

BT = torch.tensor([[1, 0, -1, 0],
                   [0, 1, 1, 0],
                   [0, -1, 1, 0],
                   [0, 1, 0, -1]], dtype=torch.float32)
G = torch.tensor([[1, 0, 0],
                  [0.5, 0.5, 0.5],
                  [0.5, -0.5, 0.5],
                  [0, 0, 1]], dtype=torch.float32)
AT = torch.tensor([[1, 1, 1, 0],
                   [0, 1, -1, -1]], dtype=torch.float32)

# csrc/winograd.cu block sizes: output channels per block, input channels
# per step. pack_u pads U to them.
COUT_BLOCK, CIN_STEP = 128, 32


def _g3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Rows of :data:`G` applied along ``dim`` (size 3 -> 4), as adds on the
    tensor's own device (no host-to-device copy of G, which would make the
    host wait for the stream)."""
    t0, t1, t2 = t.unbind(dim)
    return torch.stack([t0, 0.5 * (t0 + t1 + t2), 0.5 * (t0 - t1 + t2), t2], dim=dim)


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """``[Cout, Cin, 3, 3]`` -> transform-domain U = G g G^T, ``[4, 4, Cin,
    Cout]`` fp32."""
    return _g3(_g3(w.to(torch.float32), 2), 3).permute(2, 3, 1, 0)


def _bt4(rows):
    return rows[0] - rows[2], rows[1] + rows[2], rows[2] - rows[1], rows[1] - rows[3]


def _at2(rows):
    return rows[0] + rows[1] + rows[2], rows[1] - rows[2] - rows[3]


def input_transform(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` -> V ``[16, N*(H/2)*(W/2), C]`` fp32 (index ``4u + v``;
    tile rows ``n, a, b`` in that order), the SAME zero ring included."""
    n, c, h, w = x.shape
    h2, w2 = h // 2, w // 2
    xp = F.pad(x.to(torch.float32), (1, 1, 1, 1))
    p = [[xp[:, :, i:i + 2 * h2:2, j:j + 2 * w2:2] for j in range(4)] for i in range(4)]
    rows = [_bt4(p[i]) for i in range(4)]                     # rows[i][v]
    v = [[None] * 4 for _ in range(4)]
    for vv in range(4):
        col = _bt4([rows[i][vv] for i in range(4)])
        for uu in range(4):
            v[uu][vv] = col[uu]
    vs = torch.stack([v[uu][vv] for uu in range(4) for vv in range(4)])
    return vs.permute(0, 1, 3, 4, 2).reshape(16, n * h2 * w2, c)


def output_transform(m: torch.Tensor, n: int, h2: int, w2: int) -> torch.Tensor:
    """M ``[16, N*h2*w2, Cout]`` -> ``A^T M A`` as ``[N, Cout, 2*h2, 2*w2]``
    (same dtype as ``m``)."""
    cout = m.shape[-1]
    mm = m.reshape(4, 4, n, h2, w2, cout)
    yrows = [_at2([mm[uu, vv] for vv in range(4)]) for uu in range(4)]   # [u][l]
    y = [[None, None], [None, None]]
    for ll in range(2):
        col = _at2([yrows[uu][ll] for uu in range(4)])
        for k in range(2):
            y[k][ll] = col[k]
    out = torch.stack([torch.stack(y[0]), torch.stack(y[1])])  # [k, l, n, a, b, co]
    return out.permute(2, 5, 3, 0, 4, 1).reshape(n, cout, 2 * h2, 2 * w2)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected x [N, Cin, H, W], got {tuple(x.shape)}")
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"Winograd F(2x2,3x3) needs even H and W, got {tuple(x.shape[2:])}")
    if w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"expected w [Cout, {x.shape[1]}, 3, 3], got {tuple(w.shape)}")


def conv3x3_winograd_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv without bias, ``x`` ``[N, Cin, H, W]`` (H, W
    even) by ``w`` ``[Cout, Cin, 3, 3]``, as ``F.conv2d(x, w, padding=1)``."""
    _check(x, w)
    n, cin, h, wd = x.shape
    u = transform_weights(w).reshape(16, cin, -1).to(x.dtype).to(torch.float32)
    v = input_transform(x).to(x.dtype).to(torch.float32)
    m = torch.bmm(v, u)
    return output_transform(m, n, h // 2, wd // 2).to(x.dtype)


def pack_u(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """U ``[L, 16, Cin, Cout]`` -> ``[L, 16, Cout_pad, Cin_pad]`` in ``dtype``,
    zero-padded to the kernel's block sizes (csrc/winograd.cu).

    Within each group of 16 input channels the pairs are stored in the order
    (0,1), (8,9), (2,3), (10,11), ..., (6,7), (14,15): a tensor-core B
    fragment's two pairs, k = 2t and 2t + 8, are then one 8-byte load.
    """
    lv, _, cin, cout = u.shape
    cout_pad, cin_pad = -(-cout // COUT_BLOCK) * COUT_BLOCK, -(-cin // CIN_STEP) * CIN_STEP
    out = torch.zeros(lv, 16, cout_pad, cin_pad, dtype=dtype, device=u.device)
    out[:, :, :cout, :cin] = u.transpose(2, 3)
    # [.., group, half (k < 8 | k >= 8), pair, element] -> [.., group, pair, half, element]
    return out.reshape(lv, 16, cout_pad, cin_pad // 16, 2, 4, 2).transpose(-3, -2).reshape(
        lv, 16, cout_pad, cin_pad)


def conv3x3_winograd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5 on a CUDA tensor, :func:`conv3x3_winograd_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return conv3x3_winograd_plain(x, w)
    _check(x, w)
    extension.check_cuda_tensor(x, "x")
    n, cin, h, wd = x.shape
    cout = w.shape[0]
    u = pack_u(transform_weights(w).reshape(1, 16, cin, cout), x.dtype)
    out = torch.empty(n, cout, h, wd, dtype=x.dtype, device=x.device)
    extension.launch("winograd", "ewvit_conv3x3_winograd", "conv3x3_winograd",
                     x.data_ptr(), u.data_ptr(), out.data_ptr(), n, cin, cout, h, wd,
                     extension.dtype_code(x))
    return out
