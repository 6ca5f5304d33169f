"""Fused depthwise conv + BN + SiLU + spatial mean, NCHW (inference).

Counterpart of ewvit_tpu/ops/dw_se.py:dw_bn_silu_mean. In every stride-1
squeeze-excite MBConv::

    y = silu(dwconv_kxk_same(x) . w_eff + shift)      (BN folded into w_eff)
    mean = spatial mean of y in fp32                   (the SE squeeze)

y is stored in ``x.dtype`` and the mean is taken over the ROUNDED y, as the
TPU kernel does, so the SE input is the same whichever version ran.

- :func:`dw_bn_silu_mean_plain` -- plain PyTorch (fp32 grouped conv).
- :func:`dw_bn_silu_mean` -- K2, the hand-written kernel ``csrc/dw_se.cu``
  for a CUDA tensor; a CPU tensor takes the plain version.
- :func:`pack_dwse` / :func:`dw_bn_silu_mean_packed` -- the kernel's weight
  layout, ``[C, WS]`` fp32 (the k*k taps, then the shift, zero-padded to 16
  bytes per channel), packed once per model (``models/efficientnet.py``
  keeps it), and the launch that takes it.
- :func:`dwse_plan` -- the host-side plan of a launch (planes per unit, band
  rows, ring depth, strip width, grid) and the shared-memory layout the
  kernel derives from it, so the choice is checked on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from ewvit_tpu_torch.ops import extension

THREADS = 224                # csrc/dw_se.cu kThreads
SMEM_LIMIT = 232448          # 227 KB of shared memory a block can use on an H100
SMEM_PER_SM = 233472         # 228 KB per SM, 1 KB of it reserved per resident block
# blocks per SM by compute path, as csrc/dw_se.cu's __launch_bounds__ give them
BLOCKS_PER_SM = {"rows14": 4, "planes7": 2, "strips": 3}
STAGE_BYTES = 8192           # input bytes per ring stage the plan aims at
STAGES = 4                   # ring depth


def packed_width(kernel: int) -> int:
    """Floats per channel in the packed weights: k*k taps and the shift,
    rounded up to 16 bytes."""
    return -(-(kernel * kernel + 1) // 4) * 4


def _check(x: torch.Tensor, w_eff: torch.Tensor, shift: torch.Tensor, kernel: int):
    if kernel not in (3, 5):
        raise ValueError(f"kernel must be 3 or 5 (odd, stride-1 SAME), got {kernel}")
    if x.dim() != 4:
        raise ValueError(f"expected x [N, C, H, W], got {tuple(x.shape)}")
    c = x.shape[1]
    if tuple(w_eff.shape) != (kernel * kernel, c) or tuple(shift.shape) != (c,):
        raise ValueError(
            f"w_eff must be [{kernel * kernel}, {c}] and shift [{c}], got "
            f"{tuple(w_eff.shape)} and {tuple(shift.shape)}")


def dw_bn_silu_mean_plain(x: torch.Tensor, w_eff: torch.Tensor,
                          shift: torch.Tensor, kernel: int = 3
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, w_eff, shift, kernel)
    c = x.shape[1]
    wk = w_eff.to(torch.float32).t().reshape(c, 1, kernel, kernel)
    acc = F.conv2d(x.to(torch.float32), wk, shift.to(torch.float32),
                   padding=kernel // 2, groups=c)
    y = F.silu(acc).to(x.dtype)
    return y, y.to(torch.float32).mean(dim=(2, 3))


def pack_dwse(w_eff: torch.Tensor, shift: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """``w_eff [k*k, C]``, ``shift [C]`` -> ``[C, WS]`` fp32: row c holds
    ``w_eff[:, c]`` in tap order (dh-major), then ``shift[c]``, then zeros."""
    kk = kernel * kernel
    if w_eff.dim() != 2 or w_eff.shape[0] != kk or tuple(shift.shape) != (w_eff.shape[1],):
        raise ValueError(f"w_eff must be [{kk}, C] and shift [C], got "
                         f"{tuple(w_eff.shape)} and {tuple(shift.shape)}")
    rows = torch.cat([w_eff.to(torch.float32).t(), shift.to(torch.float32)[:, None]], dim=1)
    return F.pad(rows, (0, packed_width(kernel) - kk - 1)).contiguous()


def unpack_dwse(packed: torch.Tensor, kernel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_dwse`: ``(w_eff [k*k, C], shift [C])``."""
    kk = kernel * kernel
    return packed[:, :kk].t(), packed[:, kk]


@dataclasses.dataclass(frozen=True)
class DwsePlan:
    """One launch of K2: the problem, the plan's choices and the grid.

    A unit is ``group`` whole planes (``band_rows == h``), or one band of
    ``band_rows`` output rows of one plane (``group == 1``) with its k//2
    halo rows. Block b walks units b, b + grid, ... and the bands of each
    in order; a ring of ``stages`` stages holds the units' inputs; each
    thread computes ``strip`` adjacent outputs of one row."""

    n: int
    c: int
    h: int
    w: int
    kernel: int
    itemsize: int
    group: int
    band_rows: int
    stages: int
    strip: int
    grid: int

    @property
    def planes(self) -> int:
        return self.n * self.c

    @property
    def bands(self) -> int:
        return -(-self.h // self.band_rows)

    @property
    def units(self) -> int:
        return -(-self.planes // self.group)

    @property
    def tasks(self) -> int:
        """Strips per unit, the strip sums' slots in shared memory (none on
        the compiled-in paths)."""
        if self.path != "strips":
            return 0
        return self.group * self.band_rows * -(-self.w // self.strip)

    @property
    def path(self) -> str:
        """The kernel's compute path (csrc/dw_se.cu launch_sw): ``rows14``
        (14 x 14 compiled in, a thread per 2 output rows at k = 3 and per
        row at k = 5, ``rows14_lanes`` lanes per plane), ``planes7`` (7 x 7
        compiled in, a thread per plane) or ``strips`` (any plane, a thread
        per strip of ``strip`` outputs)."""
        if self.bands == 1 and self.h == self.w == self.strip:
            return {14: "rows14", 7: "planes7"}.get(self.h, "strips")
        return "strips"

    @property
    def lanes(self) -> int:
        """Threads' work items per full unit."""
        return {"rows14": rows14_lanes(self.kernel) * self.group,
                "planes7": self.group}.get(self.path) or self.tasks

    def _src_rows(self) -> int:
        if self.bands == 1:
            return self.h
        return min(self.h, self.band_rows + 2 * (self.kernel // 2))

    def layout(self) -> dict:
        """Shared-memory layout in bytes, as csrc/dw_se.cu make_geo lays it
        out: ``stages`` x (input run + weight window), two y tiles, two
        buffers of strip sums, one mbarrier per stage."""
        r = lambda v: -(-v // 128) * 128   # noqa: E731
        x_stage = r(self.group * self._src_rows() * self.w * self.itemsize)
        stage = x_stage + r(min(self.group, self.c) * packed_width(self.kernel) * 4)
        y_tile = r(self.group * self.band_rows * self.w * self.itemsize)
        part = r(self.tasks * 4)
        smem = self.stages * stage + 2 * y_tile + 2 * part + 8 * self.stages
        return dict(x_stage=x_stage, stage=stage, y_tile=y_tile, smem=smem)

    @property
    def smem_bytes(self) -> int:
        return self.layout()["smem"]

    def steps(self) -> Iterator[dict]:
        """Every unit step of the launch, as the kernel decodes it: byte
        offsets and sizes of its input run (from x) and output run (into y),
        whether each goes by bulk copy (16-byte aligned and sized) or by
        ordinary loads and stores, and its output rows."""
        p = self.kernel // 2
        for u in range(self.units):
            plane0 = u * self.group
            np_ = min(self.group, self.planes - plane0)
            for band in range(self.bands):
                r0 = band * self.band_rows
                nr = min(self.band_rows, self.h - r0)
                sr0, sr1 = max(0, r0 - p), min(self.h, r0 + nr + p)
                x_off = (plane0 * self.h + sr0) * self.w * self.itemsize
                y_off = (plane0 * self.h + r0) * self.w * self.itemsize
                x_bytes = np_ * (sr1 - sr0) * self.w * self.itemsize
                y_bytes = np_ * nr * self.w * self.itemsize
                yield dict(unit=u, band=band, plane0=plane0, planes=np_, r0=r0, rows=nr,
                           src_rows=(sr0, sr1), x_off=x_off, x_bytes=x_bytes,
                           x_bulk=(x_off | x_bytes) % 16 == 0, y_off=y_off,
                           y_bytes=y_bytes, y_bulk=(y_off | y_bytes) % 16 == 0)


def rows14_lanes(kernel: int) -> int:
    """Lanes per 14 x 14 plane (csrc/dw_se.cu rows14_lanes): 7 tasks of 2
    rows at k = 3, 14 of one row at k = 5, rounded up to a power of two."""
    return 8 if kernel == 3 else 16


def _strip(w: int) -> int:
    """Outputs per thread along a row: the width in {8, 7, 4} that leaves the
    fewest idle columns (the widest on a tie)."""
    return min((8, 7, 4), key=lambda s: (-(-w // s) * s - w, -s))


@functools.lru_cache(maxsize=256)
def dwse_plan(n: int, c: int, h: int, w: int, kernel: int, itemsize: int,
              sm_count: int = 132, stage_bytes: int = STAGE_BYTES,
              stages: int = STAGES) -> DwsePlan:
    """Plan one launch of K2 for ``x [n, c, h, w]`` of ``itemsize`` bytes.

    - 14 x 14 and 7 x 7 (V2-S; compiled into the kernel): units of the
      planes that fill the block's 224 threads: 28 (k = 3, ``rows14_lanes``
      8 each) or 14 (k = 5, 16 lanes) at 14 x 14, 224 at 7 x 7 (a thread
      per plane); all multiples of 16 bytes.
    - Other small planes: units of G whole planes, G the largest multiple of a step
      with G * plane bytes <= ``stage_bytes``. The step makes a full unit's
      run a multiple of 16 bytes (so every unit starts 16-byte aligned) and,
      where that stays within ``stage_bytes``, its strips a multiple of the
      block's 224 threads (no idle passes).
    - A plane larger than twice ``stage_bytes`` (B0's 112x112): bands of
      output rows, a multiple of the rows that fill the threads where that
      stays within ``stage_bytes``.
    - The ring: ``stages`` deep, less (down to 2) while the path's blocks
      per SM (``BLOCKS_PER_SM``) would not fit in its shared memory, and
      less while the layout exceeds 227 KB.
    - The grid: the resident blocks (``BLOCKS_PER_SM`` per SM, or fewer
      where shared memory bounds them), or one block per unit if fewer.

    Raises ``ValueError`` for a shape no plan fits (none at k <= 5 and
    planes <= 112x112)."""
    if kernel not in (3, 5):
        raise ValueError(f"kernel must be 3 or 5, got {kernel}")
    planes = n * c
    strip = _strip(w)
    strips = -(-w // strip)
    plane_bytes = h * w * itemsize
    row_bytes = w * itemsize
    if h == w == 14:
        # the planes that fill the 224 threads (their bytes a multiple of 16)
        step = THREADS // rows14_lanes(kernel)
        strip, group = 14, step * max(1, stage_bytes // (step * plane_bytes))
        group, band_rows = min(planes, group), h
    elif h == w == 7:
        strip, group, band_rows = 7, min(planes, THREADS), h    # a thread per plane
    elif plane_bytes > 2 * stage_bytes:
        step = THREADS // math.gcd(THREADS, strips)
        if step * row_bytes > stage_bytes:
            step = 1
        group, band_rows = 1, min(h, max(step, stage_bytes // row_bytes // step * step))
    else:
        fill = THREADS // math.gcd(THREADS, h * strips)
        align = 16 // math.gcd(16, plane_bytes)
        step = math.lcm(fill, align)
        if step * plane_bytes > stage_bytes:
            step = align
        group = min(planes, max(step, stage_bytes // plane_bytes // step * step))
        band_rows = h
    plan = DwsePlan(n, c, h, w, kernel, itemsize, group, band_rows, stages, strip, 1)
    blocks = BLOCKS_PER_SM[plan.path]
    # the ring as deep as lets the path's blocks share an SM, down to 2
    while plan.stages > 2 and plan.smem_bytes + 1024 > SMEM_PER_SM // blocks:
        plan = dataclasses.replace(plan, stages=plan.stages - 1)
    while plan.smem_bytes > SMEM_LIMIT:
        if plan.stages > 2:
            plan = dataclasses.replace(plan, stages=plan.stages - 1)
        elif plan.band_rows > 1 and plan.group == 1:
            plan = dataclasses.replace(plan, band_rows=plan.band_rows // 2)
        elif plan.group > 1:
            plan = dataclasses.replace(plan, group=plan.group // 2)
        else:
            raise ValueError(f"K2 cannot fit x [{n}, {c}, {h}, {w}] (k={kernel}) in "
                             f"{SMEM_LIMIT} bytes of shared memory")
    per_sm = max(1, min(blocks, SMEM_PER_SM // (plan.smem_bytes + 1024)))
    return dataclasses.replace(plan, grid=min(plan.units, sm_count * per_sm))


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dw_bn_silu_mean_packed(x: torch.Tensor, packed: torch.Tensor, kernel: int = 3,
                           plan: Optional[DwsePlan] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 with weights from :func:`pack_dwse` (``plan`` defaults to
    :func:`dwse_plan`); a CPU tensor takes the plain version."""
    if x.dim() != 4 or tuple(packed.shape) != (x.shape[1], packed_width(kernel)):
        raise ValueError(f"expected x [N, C, H, W] and packed [C, {packed_width(kernel)}], "
                         f"got {tuple(x.shape)} and {tuple(packed.shape)}")
    if x.device.type == "cpu":
        return dw_bn_silu_mean_plain(x, *unpack_dwse(packed, kernel), kernel)
    extension.check_cuda_tensor(x, "x")
    extension.check_cuda_tensor(packed, "packed", torch.float32)
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("K2 needs x and the packed weights 16-byte aligned "
                         "(its bulk copies start on 16-byte boundaries)")
    n, c, h, w = x.shape
    if plan is None:
        plan = dwse_plan(n, c, h, w, kernel, x.element_size(), _sm_count(x.device.index or 0))
    y = torch.empty_like(x)
    mean = torch.empty(n, c, dtype=torch.float32, device=x.device)
    extension.launch("dw_se", "ewvit_dw_bn_silu_mean", "dw_bn_silu_mean",
                     x.data_ptr(), packed.data_ptr(), y.data_ptr(), mean.data_ptr(),
                     n, c, h, w, kernel, extension.dtype_code(x), plan.group,
                     plan.band_rows, plan.stages, plan.strip, plan.grid)
    return y, mean


def dw_bn_silu_mean(x: torch.Tensor, w_eff: torch.Tensor, shift: torch.Tensor,
                    kernel: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on a CUDA tensor, :func:`dw_bn_silu_mean_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return dw_bn_silu_mean_plain(x, w_eff, shift, kernel)
    _check(x, w_eff, shift, kernel)
    extension.check_cuda_tensor(w_eff, "w_eff", torch.float32)
    extension.check_cuda_tensor(shift, "shift", torch.float32)
    return dw_bn_silu_mean_packed(x, pack_dwse(w_eff, shift, kernel), kernel)
