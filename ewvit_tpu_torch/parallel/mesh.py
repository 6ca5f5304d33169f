"""The ('dcn', 'data', 'frames') process mesh over ``torch.distributed``
(ewvit_tpu/parallel/mesh.py).

One process per device. Ranks are laid out row-major with ``dcn`` slowest,
as ``np.reshape(devices, (dcn, data, frames))`` lays out the JAX devices:
rank ``r`` sits at ``np.unravel_index(r, (dcn, data, frames))``. Clips
``[B, K, ...]`` shard B over the batch axis (``dcn`` x ``data``) and,
where a caller asks for it (serving, and training with ``F > 1``), K over
``frames``:

- the **batch group** of a rank: the ranks with its ``frames`` coordinate,
  in rank order; the rank's place in it is its batch index
  ``dcn_i * data + data_i``, and it holds global rows
  ``[index * B/W, (index + 1) * B/W)`` of each batch of B clips (W = dcn x
  data);
- the **frames group**: the ranks with its (dcn, data) coordinates. In
  serving (``InferenceEngine(frame_axis=True)``) the rank at ``frames``
  coordinate ``f`` holds frames ``[f * K/F, (f+1) * K/F)``.

Training on a frames axis (``F > 1``) lays the frames out by chunk instead:
every rank of a frames group holds the same clips (its batch rows, from
:meth:`Mesh.shard` or ``data.pipeline.BatchLoader(shard=batch_shard)``,
as the JAX ``Trainer`` replicates a batch over frames), and of each chunk of
``n`` frames the rank at coordinate ``f`` runs its contiguous share
:meth:`Layout.frame_share` ``(n, f)``: ``ceil(n/F)`` frames, fewer or none at
the end (a ragged tail chunk shorter than ``F`` leaves the last ranks no row
of it). So every rank runs every chunk and joins the same sequence of
collectives: train-mode BN takes its statistics over the **whole mesh**
(every rank holds rows of every chunk, a zero-row rank adds nothing), each
running statistic moves once per global chunk, in the unsplit order, and the
per-clip sums are all-reduced over the frames group before the head.

:func:`make_mesh` joins the process group from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), or forms a
world of one through a ``FileStore`` in a temp directory (no port), or uses
a process group the caller has already initialised. The backend is NCCL for
CUDA (``cuda:LOCAL_RANK``) and gloo for the CPU; a mesh on CUDA without
NCCL raises, and nothing falls back to the other.

The collectives that carry gradients are autograd functions:
:func:`all_reduce_sum` (its backward an all-reduce-sum) and
:func:`all_gather_rows` (its backward a reduce-scatter; gloo has none, so
there it is an all-reduce and this rank's slice, the same sum).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ewvit_tpu_torch.device import DeviceLike, resolve_device

AXES = ("dcn", "data", "frames")
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Axis sizes of a mesh and the pure rank arithmetic (no processes)."""

    dcn: int
    data: int
    frames: int

    @property
    def batch(self) -> int:
        """W, the ranks a batch is split over (dcn x data)."""
        return self.dcn * self.data

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, (self.dcn, self.data, self.frames)))

    def coords(self, rank: int) -> Tuple[int, int, int]:
        return tuple(int(c) for c in np.unravel_index(rank, (self.dcn, self.data, self.frames)))

    def batch_index(self, rank: int) -> int:
        d, a, _ = self.coords(rank)
        return d * self.data + a

    def batch_members(self, rank: int) -> List[int]:
        """The ranks of ``rank``'s batch group, by batch index."""
        f = self.coords(rank)[2]
        return [i * self.frames + f for i in range(self.batch)]

    def frame_members(self, rank: int) -> List[int]:
        """The ranks of ``rank``'s frames group, by frames coordinate."""
        base = self.batch_index(rank) * self.frames
        return list(range(base, base + self.frames))

    def frame_share(self, n: int, f: int) -> Tuple[int, int]:
        """``(lo, hi)``: the frames of a chunk of ``n`` that the rank at
        frames coordinate ``f`` runs in training (contiguous, ``ceil(n/F)``
        each in order, an empty range where none are left)."""
        per = -(-n // self.frames)
        return min(n, f * per), min(n, (f + 1) * per)

    def batch_groups(self) -> List[List[int]]:
        return [self.batch_members(f) for f in range(self.frames)]

    def frame_groups(self) -> List[List[int]]:
        return [self.frame_members(i * self.frames) for i in range(self.batch)]


def make_layout(world: int, data: Optional[int] = None, frames: int = 1,
                dcn: Optional[int] = None, local_world: Optional[int] = None) -> Layout:
    """The mesh's axis sizes for ``world`` ranks, as ``make_mesh`` defaults
    them (ewvit_tpu/parallel/mesh.py:42-70): ``dcn`` is the node count
    ``world // local_world`` (1 without ``local_world``), ``data`` the rest.
    Raises when the product is not the world."""
    if dcn is None:
        dcn = world // local_world if local_world and world % local_world == 0 else 1
    if world % dcn:
        raise ValueError(f"{world} ranks not divisible by dcn={dcn}")
    per_node = world // dcn
    if data is None:
        if per_node % frames:
            raise ValueError(f"{per_node} ranks per node not divisible by frames={frames}")
        data = per_node // frames
    if dcn * data * frames != world:
        raise ValueError(f"mesh {dcn}x{data}x{frames} != {world} ranks")
    return Layout(dcn, data, frames)


def _backend(device: torch.device) -> str:
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this torch build lacks")
        return "nccl"
    if not dist.is_gloo_available():
        raise RuntimeError("a CPU mesh needs gloo, which this torch build lacks")
    return "gloo"


@dataclasses.dataclass
class Mesh:
    """This rank's view of the mesh; build it with :func:`make_mesh`."""

    layout: Layout
    rank: int
    device: torch.device
    batch_group: object
    frames_group: object
    _created: List[object] = dataclasses.field(default_factory=list, repr=False)
    _store_dir: Optional[str] = dataclasses.field(default=None, repr=False)
    _owns_world: bool = dataclasses.field(default=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return self.layout.shape

    @property
    def batch_size(self) -> int:
        """W: the ranks a batch is split over."""
        return self.layout.batch

    @property
    def batch_index(self) -> int:
        return self.layout.batch_index(self.rank)

    @property
    def frame_size(self) -> int:
        return self.layout.frames

    @property
    def frame_index(self) -> int:
        return self.layout.coords(self.rank)[2]

    @property
    def world_size(self) -> int:
        """The ranks of the mesh (dcn x data x frames)."""
        return self.layout.batch * self.layout.frames

    @property
    def world_group(self):
        """The process group of the whole mesh (the world: ``make_mesh``
        refuses a layout that is not)."""
        return dist.group.WORLD

    def frame_share(self, n: int) -> Tuple[int, int]:
        """This rank's frames ``(lo, hi)`` of a training chunk of ``n``."""
        return self.layout.frame_share(n, self.frame_index)

    @property
    def batch_shard(self) -> Tuple[int, int]:
        """``(index, count)`` for ``data.pipeline.BatchLoader(shard=)``."""
        return self.batch_index, self.batch_size

    def local_rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` clips."""
        if n % self.batch_size:
            raise ValueError(f"a batch of {n} clips does not split over the mesh's "
                             f"{self.batch_size} batch ranks (dcn x data)")
        b = n // self.batch_size
        return slice(self.batch_index * b, (self.batch_index + 1) * b)

    def shard(self, t: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """This rank's rows of ``t``, ``groups`` batches of clips one after
        the other (micro-batches of a step): ``[groups*B, ...] ->
        [groups*B/W, ...]``."""
        if t.shape[0] % groups:
            raise ValueError(f"{t.shape[0]} rows are not {groups} equal batches")
        rows = self.local_rows(t.shape[0] // groups)
        return t.reshape(groups, -1, *t.shape[1:])[:, rows].reshape(-1, *t.shape[1:])

    def gather(self, t: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """The inverse of :meth:`shard` over the batch group, differentiable:
        every rank gets the global rows in order."""
        full = all_gather_rows(t, self.batch_group, self.batch_index, self.batch_size)
        if groups == 1:
            return full
        w = self.batch_size
        return (full.reshape(w, groups, -1, *t.shape[1:]).transpose(0, 1)
                .reshape(-1, *t.shape[1:]))

    @torch.no_grad()
    def replicate_(self, module: torch.nn.Module) -> torch.nn.Module:
        """Broadcast ``module``'s parameters and buffers from rank 0, one
        flat buffer per dtype, copied back in place (``copy_`` bumps each
        tensor's version, so a kept fold sees the change)."""
        tensors = [t for t in (*module.parameters(), *module.buffers())]
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = _flatten_dense_tensors([t.detach() for t in group])
            dist.broadcast(flat, src=0)
            for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(v)
        return module

    def all_reduce_(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """In-place sum over ``group`` (default: the batch group); not
        differentiable."""
        dist.all_reduce(t, group=self.batch_group if group is None else group)
        return t

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def close(self) -> None:
        """Destroy the subgroups this mesh made, and the process group if
        :func:`make_mesh` formed it."""
        if not dist.is_initialized():
            return
        for g in self._created:
            dist.destroy_process_group(g)
        self._created = []
        if self._owns_world:
            dist.destroy_process_group()
            self._owns_world = False
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None


def make_mesh(data: Optional[int] = None, frames: int = 1, dcn: Optional[int] = None,
              *, device: DeviceLike = "cuda") -> Mesh:
    """This process's :class:`Mesh` (see the module docstring for how the
    process group is found or formed). ``dcn`` defaults to the node count
    ``WORLD_SIZE // LOCAL_WORLD_SIZE``, ``data`` to the rest; raises when
    ``dcn * data * frames`` is not the world size."""
    dev = resolve_device(device)
    backend = _backend(dev)
    env = all(k in os.environ for k in _TORCHRUN_ENV)
    local_rank = int(os.environ["LOCAL_RANK"]) if env else None
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank if env else torch.cuda.current_device())
        torch.cuda.set_device(dev)
    owns, store_dir = False, None
    if not dist.is_initialized():
        if env:
            dist.init_process_group(backend, init_method="env://",
                                    rank=int(os.environ["RANK"]),
                                    world_size=int(os.environ["WORLD_SIZE"]))
        else:
            store_dir = tempfile.mkdtemp(prefix="ewvit_mesh_")
            store = dist.FileStore(os.path.join(store_dir, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0, world_size=1)
        owns = True
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, but a mesh on "
                           f"{dev.type} needs {backend}")
    world, rank = dist.get_world_size(), dist.get_rank()
    local_world = int(os.environ["LOCAL_WORLD_SIZE"]) if "LOCAL_WORLD_SIZE" in os.environ \
        else None
    try:
        layout = make_layout(world, data, frames, dcn, local_world)
    except ValueError:
        if owns:
            dist.destroy_process_group()
            if store_dir:
                shutil.rmtree(store_dir, ignore_errors=True)
        raise
    mesh = Mesh(layout, rank, dev, None, None, _store_dir=store_dir, _owns_world=owns)
    # every rank creates every group, in the same order (new_group's contract)
    groups = {}
    for members in layout.batch_groups() + layout.frame_groups():
        key = tuple(members)
        if key in groups:
            continue
        if len(members) == world:
            groups[key] = dist.group.WORLD
        else:
            groups[key] = dist.new_group(members)
            mesh._created.append(groups[key])
    mesh.batch_group = groups[tuple(layout.batch_members(rank))]
    mesh.frames_group = groups[tuple(layout.frame_members(rank))]
    return mesh


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, index, size):
        ctx.group, ctx.index, ctx.size = group, index, size
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        if dist.get_backend(ctx.group) == "nccl":
            out = grad.new_empty((grad.shape[0] // ctx.size, *grad.shape[1:]))
            dist.reduce_scatter_tensor(out, grad, group=ctx.group)
        else:                    # gloo has no reduce-scatter: the same sum, sliced
            full = grad.clone()
            dist.all_reduce(full, group=ctx.group)
            out = full.chunk(ctx.size)[ctx.index].contiguous()
        return out, None, None, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group``; the gradient is summed over the group too."""
    return _AllReduceSum.apply(t, group)


def all_gather_rows(t: torch.Tensor, group, index: int, size: int) -> torch.Tensor:
    """``[n, ...]`` on each of ``size`` ranks -> ``[size*n, ...]`` in group
    order; the gradient of a rank's rows is the sum over the group of the
    gradients of those rows (reduce-scatter). ``index`` is this rank's place
    in ``group``."""
    return _AllGatherRows.apply(t, group, index, size)

