"""Data parallelism over ``torch.distributed`` (ewvit_tpu/parallel)."""

from ewvit_tpu_torch.parallel.mesh import (
    AXES,
    Layout,
    Mesh,
    all_gather_rows,
    all_reduce_sum,
    make_layout,
    make_mesh,
)

__all__ = ["AXES", "Layout", "Mesh", "all_gather_rows", "all_reduce_sum", "make_layout",
           "make_mesh"]
