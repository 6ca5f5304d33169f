"""Device selection for the port's entry points.

Counterpart of ``ewvit_tpu/utils/platform.py``. The port runs on an NVIDIA
GPU; the CPU is taken only when a caller names it (the CPU tests do). A
request for CUDA on a machine without a usable GPU raises instead of falling
back.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"``/``"cuda:i"``/``"cpu"`` -> ``torch.device``; refuses a missing GPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} requested but only {torch.cuda.device_count()} "
                "CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """Config dtype name (``"bfloat16"``, ``"float32"``) -> ``torch.dtype``."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt
