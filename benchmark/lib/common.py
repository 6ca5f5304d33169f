"""Seeds, the device, and the guard against JAX in the measured process."""

from __future__ import annotations

import subprocess
import sys
from typing import List

import numpy as np

# the JAX reference package and its stack: never loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "ewvit_tpu")


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose (``tags``) of a run seeded ``seed``;
    any whole ``seed`` (numpy's SeedSequence takes large and negative ones
    as its entropy)."""
    entropy = [abs(int(seed)), int(seed < 0)]
    state = np.random.SeedSequence(entropy, spawn_key=[int(t) for t in tags]).generate_state(2)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` (compared whole) that a run must
    not load."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in FORBIDDEN if n in names)


def require_cuda(count: int):
    """Raise unless ``count`` CUDA devices are visible."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("benchmark: no CUDA device is available")
    if torch.cuda.device_count() < count:
        raise SystemExit(f"benchmark: the cell needs {count} CUDA devices, "
                         f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def power_limit() -> str:
    """``name, power.limit`` from nvidia-smi, or why it is not known."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else f"nvidia-smi rc={out.returncode}"
