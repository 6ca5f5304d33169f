"""The state one run carries from set-up to the result line."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from benchmark.lib.manifest import Cell


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    # filled in as the run goes
    program: Dict[str, Any] = dataclasses.field(default_factory=dict)   # the system under test
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)      # inputs, state, pool
    window: Dict[str, Any] = dataclasses.field(default_factory=dict)    # frames, seconds, ...
    traced: Dict[str, Any] = dataclasses.field(default_factory=dict)    # trace reduction

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        """Start the device's memory peak afresh: what the benchmark made for
        itself before the program's set-up is not the program's."""
        if self.on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
