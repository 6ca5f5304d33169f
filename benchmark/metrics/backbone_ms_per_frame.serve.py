"""backbone_ms_per_frame.serve: device ms of the configuration's SFE
backbone (``modules.backbone``: V2-S in DAMA, B0 in ``sfe``) on one full
chunk of the cell's inputs, warm: every device kernel of 5 calls summed
from the profiler, over the calls and the chunk's rows (the host's pace
between launches does not enter it)."""

from benchmark.lib import layers


def read(run, drv):
    if not run.on_card:
        return None
    return layers.module_ms_per_row(run, drv, run.cfg["modules"]["backbone"])
