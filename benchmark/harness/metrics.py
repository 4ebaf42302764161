"""What a per-layer metric's reader (``benchmark/metrics/<name>.py``) is
given: the trace of the window's first units, how many units (frames or
steps) it holds, the work one unit needs (``harness/work.py``) and the
card's published peaks. A reader returns None where it finds nothing to
read, and never a 0 in place of a share it could not measure."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .trace import Trace


@dataclasses.dataclass
class Context:
    trace: Optional[Trace]
    units: int
    work: Dict[str, float]
    peaks: Dict[str, float]

    @property
    def readable(self) -> bool:
        """A trace with device operations and units in it."""
        return (self.trace is not None and bool(self.trace.ops)
                and self.units > 0 and self.trace.window_s > 0)


def launches(ctx: Context) -> Optional[float]:
    """Device operations (kernels, copies, memsets) a unit."""
    return len(ctx.trace.ops) / ctx.units if ctx.readable else None


def mfu(ctx: Context) -> Optional[float]:
    """% of the bf16 peak: the work's FLOPs over the traced window."""
    if not ctx.readable:
        return None
    rate = ctx.work["flops"] * ctx.units / ctx.trace.window_s
    return 100.0 * rate / ctx.peaks["bf16_flops"]


def roofline(ctx: Context, names) -> Optional[float]:
    """% of its roofline a kernel reaches: the least time its work's bytes
    take at the card's memory bandwidth over the device time of the
    operations named by ``names``."""
    if not ctx.readable:
        return None
    s = ctx.trace.op_seconds(names)
    if s <= 0:
        return None
    bound = ctx.work["b1_bytes"] * ctx.units / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / s


def idle_share(ctx: Context) -> Optional[float]:
    """% of the traced window in which no device operation ran."""
    if not ctx.readable:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
