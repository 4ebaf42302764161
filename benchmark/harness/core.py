"""What a traffic driver is given and what it returns.

A driver (``benchmark/drivers/<name>.py``) has one function, ``run(run)
-> Result``: set-up, the measured window, and the comparison of what the
timed path produced with the plain reference. ``run.role`` is
``"program"`` for the system under test, ``"control"`` for the reference
put in its place at a lower precision (``benchmark/control.py``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .trace import Tracer


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    device: torch.device
    t0: float  # perf_counter at process start
    tracer: Tracer
    role: str = "program"
    # tests only: narrower model and frames (benchmark/tests)
    overrides: Optional[dict] = None
    # tests only: called with the built system before the window
    plant: Optional[Callable] = None

    def sub_seed(self, what: str) -> int:
        """A seed of its own for each kind of draw."""
        tag = sum(ord(c) * 31 ** i for i, c in enumerate(what)) % 1000003
        return (self.seed * 1000003 + tag) % (1 << 62)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self) -> float:
        return time.perf_counter()

    def setup_s(self) -> float:
        return time.perf_counter() - self.t0


@dataclasses.dataclass
class Result:
    metrics: Dict[str, float]
    attempted: int
    failed: int
    # short name -> (number compared, its limit)
    checks: Dict[str, Tuple[float, float]]
    units_traced: int = 0
    memory_peak_bytes: int = 0
    # numbers read beside the compared ones, not compared (diagnostics)
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def p95(values: List[float]) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    """Return the program's freed memory to the device, so the reference
    that runs next finds it."""
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
