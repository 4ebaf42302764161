"""The traced window: ``torch.profiler`` over a run's first units, reduced
in memory to what the per-layer metrics read.

- Host spans are the benchmark's own ``record_function`` ranges, named
  ``bench.<what>`` (``bench.window`` around the traced units; inside it
  ``bench.prepare``, ``bench.call``, ``bench.read`` around the calls into
  the program). With tracing off a span is a no-op.
- Device operations are the trace's device events (kernels, copies,
  memsets) that are not annotations; the busy time is the length of the
  union of their intervals inside the window (the arithmetic of the
  program's ``profile_stream._busy_us``, copied).
- An idle gap is an interval of the window in which no device operation
  ran, labelled by the innermost benchmark span open where it starts.

Nothing is written to disk: the events stay in memory and only the
summary leaves this module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "bench."


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted ones."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


@dataclasses.dataclass
class Trace:
    """A traced window: its length, the device operations in it and the
    benchmark's host spans (all times in microseconds of the trace's
    clock)."""

    window: Tuple[float, float]
    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return busy_us([(s, e) for _, s, e in self.ops]) / 1e6

    def op_seconds(self, fragments) -> float:
        """Device seconds of the operations whose name holds any of
        ``fragments``."""
        return sum(e - s for n, s, e in self.ops
                   if any(f in n for f in fragments)) / 1e6

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda i: -i[1])[:k]
        return [[n, us / 1e6] for n, us in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest idle gaps, each [span open at its start,
        seconds]."""
        w0, w1 = self.window
        gaps, at = [], w0
        for s, e in merged([(s, e) for _, s, e in self.ops]):
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if w1 > at:
            gaps.append((at, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.span_at(s), (e - s) / 1e6] for s, e in gaps[:k]]

    def span_at(self, t: float) -> str:
        """The innermost benchmark span (but the window) open at ``t``."""
        best = None
        for n, s, e in self.spans:
            if n != "window" and s <= t < e and (best is None
                                                 or s >= best[1]):
                best = (n, s)
        return best[0] if best else "none"


class Tracer:
    """Spans and, when on, the profiler around a run's traced units."""

    def __init__(self, on: bool):
        self.on = on
        self._prof = None
        self.trace: Optional[Trace] = None

    def span(self, what: str):
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN_PREFIX + what)

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(SPAN_PREFIX + "window")
        self._window.__enter__()

    def stop(self, sync) -> None:
        """End the traced units (``sync`` waits for the device) and reduce
        the trace."""
        if self._prof is None:
            return
        sync()
        self._window.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.trace = reduce(prof)


def reduce(prof) -> Trace:
    ops, spans = [], []
    for e in prof.events():
        name = e.name
        t = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # an annotation (ours, or the optimizer's "Optimizer.step#...")
            # shows on the device timeline too, spanning its idle gaps
            if (getattr(e, "is_user_annotation", False)
                    or name.startswith((SPAN_PREFIX, "Optimizer."))):
                continue
            ops.append((name, *t))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], *t))
    window = [(s, e) for n, s, e in spans if n == "window"]
    if not window:
        print("trace: the window span is missing", file=sys.stderr)
        window = [(min((s for _, s, _ in ops), default=0.0),
                   max((e for _, _, e in ops), default=0.0))]
    w0, w1 = window[0]
    ops = [(n, max(s, w0), min(e, w1)) for n, s, e in ops
           if e > w0 and s < w1]
    return Trace((w0, w1), ops, spans)
