"""Served frames against the plain reference.

The reference generator runs in fp32 (TF32 off) on the same uint8 input
frames and the same weights; its output is quantised to uint8 as the
program's wire does (clip to [-1, 1], (x + 1) * 127.5, truncated). A
frame's gap is the root mean square of the two uint8 frames' difference,
in levels of 255.

A temporal frame conditions on the stream's previous output. The
reference takes it from the previous frame the program served on the
wire, dequantised to the middle of its uint8 level: it follows the
program's stream frame by frame, and a frame right after a stream's reset
(a zero carry) checks the start on its own.

Each frame's gap is read several ways (``STATS``): ``rms`` over pixels,
and ``rms<k>``, the root mean square of the difference averaged over
k x k blocks (the two frames compared at 1/k of their resolution). A
cell compares the statistics its limits file names (``<what>_<stat>``)
and reports the others beside them.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness.synth import to_unit


def quantize(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8, truncated, as the program's wire."""
    return ((x.float().clamp(-1, 1) + 1.0) * 127.5).to(torch.uint8)


def dequantize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> the middle of its level in [-1, 1]."""
    return (u8.float() + 0.5) / 127.5 - 1.0


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
def generate(G: torch.nn.Module, frames_u8: torch.Tensor,
             carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """G's uint8 frames for NHWC uint8 ``frames_u8`` on G's device; a
    temporal generator conditions on ``carry`` (NHWC, in [-1, 1])."""
    x = to_unit(frames_u8)
    if carry is not None:
        x = torch.cat([x, carry], dim=-1)
    return nhwc(quantize(G(nchw(x).contiguous())))


POOLS = (4, 16, 64)


def stats(a_u8: np.ndarray, b_u8: np.ndarray) -> Dict[str, float]:
    """The gaps between two HWC uint8 frames, in levels of 255."""
    d = a_u8.astype(np.float64) - b_u8.astype(np.float64)
    out = {"rms": float(np.sqrt(np.mean(d * d)))}
    h, w = d.shape[:2]
    for k in (k for k in POOLS if k <= min(h, w)):
        p = d[:h // k * k, :w // k * k].reshape(
            h // k, k, w // k, k, -1).mean(axis=(1, 3))
        out[f"rms{k}"] = float(np.sqrt(np.mean(p * p)))
    return out


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length,
    drawn from a seeded generator: the same seed and the same stream give
    the same sample."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: List = []

    def offer(self, make) -> None:
        """Offer the next item; ``make()`` builds it only if it is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = make()


def worst_gaps(G: torch.nn.Module, items: List[Dict], carry_c: int,
               device, block: int) -> Dict[str, float]:
    """The largest of each statistic over ``items`` (dicts of ``frame``,
    ``out`` and ``prev`` uint8 HWC arrays, ``prev`` None after a reset);
    inf when there is none."""
    if not items:
        return {k: float("inf") for k in ["rms"] + [f"rms{k}" for k in POOLS]}
    worst: Dict[str, float] = {}
    for i in range(0, len(items), block):
        part = items[i:i + block]
        frames = torch.from_numpy(np.stack([it["frame"] for it in part])
                                  ).to(device)
        carry = None
        if carry_c:
            # a reset's carry is zero, not the middle of level 0
            carry = torch.stack([
                torch.zeros(frames.shape[1:3] + (carry_c,), device=device)
                if it["prev"] is None else
                dequantize(torch.from_numpy(it["prev"]).to(device))
                for it in part])
        ref = generate(G, frames, carry).cpu().numpy()
        for it, r in zip(part, ref):
            for k, v in stats(it["out"], r).items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def checks(gaps: Dict[str, Dict[str, float]], limits: Dict[str, float]):
    """``{what: worst_gaps}`` -> (the checks ``limits`` names, each
    ``<what>_<stat>``: (number, limit); every other reading)."""
    every = {f"{what}_{k}": v for what, g in gaps.items()
             for k, v in g.items()}
    return ({k: (every[k], lim) for k, lim in limits.items()},
            {k: v for k, v in every.items() if k not in limits})
