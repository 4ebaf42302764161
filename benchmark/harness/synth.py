"""Seeded procedural IR video and its RGB target, made on the device.

A copy of the program's ``data/synthetic.py::synthetic_pair``, batched:
each clip has three Gaussian blobs whose centres drift right by a tenth
of the width a frame; the IR frame is the blob field normalised to its
maximum, in three equal channels, and the RGB target a fixed colouring
of the same field. uint8, truncated as the original.
"""

from __future__ import annotations

import torch


def clips(seed: int, n: int, frames: int, size: int, device,
          with_rgb: bool = False):
    """(n, frames, size, size, 3) uint8 IR clips (and their RGB targets
    with ``with_rgb``), on ``device``: the same seed gives the same
    clips."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 104729 + 17) % (1 << 63))
    blobs = torch.rand((n, 3, 3), generator=gen, device=device)
    ax = torch.arange(size, device=device, dtype=torch.float32) / size
    t = torch.arange(frames, device=device, dtype=torch.float32)
    ir = torch.empty((n, frames, size, size, 3), dtype=torch.uint8,
                     device=device)
    rgb = torch.empty_like(ir) if with_rgb else None
    for i in range(n):
        cx = (blobs[i, :, 0][None, :] + 0.1 * t[:, None]) % 1.0  # (T, 3)
        cy = blobs[i, :, 1][None, :].expand_as(cx)
        r = blobs[i, :, 2][None, :].expand_as(cx)
        dx = (ax[None, None, None, :] - cx[..., None, None]) ** 2
        dy = (ax[None, None, :, None] - cy[..., None, None]) ** 2
        base = torch.exp(-(dx + dy) / (0.02 + 0.05 * r[..., None, None]))
        base = base.sum(1)  # (T, H, W)
        base = base / base.amax(dim=(1, 2), keepdim=True).clamp(min=1e-6)
        ir[i] = (base * 255).to(torch.uint8)[..., None].expand(
            frames, size, size, 3)
        if with_rgb:
            col = torch.stack([base, torch.roll(base, size // 8, dims=1),
                               1.0 - base], dim=-1)
            rgb[i] = (col.clamp(0, 1) * 255).to(torch.uint8)
    return (ir, rgb) if with_rgb else ir


def to_unit(u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> [-1, 1] float32, as the program's wire normalises."""
    return u8.to(torch.float32) / 127.5 - 1.0
