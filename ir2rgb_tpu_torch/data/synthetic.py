"""Synthetic IR/RGB data for tests and smoke runs (SURVEY.md §4.3).

Generates structured procedural frames where the RGB target is a known,
learnable function of the IR input (colorized gradients + moving blobs),
so a 50-step overfit run measurably improves PSNR. Also writes the frames
to disk in the A/B folder layout to exercise the real loader.

The port's copy of ``ir2rgb_tpu/data/synthetic.py`` (plain Python
and numpy; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def synthetic_pair(seed: int, size: int = 64, t: float = 0.0,
                   in_ch: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """One (IR, RGB) uint8 pair; `t` shifts blob positions (video time)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.zeros((size, size), np.float32)
    for _ in range(3):
        cx, cy, r = rng.rand(3)
        cx = (cx + 0.1 * t) % 1.0
        base += np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                         / (0.02 + 0.05 * r)))
    base = base / max(base.max(), 1e-6)
    ir = (base * 255).astype(np.uint8)
    ir = np.repeat(ir[..., None], in_ch, axis=-1)
    # RGB: deterministic colorization of the IR intensity field
    rgb = np.stack([
        base, np.roll(base, size // 8, axis=0), 1.0 - base], axis=-1)
    rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    return ir, rgb


def synthetic_pair_batch(batch: int, size: int = 64, seed: int = 0,
                         in_ch: int = 3) -> Dict[str, np.ndarray]:
    irs, rgbs = [], []
    for i in range(batch):
        ir, rgb = synthetic_pair(seed + i, size, in_ch=in_ch)
        irs.append(ir)
        rgbs.append(rgb)
    return {"a": np.stack(irs), "b": np.stack(rgbs)}


def write_synthetic_dataset(root: str, n: int = 8, size: int = 64,
                            n_videos: int = 0, frames_per_video: int = 6,
                            seed: int = 0) -> None:
    """A/B folder layout; with n_videos>0, per-video subfolders (temporal)."""
    from PIL import Image
    if n_videos:
        for v in range(n_videos):
            for sub in ("A", "B"):
                os.makedirs(os.path.join(root, sub, f"vid{v:03d}"),
                            exist_ok=True)
            for f in range(frames_per_video):
                ir, rgb = synthetic_pair(seed + v, size, t=float(f))
                Image.fromarray(ir).save(
                    os.path.join(root, "A", f"vid{v:03d}", f"{f:04d}.png"))
                Image.fromarray(rgb).save(
                    os.path.join(root, "B", f"vid{v:03d}", f"{f:04d}.png"))
        return
    os.makedirs(os.path.join(root, "A"), exist_ok=True)
    os.makedirs(os.path.join(root, "B"), exist_ok=True)
    for i in range(n):
        ir, rgb = synthetic_pair(seed + i, size)
        Image.fromarray(ir).save(os.path.join(root, "A", f"{i:04d}.png"))
        Image.fromarray(rgb).save(os.path.join(root, "B", f"{i:04d}.png"))
