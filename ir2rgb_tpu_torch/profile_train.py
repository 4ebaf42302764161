"""Where a train step's time goes on the card: each preset's train step at
full width, its crop size and batch 1, unfrozen (the trunk trains), timed
with CUDA events and then traced with torch.profiler; device time by kind
and by kernel, the device's busy time and idle share of a step, the
device launches per step, the kernel wrappers' launches per step and the
peak memory. The idle share is taken against the step time measured
without the profiler, since tracing slows the host. A temporal preset
trains on one (1, n_frames_total, H, W, C) window a step.

    python -m ir2rgb_tpu_torch.profile_train [--preset P [P ...] | all]
        [--dtype bf16|float32]

prints one JSON object a preset, the top kernels last.

Needs one CUDA device. Weights are the seeded reference init (the VGG the
seeded He-random fallback), inputs uniform in [-1, 1] from a numpy seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import warnings

import numpy as np
import torch

from ir2rgb_tpu_torch.profile_stream import card_line, summarize

STEPS = 5


def main(argv=None) -> int:
    from ir2rgb_tpu_torch import set_parity_mode
    from ir2rgb_tpu_torch.config import PRESETS
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", nargs="+", default=["pix2pixhd_512"],
                    choices=sorted(PRESETS) + ["all"])
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "float32"))
    args = ap.parse_args(argv)
    set_parity_mode()  # fp32 convs without TF32; bf16 is unaffected
    warnings.filterwarnings("ignore", message="VGG perceptual loss")
    presets = list(PRESETS) if "all" in args.preset else args.preset
    for preset in presets:
        res = profile_preset(preset, args.dtype)
        if res is None:
            return 2
        print(json.dumps(res), flush=True)
    return 0


def train_batch(cfg, seed: int = 0, device: str = "cuda", size: int = None):
    """One batch-1 batch of ``size``-square frames (``cfg``'s crop size
    when None), uniform in [-1, 1] from a numpy seed: (1, H, W, C)
    frames, or a temporal model's (1, n_frames_total, H, W, C) window."""
    m = cfg.model
    size = size or cfg.data.crop_size
    lead = (1, cfg.data.n_frames_total) if m.model == "temporal" else (1,)
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.uniform(
        -1, 1, lead + (size, size, nc)).astype(np.float32)).to(device)
        for k, nc in (("a", m.input_nc), ("b", m.output_nc))}


def profile_preset(preset: str, dtype: str):
    """The profile of ``preset``'s unfrozen train step (None when the
    trace holds no device events)."""
    from torch.profiler import ProfilerActivity, profile

    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    from ir2rgb_tpu_torch.train import create_model

    cfg = PRESETS[preset]
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype=dtype),
        train=dataclasses.replace(cfg.train, niter_fix_global=0))
    model = create_model(cfg)
    batch = train_batch(cfg)
    for _ in range(3):
        model.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STEPS):
        model.train_step(batch)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / STEPS
    peak = torch.cuda.max_memory_allocated()
    kernels = {k: v // STEPS for k, v in launch_counts().items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            model.train_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    res = summarize(prof, STEPS, step_ms, wall_us, "step")
    del model
    torch.cuda.empty_cache()
    if res is None:
        return None
    return dict(preset=preset, dtype=dtype, card=card_line(), steps=STEPS,
                size=cfg.data.crop_size,
                frames=(cfg.data.n_frames_total
                        if cfg.model.model == "temporal" else 1),
                peak_bytes=peak, kernel_launches_per_step=kernels, **res)


if __name__ == "__main__":
    sys.exit(main())
