"""Where a train step's time goes on the card: the pix2pixhd_512 train step
at full width, 512x512, batch 1, unfrozen (the trunk trains), timed with
CUDA events and then traced with torch.profiler; device time by kind and
by kernel, the device's busy time and idle share of a step, and the
device launches per step. The idle share is taken against the step time
measured without the profiler, since tracing slows the host.

    python -m ir2rgb_tpu_torch.profile_train [--dtype bf16|float32]

prints one JSON object, the top kernels last.

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
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "float32"))
    args = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    from ir2rgb_tpu_torch import set_parity_mode
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.train import create_model

    set_parity_mode()  # fp32 convs without TF32; bf16 is unaffected
    warnings.filterwarnings("ignore", message="VGG perceptual loss")
    cfg = PRESETS["pix2pixhd_512"]
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype=args.dtype),
        train=dataclasses.replace(cfg.train, niter_fix_global=0))
    model = create_model(cfg)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.uniform(
        -1, 1, (1, 512, 512, 3)).astype(np.float32)).cuda() for k in "ab"}
    for _ in range(3):
        model.train_step(batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STEPS):
        model.train_step(batch)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            model.train_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    res = summarize(prof, STEPS, step_ms, wall_us, "step")
    if res is None:
        return 2
    print(json.dumps(dict(preset="pix2pixhd_512", dtype=args.dtype,
                          card=card_line(), steps=STEPS, **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
