"""Host cost of a kernel call, and what it does to a host-bound frame.

    python3 -m ir2rgb_tpu_torch.op_overhead [--tree DIR]

On the card: the host time of one call of the B1 forward wrapper at
(1, 64, 64, 256) and of the d2s wrapper at (1, 64, 64, 1024), bf16
(2,000 calls enqueued back to back, three readings), and pix2pixhd_512's
bf16 ms/frame at batch 1 (the output fed back, CUDA events over 30
frames, five readings). ``--tree`` imports ``ir2rgb_tpu_torch`` from
another checkout (an unpacked parent commit), so that two versions of the
call path compare in one run: parent, change, change, parent.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time


def _host_us(fn, n: int = 2000) -> float:
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ir2rgb_tpu_torch.op_overhead")
    p.add_argument("--tree", default="",
                   help="import ir2rgb_tpu_torch from this checkout")
    args = p.parse_args(argv)
    if args.tree:
        sys.path.insert(0, args.tree)
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "ir2rgb_tpu_torch"]:
            del sys.modules[name]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("op_overhead measures on a CUDA card; none found")
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.kernels import _build
    from ir2rgb_tpu_torch.kernels import d2s as pd2s
    from ir2rgb_tpu_torch.kernels import instance_norm as pin
    from ir2rgb_tpu_torch.train import create_model

    _build.build()
    _build.lib()
    cfg = PRESETS["pix2pixhd_512"]
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="bf16"),
        loss=dataclasses.replace(cfg.loss, no_vgg_loss=True))
    model = create_model(cfg, device="cuda")
    x0 = torch.zeros((1, 512, 512, 3), device="cuda")

    def frame_ms(reps: int = 30) -> float:
        state = {"x": x0}
        for _ in range(5):
            state["x"] = model.generate(state["x"])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            state["x"] = model.generate(state["x"])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    ms = sorted(frame_ms() for _ in range(5))
    x = torch.randn((1, 64, 64, 256), device="cuda", dtype=torch.bfloat16)
    y = torch.randn((1, 64, 64, 1024), device="cuda", dtype=torch.bfloat16)
    with torch.inference_mode():
        b1 = sorted(_host_us(lambda: pin.instance_norm_act(x, "relu"))
                    for _ in range(3))
        d2s = sorted(_host_us(lambda: pd2s.d2s(y, 256)) for _ in range(3))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True,
        text=True, check=True).stdout.strip()
    print(json.dumps({"tree": args.tree or ".", "card": card,
                      "pix2pixhd_512_bf16_ms_per_frame": ms,
                      "b1_host_us_per_call": b1,
                      "d2s_host_us_per_call": d2s}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
