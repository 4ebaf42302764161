"""Where a frame's time goes on the card: a torch.profiler trace of the
batch-1 bf16 generator loop (output fed back as input; temporal: the
carry is the chain), summed by kernel and by kind, with the device's idle
share of a frame. The idle share is taken against the frame time
measured without the profiler (CUDA events over the same loop), since
tracing slows the host.

    python -m ir2rgb_tpu_torch.profile_stream [--preset P [P ...] | all]

prints one JSON object a preset, the top kernels last. The frame's
channels come from the preset (a label model's frame is a class-id map);
the output is fed back as the next input where it has the input's
channels, else every frame takes the same input.

Needs one CUDA device. Weights are the seeded reference init; the
perceptual loss's VGG is not built (serving does not run it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch

FRAMES = 10

# kernel-name fragments -> kind, first match wins
KINDS = [
    ("B1 instance_norm backward", ("in_bwd_",)),
    ("B1 instance_norm", ("in_fwd_",)),
    ("B3 d2s / s2d", ("d2s_kernel",)),
    ("optimizer (Adam)", ("multi_tensor_apply", "foreach", "Adam")),
    ("B2 tail", ("tail_tc_kernel", "tail_kernel")),
    # fp32 without TF32: cuDNN also runs FFT convolutions (fft2d_r2c /
    # c2r around cuBLAS gemv)
    ("conv", ("conv", "gemm", "xmma", "cudnn", "sm90_", "cutlass",
              "implicit", "dgrad", "wgrad", "fprop", "fft2d", "gemv")),
    ("reflect pad (index_select)", ("index", "gather")),
    ("avg pool", ("avg_pool", "AvgPool")),
    ("copy / layout", ("copy", "Copy", "memcpy", "Memcpy", "memset",
                       "Memset")),
]


def kind_of(name: str) -> str:
    for kind, frags in KINDS:
        if any(f in name for f in frags):
            return kind
    return "elementwise (bias and residual adds, casts)"


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()


def summarize(prof, n: int, unit_ms: float, wall_us: float, unit: str):
    """Device time of a profiled run of ``n`` units (frames, steps) by
    kind and by kernel, the device's busy time and its idle share against
    ``unit_ms``, the unit's time measured without the profiler. None when
    the trace holds no device events."""
    # device kernels and copies; a record_function range (the optimizer's
    # "Optimizer.step#Adam.step") shows on the device timeline too, and
    # would count its idle gaps as busy
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("Optimizer.")]
    if not dev:
        print("profile: the trace holds no device events; device time "
              "not measured", file=sys.stderr)
        return None
    by_name, by_kind = {}, {}
    for e in dev:
        us = e.time_range.end - e.time_range.start
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + us)
        by_kind[kind_of(e.name)] = by_kind.get(kind_of(e.name), 0.0) + us
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    return {
        f"ms_per_{unit}": unit_ms,
        f"profiled_wall_ms_per_{unit}": wall_us / n / 1e3,
        f"device_busy_ms_per_{unit}": busy / n / 1e3,
        "device_idle_share": 1 - busy / n / 1e3 / unit_ms,
        f"launches_per_{unit}": len(dev) / n,
        f"by_kind_ms_per_{unit}": {k: v / n / 1e3 for k, v in sorted(
            by_kind.items(), key=lambda i: -i[1])},
        "top_kernels": [{"name": k[:120], f"per_{unit}": c / n,
                         f"ms_per_{unit}": t / n / 1e3} for k, (c, t) in
                        sorted(by_name.items(), key=lambda i: -i[1][1])[:20]],
    }


def main(argv=None) -> int:
    from ir2rgb_tpu_torch.config import PRESETS
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", nargs="+", default=["pix2pixhd_512"],
                    choices=sorted(PRESETS) + ["all"])
    args = ap.parse_args(argv)
    presets = list(PRESETS) if "all" in args.preset else args.preset
    for preset in presets:
        res = profile_preset(preset)
        if res is None:
            return 2
        print(json.dumps(res), flush=True)
    return 0


def profile_preset(preset: str):
    """The profile of ``preset``'s served frame (None when the trace holds
    no device events)."""
    from torch.profiler import ProfilerActivity, profile

    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.infer import StreamingGenerator
    from ir2rgb_tpu_torch.train import create_model

    cfg = PRESETS[preset]
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bf16"),
                      loss=dataclasses.replace(cfg.loss, no_vgg_loss=True))
    model = create_model(cfg)
    m = cfg.model
    hw = (cfg.data.crop_size,) * 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    if m.label_nc > 0:
        x0 = torch.randint(0, m.label_nc, (1,) + hw + (1,), generator=gen,
                           device="cuda").float()
    else:
        x0 = torch.rand((1,) + hw + (m.input_nc,), generator=gen,
                        device="cuda") * 2 - 1
    if m.model == "temporal":
        s = StreamingGenerator(model, hw)

        def step():
            s.push_device(x0)
    elif m.label_nc > 0 or m.input_nc != m.output_nc:
        def step():
            model.generate(x0)
    else:
        state = {"x": x0}

        def step():
            state["x"] = model.generate(state["x"])
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FRAMES):
        step()
    end.record()
    end.synchronize()
    frame_ms = start.elapsed_time(end) / FRAMES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    res = summarize(prof, FRAMES, frame_ms, wall_us, "frame")
    del model
    torch.cuda.empty_cache()
    if res is None:
        return None
    return dict(preset=preset, card=card_line(), frames=FRAMES, **res)


if __name__ == "__main__":
    sys.exit(main())
