#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ir2rgb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each failing the run if it fails:

1. build the hand-written kernels from ir2rgb_tpu_torch/kernels/csrc;
2. B1 (fused instance norm + act): every shape and activation of the
   pix2pixhd_512 main path, bf16 and fp32, held to its plain version on
   the card, and timed beside the plain version, ``F.instance_norm`` + act
   (a yardstick the port never calls) and the card's bound;
3. B2 (output tail): the same at (1,512,512,32), yardstick
   ``F.pad(reflect)`` + ``F.conv2d`` + tanh;
4. pix2pixhd_512, then 5. temporal_512: full-width generators with
   weights drawn from a numpy seed, 8 uint8 frames through
   ``StreamingGenerator.stream`` in bf16 with the kernels' launch counts
   read around the run; an fp32 card run (TF32 off) held to the port's
   fp32 CPU run; the bf16 run's PSNR against fp32; ms/frame at batch 1.

It prints the card (``nvidia-smi`` name and power limit), one JSON line
of kernel results, and last ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the ir2rgb_tpu_torch package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# (bytes/s, fp32 FLOP/s outside the tensor cores, dense bf16 tensor FLOP/s)
# from NVIDIA's data sheets; matched against the card's name in order
CARD_PEAKS = [
    ("H100 NVL", (3.9e12, 60e12, 835e12)),
    ("H100 PCIe", (2.0e12, 51e12, 756e12)),
    ("H100", (3.35e12, 67e12, 989e12)),  # SXM: "NVIDIA H100 80GB HBM3"
    ("H800", (3.35e12, 67e12, 989e12)),
    ("GH200", (4.0e12, 67e12, 989e12)),  # before "H200", which it contains
    ("H200", (4.8e12, 67e12, 989e12)),
]

# the 36 B1 launches of one pix2pixhd_512 frame: (shape, act) -> count
B1_MAIN_PATH = {
    ((1, 256, 256, 64), "relu"): 6,
    ((1, 256, 256, 64), "none"): 3,
    ((1, 128, 128, 128), "relu"): 2,
    ((1, 64, 64, 256), "relu"): 2,
    ((1, 32, 32, 512), "relu"): 2,
    ((1, 16, 16, 1024), "relu"): 10,
    ((1, 16, 16, 1024), "none"): 9,
    ((1, 512, 512, 32), "relu"): 2,
}
B1_PER_FRAME = sum(B1_MAIN_PATH.values())
B2_SHAPE = ((1, 512, 512, 32), (7, 7, 32, 3))
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SLICE_FP32_TOL = 1e-3
BF16_MIN_PSNR = 30.0
N_FRAMES = 8
SEED = 0

failures = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip()


def peaks(name: str):
    for key, val in CARD_PEAKS:
        if key in name:
            return key, val
    raise SystemExit(f"no published peaks for card {name!r}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean wall time on the card of ``fn`` over ``reps`` back-to-back
    calls (CUDA events, after warmup, L2 warm)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph, replayed between CUDA events, so Python launch overhead is out
    of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 2.0) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10 * math.log10(peak * peak / mse) if mse > 0 else float("inf")


def act_fn(y, act):
    return torch.relu(y) if act == "relu" else y


# ---------------------------------------------------------------------------
# Kernel phases
# ---------------------------------------------------------------------------

def b1_phase(bw: float, gen: torch.Generator):
    from ir2rgb_tpu_torch.kernels import instance_norm as b1
    rows, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    for (shape, act), count in B1_MAIN_PATH.items():
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3
                 + 1).to(dtype)
            y, mean, rstd = b1.instance_norm_act(x, act)
            y_ref, mean_ref, rstd_ref = b1.instance_norm_act_reference(
                x.float(), act)
            torch.cuda.synchronize()
            err = float((y.float() - y_ref).abs().max())
            stat_err = max(float((mean - mean_ref).abs().max()),
                           float(((rstd - rstd_ref) / rstd_ref).abs().max()))
            worst[dtype] = max(worst[dtype], err)
            tag = f"B1 {shape} {act} {str(dtype)[6:]}"
            check(err <= TOL[dtype] and stat_err <= 1e-4,
                  f"{tag}: max|y - plain| {err:.3g} (tol {TOL[dtype]}), "
                  f"stats {stat_err:.3g} (tol 1e-4)")
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last view
            kern = lambda: b1.instance_norm_act(x, act)  # noqa: E731
            n, h, w, c = shape
            nbytes = 2 * x.numel() * x.element_size() + 2 * n * c * 4
            rows.append(dict(
                shape=list(shape), act=act, dtype=str(dtype)[6:],
                per_frame=count, max_abs_err=err, ms=graph_ms(kern),
                plain_ms=graph_ms(
                    lambda: b1.instance_norm_act_reference(x, act)),
                library_ms=graph_ms(
                    lambda: act_fn(F.instance_norm(x_nchw, eps=1e-5), act)),
                eager_ms=cuda_ms(kern), bound_ms=nbytes / bw * 1e3))
    frame = [r for r in rows if r["dtype"] == "bfloat16"]
    total = {k: sum(r[k] * r["per_frame"] for r in frame)
             for k in ("ms", "plain_ms", "library_ms", "eager_ms",
                       "bound_ms")}
    return rows, total, worst


def b2_phase(bw: float, fp32_peak: float, bf16_peak: float,
             gen: torch.Generator):
    b2 = importlib.import_module("ir2rgb_tpu_torch.kernels.tail_fused")
    xs, ws = B2_SHAPE
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
        w = torch.randn(ws, generator=gen, device="cuda") * 0.05
        b = torch.randn(3, generator=gen, device="cuda") * 0.1
        y = b2.tail_fused(x, w, b)
        y_ref = b2.tail_fused_reference(x.float(), w.to(dtype).float(), b)
        torch.cuda.synchronize()
        err = float((y.float() - y_ref).abs().max())
        check(tuple(y.shape) == xs[:3] + (3,) and y.dtype == dtype
              and err <= TOL[dtype],
              f"B2 {xs} {str(dtype)[6:]}: max|y - plain| {err:.3g} "
              f"(tol {TOL[dtype]})")
        x_nchw = x.permute(0, 3, 1, 2)
        w_oihw = w.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b_c = b.to(dtype)
        kern = lambda: b2.tail_fused(x, w, b)  # noqa: E731
        ms, eager = graph_ms(kern), cuda_ms(kern)
        plain = graph_ms(lambda: b2.tail_fused_reference(x, w, b))
        lib = graph_ms(lambda: torch.tanh(F.conv2d(
            F.pad(x_nchw, (3, 3, 3, 3), mode="reflect"), w_oihw, b_c)))
        n, h, wd, c = xs
        nbytes = (x.numel() + n * h * wd * 3) * x.element_size() + \
            w.numel() * 4 + 3 * 4
        flops = 2 * n * h * wd * 3 * 49 * c
        peak = bf16_peak if dtype == torch.bfloat16 else fp32_peak
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        rows[str(dtype)[6:]] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
            eager_ms=eager,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            gflop=flops / 1e9, mbytes=nbytes / 1e6)
    return rows


# ---------------------------------------------------------------------------
# Slice phases
# ---------------------------------------------------------------------------

def seeded_state_dict(model, seed: int):
    """The reference weights_init drawn from a numpy seed: conv weights
    N(0, 0.02), biases 0."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.netG.state_dict().items():
        if k.endswith(".weight"):
            a = rng.standard_normal(tuple(v.shape), dtype=np.float32) * 0.02
        else:
            a = np.zeros(tuple(v.shape), np.float32)
        sd[k] = torch.from_numpy(a)
    return sd


def make_model(preset: str, dtype: str, device: str, sd):
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.train import create_model
    cfg = PRESETS[preset]
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype=dtype))
    model = create_model(cfg, device=device)
    if sd is not None:
        model.netG.load_state_dict(sd)
    return model


def slice_phase(preset: str, seed: int, card: str):
    from ir2rgb_tpu_torch.infer import StreamingGenerator
    from ir2rgb_tpu_torch.infer.stream import _dev_normalize
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    res = {"preset": preset}
    bf16 = make_model(preset, "bf16", "cuda", None)
    sd = seeded_state_dict(bf16, seed)
    bf16.netG.load_state_dict(sd)
    temporal = bf16.cfg.model.model == "temporal"
    hw = (bf16.cfg.data.crop_size,) * 2
    rng = np.random.default_rng(seed + 1)
    frames = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
              for _ in range(N_FRAMES)]

    # the main path: uint8 frames through the pipelined stream, bf16,
    # after two frames of warmup (cuDNN picks its algorithms)
    stream = StreamingGenerator(bf16, hw)
    list(stream.stream(frames[:2]))
    stream.reset()
    outs, carry_on_card = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for out in stream.stream(frames):
        outs.append(out)
        if temporal:
            carry_on_card.append(stream.carry.is_cuda)
    torch.cuda.synchronize()
    res["stream_wall_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 \
        / N_FRAMES
    counts = launch_counts()
    res["launches"] = counts
    check(all(o.shape == hw + (3,) and o.dtype == np.uint8 for o in outs)
          and len(outs) == N_FRAMES,
          f"{preset}: {len(outs)} uint8 frames of {hw + (3,)}")
    check(counts == {"instance_norm_act": B1_PER_FRAME * N_FRAMES,
                     "tail_fused": N_FRAMES},
          f"{preset}: launches {counts} over {N_FRAMES} frames "
          f"(want {B1_PER_FRAME} B1 and 1 B2 per frame)")
    if temporal:
        check(all(carry_on_card), f"{preset}: carry stayed on the card")

    # fp32 on the card (TF32 off) against the port's fp32 CPU stream. Each
    # card step gets the same frame and the same carry as the CPU step:
    # with random weights the frame-to-frame feedback amplifies any
    # difference (about 5x a frame), so free-running streams drift apart
    # whatever the arithmetic; that drift is reported, not held to a bar.
    n_cmp = 3 if temporal else 1
    fp32 = make_model(preset, "float32", "cuda", sd)
    cpu = make_model(preset, "float32", "cpu", sd)
    s_cpu = StreamingGenerator(cpu, hw)
    free_gpu, free_bf = StreamingGenerator(fp32, hw), StreamingGenerator(
        bf16, hw)
    errs, psnrs, drift, drift_psnr = [], [], [], []
    for f in frames[:n_cmp]:
        a = _dev_normalize(torch.from_numpy(f[None]))
        prev = s_cpu.carry
        y_cpu = s_cpu.push_device(a)
        prev = None if prev is None else prev.cuda()
        y_gpu = fp32.generate(a.cuda(), prev=prev)
        y_bf = bf16.generate(a.cuda(), prev=prev)
        errs.append(float((y_gpu.cpu() - y_cpu).abs().max()))
        psnrs.append(psnr(y_bf.float(), y_gpu))
        y_free = free_gpu.push_device(a.cuda())
        drift.append(float((y_free.cpu() - y_cpu).abs().max()))
        drift_psnr.append(psnr(free_bf.push_device(a.cuda()).float(),
                               y_free))
    res.update(fp32_card_vs_cpu_max_abs=errs, bf16_vs_fp32_psnr_db=psnrs,
               free_running_fp32_card_vs_cpu_max_abs=drift,
               free_running_bf16_vs_fp32_psnr_db=drift_psnr)
    check(max(errs) <= SLICE_FP32_TOL,
          f"{preset}: fp32 card vs fp32 CPU max-abs {max(errs):.3g} over "
          f"{n_cmp} frame(s) (tol {SLICE_FP32_TOL})")
    check(min(psnrs) >= BF16_MIN_PSNR,
          f"{preset}: bf16 vs fp32 PSNR {min(psnrs):.2f} dB "
          f"(bar {BF16_MIN_PSNR})")
    if temporal:
        print(f"{preset}: free-running streams, frame by frame: fp32 card "
              f"vs CPU max-abs {[f'{e:.3g}' for e in drift]}, bf16 vs fp32 "
              f"PSNR {[f'{p:.1f}' for p in drift_psnr]} dB", flush=True)
    del fp32, cpu, s_cpu, free_gpu, free_bf

    # ms/frame at batch 1, bf16, output fed back as the next input
    # (temporal: the carry is the dependency chain), CUDA events
    x0 = _dev_normalize(torch.from_numpy(frames[0][None])).cuda()
    if temporal:
        s = StreamingGenerator(bf16, hw)
        step = lambda: s.push_device(x0)  # noqa: E731
    else:
        state = {"x": x0}

        def step():
            state["x"] = bf16.generate(state["x"])
    ms = cuda_ms(step, reps=30, warmup=5)
    res["ms_per_frame"] = ms
    res["fps"] = 1e3 / ms
    print(f"{preset}: {ms:.3f} ms/frame, {1e3 / ms:.1f} fps at batch 1, bf16"
          f" ({card}); stream() wall {res['stream_wall_ms_per_frame']:.2f} "
          "ms/frame", flush=True)
    del bf16, stream
    torch.cuda.empty_cache()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from ir2rgb_tpu_torch import set_parity_mode
    from ir2rgb_tpu_torch.kernels import _build

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    name = torch.cuda.get_device_name(0)
    row, (bw, fp32_peak, bf16_peak) = peaks(name)
    set_parity_mode()  # fp32 convs in full fp32; bf16 is unaffected

    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    print(f"built {so.name} in {build_s:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b1_rows, b1_frame, b1_worst = b1_phase(bw, gen)
    b2_rows = b2_phase(bw, fp32_peak, bf16_peak, gen)
    slices = [slice_phase(preset, SEED, card)
              for preset in ("pix2pixhd_512", "temporal_512")]

    b2 = b2_rows["bfloat16"]
    kernels = [
        dict(name="instance_norm_act", route="cuda",
             source="ir2rgb_tpu_torch/kernels/csrc/instance_norm.cu",
             replaces="ir2rgb_tpu/kernels/instance_norm.py:127",
             launches=slices[0]["launches"]["instance_norm_act"],
             max_abs_err=b1_worst[torch.bfloat16],
             max_abs_err_fp32=b1_worst[torch.float32],
             ms=b1_frame["ms"], kernel_ms=b1_frame["ms"],
             plain_ms=b1_frame["plain_ms"], bound_ms=b1_frame["bound_ms"],
             bound_by="bytes", library_ms=b1_frame["library_ms"],
             eager_ms=b1_frame["eager_ms"],
             per="one pix2pixhd_512 frame: 36 launches, bf16"),
        dict(name="tail_fused", route="cuda",
             source="ir2rgb_tpu_torch/kernels/csrc/tail_fused.cu",
             replaces="ir2rgb_tpu/kernels/tail_fused.py:189",
             launches=slices[0]["launches"]["tail_fused"],
             max_abs_err=b2["max_abs_err"],
             max_abs_err_fp32=b2_rows["float32"]["max_abs_err"],
             ms=b2["ms"], kernel_ms=b2["ms"], plain_ms=b2["plain_ms"],
             bound_ms=b2["bound_ms"], bound_by=b2["bound_by"],
             library_ms=b2["library_ms"], eager_ms=b2["eager_ms"],
             per="one launch at (1,512,512,32), bf16"),
    ]
    print(f"peaks: {row} row, {bw / 1e12} TB/s, fp32 {fp32_peak / 1e12} "
          f"TFLOP/s, bf16 {bf16_peak / 1e12} TFLOP/s")
    for s in slices:
        print("slice " + json.dumps(s))
    for r in b1_rows:
        print(f"  B1 {r['shape']} {r['act']:5s} {r['dtype']:8s} "
              f"ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
              f"lib {r['library_ms']:.4f} bound {r['bound_ms']:.4f} "
              f"eager {r['eager_ms']:.4f}")
    for k, r in b2_rows.items():
        print(f"  B2 {k:8s} ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
              f"lib {r['library_ms']:.4f} bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}) eager {r['eager_ms']:.4f}")
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", *failures,
              sep="\n  ", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
