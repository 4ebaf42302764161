#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ir2rgb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each failing the run if it fails:

1. build the hand-written kernels from ir2rgb_tpu_torch/kernels/csrc;
2. B1 forward (fused instance norm + act): every shape and activation of
   the pix2pixhd_512 generator and discriminator, bf16 and fp32, held to
   its plain version on the card, and timed beside the plain version,
   ``F.instance_norm`` + act (a yardstick the port never calls) and the
   card's bound; with each shape's plan (group width, cluster size,
   shared memory per block, route), its device kernels per call read
   with torch.profiler (must be 1), and for the four largest shapes the
   time on a cold L2;
3. B1 backward: the same shapes, dx held to the plain backward, timed
   beside it and the autograd backward of ``F.instance_norm`` + act,
   with the same plan, kernel count and cold-L2 readings;
4. B2 (output tail): the same at every preset's tail shape and a ragged
   batch-2 shape (``B2_SHAPES``), bf16 (the tensor-core route) and fp32
   (the CUDA-core route), yardstick ``F.pad(reflect)`` + ``F.conv2d`` +
   tanh; device kernels per call (must be 1), a cold-L2 time at the main
   path's shape, and the HMMA instructions of the built tensor-core
   kernels (``cuobjdump -sass``, must be > 0);
5. B3 d2s and s2d at the five ups' shapes, exact against the plain
   permutation, yardstick ``view/permute/contiguous``; and each up timed
   as the subpixel conv + d2s against ``F.conv_transpose2d``;
6. pix2pixhd_512, then 7. temporal_512 serving: full-width generators
   with weights drawn from a numpy seed, 8 uint8 frames through
   ``StreamingGenerator.stream`` in bf16 with the kernels' launch counts
   read around the run; an fp32 card run (TF32 off) held to the port's
   fp32 CPU run; the bf16 run's PSNR against fp32; ms/frame at batch 1;
8. the pix2pixhd_512 train step at full width, 512x512, batch 1: 12 bf16
   steps across the coarse-to-fine unfreeze (the trunk frozen through
   step 9, moving from step 10), the launch counts of each step, 10
   timed unfrozen steps in bf16 and in fp32, peak memory; the bf16 first
   step's losses against fp32's; one fp32 step on the card held to the
   port's fp32 CPU step at full width on 256x256 inputs (losses and every
   gradient tensor).

It prints the card (``nvidia-smi`` name and power limit), one JSON line
of kernel results, and last ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the ir2rgb_tpu_torch package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

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
# one pass of the multiscale D on a 512x512 pair: scale 0, then scale 1
B1_D_PASS = {
    ((1, 129, 129, 128), "leaky_relu"): 1,
    ((1, 65, 65, 256), "leaky_relu"): 1,
    ((1, 66, 66, 512), "leaky_relu"): 1,
    ((1, 65, 65, 128), "leaky_relu"): 1,
    ((1, 33, 33, 256), "leaky_relu"): 1,
    ((1, 34, 34, 512), "leaky_relu"): 1,
}
# per unfrozen train step: G's forward and backward, four D passes of
# which three (fake for G, real and detached fake for D) take a backward
B1_FWD_PER_STEP = {**B1_MAIN_PATH, **{k: 4 * v for k, v in B1_D_PASS.items()}}
B1_BWD_PER_STEP = {**B1_MAIN_PATH, **{k: 3 * v for k, v in B1_D_PASS.items()}}
# the five ups of a frame: (phase tensor shape, C); d2s forward, s2d back
D2S_MAIN_PATH = [((1, 16, 16, 2048), 512), ((1, 32, 32, 1024), 256),
                 ((1, 64, 64, 512), 128), ((1, 128, 128, 256), 64),
                 ((1, 256, 256, 128), 32)]
PER_STEP = {"instance_norm_act": sum(B1_FWD_PER_STEP.values()),
            "instance_norm_act_bwd": sum(B1_BWD_PER_STEP.values()),
            "tail_fused": 0, "d2s": 5, "s2d": 5}
PER_FRAME = {"instance_norm_act": B1_PER_FRAME, "instance_norm_act_bwd": 0,
             "tail_fused": 1, "d2s": 5, "s2d": 0}
# B2's x at every preset's tail: pix2pixhd_512 and temporal_512 (the main
# path), global_512 (ngf 64), the 1024 presets, the 2048 preset (two
# enhancers, ngf 16); then a ragged batch-2 shape for the edge tiles
B2_SHAPES = [(1, 512, 512, 32), (1, 512, 512, 64), (1, 1024, 1024, 32),
             (1, 2048, 2048, 16), (2, 72, 40, 32)]
B2_MAIN = B2_SHAPES[0]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SLICE_FP32_TOL = 1e-3
BF16_MIN_PSNR = 30.0
N_FRAMES = 8
TRAIN_STEPS, TIMED_STEPS = 12, 10
FIX_STEPS = 10  # niter_fix_global 10 x steps_per_epoch 1
TRAIN_FP32_LOSS_RTOL, TRAIN_FP32_GRAD_REL = 1e-4, 1e-3
BF16_LOSS_REL = 0.05
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
    of the measurement; the median of five replays, so that one replay
    slowed by the card's clocks or its host does not set the reading."""
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
    times = []
    for _ in range(5):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[2]


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 2.0) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10 * math.log10(peak * peak / mse) if mse > 0 else float("inf")


def act_fn(y, act):
    if act == "relu":
        return torch.relu(y)
    if act == "leaky_relu":
        return F.leaky_relu(y, 0.2)
    if act == "tanh":
        return torch.tanh(y)
    return y


def dtype_name(dtype) -> str:
    return str(dtype)[6:]


# ---------------------------------------------------------------------------
# Kernel phases
# ---------------------------------------------------------------------------

def device_kernels(fn, tries: int = 3) -> int:
    """Device kernels (and copies) one call of ``fn`` runs on the card,
    read with torch.profiler around that call. A profiler run that records
    no device activity at all (the tracer can miss a short run's only
    kernel) is read again, up to ``tries`` times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        if n:
            return n
    return 0


def cold_ms(fn, flush: torch.Tensor) -> float:
    """Device time of one ``fn`` call on a cold L2: ``flush`` (more than
    the 50 MB L2) is written before every call, and the graph-replay time
    of the flush alone is taken off."""
    wipe = flush.zero_
    return graph_ms(lambda: (wipe(), fn())) - graph_ms(wipe)


def plan_text(p) -> str:
    return (f"{p.channels} ch x K {p.k}, {p.smem_bytes} B smem, "
            f"{p.route}")


def per_path_totals(rows, counts, keys=("ms", "plain_ms", "library_ms",
                                        "eager_ms", "bound_ms")):
    """Sums of ``count x value`` over the bf16 rows whose (shape, act) or
    shape is in ``counts``."""
    tot = dict.fromkeys(keys, 0.0)
    for r in rows:
        n = counts.get(r["key"], 0)
        if r["dtype"] == "bfloat16" and n:
            for k in keys:
                tot[k] += n * r[k]
    return tot


# the four largest B1 shapes of the path, timed on a cold L2 as well
B1_COLD = {(1, 512, 512, 32), (1, 256, 256, 64), (1, 66, 66, 512),
           (1, 129, 129, 128)}
FLUSH_BYTES = 128 << 20


def b1_phase(bw: float, gen: torch.Generator):
    from ir2rgb_tpu_torch.kernels import instance_norm as b1
    rows, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for (shape, act) in B1_FWD_PER_STEP:
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
            tag = f"B1 {shape} {act} {dtype_name(dtype)}"
            check(err <= TOL[dtype] and stat_err <= 1e-4,
                  f"{tag}: max|y - plain| {err:.3g} (tol {TOL[dtype]}), "
                  f"stats {stat_err:.3g} (tol 1e-4)")
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last view
            kern = lambda: b1.instance_norm_act(x, act)  # noqa: E731
            n, h, w, c = shape
            nbytes = 2 * x.numel() * x.element_size() + 2 * n * c * 4
            kernels = device_kernels(kern)
            check(kernels == 1, f"{tag}: {kernels} device kernel(s) per "
                  "call (want 1)")
            rows.append(dict(
                key=(shape, act), shape=list(shape), act=act,
                dtype=dtype_name(dtype), per_frame=B1_MAIN_PATH.get(
                    (shape, act), 0),
                per_step=B1_FWD_PER_STEP[(shape, act)], max_abs_err=err,
                plan=plan_text(b1.plan_for(x)), device_kernels=kernels,
                ms=graph_ms(kern),
                plain_ms=graph_ms(
                    lambda: b1.instance_norm_act_reference(x, act)),
                library_ms=graph_ms(
                    lambda: act_fn(F.instance_norm(x_nchw, eps=1e-5), act)),
                eager_ms=cuda_ms(kern), bound_ms=nbytes / bw * 1e3,
                cold_ms=cold_ms(kern, flush) if shape in B1_COLD else None))
    return (rows, per_path_totals(rows, B1_MAIN_PATH),
            per_path_totals(rows, B1_FWD_PER_STEP), worst)


def b1_bwd_phase(bw: float, gen: torch.Generator):
    """dx of B1 at every (shape, act) of the train step, held to the plain
    backward relative to max|dx| (1e-4 fp32, 2e-2 bf16)."""
    from ir2rgb_tpu_torch.kernels import instance_norm as b1
    rows, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for (shape, act), per_step in B1_BWD_PER_STEP.items():
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3
                 + 1).to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            _, mean, rstd = b1.instance_norm_act(x, act)
            dx = b1.instance_norm_act_backward(x, mean, rstd, g, act)
            ref = b1.instance_norm_act_backward_reference(
                x.float(), mean, rstd, g.float(), act)
            torch.cuda.synchronize()
            err = float((dx.float() - ref).abs().max())
            rel = err / float(ref.abs().max())
            worst[dtype] = max(worst[dtype], rel)
            tag = f"B1 bwd {shape} {act} {dtype_name(dtype)}"
            check(dx.dtype == dtype and rel <= TOL[dtype],
                  f"{tag}: max|dx - plain| / max|dx| {rel:.3g} (tol "
                  f"{TOL[dtype]})")
            kern = lambda: b1.instance_norm_act_backward(  # noqa: E731
                x, mean, rstd, g, act)
            kernels = device_kernels(kern)
            check(kernels == 1, f"{tag}: {kernels} device kernel(s) per "
                  "call (want 1)")
            # the library's backward: autograd of F.instance_norm + act,
            # forward and backward captured together (a backward runs on
            # its forward's stream) less the forward alone
            x_lib = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
            g_lib = g.permute(0, 3, 1, 2)
            lib_fb = graph_ms(lambda: torch.autograd.grad(
                act_fn(F.instance_norm(x_lib, eps=1e-5), act), x_lib,
                g_lib))
            lib_f = graph_ms(lambda: act_fn(F.instance_norm(
                x_lib.detach(), eps=1e-5), act))
            n, h, w, c = shape
            nbytes = 3 * x.numel() * x.element_size() + 2 * n * c * 4
            rows.append(dict(
                key=(shape, act), shape=list(shape), act=act,
                dtype=dtype_name(dtype), per_step=per_step,
                max_abs_err=err, rel_err=rel,
                plan=plan_text(b1.plan_for(x, bwd=True)),
                device_kernels=kernels, ms=graph_ms(kern),
                plain_ms=graph_ms(
                    lambda: b1.instance_norm_act_backward_reference(
                        x, mean, rstd, g, act)),
                library_ms=lib_fb - lib_f, library_fwd_bwd_ms=lib_fb,
                eager_ms=cuda_ms(kern), bound_ms=nbytes / bw * 1e3,
                cold_ms=cold_ms(kern, flush) if shape in B1_COLD else None))
    return rows, per_path_totals(rows, B1_BWD_PER_STEP), worst


def d2s_phase(bw: float, gen: torch.Generator):
    """B3 both ways at the five ups' shapes: exact against the plain
    permutation, timed beside it and view/permute/contiguous."""
    from ir2rgb_tpu_torch.kernels import d2s as b3
    rows = []
    for (n, h, w, c4), c in D2S_MAIN_PATH:
        for dtype in (torch.bfloat16, torch.float32):
            y = torch.randn((n, h, w, c4), generator=gen,
                            device="cuda").to(dtype)
            x = torch.randn((n, 2 * h, 2 * w, c), generator=gen,
                            device="cuda").to(dtype)
            for name, src, kern, plain, lib in (
                    ("d2s", y, lambda: b3.d2s(y, c),
                     lambda: b3.d2s_reference(y, c),
                     lambda: y.view(n, h, w, 2, 2, c).permute(
                         0, 1, 3, 2, 4, 5).contiguous()),
                    ("s2d", x, lambda: b3.s2d(x),
                     lambda: b3.s2d_reference(x),
                     lambda: x.view(n, h, 2, w, 2, c).permute(
                         0, 1, 3, 2, 4, 5).contiguous())):
                out, want = kern(), plain()
                torch.cuda.synchronize()
                exact = torch.equal(out, want)
                check(exact, f"B3 {name} {tuple(src.shape)} "
                      f"{dtype_name(dtype)}: exact against the plain "
                      "permutation")
                rows.append(dict(
                    name=name, key=((n, h, w, c4), c),
                    shape=list(src.shape), dtype=dtype_name(dtype),
                    exact=exact, max_abs_err=float(
                        (out.float() - want.float()).abs().max()),
                    ms=graph_ms(kern), plain_ms=graph_ms(plain),
                    library_ms=graph_ms(lib), eager_ms=cuda_ms(kern),
                    bound_ms=2 * src.numel() * src.element_size() / bw
                    * 1e3))
    counts = {key: 1 for key in D2S_MAIN_PATH}
    totals = {name: per_path_totals([r for r in rows if r["name"] == name],
                                    counts) for name in ("d2s", "s2d")}
    return rows, totals


def deconv_phase(gen: torch.Generator):
    """Each up as the port runs it (subpixel conv + B3 d2s + bias, the
    rearranged weight kept) against ``F.conv_transpose2d``, in inference
    at batch 1."""
    from ir2rgb_tpu_torch.nn import Deconv, ops
    rows = []
    for (n, h, w, c4), c in D2S_MAIN_PATH:
        for dtype in (torch.bfloat16, torch.float32):
            # built outside inference mode, so that its weight is a normal
            # tensor whose rearranged copy the module keeps, as in serving
            up = Deconv(2 * c, c).to("cuda", dtype,
                                     memory_format=torch.channels_last)
            x = torch.randn((n, h, w, 2 * c), generator=gen,
                            device="cuda").to(dtype)
            with torch.inference_mode():
                sub = lambda: up(x)  # noqa: E731
                dil = lambda: ops.deconv(  # noqa: E731
                    x, up.weight, up.bias, lowering="dilated")
                a, b = sub(), dil()
                torch.cuda.synchronize()
                err = float((a.float() - b.float()).abs().max()) / float(
                    b.float().abs().max())
                check(err <= TOL[dtype], f"up {(n, h, w, 2 * c)}->{c} "
                      f"{dtype_name(dtype)}: subpixel vs conv_transpose2d "
                      f"{err:.3g} of max (tol {TOL[dtype]})")
                rows.append(dict(shape=[n, h, w, 2 * c], cout=c,
                                 dtype=dtype_name(dtype), rel_err=err,
                                 subpixel_ms=graph_ms(sub),
                                 conv_transpose_ms=graph_ms(dil),
                                 subpixel_eager_ms=cuda_ms(sub),
                                 conv_transpose_eager_ms=cuda_ms(dil)))
    return rows


def sass_hmma() -> dict:
    """HMMA (tensor-core) instructions in each tail kernel of the built
    library, from ``cuobjdump -sass``: kernel name -> count."""
    from ir2rgb_tpu_torch.kernels import _build
    tool = str(Path(_build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if "tail" in fn:
                counts[fn] = 0
        elif fn in counts and "HMMA" in line:
            counts[fn] += 1
    return counts


def b2_phase(bw: float, fp32_peak: float, bf16_peak: float,
             gen: torch.Generator):
    """B2 at every shape of ``B2_SHAPES``, bf16 and fp32, held to the
    plain version on the card and timed beside it, the library and the
    bound; one device kernel per call; a cold L2 at the main shape."""
    b2 = importlib.import_module("ir2rgb_tpu_torch.kernels.tail_fused")
    rows = []
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for xs in B2_SHAPES:
        n, h, wd, c = xs
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
            w = torch.randn((7, 7, c, 3), generator=gen, device="cuda") * 0.05
            b = torch.randn(3, generator=gen, device="cuda") * 0.1
            y = b2.tail_fused(x, w, b)
            y_ref = b2.tail_fused_reference(x.float(), w.to(dtype).float(), b)
            torch.cuda.synchronize()
            err = float((y.float() - y_ref).abs().max())
            route = b2.route(x, w, b)
            tag = f"B2 {xs} {dtype_name(dtype)} ({route})"
            check(tuple(y.shape) == xs[:3] + (3,) and y.dtype == dtype
                  and err <= TOL[dtype],
                  f"{tag}: max|y - plain| {err:.3g} (tol {TOL[dtype]})")
            kern = lambda: b2.tail_fused(x, w, b)  # noqa: E731
            kernels = device_kernels(kern)
            check(kernels == 1, f"{tag}: {kernels} device kernel(s) per call "
                  "(want 1)")
            x_nchw = x.permute(0, 3, 1, 2)
            w_oihw = w.to(dtype).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            b_c = b.to(dtype)
            nbytes = (x.numel() + n * h * wd * 3) * x.element_size() + \
                w.numel() * 4 + 3 * 4
            flops = 2 * n * h * wd * 3 * 49 * c
            peak = bf16_peak if dtype == torch.bfloat16 else fp32_peak
            t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
            rows.append(dict(
                shape=list(xs), dtype=dtype_name(dtype), route=route,
                tile_rows=b2.tc_layout(c)[0] if route == "tensor_core"
                else 16, max_abs_err=err, device_kernels=kernels,
                ms=graph_ms(kern),
                plain_ms=graph_ms(lambda: b2.tail_fused_reference(x, w, b)),
                library_ms=graph_ms(lambda: torch.tanh(F.conv2d(
                    F.pad(x_nchw, (3, 3, 3, 3), mode="reflect"), w_oihw,
                    b_c))),
                eager_ms=cuda_ms(kern), bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                cold_ms=cold_ms(kern, flush) if xs == B2_MAIN else None,
                gflop=flops / 1e9, mbytes=nbytes / 1e6))
            del x, y, y_ref
    hmma = sass_hmma()
    tc = {k: v for k, v in hmma.items() if "tail_tc_kernel" in k}
    check(bool(tc) and all(tc.values()),
          f"B2 tensor-core kernels issue HMMA: {sorted(tc.values())} "
          f"instructions in {len(tc)} instantiation(s)")
    return rows, hmma


# ---------------------------------------------------------------------------
# Slice phases
# ---------------------------------------------------------------------------

def seeded_state_dict(module, seed: int):
    """The reference weights_init drawn from a numpy seed: conv weights
    N(0, 0.02), biases 0 (CPU tensors)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
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
    sd = seeded_state_dict(bf16.netG, seed)
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
    check(counts == {k: v * N_FRAMES for k, v in PER_FRAME.items()},
          f"{preset}: launches {counts} over {N_FRAMES} frames "
          f"(want {PER_FRAME} per frame)")
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


def train_model(dtype: str, device: str, weights, fix_global: bool = True):
    """pix2pixhd_512 at full width, steps_per_epoch 1 (fix_steps 10 when
    ``fix_global``, else no freeze), with ``weights`` = (G, D, VGG)
    state_dicts."""
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.train import create_model
    cfg = PRESETS["pix2pixhd_512"]
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype=dtype))
    if not fix_global:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    niter_fix_global=0))
    model = create_model(cfg, device=device, steps_per_epoch=1)
    if weights is not None:
        for net, sd in zip((model.netG, model.netD, model.vgg), weights):
            net.load_state_dict(sd)
    return model


def train_batch(size: int, seed: int, device: str):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.uniform(
        -1, 1, (1, size, size, 3)).astype(np.float32)).to(device)
        for k in "ab"}


def clone_params(module, keep=lambda k: True):
    return {k: p.detach().clone() for k, p in module.named_parameters()
            if keep(k)}


def changed(module, before) -> dict:
    now = dict(module.named_parameters())
    return {k: not torch.equal(now[k], v) for k, v in before.items()}


def timed_steps(model, batch, n: int):
    """ms/step over ``n`` back-to-back steps (CUDA events), peak memory,
    and the kernels' launches over those steps."""
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        model.train_step(batch)
    end.record()
    end.synchronize()
    return (start.elapsed_time(end) / n, torch.cuda.max_memory_allocated(),
            launch_counts())


def grad_bar(got: dict, want: dict, rel: float):
    """Worst per-tensor ratio of ||delta|| to rel·||g_cpu|| + 1e-6·M (M the
    largest ||g_cpu|| of the network; the second term covers the conv
    biases an instance norm follows, whose true gradient is zero)."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    big = max(norms.values())
    worst = (0.0, None)
    for k, v in want.items():
        ratio = float((got[k].cpu() - v).norm()) / (rel * norms[k]
                                                    + 1e-6 * big)
        worst = max(worst, (ratio, k))
    return worst


def avg_pool_grad_check():
    """``ops.avg_pool``'s gradient on the card against the CPU's at the
    discriminator's pyramid shape; beside it ``F.avg_pool2d`` straight on
    channels-last memory, whose CUDA backward is wrong (reported)."""
    from ir2rgb_tpu_torch.nn import ops
    rng = np.random.default_rng(SEED + 5)
    x = torch.from_numpy(rng.standard_normal((1, 256, 256, 6),
                                             dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 128, 128, 6),
                                             dtype=np.float32))

    def grad(fn, dev):
        xi = x.to(dev).requires_grad_(True)
        (gx,) = torch.autograd.grad(fn(xi), xi, g.to(dev))
        return gx.cpu()

    def port(t):
        return ops.avg_pool(t, 3, 2, 1, count_include_pad=False)

    def channels_last(t):
        return F.avg_pool2d(t.permute(0, 3, 1, 2), 3, 2, 1,
                            count_include_pad=False).permute(0, 2, 3, 1)

    want = grad(port, "cpu")
    rel = {name: float((grad(fn, "cuda") - want).norm() / want.norm())
           for name, fn in (("ops.avg_pool", port),
                            ("F.avg_pool2d channels-last", channels_last))}
    check(rel["ops.avg_pool"] <= 1e-6,
          f"avg pool gradient on the card vs CPU: {rel}")
    return rel


class KinkPins:
    """Straight-through pins (``y + (saved - y).detach()``) at every conv
    output and every B1 input that a run records with a graph: recorded on
    one run, replayed in the same order on another, so that the second
    run's ReLU / LeakyReLU / abs kinks see the first run's values while
    its backward is its own."""

    def __init__(self):
        self.saved, self.replayed, self._replay = [], 0, False

    def pin(self, y: torch.Tensor) -> torch.Tensor:
        if not (torch.is_grad_enabled() and y.requires_grad):
            return y
        if not self._replay:
            self.saved.append(y.detach().cpu())
            return y
        r = self.saved[self.replayed].to(y.device, y.dtype)
        self.replayed += 1
        return y + (r - y).detach()

    @contextlib.contextmanager
    def _patched(self, replay: bool):
        from ir2rgb_tpu_torch.nn import ops
        conv, b1 = ops.conv, ops.fused_instance_norm_act
        self._replay = replay
        ops.conv = lambda *a, **kw: self.pin(conv(*a, **kw))
        ops.fused_instance_norm_act = (
            lambda x, act="relu", negative_slope=0.2: b1(
                self.pin(x), act, negative_slope))
        try:
            yield
        finally:
            ops.conv, ops.fused_instance_norm_act = conv, b1

    def recording(self):
        return self._patched(False)

    def replaying(self):
        return self._patched(True)


def train_phase(card: str):
    """The main path of this slice: the pix2pixhd_512 train step at full
    width, 512x512, batch 1."""
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    res = {"preset": "pix2pixhd_512", "batch": 1, "size": 512,
           "fix_steps": FIX_STEPS, "avg_pool_grad_rel": avg_pool_grad_check()}
    bf16 = train_model("bf16", "cuda", None)
    weights = (seeded_state_dict(bf16.netG, SEED),
               seeded_state_dict(bf16.netD, SEED + 1),
               {k: v.cpu() for k, v in bf16.vgg.state_dict().items()})
    for net, sd in zip((bf16.netG, bf16.netD, bf16.vgg), weights):
        net.load_state_dict(sd)
    check(bf16.fix_steps == FIX_STEPS, f"train: fix_steps {bf16.fix_steps}")
    batch = train_batch(512, SEED + 3, "cuda")

    # 12 steps across the unfreeze: the trunk (model.*) frozen through
    # step 9 and moving from step 10; the enhancer and D move every step
    trunk0 = clone_params(bf16.netG, lambda k: k.startswith("model."))
    losses, counts, moved, walls = [], [], [], []
    for i in range(TRAIN_STEPS):
        enh = clone_params(bf16.netG, lambda k: not k.startswith("model."))
        dis = clone_params(bf16.netD)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        m = bf16.train_step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts.append(launch_counts())
        losses.append({k: float(v) for k, v in m.items()})
        trunk_moved = any(changed(bf16.netG, trunk0).values())
        weights_moved = [v for k, v in {**changed(bf16.netG, enh),
                                        **changed(bf16.netD, dis)}.items()
                         if k.endswith("weight")]
        moved.append(dict(step=i, trunk=trunk_moved,
                          enhancer_and_d_weights=sum(weights_moved),
                          of=len(weights_moved)))
        check(trunk_moved == (i >= FIX_STEPS) and all(weights_moved),
              f"train step {i}: trunk moved {trunk_moved} (want "
              f"{i >= FIX_STEPS}), enhancer and D weights moved "
              f"{sum(weights_moved)} of {len(weights_moved)}")
        check(all(math.isfinite(v) for v in losses[-1].values()),
              f"train step {i}: losses {losses[-1]}")
        if i >= FIX_STEPS:
            check(counts[-1] == PER_STEP, f"train step {i} (unfrozen): "
                  f"launches {counts[-1]} (want {PER_STEP})")
        else:
            check(counts[-1]["instance_norm_act"] == PER_STEP[
                "instance_norm_act"] and counts[-1]["d2s"] == 5,
                f"train step {i} (frozen): launches {counts[-1]}")
    res.update(losses_bf16=losses, launches_by_step=counts, moved=moved,
               wall_ms_by_step=walls)
    del trunk0

    # ms/step: 10 more unfrozen steps, bf16, then fp32 (TF32 off) after
    # two warmup steps of its own
    ms, peak, run_counts = timed_steps(bf16, batch, TIMED_STEPS)
    check(run_counts == {k: v * TIMED_STEPS for k, v in PER_STEP.items()},
          f"train: launches {run_counts} over {TIMED_STEPS} timed steps")
    res.update(ms_per_step_bf16=ms, peak_bytes_bf16=peak,
               launches_timed=run_counts)
    del bf16
    torch.cuda.empty_cache()
    fp32 = train_model("float32", "cuda", weights, fix_global=False)
    first = {k: float(v) for k, v in fp32.train_step(batch).items()}
    fp32.train_step(batch)
    ms32, peak32, _ = timed_steps(fp32, batch, TIMED_STEPS)
    res.update(losses_fp32_first=first, ms_per_step_fp32=ms32,
               peak_bytes_fp32=peak32)
    rel = {k: abs(losses[0][k] - v) / abs(v) for k, v in first.items()}
    res["bf16_vs_fp32_first_step_rel"] = rel
    check(max(rel.values()) <= BF16_LOSS_REL,
          f"train: bf16 first-step losses within {BF16_LOSS_REL:.0%} of "
          f"fp32 ({ {k: f'{v:.3g}' for k, v in rel.items()} })")
    del fp32
    torch.cuda.empty_cache()

    # one fp32 step on the card against the port's fp32 CPU step at full
    # width on 256x256 inputs, the same weights and batch. The losses are
    # held as they come. The gradients are held at the forward point of
    # the CPU run: every conv output and every B1 input is pinned to the
    # CPU's value (KinkPins). Unpinned, fp32 rounding flips a few ReLU
    # units across their kink (most in the trunk's 8x8x1024 blocks, where
    # one unit carries ~0.4% of a layer's gradient), which moves every G
    # gradient by ~0.5% whatever the arithmetic; that spread is reported.
    cpu = train_model("float32", "cpu", weights, fix_global=False)
    card32 = train_model("float32", "cuda", weights, fix_global=False)
    b_cpu = train_batch(256, SEED + 4, "cpu")
    b_card = {k: v.cuda() for k, v in b_cpu.items()}
    pins = KinkPins()
    t0 = time.perf_counter()
    with pins.recording():
        m_cpu = cpu.compute_grads(b_cpu)
    cpu_s = time.perf_counter() - t0
    m_card = card32.compute_grads(b_card)
    torch.cuda.synchronize()
    loss_rel = {k: abs(float(m_card[k]) - float(v)) / abs(float(v))
                for k, v in m_cpu.items()}
    nets = ("netG", "netD")
    want = {n: {k: p.grad for k, p in getattr(cpu, n).named_parameters()}
            for n in nets}
    free = {n: grad_bar({k: p.grad for k, p in getattr(
        card32, n).named_parameters()}, want[n], TRAIN_FP32_GRAD_REL)
            for n in nets}
    with pins.replaying():
        card32.compute_grads(b_card)
    check(pins.replayed == len(pins.saved) > 0,
          f"train fp32 card vs CPU: {pins.replayed} of {len(pins.saved)} "
          "pins replayed")
    worst = {n: grad_bar({k: p.grad for k, p in getattr(
        card32, n).named_parameters()}, want[n], TRAIN_FP32_GRAD_REL)
             for n in nets}
    res.update(fp32_card_vs_cpu_loss_rel=loss_rel,
               fp32_card_vs_cpu_worst_grad_pinned=worst,
               fp32_card_vs_cpu_worst_grad_unpinned=free, cpu_step_s=cpu_s,
               pins=len(pins.saved))
    check(max(loss_rel.values()) <= TRAIN_FP32_LOSS_RTOL,
          f"train fp32 card vs CPU at 256px: losses rel "
          f"{max(loss_rel.values()):.3g} (tol {TRAIN_FP32_LOSS_RTOL})")
    for name, (ratio, key) in worst.items():
        check(ratio <= 1.0, f"train fp32 card vs CPU at 256px: {name} "
              f"gradients, worst {key} at {ratio:.3g} of the bar "
              f"(||d|| <= {TRAIN_FP32_GRAD_REL}·||g|| + 1e-6·M); unpinned "
              f"{free[name][1]} at {free[name][0]:.3g}")
    del cpu, card32
    torch.cuda.empty_cache()
    print(f"train pix2pixhd_512 b1 512px: {ms:.2f} ms/step bf16, "
          f"{ms32:.2f} ms/step fp32, peak {peak / 2**30:.2f} / "
          f"{peak32 / 2**30:.2f} GiB ({card})", flush=True)
    return res


def kernel_entry(name, source, replaces, launches, rows_total, worst,
                 per, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=worst, ms=rows_total["ms"],
                plain_ms=rows_total["plain_ms"],
                bound_ms=rows_total["bound_ms"], bound_by="bytes",
                library_ms=rows_total["library_ms"],
                eager_ms=rows_total["eager_ms"], per=per, **extra)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from ir2rgb_tpu_torch import set_parity_mode
    from ir2rgb_tpu_torch.kernels import _build

    # the VGG of the train phase is the documented numpy-seeded He-random
    # fallback on purpose; its warning says nothing here
    warnings.filterwarnings("ignore", message="VGG perceptual loss")
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
    b1_rows, b1_frame, b1_step, b1_worst = b1_phase(bw, gen)
    bwd_rows, bwd_step, bwd_worst = b1_bwd_phase(bw, gen)
    b2_rows, b2_hmma = b2_phase(bw, fp32_peak, bf16_peak, gen)
    d2s_rows, d2s_step = d2s_phase(bw, gen)
    up_rows = deconv_phase(gen)
    slices = [slice_phase(preset, SEED, card)
              for preset in ("pix2pixhd_512", "temporal_512")]
    train = train_phase(card)

    serve = {s["preset"]: s["launches"] for s in slices}
    steps = train["launches_timed"]
    b2 = next(r for r in b2_rows
              if tuple(r["shape"]) == B2_MAIN and r["dtype"] == "bfloat16")
    b2_fp32 = next(r for r in b2_rows
                   if tuple(r["shape"]) == B2_MAIN and r["dtype"] == "float32")
    kernels = [
        kernel_entry(
            "instance_norm_act",
            "ir2rgb_tpu_torch/kernels/csrc/instance_norm.cu",
            "ir2rgb_tpu/kernels/instance_norm.py:127",
            steps["instance_norm_act"], b1_step, b1_worst[torch.bfloat16],
            f"one pix2pixhd_512 train step: {PER_STEP['instance_norm_act']}"
            " launches, bf16; launches over the 10 timed steps",
            max_abs_err_fp32=b1_worst[torch.float32],
            device_kernels_per_call=max(r["device_kernels"]
                                        for r in b1_rows),
            l2_route=sorted({str(r["shape"]) for r in b1_rows
                             if r["plan"].endswith("l2")}),
            per_serving_frame={k: b1_frame[k] for k in b1_frame},
            launches_by_path=dict(serve_8_frames={
                p: c["instance_norm_act"] for p, c in serve.items()},
                train_10_steps=steps["instance_norm_act"])),
        kernel_entry(
            "instance_norm_act_bwd",
            "ir2rgb_tpu_torch/kernels/csrc/instance_norm.cu",
            "ir2rgb_tpu/kernels/instance_norm.py:201",
            steps["instance_norm_act_bwd"], bwd_step,
            bwd_worst[torch.bfloat16],
            f"one train step: {PER_STEP['instance_norm_act_bwd']} launches,"
            " bf16; max_abs_err is relative to max|dx|",
            max_rel_err_fp32=bwd_worst[torch.float32],
            device_kernels_per_call=max(r["device_kernels"]
                                        for r in bwd_rows),
            l2_route=sorted({str(r["shape"]) for r in bwd_rows
                             if r["plan"].endswith("l2")})),
        dict(name="tail_fused", route="cuda",
             source="ir2rgb_tpu_torch/kernels/csrc/tail_fused.cu",
             replaces="ir2rgb_tpu/kernels/tail_fused.py:189",
             launches=serve["pix2pixhd_512"]["tail_fused"],
             max_abs_err=b2["max_abs_err"],
             max_abs_err_fp32=b2_fp32["max_abs_err"],
             ms=b2["ms"], plain_ms=b2["plain_ms"],
             bound_ms=b2["bound_ms"], bound_by=b2["bound_by"],
             library_ms=b2["library_ms"], eager_ms=b2["eager_ms"],
             cold_ms=b2["cold_ms"],
             per="one launch at (1,512,512,32), bf16 (tensor-core route); "
                 "launches over 8 pix2pixhd_512 serving frames (not on the "
                 "train path)",
             device_kernels_per_call=max(r["device_kernels"]
                                         for r in b2_rows),
             sass_hmma_per_kernel=b2_hmma,
             shapes=[{k: r[k] for k in ("shape", "dtype", "route",
                                        "tile_rows", "max_abs_err", "ms",
                                        "plain_ms", "library_ms", "bound_ms",
                                        "bound_by", "eager_ms", "cold_ms",
                                        "device_kernels")}
                     for r in b2_rows]),
        kernel_entry(
            "d2s", "ir2rgb_tpu_torch/kernels/csrc/d2s.cu",
            "ir2rgb_tpu/kernels/d2s.py:100", steps["d2s"], d2s_step["d2s"],
            max(r["max_abs_err"] for r in d2s_rows if r["name"] == "d2s"),
            "the five ups of one frame or step, bf16",
            launches_by_path=dict(serve_8_frames={
                p: c["d2s"] for p, c in serve.items()},
                train_10_steps=steps["d2s"])),
        kernel_entry(
            "s2d", "ir2rgb_tpu_torch/kernels/csrc/d2s.cu",
            "ir2rgb_tpu/kernels/d2s.py:115", steps["s2d"], d2s_step["s2d"],
            max(r["max_abs_err"] for r in d2s_rows if r["name"] == "s2d"),
            "the five ups' gradients of one train step, bf16"),
    ]
    print(f"peaks: {row} row, {bw / 1e12} TB/s, fp32 {fp32_peak / 1e12} "
          f"TFLOP/s, bf16 {bf16_peak / 1e12} TFLOP/s")
    for s in slices:
        print("slice " + json.dumps(s))
    print("train " + json.dumps(train))
    for tag, rows in (("B1", b1_rows), ("B1 bwd", bwd_rows)):
        for r in rows:
            cold = "" if r["cold_ms"] is None else \
                f" cold-L2 {r['cold_ms']:.4f}"
            print(f"  {tag} {r['shape']} {r['act']:10s} {r['dtype']:8s} "
                  f"ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
                  f"lib {r['library_ms']:.4f} bound {r['bound_ms']:.4f} "
                  f"eager {r['eager_ms']:.4f}{cold}; plan {r['plan']}, "
                  f"{r['device_kernels']} kernel/call")
    for r in b2_rows:
        cold = "" if r["cold_ms"] is None else f" cold-L2 {r['cold_ms']:.4f}"
        print(f"  B2 {r['shape']} {r['dtype']:8s} ms {r['ms']:.4f} plain "
              f"{r['plain_ms']:.4f} lib {r['library_ms']:.4f} bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) eager "
              f"{r['eager_ms']:.4f}{cold}; {r['route']}, "
              f"{r['tile_rows']} rows a tile, {r['device_kernels']} "
              "kernel/call")
    print(f"  B2 HMMA instructions per kernel (cuobjdump -sass): {b2_hmma}")
    for r in d2s_rows:
        print(f"  B3 {r['name']} {r['shape']} {r['dtype']:8s} ms "
              f"{r['ms']:.4f} plain {r['plain_ms']:.4f} lib "
              f"{r['library_ms']:.4f} bound {r['bound_ms']:.4f} eager "
              f"{r['eager_ms']:.4f}")
    for r in up_rows:
        print(f"  up {r['shape']}->{r['cout']} {r['dtype']:8s} subpixel "
              f"{r['subpixel_ms']:.4f} conv_transpose "
              f"{r['conv_transpose_ms']:.4f} (eager "
              f"{r['subpixel_eager_ms']:.4f} / "
              f"{r['conv_transpose_eager_ms']:.4f}) rel {r['rel_err']:.2g}")
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
