#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ir2rgb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each failing the run if it fails:

1. build the hand-written kernels from ir2rgb_tpu_torch/kernels/csrc;
2. B1 forward (fused instance norm + act): every shape and activation it
   runs at (``B1_FWD_SHAPES``: every served preset's generator,
   ``SERVE``, and every preset's train step, G and D, at its crop size
   and at 256x256, ``TRAIN`` / ``TRAIN_256``), bf16 and fp32, held to
   its plain version on the card, and timed beside the plain version,
   ``F.instance_norm`` + act (a yardstick the port never calls) and the
   card's bound; with each shape's plan (group width, cluster size,
   shared memory per block, route), its device kernels per call (the
   nodes of a CUDA graph captured around one call; must be 1), and for
   the four largest shapes of the pix2pixhd_512 step the time on a cold
   L2;
3. B1 backward: every train step's shapes (``B1_BWD_SHAPES``), dx held
   to the plain backward, timed beside it and the autograd backward of
   ``F.instance_norm`` + act, with the same plan, kernel count and
   cold-L2 readings;
4. B2 (output tail): the same at every preset's tail shape and a ragged
   batch-2 shape (``B2_SHAPES``), bf16 (the tensor-core route) and fp32
   (the CUDA-core route), yardstick ``F.pad(reflect)`` + ``F.conv2d`` +
   tanh; device kernels per call (must be 1), a cold-L2 time at the main
   path's shape, and the HMMA instructions of the built tensor-core
   kernels (``cuobjdump -sass``, must be > 0);
5. B3 d2s at every up of a served frame or a train step and s2d at every
   up's gradient (``D2S_SHAPES``, ``S2D_SHAPES``), exact against the
   plain permutation, yardstick ``view/permute/contiguous``; and each up
   (the five k3 ups, the U-Net's eight k4 ups) timed as the subpixel
   conv + d2s against ``F.conv_transpose2d``;
6. serving, one phase per preset: pix2pixhd_512 and temporal_512, then
   resnet9_256, temporal_256, pix2pixhd_global_512, pix2pixhd_1024,
   temporal_1024, pix2pixhd_2048 and pix2pix_unet256. Full-width
   generators with weights drawn from a numpy seed, 8 uint8 frames of
   the preset's crop size through ``StreamingGenerator.stream`` in bf16
   with the kernels' launch counts read around the run (``per_frame``);
   an fp32 card run (TF32 off) held to the port's fp32 CPU run (the
   main path's two at 512x512, the others at 256x256); the bf16 run's
   PSNR against fp32; ms/frame at batch 1;
7. ``ops.avg_pool``'s gradient on the card against the CPU's;
8. training, one phase per preset (``TRAIN``), at full width, the
   preset's crop size and batch 1, a temporal preset on windows of its
   4 frames: 4 bf16 steps, across the coarse-to-fine unfreeze where the
   preset has one (the trunk frozen for steps 0-1), each step's kernel
   launches held to ``TRAIN``, finite losses and the weights a step
   moves moved; 5 timed steps in bf16 and in fp32 (TF32 off) with peak
   memory; the bf16 first step's losses against fp32's; one fp32 step on
   the card held to the port's fp32 CPU step at full width on 256x256
   inputs (losses, launches against ``TRAIN_256``, and every gradient
   tensor at the CPU run's forward point);
9. ``train_cli``: the training CLI (``ir2rgb_tpu_torch.cli.train``) from
   folders of PNG frames at full width, bf16: pix2pixhd_512 for 6 frozen
   steps, then resumed with continue_train for 6 more across the
   unfreeze, and temporal_512 for 3 windows, each step's and each
   display's launches held to ``TRAIN`` / ``SERVE``, the checkpoints and
   epoch labels, the restored state bit for bit, and the first resumed
   step against the uninterrupted one; with the loader, checkpoint and
   fit-versus-bare-step numbers (``train_cli_phase``).

It prints each phase's seconds, the card (``nvidia-smi`` name and power
limit), one JSON line of kernel results, and last
``{"ok": true, "device": {...}}``; every phase's results go to
``build/chip_smoke.json`` as well. Without a CUDA device, or
without the ir2rgb_tpu_torch package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
import warnings
from collections import Counter
from functools import partial
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
# the five ups of a frame: (phase tensor shape, C); d2s forward, s2d back
D2S_MAIN_PATH = [((1, 16, 16, 2048), 512), ((1, 32, 32, 1024), 256),
                 ((1, 64, 64, 512), 128), ((1, 128, 128, 256), 64),
                 ((1, 256, 256, 128), 32)]

# What one served frame sends to each kernel, per preset: B1 (shape, act)
# -> count, B2's x shapes, B3 d2s (phase tensor shape, C) in order.
# tests/test_torch_port_serve_zoo.py holds these to a meta-device forward.
_RESNET9_256 = dict(
    b1={((1, 256, 256, 64), "relu"): 2, ((1, 128, 128, 128), "relu"): 2,
        ((1, 64, 64, 256), "relu"): 10, ((1, 64, 64, 256), "none"): 9},
    tail=[(1, 256, 256, 64)],
    d2s=[((1, 64, 64, 512), 128), ((1, 128, 128, 256), 64)])
def _trunk(hw: int, ngf: int = 64, downs: int = 4, blocks: int = 9):
    """The global trunk (headless) at ``hw``: its B1 (shape, act) ->
    count and its ups' d2s (phase shape, C), in order."""
    b1 = Counter([((1, hw, hw, ngf), "relu")]
                 + [((1, hw >> i, hw >> i, ngf << i), "relu")
                    for i in range(1, downs + 1)]
                 + [((1, hw >> downs, hw >> downs, ngf << downs), a)
                    for _ in range(blocks) for a in ("relu", "none")]
                 + [((1, hw >> i, hw >> i, ngf << i), "relu")
                    for i in range(downs - 1, -1, -1)])
    d2s = [((1, hw >> i, hw >> i, 4 * (ngf << (i - 1))), ngf << (i - 1))
           for i in range(downs, 0, -1)]
    return b1, d2s


# the global trunk at 512x512 (global_512, and the 1024 / 2048 presets')
_TRUNK_512_B1, _TRUNK_512_D2S = _trunk(512)


def _with_enhancer(b1: dict, hw: int, ngf_n: int, blocks: int = 3) -> dict:
    """``b1`` plus an enhancer level at ``hw``: down0 and the up at
    (hw, ngf_n), down1 and the blocks at (hw / 2, 2 ngf_n)."""
    out = dict(b1)
    for key, n in ((((1, hw, hw, ngf_n), "relu"), 2),
                   (((1, hw // 2, hw // 2, 2 * ngf_n), "relu"), 1 + blocks),
                   (((1, hw // 2, hw // 2, 2 * ngf_n), "none"), blocks)):
        out[key] = out.get(key, 0) + n
    return out


_MAIN_512 = dict(b1=B1_MAIN_PATH, tail=[(1, 512, 512, 32)],
                 d2s=D2S_MAIN_PATH)
_LOCAL_1024 = dict(b1=_with_enhancer(_TRUNK_512_B1, 1024, 32),
                   tail=[(1, 1024, 1024, 32)],
                   d2s=_TRUNK_512_D2S + [((1, 512, 512, 128), 32)])
SERVE = {
    "pix2pixhd_512": _MAIN_512,
    "temporal_512": _MAIN_512,
    "resnet9_256": _RESNET9_256,
    "temporal_256": _RESNET9_256,
    "pix2pixhd_global_512": dict(b1=_TRUNK_512_B1, tail=[(1, 512, 512, 64)],
                                 d2s=_TRUNK_512_D2S),
    "pix2pixhd_1024": _LOCAL_1024,
    "temporal_1024": _LOCAL_1024,
    "pix2pixhd_2048": dict(
        b1=_with_enhancer(_with_enhancer(_TRUNK_512_B1, 1024, 32), 2048, 16),
        tail=[(1, 2048, 2048, 16)],
        d2s=_TRUNK_512_D2S + [((1, 512, 512, 128), 32),
                              ((1, 1024, 1024, 64), 16)]),
    # every U-Net norm takes no activation: 6 on the way down, 7 up
    "pix2pix_unet256": dict(
        b1={((1, 64, 64, 128), "none"): 2, ((1, 32, 32, 256), "none"): 2,
            ((1, 16, 16, 512), "none"): 2, ((1, 8, 8, 512), "none"): 2,
            ((1, 4, 4, 512), "none"): 2, ((1, 2, 2, 512), "none"): 2,
            ((1, 128, 128, 64), "none"): 1},
        tail=[],
        d2s=[((1, 1, 1, 2048), 512), ((1, 2, 2, 2048), 512),
             ((1, 4, 4, 2048), 512), ((1, 8, 8, 2048), 512),
             ((1, 16, 16, 1024), 256), ((1, 32, 32, 512), 128),
             ((1, 64, 64, 256), 64), ((1, 128, 128, 12), 3)]),
}


def _d_pass(size: int, num_d: int, ndf: int = 64, n_layers: int = 3):
    """B1 (shape, act) -> count of one pass of the PatchGAN (``num_d``
    scales, each half the last) over a ``size``-square pair: 4x4 convs
    padded 2, stride 2 but the last normed one."""
    out = Counter()
    for i in range(num_d):
        h = (size >> i) // 2 + 1  # layer 0, no norm
        nf = ndf
        for j in range(1, n_layers + 1):
            h = h // 2 + 1 if j < n_layers else h + 1
            nf = min(nf * 2, 512)
            out[((1, h, h, nf), "leaky_relu")] += 1
    return out


def _scaled(shape, num: int, den: int):
    n, h, w, c = shape
    return (n, h * num // den, w * num // den, c)


def _mul(table: Counter, n: int) -> Counter:
    return Counter({k: v * n for k, v in table.items()})


# Each preset's train step at batch 1: (crop size, frames a step, D
# scales, feature matching on, the local enhancer's trunk (hw, ngf) or
# None). The G tables are SERVE's: a train step runs the same generator
# (with the composed tail, so no B2).
_TRAIN_SPEC = {
    "resnet9_256": (256, 1, 1, True, None),
    "temporal_256": (256, 4, 2, True, None),
    "pix2pix_unet256": (256, 1, 1, False, None),
    "pix2pixhd_512": (512, 1, 2, True, (256, 64)),
    "temporal_512": (512, 4, 2, True, (256, 64)),
    "pix2pixhd_global_512": (512, 1, 2, True, None),
    "pix2pixhd_1024": (1024, 1, 3, True, (512, 64)),
    "temporal_1024": (1024, 4, 3, True, (512, 64)),
    "pix2pixhd_2048": (2048, 1, 3, True, (512, 64)),
}


def train_table(preset: str, size: int = None) -> dict:
    """What one train step of ``preset`` at ``size`` (its crop size when
    None) sends to each kernel: B1 forward and backward (shape, act) ->
    count, d2s (phase shape, C) -> count, s2d (image shape) -> count;
    under "unfrozen" and, for the local enhancer (coarse-to-fine), under
    "frozen" too. Per frame G runs once; D four times with feature
    matching (G's fake, the real taps with no graph, D's real and fake),
    else three, each but the no-graph one with a backward. A frozen
    step's trunk takes no backward where its input needs no gradient:
    every frame of a frame step, the first frame of a window (later
    frames reach the trunk through the carry)."""
    crop, frames, num_d, fm, trunk = _TRAIN_SPEC[preset]
    size = size or crop
    g_b1 = Counter({(_scaled(k, size, crop), a): n
                    for (k, a), n in SERVE[preset]["b1"].items()})
    g_d2s = Counter((_scaled(k, size, crop), c)
                    for k, c in SERVE[preset]["d2s"])
    d = _d_pass(size, num_d)

    def s2d(d2s):
        return Counter({(n, 2 * h, 2 * w, c): m
                        for ((n, h, w, _), c), m in d2s.items()})

    unfrozen = dict(b1=_mul(g_b1 + _mul(d, 4 if fm else 3), frames),
                    b1_bwd=_mul(g_b1 + _mul(d, 3), frames),
                    d2s=_mul(g_d2s, frames), s2d=_mul(s2d(g_d2s), frames))
    out = {"unfrozen": unfrozen}
    if trunk is not None:
        t_b1, t_d2s = _trunk(trunk[0] * size // crop, trunk[1])
        out["frozen"] = dict(unfrozen, b1_bwd=unfrozen["b1_bwd"] - t_b1,
                             s2d=unfrozen["s2d"] - s2d(Counter(t_d2s)))
    return out


TRAIN = {p: train_table(p) for p in _TRAIN_SPEC}
# the same at 256x256, where each preset's fp32 card step is held to the
# CPU's
TRAIN_256 = {p: train_table(p, 256) for p in _TRAIN_SPEC}


def per_step(table: dict) -> dict:
    """Kernel launches of one train step from its ``TRAIN`` table."""
    return {"instance_norm_act": sum(table["b1"].values()),
            "instance_norm_act_bwd": sum(table["b1_bwd"].values()),
            "tail_fused": 0, "d2s": sum(table["d2s"].values()),
            "s2d": sum(table["s2d"].values())}


# the headline train step, pix2pixhd_512 unfrozen: 60 B1 forward (G's 36,
# four D passes of 6) and 54 backward (G's, three D passes: the fake for
# G, the real and the detached fake for D)
B1_FWD_PER_STEP = TRAIN["pix2pixhd_512"]["unfrozen"]["b1"]
B1_BWD_PER_STEP = TRAIN["pix2pixhd_512"]["unfrozen"]["b1_bwd"]
PER_STEP = per_step(TRAIN["pix2pixhd_512"]["unfrozen"])

# the U-Net's k4 ups as the deconv phase times them: (input shape, cout)
UNET_UPS = [((1, 1, 1, 512), 512), ((1, 2, 2, 1024), 512),
            ((1, 4, 4, 1024), 512), ((1, 8, 8, 1024), 512),
            ((1, 16, 16, 1024), 256), ((1, 32, 32, 512), 128),
            ((1, 64, 64, 256), 64), ((1, 128, 128, 128), 3)]


def per_frame(preset: str) -> dict:
    """Kernel launches of one served frame of ``preset``."""
    t = SERVE[preset]
    return {"instance_norm_act": sum(t["b1"].values()),
            "instance_norm_act_bwd": 0, "tail_fused": len(t["tail"]),
            "d2s": len(t["d2s"]), "s2d": 0}


def _keys(tables, field):
    return {k for t in tables for v in t.values() for k in v[field]}


_STEPS = list(TRAIN.values()) + list(TRAIN_256.values())
# every (shape, act) B1 runs at, in serving, in each preset's train step
# and in its 256x256 fp32 step: the headline step's first, then the rest
B1_FWD_SHAPES = list(B1_FWD_PER_STEP) + sorted(
    ({k for t in SERVE.values() for k in t["b1"]} | _keys(_STEPS, "b1"))
    - set(B1_FWD_PER_STEP))
B1_BWD_SHAPES = list(B1_BWD_PER_STEP) + sorted(
    _keys(_STEPS, "b1_bwd") - set(B1_BWD_PER_STEP))
# B2's x at every preset's tail, then a ragged batch-2 shape for the edge
# tiles and the batch index
B2_MAIN = (1, 512, 512, 32)
B2_SHAPES = sorted({x for t in SERVE.values() for x in t["tail"]}) + [
    (2, 72, 40, 32)]
# B3's d2s at every up of a served frame and of a train step (phase
# shape, C), and its s2d at every up's gradient (image shape), the
# headline path's first
D2S_SHAPES = D2S_MAIN_PATH + sorted(
    ({k for t in SERVE.values() for k in t["d2s"]} | _keys(_STEPS, "d2s"))
    - set(D2S_MAIN_PATH))
S2D_MAIN_PATH = list(TRAIN["pix2pixhd_512"]["unfrozen"]["s2d"])
S2D_SHAPES = S2D_MAIN_PATH + sorted(_keys(_STEPS, "s2d")
                                    - set(S2D_MAIN_PATH))
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SLICE_FP32_TOL = 1e-3
BF16_MIN_PSNR = 30.0
N_FRAMES = 8
# train steps a preset: the first FIX_STEPS frozen where the preset trains
# coarse to fine (niter_fix_global 1 x steps_per_epoch FIX_STEPS), then
# unfrozen; then TIMED_STEPS timed in bf16 and in fp32
TRAIN_STEPS, TIMED_STEPS, FIX_STEPS = 4, 5, 2
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

def device_kernels(fn) -> int:
    """Device kernels (and copies and memsets) one call of ``fn`` puts on
    the card: the nodes of a CUDA graph captured around that call, counted
    with the driver's ``cuGraphGetNodes``. Capture fails if ``fn`` launches
    on any other stream, so nothing it runs goes uncounted, and unlike a
    profiler trace the count does not depend on the tracer catching a
    short run's activity."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: builds, caches and the allocator's pool
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # an empty graph is a count of 0
        with torch.cuda.graph(graph):
            fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    rc = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                 None, ctypes.byref(count))
    graph.reset()
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes returned CUresult {rc}")
    return count.value


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
    for (shape, act) in B1_FWD_SHAPES:
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
                per_step=B1_FWD_PER_STEP.get((shape, act), 0),
                max_abs_err=err,
                plan=plan_text(b1.plan_for(x)), device_kernels=kernels,
                ms=graph_ms(kern),
                plain_ms=graph_ms(
                    lambda: b1.instance_norm_act_reference(x, act)),
                library_ms=graph_ms(
                    lambda: act_fn(F.instance_norm(x_nchw, eps=1e-5), act)),
                eager_ms=cuda_ms(kern), bound_ms=nbytes / bw * 1e3,
                cold_ms=cold_ms(kern, flush) if shape in B1_COLD else None))
    by_preset = {p: per_path_totals(rows, t["b1"]) for p, t in SERVE.items()}
    by_step = {p: per_path_totals(rows, t["unfrozen"]["b1"])
               for p, t in TRAIN.items()}
    return rows, by_preset, by_step, worst


def b1_bwd_phase(bw: float, gen: torch.Generator):
    """dx of B1 at every (shape, act) of each preset's train step (at its
    crop size and at 256x256), held to the plain backward relative to
    max|dx| (1e-4 fp32, 2e-2 bf16)."""
    from ir2rgb_tpu_torch.kernels import instance_norm as b1
    rows, worst = [], {torch.float32: 0.0, torch.bfloat16: 0.0}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for (shape, act) in B1_BWD_SHAPES:
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
                dtype=dtype_name(dtype),
                per_step=B1_BWD_PER_STEP.get((shape, act), 0),
                max_abs_err=err, rel_err=rel,
                plan=plan_text(b1.plan_for(x, bwd=True)),
                device_kernels=kernels, ms=graph_ms(kern),
                plain_ms=graph_ms(
                    lambda: b1.instance_norm_act_backward_reference(
                        x, mean, rstd, g, act)),
                library_ms=lib_fb - lib_f, library_fwd_bwd_ms=lib_fb,
                eager_ms=cuda_ms(kern), bound_ms=nbytes / bw * 1e3,
                cold_ms=cold_ms(kern, flush) if shape in B1_COLD else None))
    by_step = {p: per_path_totals(rows, t["unfrozen"]["b1_bwd"])
               for p, t in TRAIN.items()}
    return rows, by_step, worst


def d2s_phase(bw: float, gen: torch.Generator):
    """B3 d2s at every up of a served frame and of a train step, and s2d
    at every up's gradient in a train step: exact against the plain
    permutation, timed beside it and view/permute/contiguous."""
    from ir2rgb_tpu_torch.kernels import d2s as b3
    rows = []
    cases = ([("d2s", (n, h, w, c4), c) for (n, h, w, c4), c in D2S_SHAPES]
             + [("s2d", shape, shape[3]) for shape in S2D_SHAPES])
    for name, shape, c in cases:
        n, h, w, _ = shape
        for dtype in (torch.bfloat16, torch.float32):
            src = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            if name == "d2s":
                key, view = (shape, c), (n, h, w, 2, 2, c)
                kern = partial(b3.d2s, src, c)
                plain = partial(b3.d2s_reference, src, c)
            else:
                key, view = shape, (n, h // 2, 2, w // 2, 2, c)
                kern = partial(b3.s2d, src)
                plain = partial(b3.s2d_reference, src)
            # the library's yardstick: the same permutation, one copy
            lib = partial(lambda t, v: t.view(v).permute(
                0, 1, 3, 2, 4, 5).contiguous(), src, view)
            out, want = kern(), plain()
            torch.cuda.synchronize()
            exact = torch.equal(out, want)
            check(exact, f"B3 {name} {shape} {dtype_name(dtype)}: exact "
                  "against the plain permutation")
            rows.append(dict(
                name=name, key=key, shape=list(shape),
                dtype=dtype_name(dtype), exact=exact, max_abs_err=float(
                    (out.float() - want.float()).abs().max()),
                ms=graph_ms(kern), plain_ms=graph_ms(plain),
                library_ms=graph_ms(lib), eager_ms=cuda_ms(kern),
                bound_ms=2 * src.numel() * src.element_size() / bw * 1e3))
    d2s_rows = [r for r in rows if r["name"] == "d2s"]
    s2d_rows = [r for r in rows if r["name"] == "s2d"]
    totals = {"d2s": per_path_totals(d2s_rows,
                                     {k: 1 for k in D2S_MAIN_PATH}),
              "s2d": per_path_totals(s2d_rows,
                                     {k: 1 for k in S2D_MAIN_PATH})}
    by_preset = {p: per_path_totals(d2s_rows, {k: t["d2s"].count(k)
                                               for k in t["d2s"]})
                 for p, t in SERVE.items()}
    by_step = {p: {"d2s": per_path_totals(d2s_rows, t["unfrozen"]["d2s"]),
                   "s2d": per_path_totals(s2d_rows, t["unfrozen"]["s2d"])}
               for p, t in TRAIN.items()}
    return rows, totals, by_preset, by_step


def deconv_phase(gen: torch.Generator):
    """Each up as the port runs it (subpixel conv + B3 d2s + bias, the
    rearranged weight kept) against ``F.conv_transpose2d``, in inference
    at batch 1: the five k3 ups of the main path and the U-Net's eight k4
    ups."""
    from ir2rgb_tpu_torch.nn import Deconv, ops
    rows = []
    ups = ([((n, h, w, 2 * c), c, 3) for (n, h, w, _), c in D2S_MAIN_PATH]
           + [(xs, c, 4) for xs, c in UNET_UPS])
    for (n, h, w, cin), c, k in ups:
        geometry = dict(padding=1, output_padding=1 if k == 3 else 0)
        for dtype in (torch.bfloat16, torch.float32):
            # built outside inference mode, so that its weight is a normal
            # tensor whose rearranged copy the module keeps, as in serving
            up = Deconv(cin, c, k, **geometry).to(
                "cuda", dtype, memory_format=torch.channels_last)
            x = torch.randn((n, h, w, cin), generator=gen,
                            device="cuda").to(dtype)
            with torch.inference_mode():
                sub = lambda: up(x)  # noqa: E731
                dil = lambda: ops.deconv(  # noqa: E731
                    x, up.weight, up.bias, lowering="dilated", **geometry)
                a, b = sub(), dil()
                torch.cuda.synchronize()
                err = float((a.float() - b.float()).abs().max()) / float(
                    b.float().abs().max())
                check(err <= TOL[dtype], f"up k{k} {(n, h, w, cin)}->{c} "
                      f"{dtype_name(dtype)}: subpixel vs conv_transpose2d "
                      f"{err:.3g} of max (tol {TOL[dtype]})")
                rows.append(dict(shape=[n, h, w, cin], cout=c, k=k,
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


def slice_phase(preset: str, seed: int, card: str, cmp_size=None):
    """Serve ``preset`` at full width and its crop size: uint8 frames
    through the stream in bf16 with the launches counted, the fp32 card
    held to the fp32 CPU on ``cmp_size``-square frames (the crop size
    when None), bf16 against fp32 there, and ms/frame at batch 1."""
    from ir2rgb_tpu_torch.infer import StreamingGenerator
    from ir2rgb_tpu_torch.infer.stream import _dev_normalize
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    res = {"preset": preset}
    bf16 = make_model(preset, "bf16", "cuda", None)
    sd = seeded_state_dict(bf16.netG, seed)
    bf16.netG.load_state_dict(sd)
    temporal = bf16.cfg.model.model == "temporal"
    hw = (bf16.cfg.data.crop_size,) * 2
    in_nc = bf16.cfg.model.input_nc
    rng = np.random.default_rng(seed + 1)
    frames = [rng.integers(0, 256, hw + (in_nc,), dtype=np.uint8)
              for _ in range(N_FRAMES)]
    cmp_hw = hw if cmp_size is None else (cmp_size, cmp_size)
    cmp_frames = frames if cmp_size is None else [
        rng.integers(0, 256, cmp_hw + (in_nc,), dtype=np.uint8)
        for _ in range(3)]
    res["cmp_hw"] = list(cmp_hw)
    want = per_frame(preset)

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
    check(counts == {k: v * N_FRAMES for k, v in want.items()},
          f"{preset}: launches {counts} over {N_FRAMES} frames "
          f"(want {want} per frame)")
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
    s_cpu = StreamingGenerator(cpu, cmp_hw)
    free_gpu, free_bf = StreamingGenerator(fp32, cmp_hw), StreamingGenerator(
        bf16, cmp_hw)
    errs, psnrs, drift, drift_psnr = [], [], [], []
    for f in cmp_frames[:n_cmp]:
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
    at = f"{cmp_hw[0]}x{cmp_hw[1]}"
    check(max(errs) <= SLICE_FP32_TOL,
          f"{preset}: fp32 card vs fp32 CPU max-abs {max(errs):.3g} over "
          f"{n_cmp} frame(s) at {at} (tol {SLICE_FP32_TOL})")
    check(min(psnrs) >= BF16_MIN_PSNR,
          f"{preset}: bf16 vs fp32 PSNR {min(psnrs):.2f} dB at {at} "
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


def train_model(preset: str, dtype: str, device: str, weights,
                fix_steps: int = 0):
    """``preset`` at full width, with ``weights`` = (G, D, VGG)
    state_dicts (VGG None: the preset has no VGG loss); the trunk frozen
    for the first ``fix_steps`` steps (niter_fix_global 1 x
    steps_per_epoch ``fix_steps``; only the local enhancer has a trunk),
    none when 0."""
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.train import create_model
    cfg = PRESETS[preset]
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype=dtype),
        train=dataclasses.replace(cfg.train,
                                  niter_fix_global=int(fix_steps > 0)))
    model = create_model(cfg, device=device,
                         steps_per_epoch=max(fix_steps, 1))
    if weights is not None:
        for net, sd in zip((model.netG, model.netD, model.vgg), weights):
            if sd is not None:
                net.load_state_dict(sd)
    return model


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
        if ratio >= worst[0]:
            worst = (ratio, k)
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
    output and every B1 input and output that a run records with a graph,
    and B1's statistics (mean, rstd) at every call: recorded on one run,
    replayed in the same order on another. The second run's forward then
    takes the first run's values, and every kink its backward meets
    decides as the first run's did: ReLU / LeakyReLU on pinned values
    and, inside B1's backward kernel, on x-hat computed from the pinned x
    and the first run's statistics. Its backward is its own."""

    def __init__(self):
        self.saved, self.stats = [], []
        self.replayed, self.stats_replayed, self._replay = 0, 0, False

    def pin(self, y: torch.Tensor) -> torch.Tensor:
        if not (torch.is_grad_enabled() and y.requires_grad):
            return y
        if not self._replay:
            self.saved.append(y.detach().cpu())
            return y
        r = self.saved[self.replayed].to(y.device, y.dtype)
        self.replayed += 1
        return y + (r - y).detach()

    def _stats(self, mean: torch.Tensor, rstd: torch.Tensor):
        if not self._replay:
            self.stats.append((mean.cpu(), rstd.cpu()))
            return mean, rstd
        m, r = self.stats[self.stats_replayed]
        self.stats_replayed += 1
        return m.to(mean.device), r.to(rstd.device)

    def all_replayed(self) -> bool:
        return (self.replayed == len(self.saved) > 0
                and self.stats_replayed == len(self.stats) > 0)

    @contextlib.contextmanager
    def _patched(self, replay: bool):
        from ir2rgb_tpu_torch.kernels import instance_norm as b1k
        from ir2rgb_tpu_torch.nn import ops
        conv, b1 = ops.conv, ops.fused_instance_norm_act
        norm_stats = b1k.instance_norm_act
        self._replay = replay

        def stats(x, act="relu", eps=b1k.INSTANCE_NORM_EPS,
                  negative_slope=0.2):
            y, mean, rstd = norm_stats(x, act, eps, negative_slope)
            return (y, *self._stats(mean, rstd))

        ops.conv = lambda *a, **kw: self.pin(conv(*a, **kw))
        ops.fused_instance_norm_act = (
            lambda x, act="relu", negative_slope=0.2: self.pin(b1(
                self.pin(x), act, negative_slope)))
        b1k.instance_norm_act = stats
        try:
            yield
        finally:
            ops.conv, ops.fused_instance_norm_act = conv, b1
            b1k.instance_norm_act = norm_stats

    def recording(self):
        return self._patched(False)

    def replaying(self):
        return self._patched(True)


def train_phase(preset: str, card: str):
    """Train ``preset`` at full width, its crop size and batch 1 (a
    temporal preset on windows of its n_frames_total frames): TRAIN_STEPS
    bf16 steps with each step's launches held to ``TRAIN`` (frozen, then
    from FIX_STEPS unfrozen where the preset trains coarse to fine),
    finite losses and the weights that a step moves moved; TIMED_STEPS
    timed steps in bf16 and in fp32 (TF32 off) with peak memory; bf16's
    first-step losses against fp32's; one fp32 step on the card held to
    the port's fp32 CPU step at 256x256 (losses, and every gradient at
    the CPU run's forward point)."""
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    from ir2rgb_tpu_torch.profile_train import train_batch
    table = TRAIN[preset]
    fix = FIX_STEPS if "frozen" in table else 0
    bf16 = train_model(preset, "bf16", "cuda", None, fix)
    weights = (seeded_state_dict(bf16.netG, SEED),
               seeded_state_dict(bf16.netD, SEED + 1),
               None if bf16.vgg is None else
               {k: v.cpu() for k, v in bf16.vgg.state_dict().items()})
    for net, sd in zip((bf16.netG, bf16.netD), weights):
        net.load_state_dict(sd)
    cfg = bf16.cfg
    res = {"preset": preset, "batch": 1, "size": cfg.data.crop_size,
           "frames": (cfg.data.n_frames_total
                      if cfg.model.model == "temporal" else 1),
           "fix_steps": bf16.fix_steps}
    check(bf16.fix_steps == fix, f"{preset} train: fix_steps "
          f"{bf16.fix_steps} (want {fix})")
    batch = train_batch(cfg, SEED + 3, "cuda")

    losses, counts, walls, launches = [], [], [], {}
    for i in range(TRAIN_STEPS):
        frozen = i < fix
        g0, d0 = clone_params(bf16.netG), clone_params(bf16.netD)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        m = bf16.train_step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts.append(launch_counts())
        launches = {k: launches.get(k, 0) + v for k, v in counts[-1].items()}
        losses.append({k: float(v) for k, v in m.items()})
        want = per_step(table["frozen" if frozen else "unfrozen"])
        check(counts[-1] == want, f"{preset} train step {i} "
              f"({'frozen' if frozen else 'unfrozen'}): launches "
              f"{counts[-1]} (want {want})")
        check(all(math.isfinite(v) for v in losses[-1].values()),
              f"{preset} train step {i}: losses {losses[-1]}")
        # every weight moves, but the frozen trunk's (model.*), which stay
        moved = {**changed(bf16.netG, g0), **{
            "D." + k: v for k, v in changed(bf16.netD, d0).items()}}
        trunk = {k for k in moved if frozen and k.startswith("model.")}
        stuck = [k for k, v in moved.items() if k.endswith("weight")
                 and k not in trunk and not v]
        check(not stuck and not any(moved[k] for k in trunk),
              f"{preset} train step {i}: {len(stuck)} weight(s) did not "
              f"move {stuck[:3]}; frozen trunk tensors moved "
              f"{sum(moved[k] for k in trunk)} of {len(trunk)}")
    res.update(losses_bf16=losses, launches_by_step=counts,
               wall_ms_by_step=walls)
    del g0, d0  # the last step's copies of every weight, out of the peak

    # ms/step, unfrozen: bf16, then fp32 (TF32 off) after two steps of
    # its own (the first one's losses held against bf16's first)
    unfrozen = per_step(table["unfrozen"])
    ms, peak, run_counts = timed_steps(bf16, batch, TIMED_STEPS)
    check(run_counts == {k: v * TIMED_STEPS for k, v in unfrozen.items()},
          f"{preset} train: launches {run_counts} over {TIMED_STEPS} timed "
          "bf16 steps")
    launches = {k: launches[k] + v for k, v in run_counts.items()}
    del bf16
    torch.cuda.empty_cache()
    fp32 = train_model(preset, "float32", "cuda", weights)
    first = {k: float(v) for k, v in fp32.train_step(batch).items()}
    fp32.train_step(batch)
    ms32, peak32, run32 = timed_steps(fp32, batch, TIMED_STEPS)
    check(run32 == {k: v * TIMED_STEPS for k, v in unfrozen.items()},
          f"{preset} train: launches {run32} over {TIMED_STEPS} timed fp32 "
          "steps")
    launches = {k: launches[k] + v for k, v in run32.items()}
    rel = {k: abs(losses[0][k] - v) / abs(v) for k, v in first.items()}
    res.update(ms_per_step_bf16=ms, peak_bytes_bf16=peak,
               ms_per_step_fp32=ms32, peak_bytes_fp32=peak32,
               losses_fp32_first=first, bf16_vs_fp32_first_step_rel=rel,
               launches=launches)
    check(max(rel.values()) <= BF16_LOSS_REL,
          f"{preset} train: bf16 first-step losses within "
          f"{BF16_LOSS_REL:.0%} of fp32 "
          f"({ {k: f'{v:.3g}' for k, v in rel.items()} })")
    del fp32
    torch.cuda.empty_cache()

    # one fp32 step on the card against the port's fp32 CPU step at full
    # width on 256x256 inputs, the same weights and batch. The losses are
    # held as they come. The gradients are held at the forward point of
    # the CPU run: every conv output and every B1 input and output is
    # pinned to the CPU's value, and B1's backward reads the CPU's
    # statistics, so that its activation masks are the CPU's (KinkPins).
    # Unpinned, fp32 rounding flips a few ReLU units across their kink
    # (most in the trunk's 8x8x1024 blocks, where one unit carries ~0.4%
    # of a layer's gradient), which moves every G gradient by ~0.5%
    # whatever the arithmetic; that spread is reported. With only the
    # inputs of B1 pinned, a unit whose x-hat sits within the two runs'
    # rounding of zero still flipped in temporal_512's 4-frame window
    # (model.1.weight at 2.47 of the bar, NVIDIA H100 80GB HBM3, 700 W).
    cpu = train_model(preset, "float32", "cpu", weights)
    card32 = train_model(preset, "float32", "cuda", weights)
    b_cpu = train_batch(cfg, SEED + 4, "cpu", size=256)
    b_card = {k: v.cuda() for k, v in b_cpu.items()}
    pins = KinkPins()
    t0 = time.perf_counter()
    with pins.recording():
        m_cpu = cpu.compute_grads(b_cpu)
    cpu_s = time.perf_counter() - t0
    reset_launch_counts()
    m_card = card32.compute_grads(b_card)
    torch.cuda.synchronize()
    want256 = TRAIN_256[preset]["unfrozen"]
    got256 = launch_counts()
    check(got256["instance_norm_act"] == sum(want256["b1"].values())
          and got256["instance_norm_act_bwd"] == sum(
              want256["b1_bwd"].values())
          and got256["d2s"] == sum(want256["d2s"].values())
          and got256["s2d"] == sum(want256["s2d"].values()),
          f"{preset} train fp32 at 256px: launches {got256}")
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
    check(pins.all_replayed(),
          f"{preset} train fp32 card vs CPU: {pins.replayed} of "
          f"{len(pins.saved)} pins and {pins.stats_replayed} of "
          f"{len(pins.stats)} B1 statistics replayed")
    worst = {n: grad_bar({k: p.grad for k, p in getattr(
        card32, n).named_parameters()}, want[n], TRAIN_FP32_GRAD_REL)
             for n in nets}
    res.update(fp32_card_vs_cpu_loss_rel=loss_rel,
               fp32_card_vs_cpu_worst_grad_pinned=worst,
               fp32_card_vs_cpu_worst_grad_unpinned=free, cpu_step_s=cpu_s,
               pins=len(pins.saved))
    check(max(loss_rel.values()) <= TRAIN_FP32_LOSS_RTOL,
          f"{preset} train fp32 card vs CPU at 256px: losses rel "
          f"{max(loss_rel.values()):.3g} (tol {TRAIN_FP32_LOSS_RTOL})")
    for name, (ratio, key) in worst.items():
        check(ratio <= 1.0, f"{preset} train fp32 card vs CPU at 256px: "
              f"{name} gradients, worst {key} at {ratio:.3g} of the bar "
              f"(||d|| <= {TRAIN_FP32_GRAD_REL}·||g|| + 1e-6·M); unpinned "
              f"{free[name][1]} at {free[name][0]:.3g}")
    del cpu, card32
    torch.cuda.empty_cache()
    print(f"train {preset} b1 {res['size']}px x {res['frames']} frame(s): "
          f"{ms:.2f} ms/step bf16, {ms32:.2f} ms/step fp32, peak "
          f"{peak / 2**30:.2f} / {peak32 / 2**30:.2f} GiB ({card})",
          flush=True)
    return res


# the train_cli phase: pix2pixhd_512 trains 6 steps frozen (one epoch of
# 6 pairs, niter_fix_global 1), then resumes for 6 unfrozen; temporal_512
# trains 3 windows of 4 frames; then a bare-step timing
CLI_PAIRS, CLI_FRAMES, CLI_BARE_STEPS = 6, 6, 5


@contextlib.contextmanager
def wrapped(owner, name, make):
    """``owner.name`` replaced by ``make(original)`` inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def state_on_card(model) -> dict:
    """A copy of everything ``GanModel.state_dict`` holds, the config
    aside (it names the run), tensors cloned where they lie."""
    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.detach().clone()
        if isinstance(v, dict):
            return {k: copy(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(copy(x) for x in v)
        return v
    state = copy(model.state_dict())
    state.pop("config")
    return state


def first_difference(x, y, at="state"):
    """None if ``x`` and ``y`` are bit-equal nested states, else where
    they first differ."""
    if isinstance(x, torch.Tensor):
        same = (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                and x.shape == y.shape and torch.equal(x, y.to(x.device)))
        return None if same else at
    if isinstance(x, dict):
        if x.keys() != y.keys():
            return f"{at} keys"
        return next((d for d in (first_difference(x[k], y[k], f"{at}.{k}")
                                 for k in x) if d), None)
    if isinstance(x, (list, tuple)):
        if len(x) != len(y):
            return f"{at} length"
        return next((d for d in (first_difference(a, b, f"{at}[{i}]")
                                 for i, (a, b) in enumerate(zip(x, y))) if d),
                    None)
    return None if x == y else at


def train_cli_phase(card: str):
    """``python -m ir2rgb_tpu_torch.cli.train`` in process, from folders of
    PNG frames that ``data/synthetic.py`` writes (decoded by
    ``data/native.py``: the C++ library where it loads, else PIL):

    - pix2pixhd_512 at full width, bf16, batch 1, crop 512 from 572, on
      CLI_PAIRS pairs: run 1 trains one epoch with the trunk frozen
      (niter_fix_global 1), saving at steps 3 and 6 and labelling epoch 1
      at step 6, with a display (B2) at steps 3 and 6; run 2 resumes with
      continue_train, crosses the unfreeze (G's Adam state cleared at step
      6) and ends at 12. Each step's launches are held to ``TRAIN`` and
      each display's to the served frame's; the state restored in run 2
      is held bit for bit to run 1's at its end, on the card; and the
      first resumed step's losses to those of run 1's model taking the
      same step (uninterrupted), bit for bit, with cuDNN deterministic;
    - temporal_512 at full width for 3 windows of 4 frames;
    - the numbers beside: ms/step through ``Trainer.fit`` against the bare
      ``train_step`` on one batch, the wait in ``next()`` on the prefetch
      queue, host decode ms a batch, checkpoint bytes, the ``save()``
      stall and its snapshot, the write until the file is on disk, the
      restore, and peak memory."""
    import shutil
    from ir2rgb_tpu_torch.checkpoint import manager as ckpt
    from ir2rgb_tpu_torch.cli.train import main as cli_main
    from ir2rgb_tpu_torch.data import decoder_in_use, write_synthetic_dataset
    from ir2rgb_tpu_torch.data import loader
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    from ir2rgb_tpu_torch.train import GanModel, Trainer
    sync = torch.cuda.synchronize
    root = Path("build") / "train_cli"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_synthetic_dataset(str(root / "pairs"), n=CLI_PAIRS, size=572)
    write_synthetic_dataset(str(root / "video"), n_videos=1,
                            frames_per_video=CLI_FRAMES, size=572)
    res = {"decoder": decoder_in_use(),
           "write_folders_s": time.perf_counter() - t0}
    print(f"train_cli: host decode by {res['decoder']} "
          "(data/native.py::decoder_in_use)", flush=True)

    rec = {"steps": [], "displays": [], "decode": [], "waits": [],
           "snapshot_s": [], "save_s": [], "write": [], "fits": [],
           "restore_s": [], "restored": [], "trainers": [], "batches": []}

    def timed(key):
        def make(orig):
            def run(*a, **kw):
                t = time.perf_counter()
                out = orig(*a, **kw)
                rec[key].append(time.perf_counter() - t)
                return out
            return run
        return make

    def snapshot(orig):
        def run(state):  # snapshot recurses: time the outer call only
            if rec.get("in_snapshot"):
                return orig(state)
            rec["in_snapshot"] = True
            t = time.perf_counter()
            try:
                return orig(state)
            finally:
                rec["in_snapshot"] = False
                rec["snapshot_s"].append(time.perf_counter() - t)
        return run

    def decode(orig):
        def run(paths, *a, **kw):
            t = time.perf_counter()
            out = orig(paths, *a, **kw)
            rec["decode"].append((len(paths), time.perf_counter() - t))
            return out
        return run

    def prefetch(orig):
        def run(it, depth=2):
            gen, waits = orig(it, depth), []
            rec["waits"].append(waits)  # one list per loader stream
            while True:
                t = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    return
                waits.append(time.perf_counter() - t)
                yield item
        return run

    def write(orig):
        def run(path, state):
            t = time.perf_counter()
            orig(path, state)
            rec["write"].append((os.path.basename(path),
                                 time.perf_counter() - t,
                                 os.path.getsize(path)))
        return run

    def train_step(orig):
        def run(model, batch):
            rec["batches"].append(batch)
            reset_launch_counts()
            out = orig(model, batch)
            rec["steps"].append((model.step - 1, launch_counts(),
                                 {k: v.detach().clone()
                                  for k, v in out.items()}))
            return out
        return run

    def display(orig):
        def run(trainer, batch, step):
            reset_launch_counts()
            orig(trainer, batch, step)
            rec["displays"].append((step, launch_counts()))
        return run

    def fit(orig):
        def run(trainer, data, total_steps=None):
            start = trainer.model.step
            sync()
            t = time.perf_counter()
            orig(trainer, data, total_steps)
            sync()
            rec["fits"].append((trainer.model.step - start,
                                time.perf_counter() - t))
            rec["trainers"].append(trainer)
        return run

    def init_or_restore(orig):
        def run(trainer):
            sync()
            t = time.perf_counter()
            orig(trainer)
            sync()
            rec["restore_s"].append(time.perf_counter() - t)
            rec["restored"].append((trainer.model.step,
                                    state_on_card(trainer.model)))
        return run

    base = ["--preset", "pix2pixhd_512", "--model.compute_dtype", "bf16",
            "--data.dataroot", str(root / "pairs"),
            "--train.checkpoints_dir", str(root / "runs"),
            "--train.name", "pix2pixhd_512", "--train.niter_decay", "0",
            "--train.niter_fix_global", "1", "--train.save_latest_freq", "3",
            "--train.save_epoch_freq", "1", "--train.print_freq", "2",
            "--train.display_freq", "3"]
    temporal = ["--preset", "temporal_512", "--model.compute_dtype", "bf16",
                "--data.dataroot", str(root / "video"),
                "--train.checkpoints_dir", str(root / "runs"),
                "--train.name", "temporal_512", "--train.niter", "1",
                "--train.niter_decay", "0", "--train.display_freq", "3",
                "--train.print_freq", "3"]
    # cuDNN's deterministic algorithms for the phase: the uninterrupted
    # step below must reproduce the resumed one bit for bit
    deterministic = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for owner, name, make in (
                (loader, "_decode_many", decode),
                (loader, "_prefetch", prefetch),
                (ckpt, "snapshot", snapshot),
                (ckpt, "_write", write),
                (ckpt.CheckpointManager, "save", timed("save_s")),
                (GanModel, "train_step", train_step),
                (Trainer, "_display", display),
                (Trainer, "fit", fit),
                (Trainer, "init_or_restore", init_or_restore)):
            stack.enter_context(wrapped(owner, name, make))
        check(cli_main(base + ["--train.niter", "1"]) == 0, "train_cli run 1")
        run1 = rec["trainers"][-1]
        end1 = state_on_card(run1.model)
        n1 = len(rec["steps"])
        check(cli_main(base + ["--train.niter", "2",
                               "--train.continue_train", "true"]) == 0,
              "train_cli run 2 (resume)")
        run2 = rec["trainers"][-1]
        n2 = len(rec["steps"])
        d2 = len(rec["displays"])
        peaks = [torch.cuda.max_memory_allocated()]
        torch.cuda.reset_peak_memory_stats()
        check(cli_main(temporal) == 0, "train_cli temporal_512")
        peaks.append(torch.cuda.max_memory_allocated())

    # launches: every step's and every display's
    steps = rec["steps"]
    frozen = per_step(TRAIN["pix2pixhd_512"]["frozen"])
    unfrozen = per_step(TRAIN["pix2pixhd_512"]["unfrozen"])
    for i, (step, got, metrics) in enumerate(steps):
        preset = "pix2pixhd_512" if i < n2 else "temporal_512"
        if i < n2:
            want = frozen if step < 6 else unfrozen
        else:
            want = per_step(TRAIN["temporal_512"]["frozen"])
        check(got == want, f"train_cli {preset} step {step}: launches {got} "
              f"(want {want})")
        check(all(math.isfinite(float(v)) for v in metrics.values()),
              f"train_cli {preset} step {step}: finite losses")
    check([s for s, _, _ in steps] == list(range(12)) + [0, 1, 2],
          f"train_cli: steps {[s for s, _, _ in steps]}")
    for i, (step, got) in enumerate(rec["displays"]):
        preset = "pix2pixhd_512" if i < d2 else "temporal_512"
        check(got == per_frame(preset), f"train_cli {preset} display at "
              f"step {step}: launches {got} (want {per_frame(preset)})")
    check([s for s, _ in rec["displays"]] == [3, 6, 6, 9, 12, 12, 3, 3],
          f"train_cli: displays at {[s for s, _ in rec['displays']]}")
    res["launches"] = {p: {k: sum(c[k] for _, c, _ in group)
                           + sum(c[k] for _, c in shown) for k in PER_STEP}
                       for p, group, shown in (
                           ("pix2pixhd_512", steps[:n2],
                            rec["displays"][:d2]),
                           ("temporal_512", steps[n2:],
                            rec["displays"][d2:]))}

    # the run's files, its checkpoints and labels
    run_dir = root / "runs" / "pix2pixhd_512"
    files = ["config.json", "loss_log.txt", "metrics.jsonl", "web/index.html"]
    missing = [f for f in files if not (run_dir / f).exists()]
    images = sorted(os.listdir(run_dir / "web" / "images"))
    ckpts = sorted(os.listdir(run_dir / "ckpt"))
    with open(run_dir / "ckpt" / "epochs.json") as fh:
        labels = json.load(fh)
    records = [json.loads(x) for x in open(run_dir / "metrics.jsonl")]
    check(not missing and len(images) == 12 and os.listdir(run_dir / "tb"),
          f"train_cli: run files (missing {missing}, {len(images)} images)")
    check(ckpts == ["12.pt", "3.pt", "6.pt", "9.pt", "epochs.json"]
          and labels == {"1": 6, "2": 12},
          f"train_cli: checkpoints {ckpts}, epochs.json {labels}")
    check([r["step"] for r in records] == [2, 4, 6, 8, 10, 12],
          f"train_cli: metrics.jsonl steps {[r['step'] for r in records]}")

    # the resume: run 2 starts at step 6 with run 1's state, bit for bit
    start2, restored = rec["restored"][1]
    diff = first_difference(end1, restored)
    check(start2 == 6 and diff is None,
          f"train_cli: run 2 restored step {start2} (want 6); first "
          f"difference from run 1's end state: {diff}")
    # G's Adam state restarted at the unfreeze (step 6), D's did not
    adam_steps = {n: sorted({float(v["step"]) for v in opt.state.values()})
                  for n, opt in (("G", run2.model.opt_g),
                                 ("D", run2.model.opt_d))}
    check(adam_steps == {"G": [6.0], "D": [12.0]},
          f"train_cli: Adam step counts after run 2 {adam_steps} (want G "
          "[6.0], D [12.0])")

    # the first resumed step against run 1's model taking it uninterrupted
    first_batch = rec["batches"][n1]
    resumed = steps[n1][2]
    uninterrupted = {k: v.detach().clone() for k, v in
                     run1.model.train_step(first_batch).items()}
    same = all(torch.equal(resumed[k], uninterrupted[k]) for k in resumed)
    res["first_resumed_step"] = {k: [float(resumed[k]),
                                     float(uninterrupted[k])]
                                 for k in resumed}
    check(same, "train_cli: first resumed step's losses equal the "
          f"uninterrupted step's bit for bit {res['first_resumed_step']}")

    # fit against the bare step on one batch (both unfrozen, bf16)
    n_fit, fit_s = rec["fits"][1]
    sync()
    t = time.perf_counter()
    for _ in range(CLI_BARE_STEPS):
        run1.model.train_step(first_batch)
    sync()
    bare_ms = (time.perf_counter() - t) * 1e3 / CLI_BARE_STEPS
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        deterministic
    frames = sum(n for n, _ in rec["decode"])
    writes = {name: (sec, size) for name, sec, size in rec["write"]}
    res.update(
        fit_ms_per_step=fit_s * 1e3 / n_fit, bare_ms_per_step=bare_ms,
        fit_window_step_time_ms=[r["step_time"] * 1e3 for r in records],
        prefetch_wait_s=rec["waits"][1],
        decode_ms_per_batch=2e3 * sum(s for _, s in rec["decode"]) / frames,
        decoded_frames=frames,
        checkpoint_bytes={k: v[1] for k, v in writes.items()},
        write_s={k: v[0] for k, v in writes.items()},
        snapshot_s=rec["snapshot_s"], save_call_s=rec["save_s"],
        restore_s=rec["restore_s"][1],
        # runs 1 and 2 (run 1's model kept for the comparison), then the
        # temporal run with both pix2pixhd_512 models still live
        peak_bytes={"pix2pixhd_512": peaks[0], "temporal_512": peaks[1]})
    waits = rec["waits"][1][1:]  # run 2's, after the first batch
    peaks_named = res["peak_bytes"]
    print(f"train_cli pix2pixhd_512 bf16 b1 512px ({card}): "
          f"{res['fit_ms_per_step']:.1f} ms/step through Trainer.fit (run 2,"
          f" {n_fit} steps) vs {bare_ms:.1f} ms/step bare train_step; "
          f"prefetch next() wait mean {1e3 * sum(waits) / len(waits):.2f} "
          f"ms, max {1e3 * max(waits):.2f} ms; decode "
          f"{res['decode_ms_per_batch']:.1f} ms/batch ({res['decoder']})",
          flush=True)
    print(f"train_cli checkpoints ({card}): " + ", ".join(
        f"{k} {v[1] / 1e9:.2f} GB written in {v[0]:.2f} s"
        for k, v in writes.items()) + f"; save() stall "
        f"{[round(x, 3) for x in rec['save_s']]} s, of it snapshot "
        f"{[round(x, 3) for x in rec['snapshot_s']]} s; restore "
        f"{res['restore_s']:.2f} s; peak GiB " + json.dumps(
            {k: round(v / 2**30, 2) for k, v in peaks_named.items()}),
        flush=True)
    del run1, run2, rec
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
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

    seconds = {}

    def phase(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)
        return out

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b1_rows, b1_frame, b1_steps, b1_worst = phase("B1", b1_phase, bw, gen)
    bwd_rows, bwd_steps, bwd_worst = phase("B1 bwd", b1_bwd_phase, bw, gen)
    b2_rows, b2_hmma = phase("B2", b2_phase, bw, fp32_peak, bf16_peak, gen)
    d2s_rows, d2s_step, d2s_frame, d2s_steps = phase("B3", d2s_phase, bw,
                                                     gen)
    up_rows = phase("ups", deconv_phase, gen)
    # the main path's two presets at their crop size, then every other
    # served preset, held to the CPU on 256x256 frames (every generator
    # here divides 256)
    slices = [phase(p, slice_phase, p, SEED, card)
              for p in ("pix2pixhd_512", "temporal_512")]
    slices += [phase(p, slice_phase, p, SEED, card, cmp_size=256)
               for p in SERVE if p not in ("pix2pixhd_512", "temporal_512")]
    avg_pool_rel = phase("avg pool grad", avg_pool_grad_check)
    trains = [phase("train " + p, train_phase, p, card) for p in TRAIN]
    cli = phase("train_cli", train_cli_phase, card)

    # launches summed over every path's counted runs: 8 served frames a
    # preset, and each preset's bf16 steps and timed bf16 and fp32 steps
    by_path = {**{"serve " + s["preset"]: s["launches"] for s in slices},
               **{"train " + t["preset"]: t["launches"] for t in trains},
               **{"train_cli " + p: c for p, c in cli["launches"].items()}}
    total = {k: sum(c[k] for c in by_path.values())
             for k in PER_STEP}
    for k, n in total.items():
        check(n > 0, f"{k}: {n} launches over the paths")

    def path_launches(k):
        return {p: c[k] for p, c in by_path.items() if c[k]}

    b2 = next(r for r in b2_rows
              if tuple(r["shape"]) == B2_MAIN and r["dtype"] == "bfloat16")
    b2_fp32 = next(r for r in b2_rows
                   if tuple(r["shape"]) == B2_MAIN and r["dtype"] == "float32")
    main_step = "pix2pixhd_512"
    kernels = [
        kernel_entry(
            "instance_norm_act",
            "ir2rgb_tpu_torch/kernels/csrc/instance_norm.cu",
            "ir2rgb_tpu/kernels/instance_norm.py:136",
            total["instance_norm_act"], b1_steps[main_step],
            b1_worst[torch.bfloat16],
            f"times: one {main_step} train step "
            f"({PER_STEP['instance_norm_act']} launches), bf16; launches: "
            "summed over every path's counted runs",
            max_abs_err_fp32=b1_worst[torch.float32],
            device_kernels_per_call=max(r["device_kernels"]
                                        for r in b1_rows),
            l2_route=sorted({str(r["shape"]) for r in b1_rows
                             if r["plan"].endswith("l2")}),
            per_serving_frame_by_preset=b1_frame,
            per_train_step_by_preset=b1_steps,
            launches_by_path=path_launches("instance_norm_act")),
        kernel_entry(
            "instance_norm_act_bwd",
            "ir2rgb_tpu_torch/kernels/csrc/instance_norm.cu",
            "ir2rgb_tpu/kernels/instance_norm.py:201",
            total["instance_norm_act_bwd"], bwd_steps[main_step],
            bwd_worst[torch.bfloat16],
            f"times: one unfrozen {main_step} train step "
            f"({PER_STEP['instance_norm_act_bwd']} launches), bf16; "
            "max_abs_err is relative to max|dx|",
            max_rel_err_fp32=bwd_worst[torch.float32],
            device_kernels_per_call=max(r["device_kernels"]
                                        for r in bwd_rows),
            l2_route=sorted({str(r["shape"]) for r in bwd_rows
                             if r["plan"].endswith("l2")}),
            per_train_step_by_preset=bwd_steps,
            launches_by_path=path_launches("instance_norm_act_bwd")),
        dict(name="tail_fused", route="cuda",
             source="ir2rgb_tpu_torch/kernels/csrc/tail_fused.cu",
             replaces="ir2rgb_tpu/kernels/tail_fused.py:203",
             launches=total["tail_fused"],
             max_abs_err=b2["max_abs_err"],
             max_abs_err_fp32=b2_fp32["max_abs_err"],
             ms=b2["ms"], plain_ms=b2["plain_ms"],
             bound_ms=b2["bound_ms"], bound_by=b2["bound_by"],
             library_ms=b2["library_ms"], eager_ms=b2["eager_ms"],
             cold_ms=b2["cold_ms"],
             per="times: one launch at (1,512,512,32), bf16 (tensor-core "
                 "route); launches: the served frames (not on the train "
                 "path)",
             device_kernels_per_call=max(r["device_kernels"]
                                         for r in b2_rows),
             launches_by_path=path_launches("tail_fused"),
             sass_hmma_per_kernel=b2_hmma,
             shapes=[{k: r[k] for k in ("shape", "dtype", "route",
                                        "tile_rows", "max_abs_err", "ms",
                                        "plain_ms", "library_ms", "bound_ms",
                                        "bound_by", "eager_ms", "cold_ms",
                                        "device_kernels")}
                     for r in b2_rows]),
        kernel_entry(
            "d2s", "ir2rgb_tpu_torch/kernels/csrc/d2s.cu",
            "ir2rgb_tpu/kernels/d2s.py:107", total["d2s"], d2s_step["d2s"],
            max(r["max_abs_err"] for r in d2s_rows if r["name"] == "d2s"),
            f"times: the five ups of one {main_step} frame or step, bf16",
            per_serving_frame_by_preset=d2s_frame,
            per_train_step_by_preset={p: t["d2s"]
                                      for p, t in d2s_steps.items()},
            launches_by_path=path_launches("d2s")),
        kernel_entry(
            "s2d", "ir2rgb_tpu_torch/kernels/csrc/d2s.cu",
            "ir2rgb_tpu/kernels/d2s.py:119", total["s2d"], d2s_step["s2d"],
            max(r["max_abs_err"] for r in d2s_rows if r["name"] == "s2d"),
            f"times: the five ups' gradients of one unfrozen {main_step} "
            "train step, bf16",
            per_train_step_by_preset={p: t["s2d"]
                                      for p, t in d2s_steps.items()},
            launches_by_path=path_launches("s2d")),
    ]
    print(f"peaks: {row} row, {bw / 1e12} TB/s, fp32 {fp32_peak / 1e12} "
          f"TFLOP/s, bf16 {bf16_peak / 1e12} TFLOP/s")
    for s in slices:
        print("slice " + json.dumps(s))
    print("avg pool gradient, card vs CPU " + json.dumps(avg_pool_rel))
    for t in trains:
        print("train " + json.dumps(t))
    print("train_cli " + json.dumps(cli))
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
        print(f"  up k{r['k']} {r['shape']}->{r['cout']} {r['dtype']:8s} "
              "subpixel "
              f"{r['subpixel_ms']:.4f} conv_transpose "
              f"{r['conv_transpose_ms']:.4f} (eager "
              f"{r['subpixel_eager_ms']:.4f} / "
              f"{r['conv_transpose_eager_ms']:.4f}) rel {r['rel_err']:.2g}")
    for p, t in b1_frame.items():
        print(f"  {p} per frame, bf16: B1 {t['ms']:.4f} ms (bound "
              f"{t['bound_ms']:.4f}), B3 d2s {d2s_frame[p]['ms']:.4f} ms "
              f"(bound {d2s_frame[p]['bound_ms']:.4f})")
    for p in TRAIN:
        parts = [(k, t) for k, t in (
            ("B1", b1_steps[p]), ("B1 bwd", bwd_steps[p]),
            ("d2s", d2s_steps[p]["d2s"]), ("s2d", d2s_steps[p]["s2d"]))]
        print(f"  {p} per unfrozen train step, bf16: " + ", ".join(
            f"{k} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, plain "
            f"{t['plain_ms']:.4f}, lib {t['library_ms']:.4f})"
            for k, t in parts))
    print("phase seconds " + json.dumps(seconds))
    # everything above in one file, for runs whose output is cut short
    out = Path("build")
    out.mkdir(exist_ok=True)
    with open(out / "chip_smoke.json", "w") as fh:
        json.dump({"card": card, "seconds": seconds, "failures": failures,
                   "slices": slices, "trains": trains, "train_cli": cli,
                   "kernels": kernels}, fh)
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
