#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ir2rgb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each failing the run if it fails:

1. build the hand-written kernels from ir2rgb_tpu_torch/kernels/csrc;
2. B1 forward (fused instance norm + act): every shape and activation it
   runs at (``B1_FWD_SHAPES``: every served preset's generator,
   ``SERVE``, and every preset's train step, G and D, at its crop size
   and at 256x256, ``TRAIN`` / ``TRAIN_256``, and the train_options
   phase's, ``TRAIN_OPTIONS``), bf16 and fp32, held to
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
   resnet9_256, temporal_256, cyclegan_256 (its G_A),
   pix2pixhd_global_512, pix2pixhd_1024, temporal_1024, pix2pixhd_2048
   and pix2pix_unet256. Full-width
   generators with weights drawn from a numpy seed, 8 uint8 frames of
   the preset's crop size through ``StreamingGenerator.stream`` in bf16
   with the kernels' launch counts read around the run (``per_frame``);
   an fp32 card run (TF32 off) held to the port's fp32 CPU run (the
   main path's two at 512x512, the others at 256x256); the bf16 run's
   PSNR against fp32; ms/frame at batch 1;
7. ``ops.avg_pool``'s gradient and second derivative on the card
   against the CPU's;
8. training, one phase per preset (``TRAIN``), at full width, the
   preset's crop size and batch 1, a temporal preset on windows of its
   4 frames: 4 bf16 steps, across the coarse-to-fine unfreeze where the
   preset has one (the trunk frozen for steps 0-1), each step's kernel
   launches held to ``TRAIN``, finite losses and the weights a step
   moves moved; 5 timed steps in bf16 and in fp32 (TF32 off) with peak
   memory; the bf16 first step's losses against fp32's; one fp32 step on
   the card held to the port's fp32 CPU step at full width on 256x256
   inputs (losses, launches against ``TRAIN_256``, and every gradient
   tensor at the CPU run's forward point); cyclegan_256 trains its two
   generators and two discriminators the same way;
8b. ``train_options`` (``train_options_phase``), at full width: WGAN-GP
   on pix2pixhd_512 and, with the pixel D, on pix2pix_unet256 (bf16
   steps with launches held to ``TRAIN_OPTIONS``: the penalty's D pass,
   its B1 backward and the outer backward's; an fp32 step and D's
   gradient from D_GP alone against the CPU's, pinned); grad-accum 2
   against 1 on a batch of 2 (gradients at one forward point, peaks);
   EMA (the shadow against a float64 recompute, and served from a
   checkpoint bit for bit); the bf16-moment Adam against the formula;
   remat on pix2pixhd_1024 and pix2pixhd_2048 with dropout (losses bit
   for bit, gradients, launches, a lower peak); and the device time of
   B1's second derivative beside the B1 backward kernel;
9. ``train_cli``: the training CLI (``ir2rgb_tpu_torch.cli.train``) from
   folders of PNG frames at full width, bf16: pix2pixhd_512 for 6 frozen
   steps, then resumed with continue_train for 6 more across the
   unfreeze, and temporal_512 for 3 windows, each step's and each
   display's launches held to ``TRAIN`` / ``SERVE``, the checkpoints and
   epoch labels, the restored state bit for bit, and the first resumed
   step against the uninterrupted one; with the loader, checkpoint and
   fit-versus-bare-step numbers (``train_cli_phase``);
10. ``serve``: multi-stream serving (``serve_phase``). B1, B2 and B3 are
   checked above at every batched tick's shapes too (``SERVE_TICK``:
   every batch the phase launches: the ladder's 1, 2, 4, 8 and 16 of
   temporal_512 and pix2pixhd_1024, the server's and the CLI's, and 16
   of pix2pixhd_2048). A ``MultiStreamServer`` of temporal_512 at full
   width serves 12 streams over 8 physical rows for 6 ticks in which
   streams open, skip, close and reopen, fp32 and bf16: every chunk
   tick's launches equal one served frame's, each stream's frame is held
   to a batch-1 forward on the same frame and carry. Then the ms/tick
   ladder of temporal_512 and pix2pixhd_1024 at 1, 2, 4, 8 and 16 slots
   with the aggregate frames/s and peak memory, and one pix2pixhd_2048
   tick at 16; ``cli.infer --torch_g`` then ``cli.evaluate`` on a
   512x512 folder; a ``cli.serve`` subprocess in fp32 with a raw and a
   JPEG client, every reply held to a batch-1 stream.

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
    # a CycleGAN serves G_A, ResNet-9 at 256
    "cyclegan_256": _RESNET9_256,
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


def _d_pass(size: int, num_d: int, ndf: int = 64, n_layers: int = 3,
            pad: int = 2):
    """B1 (shape, act) -> count of one pass of the PatchGAN (``num_d``
    scales, each half the last) over a ``size``-square pair: 4x4 convs
    padded ``pad`` (2, pix2pixHD's; a CycleGAN's 1), stride 2 but the
    last normed one."""
    out = Counter()
    for i in range(num_d):
        h = ((size >> i) + 2 * pad - 4) // 2 + 1  # layer 0, no norm
        nf = ndf
        for j in range(1, n_layers + 1):
            h = ((h + 2 * pad - 4) // 2 + 1 if j < n_layers
                 else h + 2 * pad - 3)
            nf = min(nf * 2, 512)
            out[((1, h, h, nf), "leaky_relu")] += 1
    return out


def _pixel_d_pass(size: int, ndf: int = 64):
    """B1 of one pass of the pixel D: its one norm, at full resolution."""
    return Counter({((1, size, size, 2 * ndf), "leaky_relu"): 1})


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
    "cyclegan_256": (256, 1, 1, False, None),
}
# A CycleGAN's step: six generator passes (G_A(a), G_B(b), the two
# reconstructions, the two identities), each with a backward, and six D
# passes (two on the fakes for G, four for D's own update), each with a
# backward; its Ds pad 1
_CYCLE = {"cyclegan_256"}


def _gp(d: Counter):
    """The B1 launches WGAN-GP adds to a frame's step: one D forward on
    x-hat, the B1 backward inside the penalty's first derivative on every
    norm of that pass, and in the outer backward the B1 backward of every
    norm of that pass again: the second derivative (PyTorch arithmetic,
    kernels/instance_norm.py) reaches each norm's input, the last norm's
    through the head conv's double backward."""
    return dict(b1=d, b1_bwd=_mul(d, 2))


def train_table(preset: str, size: int = None, gp: bool = False,
                pixel: bool = False) -> dict:
    """What one train step of ``preset`` at ``size`` (its crop size when
    None) sends to each kernel: B1 forward and backward (shape, act) ->
    count, d2s (phase shape, C) -> count, s2d (image shape) -> count;
    under "unfrozen" and, for the local enhancer (coarse-to-fine), under
    "frozen" too. Per frame G runs once; D four times with feature
    matching (G's fake, the real taps with no graph, D's real and fake),
    else three, each but the no-graph one with a backward. A frozen
    step's trunk takes no backward where its input needs no gradient:
    every frame of a frame step, the first frame of a window (later
    frames reach the trunk through the carry). A CycleGAN (``_CYCLE``)
    runs six G passes and six D passes a step, each both ways. ``gp``:
    with WGAN-GP (``_gp``); ``pixel``: with the pixel D in place of the
    preset's."""
    crop, frames, num_d, fm, trunk = _TRAIN_SPEC[preset]
    size = size or crop
    g_b1 = Counter({(_scaled(k, size, crop), a): n
                    for (k, a), n in SERVE[preset]["b1"].items()})
    g_d2s = Counter((_scaled(k, size, crop), c)
                    for k, c in SERVE[preset]["d2s"])
    cycle = preset in _CYCLE
    d = (_pixel_d_pass(size) if pixel else
         _d_pass(size, num_d, pad=1 if cycle else 2))
    g_passes, d_fwd, d_bwd = ((6, 6, 6) if cycle else
                              (1, 4 if fm else 3, 3))

    def s2d(d2s):
        return Counter({(n, 2 * h, 2 * w, c): m
                        for ((n, h, w, _), c), m in d2s.items()})

    b1, b1_bwd = _mul(g_b1, g_passes) + _mul(d, d_fwd), _mul(
        g_b1, g_passes) + _mul(d, d_bwd)
    if gp:
        extra = _gp(d)
        b1, b1_bwd = b1 + extra["b1"], b1_bwd + extra["b1_bwd"]
    unfrozen = dict(b1=_mul(b1, frames), b1_bwd=_mul(b1_bwd, frames),
                    d2s=_mul(g_d2s, frames * g_passes),
                    s2d=_mul(s2d(g_d2s), frames * g_passes))
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


def at_batch(table: dict, n: int) -> dict:
    """A ``TRAIN``-style table's shapes at batch ``n``."""
    def at(key):
        shape, rest = key
        return ((n,) + tuple(shape[1:]), rest)
    return {k: Counter({(at(key) if k != "s2d" else
                         (n,) + tuple(key[1:])): c
                        for key, c in v.items()})
            for k, v in table.items()}


# The train_options phase (``train_options_phase``): WGAN-GP on
# pix2pixhd_512 (bf16 steps at its crop size, the fp32 card-vs-CPU step
# at 256x256) and the pixel D with WGAN-GP on pix2pix_unet256; grad-accum
# 2 against accum 1 at batch 2 (pix2pixhd_512, 256x256: the micro-batch
# shapes are TRAIN_256's, the full batch's at batch 2); remat runs
# TRAIN's shapes. The pixel D's one norm on pix2pixhd_512 is checked too.
ACCUM_SIZE = 256
TRAIN_OPTIONS = {
    "gp pix2pixhd_512": train_table("pix2pixhd_512", gp=True),
    "gp pix2pixhd_512 256": train_table("pix2pixhd_512", 256, gp=True),
    "gp pixel pix2pix_unet256": train_table("pix2pix_unet256", gp=True,
                                            pixel=True),
    "accum pix2pixhd_512 b2": at_batch(train_table(
        "pix2pixhd_512", ACCUM_SIZE)["unfrozen"], 2),
    "pixel pix2pixhd_512": train_table("pix2pixhd_512", pixel=True),
}


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


_STEPS = (list(TRAIN.values()) + list(TRAIN_256.values())
          + [t if "unfrozen" in t else {"unfrozen": t}
             for t in TRAIN_OPTIONS.values()])
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

# The batched serving tick (the serve phase, ``infer/multistream.py``):
# N streams share one forward at the physical batch, so each kernel sees
# the served frame's shapes at batch S. The phase's MultiStreamServer runs
# SERVE_SLOTS streams over SERVE_PHYSICAL rows (two chunk ticks a logical
# tick); SERVE_DEFAULT is the port's default cap on the physical batch
# (``KNEE_SLOTS``, checked in the phase), so the largest batch a tick
# gives the kernels; cli.serve runs with SERVE_CLI_SLOTS slots.
SERVE_PHYSICAL, SERVE_DEFAULT, SERVE_SLOTS, SERVE_CLI_SLOTS = 8, 16, 12, 4
# the ms/tick ladder: physical batches and presets
LADDER_SLOTS = (1, 2, 4, 8, 16)
LADDER_PRESETS = ("temporal_512", "pix2pixhd_1024")


def batched(table: dict, n: int) -> dict:
    """A ``SERVE`` entry's kernel shapes at batch ``n``."""
    def at(shape):
        return (n,) + tuple(shape[1:])
    return dict(b1={(at(s), a): c for (s, a), c in table["b1"].items()},
                tail=[at(s) for s in table["tail"]],
                d2s=[(at(s), c) for s, c in table["d2s"]])


# every (preset, physical batch) the serve phase launches (it checks that
# its runs stay inside this table)
SERVE_TICK = {(p, n): batched(SERVE[p], n) for p, n in sorted(
    {(p, n) for p in LADDER_PRESETS for n in LADDER_SLOTS}
    | {("temporal_512", SERVE_PHYSICAL), ("temporal_512", SERVE_CLI_SLOTS),
       ("pix2pixhd_2048", SERVE_DEFAULT)})}
B1_FWD_SHAPES += sorted({k for t in SERVE_TICK.values() for k in t["b1"]}
                        - set(B1_FWD_SHAPES))
B2_SHAPES += sorted({x for t in SERVE_TICK.values() for x in t["tail"]}
                    - set(B2_SHAPES))
D2S_SHAPES += sorted({k for t in SERVE_TICK.values() for k in t["d2s"]}
                     - set(D2S_SHAPES))
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# graph_ms captures REPS_LONG calls of a call longer than LONG_CALL_MS
LONG_CALL_MS, REPS_LONG = 20.0, 4
SLICE_FP32_TOL = 1e-3
BF16_MIN_PSNR = 30.0
# a batched stream against its batch-1 stream, bf16 (the serve phase)
BF16_SERVE_PSNR = 40.0
# a cli.serve reply (uint8) against a batch-1 fp32 stream of the same
# frames, TF32 off on both sides, over a stream's first three frames. On
# an H100 80GB HBM3 free-running fp32 streams read 82, 76 and 70 dB on
# frames 1-3 against the batched server; a reply served without its
# carry is checked to read below the bar
FP32_SERVE_PSNR = 60.0
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
    slowed by the card's clocks or its host does not set the reading. A
    call of more than LONG_CALL_MS is captured REPS_LONG times, which
    keeps the batched serving tick's largest shapes to seconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
        start.record(side)
        fn()
        end.record(side)
    torch.cuda.current_stream().wait_stream(side)
    end.synchronize()
    if start.elapsed_time(end) > LONG_CALL_MS:
        reps = REPS_LONG
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
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
                fix_steps: int = 0, **sections):
    """``preset`` at full width, with ``weights`` (network name -> its
    state_dict, "vgg" for the VGG; None: the seeded init) loaded; the
    trunk frozen for the first ``fix_steps`` steps (niter_fix_global 1 x
    steps_per_epoch ``fix_steps``; only the local enhancer has a trunk),
    none when 0. ``sections``: config fields to change, by section
    (``model=dict(remat=True)``)."""
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.train import create_model
    cfg = PRESETS[preset]
    changes = {k: dict(v) for k, v in sections.items()}
    changes.setdefault("model", {})["compute_dtype"] = dtype
    changes.setdefault("train", {})["niter_fix_global"] = int(fix_steps > 0)
    cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                         for k, v in changes.items()})
    model = create_model(cfg, device=device,
                         steps_per_epoch=max(fix_steps, 1))
    if weights is not None:
        for name, net in nets_of(model).items():
            net.load_state_dict(weights[name])
        if model.vgg is not None:
            model.vgg.load_state_dict(weights["vgg"])
        if model.ema is not None:
            model.init_ema()
    return model


def nets_of(model) -> dict:
    """Every network a train step updates, by state_dict key."""
    return {**model.g_nets(), **model.d_nets()}


# the seed of each network's weights (seeded_state_dict)
NET_SEEDS = {"netG": SEED, "netD": SEED + 1, "netG_B": SEED + 4,
             "netD_B": SEED + 5}


def seeded_model(preset: str, dtype: str, fix_steps: int = 0,
                 **sections) -> tuple:
    """``train_model`` on the card with ``seeded_weights``: (the model,
    its weights)."""
    model = train_model(preset, dtype, "cuda", None, fix_steps, **sections)
    weights = seeded_weights(model)
    for name, net in nets_of(model).items():
        net.load_state_dict(weights[name])
    if model.ema is not None:
        model.init_ema()
    return model, weights


def seeded_weights(model) -> dict:
    """``train_model``'s weights for ``model``'s networks, drawn from
    numpy seeds, and its VGG's as they are (CPU tensors)."""
    w = {name: seeded_state_dict(net, NET_SEEDS[name])
         for name, net in nets_of(model).items()}
    if model.vgg is not None:
        w["vgg"] = {k: v.cpu() for k, v in model.vgg.state_dict().items()}
    return w


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


def grads_of(model) -> dict:
    """Network name -> parameter name -> its ``.grad``."""
    return {n: {k: p.grad for k, p in net.named_parameters()}
            for n, net in nets_of(model).items()}


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
    """``ops.avg_pool``'s gradient, and its second derivative (WGAN-GP's
    path between D's scales), on the card against the CPU's at the
    discriminator's pyramid shape; beside them ``F.avg_pool2d`` straight
    on channels-last memory, whose CUDA backward is wrong (reported)."""
    from ir2rgb_tpu_torch.nn import ops
    rng = np.random.default_rng(SEED + 5)
    x = torch.from_numpy(rng.standard_normal((1, 256, 256, 6),
                                             dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 128, 128, 6),
                                             dtype=np.float32))
    h = torch.from_numpy(rng.standard_normal((1, 256, 256, 6),
                                             dtype=np.float32))

    def grad(fn, dev):
        xi = x.to(dev, copy=True).requires_grad_(True)
        (gx,) = torch.autograd.grad(fn(xi), xi, g.to(dev))
        return gx.cpu()

    def port(t):
        return ops.avg_pool(t, 3, 2, 1, count_include_pad=False)

    def channels_last(t):
        return F.avg_pool2d(t.permute(0, 3, 1, 2), 3, 2, 1,
                            count_include_pad=False).permute(0, 2, 3, 1)

    def grad2(fn, dev):
        # the second derivative WGAN-GP takes through the pool between
        # D's scales: d/dx <h, d/dx <g, pool(x)^2>>
        xi = x.to(dev, copy=True).requires_grad_(True)
        (gx,) = torch.autograd.grad((fn(xi).square() * g.to(dev)).sum(), xi,
                                    create_graph=True)
        (gxx,) = torch.autograd.grad((gx * h.to(dev)).sum(), xi)
        return gxx.cpu()

    want, want2 = grad(port, "cpu"), grad2(port, "cpu")
    fns = (("ops.avg_pool", port), ("F.avg_pool2d channels-last",
                                    channels_last))
    rel = {name: float((grad(fn, "cuda") - want).norm() / want.norm())
           for name, fn in fns}
    rel.update({name + " second derivative": float(
        (grad2(fn, "cuda") - want2).norm() / want2.norm())
        for name, fn in fns})
    check(rel["ops.avg_pool"] <= 1e-6
          and rel["ops.avg_pool second derivative"] <= 1e-6,
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

    def __init__(self, merge: int = 1):
        """``merge`` > 1: the recording ran ``merge`` micro-batches one
        after the other (grad-accum), the replay runs them as one batch:
        replayed call i takes the concatenation, along the batch, of
        call i of every micro-batch's recording."""
        self.saved, self.stats = [], []
        self.replayed, self.stats_replayed, self._replay = 0, 0, False
        self.merge = merge

    def _take(self, records: list, i: int):
        n = len(records) // self.merge
        parts = [records[i + j * n] for j in range(self.merge)]
        if self.merge == 1:
            return parts[0]
        if isinstance(parts[0], tuple):
            return tuple(torch.cat(t) for t in zip(*parts))
        return torch.cat(parts)

    def pin(self, y: torch.Tensor) -> torch.Tensor:
        if not (torch.is_grad_enabled() and y.requires_grad):
            return y
        if not self._replay:
            self.saved.append(y.detach().cpu())
            return y
        r = self._take(self.saved, self.replayed).to(y.device, y.dtype)
        self.replayed += 1
        return y + (r - y).detach()

    def _stats(self, mean: torch.Tensor, rstd: torch.Tensor):
        if not self._replay:
            self.stats.append((mean.cpu(), rstd.cpu()))
            return mean, rstd
        m, r = self._take(self.stats, self.stats_replayed)
        self.stats_replayed += 1
        return m.to(mean.device), r.to(rstd.device)

    def all_replayed(self) -> bool:
        return (self.replayed * self.merge == len(self.saved) > 0
                and self.stats_replayed * self.merge == len(self.stats) > 0)

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
    bf16, weights = seeded_model(preset, "bf16", fix)
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
        before = {n: clone_params(net) for n, net in nets_of(bf16).items()}
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
        moved = {f"{n}.{k}": v for n, net in nets_of(bf16).items()
                 for k, v in changed(net, before[n]).items()}
        trunk = {k for k in moved if frozen and k.startswith("netG.model.")}
        stuck = [k for k, v in moved.items() if k.endswith("weight")
                 and k not in trunk and not v]
        check(not stuck and not any(moved[k] for k in trunk),
              f"{preset} train step {i}: {len(stuck)} weight(s) did not "
              f"move {stuck[:3]}; frozen trunk tensors moved "
              f"{sum(moved[k] for k in trunk)} of {len(trunk)}")
    res.update(losses_bf16=losses, launches_by_step=counts,
               wall_ms_by_step=walls)
    del before  # the last step's copies of every weight, out of the peak

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
    want = grads_of(cpu)
    free = {n: grad_bar(g, want[n], TRAIN_FP32_GRAD_REL)
            for n, g in grads_of(card32).items()}
    with pins.replaying():
        card32.compute_grads(b_card)
    check(pins.all_replayed(),
          f"{preset} train fp32 card vs CPU: {pins.replayed} of "
          f"{len(pins.saved)} pins and {pins.stats_replayed} of "
          f"{len(pins.stats)} B1 statistics replayed")
    worst = {n: grad_bar(g, want[n], TRAIN_FP32_GRAD_REL)
             for n, g in grads_of(card32).items()}
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


# the train_options phase
GP_EPS = (0.3, 0.7)  # the penalty's mixing weights, one a sample
EMA_DECAY, EMA_STEPS = 0.999, 3
REMAT_PRESETS = ("pix2pixhd_1024", "pix2pixhd_2048")
# the enhancer levels of a local preset: (hw, ngf_n) each
_ENHANCERS = {"pix2pixhd_1024": [(1024, 32)],
              "pix2pixhd_2048": [(1024, 32), (2048, 16)]}


def remat_table(preset: str) -> dict:
    """One unfrozen remat train step of a local preset: ``TRAIN``'s, plus
    the B1 forward of every residual block's two norms again, recomputed
    in the backward (the trunk's 9 at its 16th resolution, each
    enhancer's 3 at its half)."""
    crop, _, _, _, (hw, ngf) = _TRAIN_SPEC[preset]
    blocks = Counter({((1, hw >> 4, hw >> 4, ngf << 4), a): 9
                      for a in ("relu", "none")})
    for level, ngf_n in _ENHANCERS[preset]:
        blocks.update({((1, level // 2, level // 2, 2 * ngf_n), a): 3
                       for a in ("relu", "none")})
    t = TRAIN[preset]["unfrozen"]
    return dict(t, b1=t["b1"] + blocks)


REMAT = {p: remat_table(p) for p in REMAT_PRESETS}


@contextlib.contextmanager
def fixed_eps():
    """The penalty's mixing weights fixed (``GP_EPS``), the same on the
    card and the CPU, whose generators draw different numbers."""
    from ir2rgb_tpu_torch.losses import gan
    with wrapped(gan, "draw_eps", lambda orig: lambda n, generator:
                 torch.tensor(GP_EPS[:n]).reshape(n, 1, 1, 1).to(
                     generator.device)):
        yield


def gp_grads(model, batch) -> tuple:
    """One step's metrics and gradients (``grads_of``), and D's gradient
    from the D_GP term alone, from one forward."""
    for p in model._params():
        p.grad = None
    loss_g, loss_d, m = model.loss_and_metrics(batch)
    names, params = zip(*model.netD.named_parameters())
    # the logits' biases do not reach the input gradient: no D_GP term
    gp = torch.autograd.grad(m["D_GP"], params, retain_graph=True,
                             allow_unused=True)
    (loss_g + loss_d).backward()
    return ({k: float(v.detach()) for k, v in m.items()
             if not k.startswith("_")},
            grads_of(model), {k: torch.zeros_like(p) if g is None else g
                              for k, p, g in zip(names, params, gp)})


def gp_check(tag: str, preset: str, card: str, **sections) -> dict:
    """WGAN-GP on ``preset`` (``sections`` change its config): TRAIN_STEPS
    bf16 steps at its crop size with each step's launches held to
    ``TRAIN_OPTIONS[tag]``, finite losses, D_GP > 0 and every weight
    moved; then one fp32 step on the card against the port's fp32 CPU
    step at 256x256 on the same weights, batch and mixing weights: its
    launches held to ``TRAIN_OPTIONS[tag + " 256"]`` (or ``tag``'s at
    256), the losses, every gradient and D's gradient from D_GP alone at
    the CPU run's forward point (``KinkPins``, whose B1 statistics the
    second derivative reads too)."""
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    from ir2rgb_tpu_torch.profile_train import train_batch
    loss = dict(sections.pop("loss", {}), gan_mode="wgangp")
    bf16, weights = seeded_model(preset, "bf16", loss=loss, **sections)
    res = {"tag": tag, "preset": preset, "net_d": bf16.disc_cfg.net_d}
    batch = train_batch(bf16.cfg, SEED + 3, "cuda")
    want = per_step(TRAIN_OPTIONS[tag]["unfrozen"])
    losses, counts, launches = [], [], {}
    for i in range(TRAIN_STEPS):
        before = {n: clone_params(net) for n, net in nets_of(bf16).items()}
        reset_launch_counts()
        m = bf16.train_step(batch)
        torch.cuda.synchronize()
        counts.append(launch_counts())
        launches = {k: launches.get(k, 0) + v for k, v in counts[-1].items()}
        losses.append({k: float(v) for k, v in m.items()})
        check(counts[-1] == want, f"{tag} step {i}: launches {counts[-1]} "
              f"(want {want})")
        check(all(math.isfinite(v) for v in losses[-1].values())
              and losses[-1]["D_GP"] > 0, f"{tag} step {i}: {losses[-1]}")
        stuck = [f"{n}.{k}" for n, net in nets_of(bf16).items()
                 for k, v in changed(net, before[n]).items()
                 if k.endswith("weight") and not v]
        check(not stuck, f"{tag} step {i}: every weight moved (stuck: "
              f"{stuck[:3]})")
    ms, peak, run = timed_steps(bf16, batch, TIMED_STEPS)
    check(run == _mul(want, TIMED_STEPS), f"{tag}: launches {run} "
          f"over {TIMED_STEPS} timed steps")
    launches = {k: launches[k] + v for k, v in run.items()}
    res.update(losses_bf16=losses, launches_by_step=counts,
               ms_per_step_bf16=ms, peak_bytes_bf16=peak)
    del bf16, before
    torch.cuda.empty_cache()

    key = tag + " 256" if tag + " 256" in TRAIN_OPTIONS else tag
    cpu = train_model(preset, "float32", "cpu", weights, loss=loss,
                      **sections)
    card32 = train_model(preset, "float32", "cuda", weights, loss=loss,
                         **sections)
    b_cpu = train_batch(cpu.cfg, SEED + 4, "cpu", size=256)
    b_card = {k: v.cuda() for k, v in b_cpu.items()}
    pins = KinkPins()
    with fixed_eps():
        with pins.recording():
            m_cpu, want_g, want_gp = gp_grads(cpu, b_cpu)
        reset_launch_counts()
        card32.compute_grads(b_card)
        torch.cuda.synchronize()
        got = launch_counts()
        table = per_step(TRAIN_OPTIONS[key]["unfrozen"])
        check(got == table, f"{tag} fp32 at 256px: launches {got} (want "
              f"{table})")
        with pins.replaying():
            m_card, got_g, got_gp = gp_grads(card32, b_card)
    check(pins.all_replayed(), f"{tag} fp32 card vs CPU: "
          f"{pins.replayed} of {len(pins.saved)} pins and "
          f"{pins.stats_replayed} of {len(pins.stats)} B1 statistics "
          "replayed")
    loss_rel = {k: abs(m_card[k] - v) / abs(v) for k, v in m_cpu.items()}
    worst = {n: grad_bar(got_g[n], want_g[n], TRAIN_FP32_GRAD_REL)
             for n in want_g}
    worst["netD from D_GP"] = grad_bar(got_gp, want_gp, TRAIN_FP32_GRAD_REL)
    res.update(fp32_card_vs_cpu_loss_rel=loss_rel,
               fp32_card_vs_cpu_worst_grad_pinned=worst,
               launches_fp32_256=got, launches=launches)
    check(max(loss_rel.values()) <= TRAIN_FP32_LOSS_RTOL,
          f"{tag} fp32 card vs CPU at 256px: losses rel {loss_rel}")
    for name, (ratio, k) in worst.items():
        check(ratio <= 1.0, f"{tag} fp32 card vs CPU at 256px: {name} "
              f"gradients, worst {k} at {ratio:.3g} of the bar")
    print(f"{tag}: {ms:.2f} ms/step bf16 at {res['preset']}'s crop, D_GP "
          f"{losses[-1]['D_GP']:.4g}; fp32 card vs CPU worst "
          f"{ {n: round(r, 3) for n, (r, _) in worst.items()} } of the bar "
          f"({card})", flush=True)
    del cpu, card32
    torch.cuda.empty_cache()
    return res


def accum_check(card: str) -> dict:
    """grad-accum 2 against accum 1 on one batch of 2 (pix2pixhd_512 at
    ACCUM_SIZE, fp32): each run's launches held to its table, and the
    accumulated gradients held to the full batch's at the accumulated
    run's forward point (``KinkPins(merge=2)``: the full batch replays
    the two micro-batches' values). Instance norm's statistics are per
    sample, every loss a batch mean. Peak memory of each."""
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    preset = "pix2pixhd_512"
    acc, weights = seeded_model(preset, "float32", train=dict(grad_accum=2))
    full = train_model(preset, "float32", "cuda", weights)
    rng = np.random.default_rng(SEED + 6)
    batch = {k: torch.from_numpy(rng.uniform(-1, 1, (
        2, ACCUM_SIZE, ACCUM_SIZE, 3)).astype(np.float32)).cuda()
        for k in "ab"}
    res = {}
    for name, model, table in (
            ("accum2", acc, _mul(per_step(
                TRAIN_256[preset]["unfrozen"]), 2)),
            ("accum1", full, per_step(
                TRAIN_OPTIONS["accum pix2pixhd_512 b2"]))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        model.compute_grads(batch)
        torch.cuda.synchronize()
        res[f"peak_bytes_{name}"] = torch.cuda.max_memory_allocated()
        res[f"launches_{name}"] = got = launch_counts()
        check(got == table, f"grad-accum {name}: launches {got} (want "
              f"{table})")
    pins = KinkPins(merge=2)
    with pins.recording():
        m_acc = acc.compute_grads(batch)
    with pins.replaying():
        m_full = full.compute_grads(batch)
    check(pins.all_replayed(), "grad-accum: the full batch replayed "
          f"{pins.replayed} x 2 of {len(pins.saved)} pins")
    want = {n: {k: v.cpu() for k, v in g.items()}
            for n, g in grads_of(full).items()}
    worst = {n: grad_bar(g, want[n], TRAIN_FP32_GRAD_REL)
             for n, g in grads_of(acc).items()}
    loss_rel = {k: abs(float(m_acc[k]) - float(v)) / abs(float(v))
                for k, v in m_full.items()}
    res.update(worst_grad=worst, loss_rel=loss_rel,
               launches={k: v + res["launches_accum1"][k]
                         for k, v in res["launches_accum2"].items()})
    check(max(loss_rel.values()) <= TRAIN_FP32_LOSS_RTOL,
          f"grad-accum 2 vs 1: losses rel {loss_rel}")
    for n, (ratio, k) in worst.items():
        check(ratio <= 1.0, f"grad-accum 2 vs 1: {n} gradients, worst {k} "
              f"at {ratio:.3g} of the bar")
    print(f"grad-accum {preset} b2 at {ACCUM_SIZE}px fp32: peak "
          f"{res['peak_bytes_accum2'] / 2**30:.2f} GiB accum 2, "
          f"{res['peak_bytes_accum1'] / 2**30:.2f} GiB accum 1; worst "
          f"{ {n: round(r, 3) for n, (r, _) in worst.items()} } of the bar "
          f"({card})", flush=True)
    del acc, full
    torch.cuda.empty_cache()
    return res


def ema_check(card: str) -> dict:
    """EMA_STEPS bf16 steps of pix2pixhd_512 with ema_decay EMA_DECAY:
    the shadow against d·e + (1 − d)·p recomputed in float64 from the
    recorded parameters, to fp32 rounding; a stream frame served from the
    checkpoint's EMA (``cli/common.py``'s ``--infer.use_ema`` path) bit
    for bit against one served from a model whose netG was loaded with
    the shadow."""
    import shutil

    from ir2rgb_tpu_torch.checkpoint import CheckpointManager
    from ir2rgb_tpu_torch.cli.common import load_generator_params
    from ir2rgb_tpu_torch.infer import StreamingGenerator
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    from ir2rgb_tpu_torch.profile_train import train_batch
    from ir2rgb_tpu_torch.train import create_model
    preset = "pix2pixhd_512"
    model, _ = seeded_model(preset, "bf16", train=dict(ema_decay=EMA_DECAY))
    d = EMA_DECAY
    e64 = {k: p.detach().double() for k, p in model.netG.named_parameters()}
    start = max(float((model.ema["netG"][k].double() - v).abs().max())
                for k, v in e64.items())
    batch = train_batch(model.cfg, SEED + 3, "cuda")
    want = per_step(TRAIN[preset]["unfrozen"])
    launches = {}
    for i in range(EMA_STEPS):
        reset_launch_counts()
        model.train_step(batch)
        got = launch_counts()
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        check(got == want, f"EMA step {i}: launches {got} (want {want})")
        for k, p in model.netG.named_parameters():
            e64[k] = d * e64[k] + (1 - d) * p.detach().double()
    worst = 0.0
    for k, p in model.netG.named_parameters():
        e = model.ema["netG"][k].double()
        tol = 16 * 2.0 ** -24 * (e64[k].abs() + p.detach().double().abs())
        worst = max(worst, float(((e - e64[k]).abs() / (tol + 1e-30)).max()))
    check(start == 0.0 and worst <= 1.0,
          f"EMA: shadow at creation off by {start}; after {EMA_STEPS} "
          f"steps at {worst:.3g} of 16 fp32 ulps of the float64 recompute")

    run = Path("build") / "ema_run"
    shutil.rmtree(run, ignore_errors=True)
    cfg = model.cfg.replace(
        train=dataclasses.replace(model.cfg.train, name=run.name,
                                  checkpoints_dir=str(run.parent)),
        infer=dataclasses.replace(model.cfg.infer, use_ema=True))
    ckpt = CheckpointManager(str(run / "ckpt"))
    ckpt.save(model.step, model.state_dict())
    ckpt.wait()
    served = create_model(cfg.replace(loss=dataclasses.replace(
        cfg.loss, no_vgg_loss=True)), device="cuda")
    served.netG.load_state_dict(load_generator_params(cfg, served))
    loaded = make_model(preset, "bf16", "cuda",
                        {k: v.detach().clone() for k, v in
                         model.ema_state_dict().items()})
    rng = np.random.default_rng(SEED + 7)
    frames = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
              for _ in range(2)]
    outs = [list(StreamingGenerator(m, (512, 512)).stream(frames))
            for m in (served, loaded)]
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    check(same, "EMA: frames served from the checkpoint's EMA equal, bit "
          "for bit, those of a netG loaded with the shadow")
    shutil.rmtree(run, ignore_errors=True)
    print(f"EMA {preset} bf16 x{EMA_STEPS}: shadow at {worst:.3g} of the "
          f"fp32 bar, served frames equal {same} ({card})", flush=True)
    del model, served, loaded
    torch.cuda.empty_cache()
    return {"worst_of_bar": worst, "served_equal": same,
            "launches": launches}


def adam_bf16_check(card: str) -> dict:
    """adam_mu_dtype bf16 on pix2pixhd_512, bf16: one train step (finite,
    first moments stored bf16, second fp32), then one G step on fixed
    gradients against the plain formula in float64 on the card: the
    stored first moment within bf16 rounding of it, the parameters within
    1e-6 of |p| + lr."""
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    from ir2rgb_tpu_torch.profile_train import train_batch
    from ir2rgb_tpu_torch.train.optim import AdamBf16Mu
    preset = "pix2pixhd_512"
    model = train_model(preset, "bf16", "cuda", None,
                        train=dict(adam_mu_dtype="bf16"))
    opt = model.opt_g
    check(isinstance(opt, AdamBf16Mu), f"adam bf16: {type(opt).__name__}")
    reset_launch_counts()
    m = model.train_step(train_batch(model.cfg, SEED + 3, "cuda"))
    launches, want = launch_counts(), per_step(TRAIN[preset]["unfrozen"])
    check(launches == want, f"adam bf16 step: launches {launches} (want "
          f"{want})")
    states = list(opt.state.values())
    dtypes_ok = bool(states) and all(
        st["exp_avg"].dtype == torch.bfloat16
        and st["exp_avg_sq"].dtype == torch.float32 for st in states)
    check(dtypes_ok and all(math.isfinite(float(v)) for v in m.values()),
          "adam bf16: first moments bf16, second fp32, losses finite "
          f"{ {k: float(v) for k, v in m.items()} }")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    b1, b2 = opt.param_groups[0]["betas"]
    lr, eps = opt.param_groups[0]["lr"], opt.param_groups[0]["eps"]
    before = {}
    for p in model.netG.parameters():
        p.grad = torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
        st = opt.state[p]
        before[p] = (p.detach().double(), st["exp_avg"].double(),
                     st["exp_avg_sq"].double(), st["step"])
    opt.step()
    mu_worst = p_worst = 0.0
    for p, (p0, mu0, nu0, t) in before.items():
        g = p.grad.double()
        mu = (1 - b1) * g + b1 * mu0
        nu = b2 * nu0 + (1 - b2) * g * g
        t += 1
        upd = (mu / (1 - b1 ** t)) / ((nu / (1 - b2 ** t)).sqrt() + eps)
        p64 = p0 - lr * upd
        st = opt.state[p]
        mu_worst = max(mu_worst, float(((st["exp_avg"].double() - mu).abs()
                                        / (2.0 ** -8 * mu.abs() + 1e-30))
                                       .max()))
        p_worst = max(p_worst, float(((p.detach().double() - p64).abs()
                                      / (1e-6 * (p64.abs() + lr))).max()))
    check(mu_worst <= 1.0 and p_worst <= 1.0,
          f"adam bf16 vs the float64 formula: mu at {mu_worst:.3g} of bf16 "
          f"rounding, parameters at {p_worst:.3g} of the bar")
    print(f"adam bf16 {preset}: mu at {mu_worst:.3g} of bf16 rounding, "
          f"parameters at {p_worst:.3g} of 1e-6 ({card})", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"mu_of_bf16_rounding": mu_worst, "params_of_bar": p_worst,
            "launches": launches}


def remat_check(preset: str, card: str) -> dict:
    """remat against the plain step on ``preset``, bf16, dropout on, the
    same weights and generator seed: the first step's losses bit for bit
    (the same forward, the same masks), every gradient under the bar,
    the launches of TIMED_STEPS steps held to ``REMAT`` (the blocks'
    norms run again in the backward) and ``TRAIN``, and the peak memory
    and ms/step of each; remat's peak must be the lower."""
    from ir2rgb_tpu_torch.profile_train import train_batch
    res = {"preset": preset}
    model = dict(use_dropout=True)
    plain, weights = seeded_model(preset, "bf16", model=model)
    del plain
    torch.cuda.empty_cache()
    runs = {}
    for name, table in (("plain", TRAIN[preset]["unfrozen"]),
                        ("remat", REMAT[preset])):
        m = train_model(preset, "bf16", "cuda", weights,
                        model=dict(model, remat=name == "remat"))
        batch = train_batch(m.cfg, SEED + 3, "cuda")
        losses = {k: v.clone() for k, v in m.compute_grads(batch).items()}
        grads = {n: {k: v.float().cpu() for k, v in g.items()}
                 for n, g in grads_of(m).items()}
        ms, peak, counts = timed_steps(m, batch, TIMED_STEPS)
        want = _mul(per_step(table), TIMED_STEPS)
        check(counts == want, f"{preset} {name}: launches {counts} over "
              f"{TIMED_STEPS} steps (want {want})")
        runs[name] = (losses, grads, ms, peak, counts)
        del m, batch
        torch.cuda.empty_cache()
    (l0, g0, ms0, peak0, _), (l1, g1, ms1, peak1, c1) = (runs["plain"],
                                                         runs["remat"])
    same = all(torch.equal(l0[k], l1[k]) for k in l0)
    worst = {n: grad_bar(g1[n], g0[n], TRAIN_FP32_GRAD_REL) for n in g0}
    res.update(losses_equal=same, worst_grad=worst, ms_plain=ms0,
               ms_remat=ms1, peak_bytes_plain=peak0, peak_bytes_remat=peak1,
               launches=c1)
    check(same, f"{preset} remat: losses equal the plain step's bit for "
          "bit")
    for n, (ratio, k) in worst.items():
        check(ratio <= 1.0, f"{preset} remat: {n} gradients, worst {k} at "
              f"{ratio:.3g} of the bar")
    check(peak1 < peak0, f"{preset} remat: peak {peak1 / 2**30:.2f} GiB "
          f"below the plain step's {peak0 / 2**30:.2f} GiB")
    print(f"remat {preset} bf16 dropout: peak {peak0 / 2**30:.2f} -> "
          f"{peak1 / 2**30:.2f} GiB, {ms0:.2f} -> {ms1:.2f} ms/step "
          f"({ms1 / ms0:.3f}x) ({card})", flush=True)
    return res


def second_derivative_ms(bw: float) -> list:
    """Device time of B1's second derivative (``InstanceNormActBackward``'s
    backward: PyTorch arithmetic, no kernel of the port) at each norm of
    the WGAN-GP D pass of pix2pixhd_512, bf16, beside the B1 backward
    kernel at the same shape (CUDA events, eager)."""
    from types import SimpleNamespace

    from ir2rgb_tpu_torch.kernels import instance_norm as b1
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rows = []
    for (shape, act) in sorted(_d_pass(512, 2)):
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(
            torch.bfloat16)
        g, gg = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        _, mean, rstd = b1.instance_norm_act(x, act)
        ctx = SimpleNamespace(saved_tensors=(x, g, mean, rstd), act=act,
                              negative_slope=0.2, eps=b1.INSTANCE_NORM_EPS)
        rows.append(dict(
            shape=list(shape), act=act,
            second_derivative_ms=cuda_ms(
                lambda: b1.InstanceNormActBackward.backward(ctx, gg)),
            b1_bwd_ms=cuda_ms(lambda: b1.instance_norm_act_backward(
                x, mean, rstd, g, act))))
    return rows


def train_options_phase(card: str) -> dict:
    """The train step's options at full width (ROADMAP A8): WGAN-GP on
    pix2pixhd_512 and the pixel D with WGAN-GP on pix2pix_unet256
    (``gp_check``), grad-accum (``accum_check``), EMA (``ema_check``),
    bf16 Adam moments (``adam_bf16_check``), remat on pix2pixhd_1024 and
    pix2pixhd_2048 (``remat_check``), and the time of B1's second
    derivative (``second_derivative_ms``)."""
    bw = peaks(torch.cuda.get_device_name(0))[1][0]
    res = {"gp": [gp_check("gp pix2pixhd_512", "pix2pixhd_512", card),
                  gp_check("gp pixel pix2pix_unet256", "pix2pix_unet256",
                           card, model=dict(net_d="pixel"))],
           "accum": accum_check(card), "ema": ema_check(card),
           "adam_bf16": adam_bf16_check(card),
           "remat": [remat_check(p, card) for p in REMAT_PRESETS],
           "second_derivative": second_derivative_ms(bw)}
    launches = {}
    for part in (*res["gp"], res["accum"], res["ema"], res["adam_bf16"],
                 *res["remat"]):
        launches = {k: launches.get(k, 0) + v
                    for k, v in part["launches"].items()}
    res["launches"] = launches
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


# the serve phase's streams: (opened, closed, sending) at each logical tick
# of SERVE_SLOTS slots. Stream 12 reopens stream 5's slot (fresh carry);
# streams 3 and 7 skip tick 1 (carries held); the last tick is one chunk.
SERVE_PLAN = [
    (range(10), (), range(10)),
    (range(10, 12), (), [i for i in range(12) if i not in (3, 7)]),
    ((), (), range(12)),
    ((), (5,), [i for i in range(12) if i != 5]),
    ((12,), (), [i for i in range(13) if i != 5]),
    ((), (), range(4)),
]


def _banner(proc, timeout: float) -> str:
    """The first line ``proc`` prints, or raise after ``timeout`` s."""
    import selectors
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        if not sel.select(timeout):
            raise RuntimeError(f"cli.serve printed no banner in {timeout} s")
        return proc.stdout.readline()
    finally:
        sel.close()


def generator_skeleton(preset: str):
    """``preset``'s generator on the meta device (its keys and shapes)."""
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.nn import define_g
    from ir2rgb_tpu_torch.train.model import network_configs
    with torch.device("meta"):
        return define_g(network_configs(PRESETS[preset])[0])


def multistream_run(preset: str, dtype: str, sd, seed: int):
    """SERVE_PLAN through a ``MultiStreamServer`` of SERVE_SLOTS slots over
    SERVE_PHYSICAL rows at full width: each tick's launches counted,
    each stream's frame held to a batch-1 forward on the same frame and
    the same carry (the slot's pool row before the tick, zero on a
    reset), and to a free-running batch-1 ``StreamingGenerator``."""
    from ir2rgb_tpu_torch.infer import StreamingGenerator
    from ir2rgb_tpu_torch.infer.multistream import MultiStreamServer
    from ir2rgb_tpu_torch.infer.stream import _dev_normalize, _dev_quantize
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    model = make_model(preset, dtype, "cuda", sd)
    hw = (model.cfg.data.crop_size,) * 2
    in_nc, out_nc = model.cfg.model.input_nc, model.cfg.model.output_nc
    srv = MultiStreamServer(model, hw, n_slots=SERVE_SLOTS,
                            physical_slots=SERVE_PHYSICAL)
    tick, chunks = srv._tick, [0]

    def counted(*args):
        chunks[0] += 1
        return tick(*args)

    srv._tick = counted
    rng = np.random.default_rng(seed)
    slot, free, free_psnr = {}, {}, {}
    counts = Counter()
    fp32_err, bf16_psnr, u8_diff, held_ok = [], [], 0, True
    for opened, closed, sending in SERVE_PLAN:
        for k in closed:
            srv.close(slot.pop(k))
        for k in opened:
            slot[k] = srv.open()
            free[k], free_psnr[k] = StreamingGenerator(model, hw), []
        frames = {k: rng.integers(0, 256, hw + (in_nc,), dtype=np.uint8)
                  for k in sending}
        before = srv._carry.clone()
        pending = srv._pending_reset.copy()
        torch.cuda.synchronize()
        reset_launch_counts()
        outs = srv.step({slot[k]: f for k, f in frames.items()})
        torch.cuda.synchronize()
        counts.update(launch_counts())
        after = srv._carry
        for k, sid in slot.items():
            if k not in frames:  # skipped: the carry is held exactly
                held_ok &= torch.equal(after[sid], before[sid])
                continue
            a = _dev_normalize(torch.from_numpy(frames[k][None]).cuda())
            prev = (torch.zeros_like(before[sid:sid + 1]) if pending[sid]
                    else before[sid:sid + 1])
            want = model.generate(a, prev=prev).float()
            got = after[sid:sid + 1, ..., :out_nc]
            fp32_err.append(float((got - want).abs().max()))
            bf16_psnr.append(psnr(got, want))
            u8 = _dev_quantize(want)[0].cpu().numpy()
            u8_diff = max(u8_diff, int(np.abs(
                u8.astype(np.int16) - outs[sid].astype(np.int16)).max()))
            free_psnr[k].append(round(psnr(
                torch.from_numpy(free[k].push(frames[k])).double(),
                torch.from_numpy(outs[sid]).double(), peak=255.0), 2))
    del srv, model, free
    torch.cuda.empty_cache()
    return dict(dtype=dtype, chunk_ticks=chunks[0],
                launches={k: v for k, v in counts.items() if v},
                same_carry_fp32_max_abs=max(fp32_err),
                same_carry_min_psnr_db=min(bf16_psnr),
                same_carry_u8_max_diff=u8_diff, skipped_carries_held=held_ok,
                free_running_u8_psnr_db=free_psnr)


def tick_ladder(preset: str, sd, seed: int, slots=LADDER_SLOTS):
    """ms/tick of ``MultiStreamServer.step_device`` at each physical batch
    of ``slots``, bf16, device frames in and out: CUDA events around 5
    ticks, the median of 5 such readings after 3 warm ticks; with the
    peak memory allocated over the ticks and the output's shape and
    type checked."""
    from ir2rgb_tpu_torch.infer.multistream import MultiStreamServer
    model = make_model(preset, "bf16", "cuda", sd)
    hw = (model.cfg.data.crop_size,) * 2
    rng = np.random.default_rng(seed)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    rows = []
    for s in slots:
        check((preset, s) in SERVE_TICK, f"serve ladder {preset} x{s}: its "
              "kernel shapes are checked (SERVE_TICK)")
        srv = MultiStreamServer(model, hw, n_slots=s, physical_slots=s)
        frames = torch.from_numpy(rng.integers(
            0, 256, (s,) + hw + (model.cfg.model.input_nc,),
            dtype=np.uint8)).cuda()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            out = srv.step_device(frames)
        check(out.shape == (s,) + hw + (model.cfg.model.output_nc,)
              and out.dtype == torch.uint8,
              f"serve ladder {preset} x{s}: output {tuple(out.shape)} "
              f"{out.dtype}")
        readings = []
        for _ in range(5):
            torch.cuda.synchronize()
            start.record()
            for _ in range(5):
                srv.step_device(frames)
            end.record()
            end.synchronize()
            readings.append(start.elapsed_time(end) / 5)
        ms = sorted(readings)[2]
        rows.append(dict(slots=s, ms_per_tick=ms, frames_per_s=s * 1e3 / ms,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         ms_readings=readings))
        del srv, frames, out
    del model
    torch.cuda.empty_cache()
    return rows


def serve_phase(card: str):
    """Multi-stream serving on the card (``infer/multistream.py``,
    ``infer/server.py``, the serving CLIs):

    - ``multistream_run`` of temporal_512 at full width in fp32 (TF32 off)
      and bf16: every chunk tick's launches equal one served frame's
      (``per_frame``); each stream's frame against a batch-1 forward on
      the same frame and carry: fp32 within SLICE_FP32_TOL, bf16 at
      BF16_SERVE_PSNR dB or more; skipped streams' carries held exactly.
      Free-running batch-1 streams are reported beside (a random-weight
      temporal loop amplifies any difference about 5x a frame);
    - the ms/tick ladder (``tick_ladder``) of LADDER_PRESETS, with the
      aggregate frames/s, the peak memory and the physical batch with
      the most frames/s; then one pix2pixhd_2048 tick at SERVE_DEFAULT;
    - ``cli.infer --torch_g`` on a 512x512 two-sequence folder, its
      launches held to ``per_frame``, then ``cli.evaluate`` on its
      gallery: the mean PSNRs within 0.1 dB;
    - ``cli.serve`` as a subprocess in fp32 on port 0 with
      SERVE_CLI_SLOTS slots and two clients, one sending raw frames and
      one JPEG: every reply against a batch-1 fp32 stream of the frames
      the server decoded at FP32_SERVE_PSNR dB or more, and each later
      reply against a stream without its carry below that bar; then the
      subprocess is stopped.

    Every (preset, physical batch) it launches is in SERVE_TICK, so B1,
    B2 and B3 were held to their plain versions at its shapes."""
    import io
    import shutil
    from ir2rgb_tpu_torch.cli import evaluate as cli_evaluate
    from ir2rgb_tpu_torch.cli import infer as cli_infer
    from ir2rgb_tpu_torch.data import native, write_synthetic_dataset
    from ir2rgb_tpu_torch.infer import StreamingGenerator
    from ir2rgb_tpu_torch.infer.multistream import (KNEE_SLOTS,
                                                    default_physical_slots)
    from ir2rgb_tpu_torch.infer.server import FrameClient
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    check(KNEE_SLOTS == SERVE_DEFAULT, f"serve: the default cap on the "
          f"physical batch, KNEE_SLOTS {KNEE_SLOTS}, is the checked "
          f"SERVE_DEFAULT {SERVE_DEFAULT}")
    preset = "temporal_512"
    cli_physical = default_physical_slots(SERVE_CLI_SLOTS)
    check({(preset, SERVE_PHYSICAL), (preset, cli_physical)}
          <= set(SERVE_TICK), f"serve {preset}: the server's batch "
          f"{SERVE_PHYSICAL} and cli.serve's {cli_physical} are checked "
          "(SERVE_TICK)")
    want = per_frame(preset)
    sd = seeded_state_dict(generator_skeleton(preset), SEED)
    res = {"runs": [], "ladder": {}, "launches": {}}
    for dtype in ("float32", "bf16"):
        run = multistream_run(preset, dtype, sd, SEED + 7)
        res["runs"].append(run)
        res["launches"][f"multistream {preset} {dtype}"] = run["launches"]
        n = run["chunk_ticks"]
        check(run["launches"] == {k: v * n for k, v in want.items() if v}
              and n == 11, f"serve {preset} {dtype}: launches "
              f"{run['launches']} over {n} chunk ticks (want 11 x "
              f"{want}: batching adds no launch)")
        check(run["skipped_carries_held"],
              f"serve {preset} {dtype}: skipped streams' carries held")
        if dtype == "float32":
            check(run["same_carry_fp32_max_abs"] <= SLICE_FP32_TOL,
                  f"serve {preset} fp32: batched vs batch-1 max-abs "
                  f"{run['same_carry_fp32_max_abs']:.3g} (tol "
                  f"{SLICE_FP32_TOL})")
        else:
            check(run["same_carry_min_psnr_db"] >= BF16_SERVE_PSNR,
                  f"serve {preset} bf16: batched vs batch-1 PSNR "
                  f"{run['same_carry_min_psnr_db']:.2f} dB (bar "
                  f"{BF16_SERVE_PSNR})")
        print(f"serve {preset} {dtype}: uint8 max diff "
              f"{run['same_carry_u8_max_diff']} at the same carry; "
              "free-running batch-1 streams, PSNR (uint8) frame by frame: "
              + json.dumps(run["free_running_u8_psnr_db"]), flush=True)

    for p in LADDER_PRESETS:
        psd = sd if p == preset else seeded_state_dict(
            generator_skeleton(p), SEED)
        rows = tick_ladder(p, psd, SEED + 8)
        knee = max(rows, key=lambda r: r["frames_per_s"])
        res["ladder"][p] = dict(rows=rows, knee_slots=knee["slots"])
        print(f"serve ladder {p} bf16 ({card}): " + ", ".join(
            f"S={r['slots']} {r['ms_per_tick']:.3f} ms/tick "
            f"{r['frames_per_s']:.1f} frames/s {r['peak_gib']:.2f} GiB"
            for r in rows) + f"; most frames/s at S={knee['slots']}",
            flush=True)
    big = "pix2pixhd_2048"
    (row,) = tick_ladder(big, seeded_state_dict(generator_skeleton(big),
                                                SEED), SEED + 10,
                         slots=(SERVE_DEFAULT,))
    res["ladder"][big] = dict(rows=[row])
    print(f"serve tick {big} bf16 ({card}): S={row['slots']} "
          f"{row['ms_per_tick']:.3f} ms/tick {row['frames_per_s']:.1f} "
          f"frames/s, peak {row['peak_gib']:.2f} GiB", flush=True)

    root = Path("build") / "serve_cli"
    shutil.rmtree(root, ignore_errors=True)
    write_synthetic_dataset(str(root / "data"), size=512, n_videos=2,
                            frames_per_video=3)
    pth = root / "G.pth"
    torch.save(sd, pth)
    argv = ["--preset", preset, "--data.dataroot", str(root / "data"),
            "--data.load_size", "512", "--data.crop_size", "512",
            "--train.name", "serve_cli", "--train.checkpoints_dir",
            str(root / "ckpt"), "--infer.results_dir", str(root / "res"),
            "--torch_g", str(pth)]
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = cli_infer.main(argv)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    res["launches"][f"cli.infer {preset}"] = counts
    line = out.getvalue().strip().splitlines()[-1]
    frames = int(line.split()[1])
    infer_psnr = float(line.split("PSNR:")[1].split()[0])
    check(rc == 0 and frames == 6 and counts == {
        k: v * frames for k, v in want.items() if v},
        f"serve cli.infer {preset}: rc {rc}, {frames} frames, launches "
        f"{counts} (want 6 x {want})")
    gallery = root / "res" / "serve_cli" / "test_latest" / "images"
    for sub, suffix in (("gen", "_generated.png"), ("tgt", "_target.png")):
        (root / sub).mkdir()
        for f in sorted(gallery.glob("*" + suffix)):
            shutil.copy(f, root / sub / f.name)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_evaluate.main(["--generated", str(root / "gen"), "--target",
                                str(root / "tgt"), "--json_out",
                                str(root / "eval.json")])
    ev = json.loads((root / "eval.json").read_text())
    res["cli"] = dict(infer_line=line, evaluate=ev)
    check(rc == 0 and ev["frames"] == 6
          and abs(ev["psnr_mean"] - infer_psnr) <= 0.1,
          f"serve cli.evaluate: rc {rc}, {ev['frames']} frames, mean PSNR "
          f"{ev['psnr_mean']:.3f} dB vs cli.infer's {infer_psnr:.2f} (tol "
          "0.1)")

    repo = Path(__file__).resolve().parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "ir2rgb_tpu_torch.cli.serve", "--preset",
         preset, "--model.compute_dtype", "float32", "--data.crop_size",
         "512", "--infer.serve_port", "0", "--infer.serve_slots",
         str(SERVE_CLI_SLOTS), "--torch_g", str(pth)],
        stdout=subprocess.PIPE, text=True, cwd=repo,
        env=dict(os.environ, PYTHONPATH=str(repo)))
    try:
        banner = _banner(proc, 300)
        res["cli"]["serve_banner"] = banner.strip()
        port = int(banner.split(" at ")[1].split()[0].rsplit(":", 1)[1])
        rng = np.random.default_rng(SEED + 9)
        sent = {k: [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
                    for _ in range(3)] for k in ("raw", "jpeg")}
        replies = {"raw": [], "jpeg": []}
        with FrameClient("127.0.0.1", port, timeout=120) as raw, \
                FrameClient("127.0.0.1", port, jpeg=True, quality=95,
                            timeout=120) as jpg:
            for t in range(3):
                raw.send(sent["raw"][t])
                jpg.send(sent["jpeg"][t])
                replies["raw"].append(raw.recv())
                replies["jpeg"].append(jpg.recv())
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    # the references: batch-1 fp32 streams (TF32 off, as the server) of
    # the frames the server saw, and the same frames without a carry
    model = make_model(preset, "float32", "cuda", sd)
    served = {"raw": sent["raw"], "jpeg": []}
    for f in sent["jpeg"]:
        j = np.frombuffer(native.encode_jpeg(f, 95), np.uint8)
        served["jpeg"].append(native.decode_jpeg_mem_batch(
            j, np.array([0]), np.array([len(j)]), 512, 512)[0])
    def u8_psnr(a, b):
        return psnr(torch.tensor(a, dtype=torch.float64),
                    torch.tensor(b, dtype=torch.float64), peak=255.0)

    serve_psnr, no_carry_psnr = {}, {}
    for k in ("raw", "jpeg"):
        ref = StreamingGenerator(model, (512, 512))
        serve_psnr[k] = [u8_psnr(ref.push(f), r)
                         for f, r in zip(served[k], replies[k])]
        no_carry_psnr[k] = [
            u8_psnr(StreamingGenerator(model, (512, 512)).push(f), r)
            for f, r in zip(served[k][1:], replies[k][1:])]
    res["cli"]["serve_reply_psnr_db"] = serve_psnr
    res["cli"]["serve_reply_no_carry_psnr_db"] = no_carry_psnr
    check(all(r.shape == (512, 512, 3) and r.dtype == np.uint8
              for k in replies for r in replies[k])
          and min(min(v) for v in serve_psnr.values()) >= FP32_SERVE_PSNR,
          f"serve cli.serve (subprocess, fp32, {SERVE_CLI_SLOTS} slots): 2 "
          f"clients x 3 replies vs batch-1 streams, PSNR {serve_psnr} dB "
          f"(bar {FP32_SERVE_PSNR})")
    check(max(max(v) for v in no_carry_psnr.values()) < FP32_SERVE_PSNR,
          f"serve cli.serve: replies 2-3 vs the same frames without a "
          f"carry, PSNR {no_carry_psnr} dB (below {FP32_SERVE_PSNR}: the "
          "bar catches a dropped carry)")
    print(f"serve cli ({card}): {line}; evaluate psnr_mean "
          f"{ev['psnr_mean']:.3f} dB; cli.serve replies PSNR vs batch-1 "
          + json.dumps({k: [round(x, 2) for x in v]
                        for k, v in serve_psnr.items()})
          + "; without the carry "
          + json.dumps({k: [round(x, 2) for x in v]
                        for k, v in no_carry_psnr.items()}), flush=True)
    del model
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
    options = phase("train_options", train_options_phase, card)
    cli = phase("train_cli", train_cli_phase, card)
    serve = phase("serve", serve_phase, card)

    # launches summed over every path's counted runs: 8 served frames a
    # preset, and each preset's bf16 steps and timed bf16 and fp32 steps
    by_path = {**{"serve " + s["preset"]: s["launches"] for s in slices},
               **{"train " + t["preset"]: t["launches"] for t in trains},
               "train_options": options["launches"],
               **{"train_cli " + p: c for p, c in cli["launches"].items()},
               **{"serve " + p: c for p, c in serve["launches"].items()}}
    total = {k: sum(c.get(k, 0) for c in by_path.values())
             for k in PER_STEP}
    for k, n in total.items():
        check(n > 0, f"{k}: {n} launches over the paths")

    def path_launches(k):
        return {p: c[k] for p, c in by_path.items() if c.get(k)}

    b2 = next(r for r in b2_rows
              if tuple(r["shape"]) == B2_MAIN and r["dtype"] == "bfloat16")
    b2_fp32 = next(r for r in b2_rows
                   if tuple(r["shape"]) == B2_MAIN and r["dtype"] == "float32")
    main_step = "pix2pixhd_512"
    # each kernel's time over one batched serving tick (SERVE_TICK), bf16
    tick_b1 = {f"{p} x{n}": per_path_totals(b1_rows, t["b1"])
               for (p, n), t in SERVE_TICK.items()}
    tick_d2s = {f"{p} x{n}": per_path_totals(
        [r for r in d2s_rows if r["name"] == "d2s"],
        {k: t["d2s"].count(k) for k in t["d2s"]})
        for (p, n), t in SERVE_TICK.items()}
    tick_b2 = {f"{p} x{n}": {k: sum(r[k] for r in b2_rows
                                    if r["dtype"] == "bfloat16"
                                    and tuple(r["shape"]) in t["tail"])
                             for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "eager_ms")}
               for (p, n), t in SERVE_TICK.items()}
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
            per_serving_tick_by_preset=tick_b1,
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
             per_serving_tick_by_preset=tick_b2,
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
            per_serving_tick_by_preset=tick_d2s,
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
    print("train_options " + json.dumps(options))
    print("train_cli " + json.dumps(cli))
    print("serve " + json.dumps(serve))
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
    for p in tick_b1:
        print(f"  {p} per serving tick, bf16: " + ", ".join(
            f"{k} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, plain "
            f"{t['plain_ms']:.4f}, lib {t['library_ms']:.4f})"
            for k, t in (("B1", tick_b1[p]), ("B2", tick_b2[p]),
                         ("d2s", tick_d2s[p]))))
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
                   "slices": slices, "trains": trains,
                   "train_options": options, "train_cli": cli,
                   "serve": serve,
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
