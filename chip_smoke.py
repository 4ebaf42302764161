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
   JPEG client, every reply held to a batch-1 stream;
11. ``quant`` (``quant_phase``): every served preset (``SERVE``) at full
   width and batch 1 in each quantized serving mode (``nn/quant.py``:
   int8, int8_mixed, int8_w) beside "none", bf16: uint8 frames through
   ``StreamingGenerator.stream`` with the launches held to ``SERVE`` (B2
   none under int8, ``quant_per_frame``), ms/frame, peak memory and the
   PSNR against "none"; fp32 (TF32 off) card frames held to the port's
   fp32 CPU frames of the same mode at 256x256 (max-abs <=
   SLICE_FP32_TOL; int8 and int8_mixed also >= QUANT_MIN_PSNR dB, at the
   CPU's quantized inputs, ``QuantPins``, with each int8 conv's own card
   input flipping at most QUANT_MAX_FLIP_SHARE of its int8 activations
   against the CPU's, and the unpinned frames >= QUANT_UNPINNED_MIN_PSNR
   dB; a card path with one wrong layer, ``broken_norm``, must fail the
   flips bar); one
   ``MultiStreamServer`` tick of temporal_512 at QUANT_TICK_SLOTS streams
   in int8_mixed; and the int32 product of ``torch._int_mm`` equal bit
   for bit to the plain product at every distinct quantized conv shape
   those runs gave it;
12. ``netE`` (``nete_phase``): pix2pixhd_512 with the feature encoder and
   the edge channel, 512x512, instance maps a seeded Voronoi of
   NETE_CELLS cells: bf16 train steps with each step's launches held to
   ``NETE`` (netE's B1 both ways and its ups' d2s / s2d on top of the
   preset's), netE's weights moved, timed steps with peak memory; one
   fp32 step on the card held to the CPU's at 256x256 (pinned, the
   ``train`` phase's bars, netE's tail bias through float64 sums,
   ``TailGrad``; ``inst_collisions`` equal; the pooling on its own); then
   ``collect_dataset_features`` over 4 frames, ``kmeans``,
   ``sample_feature_map`` and a served frame with those features, and a
   ``use_encoded_image`` frame held fp32 card to CPU at 256x256. B1 and
   B3 are checked above at every netE shape (``NETE`` is in the steps'
   tables);
13. ``export`` (``export_phase``): sealed artifacts (``infer/export.py``)
   exported on the card, written, loaded and served at full width and
   512x512, one seeded weight set a preset: pix2pixhd_512 and
   temporal_512 in bf16 and fp32 and pix2pixhd_512 in int8_mixed bf16.
   The program's ``ir2rgb::`` op nodes and a CUDA-graph-captured
   frame's kernel nodes (by name, ``graph_kernels``) equal a live
   frame's launches (``SERVE``), and so do the counted launches of
   EXPORT_FRAMES frames; each frame, at the live stream's carry and
   through a reset, is held to the live ``StreamingGenerator`` (fp32
   within 1 LSB and the carry SLICE_FP32_TOL; bf16 and int8_mixed >=
   EXPORT_MIN_PSNR dB); ms/frame beside the live path, cold start (load
   and first frame, in process), bytes and the frames' peak memory are
   reported. A temporal_512 multi-stream artifact at EXPORT_SLOTS slots
   is held to the live ``MultiStreamServer`` tick by tick, and an fp32
   artifact exported on the CPU is served on the card (the program
   moved by ``move_to_device_pass``);
14. ``parallel`` (``parallel_phase``): data-parallel training
   (``ir2rgb_tpu_torch/parallel/``), pix2pixhd_512 at full width and its
   crop size. (a) ``torchrun --standalone --nproc_per_node 1 -m
   ir2rgb_tpu_torch.cli.train`` (NCCL, world 1) for PARALLEL_STEPS bf16
   steps on train_cli's PNG folder, its checkpoint equal bit for bit to
   the same run without torchrun, ms/step of both; (b) two ranks on the
   one card over gloo (ranks 0 and 1 of the ranks' world, below), a
   global batch of 2: one fp32 step (TF32 off) held to the one-process
   batch-2 step (metrics, every gradient, the weights after it), then
   PARALLEL_STEPS bf16 steps with each rank's launches held to ``TRAIN``
   at batch 1 and the replicas bit-equal after each, with ms/step, the
   gradient all-reduce's bytes and ms (gloo stages CUDA tensors through
   the host);
15. ``spatial`` (``spatial_phase``): spatially partitioned serving
   (``parallel/spatial.py``) on gloo ranks sharing the one card (the
   ranks' world, below). B1 split (``ir2rgb::instance_norm_stats`` and
   ``ir2rgb::instance_norm_apply``) at every shard shape of the frames
   (``B1_SPLIT_SHAPES``) and of the spatial_train phase's steps
   (``B1_SPLIT_TRAIN_SHAPES``: the discriminators', a temporal_1024 sp-4
   rank's) against its plain versions, bf16 and fp32, one device kernel
   a call, the statistics of two calls bit-identical and, for an fp32
   input of mean 1e3 x std, within SPLIT_LARGE_MEAN_REL of float64; the
   frames' shapes timed beside the plain versions, the library's and
   the bound, the statistics also beside the fused forward at each shape
   and on a cold L2 from SPLIT_COLD_BYTES, and summed over all of a
   ``SPLIT_FRAME`` rank's launches; a bf16 tensor off the statistics'
   16-byte loads refused; B2 at the tails' extended shapes and d2s at
   the shard shapes are in the kernel phases above. Frames
   (``SPATIAL_CASES``): pix2pixhd_2048 at full width on sp 2 and 4, fp32
   and bf16, 2 frames; pix2pixhd_512 on sp 2, bf16; temporal_512 on sp
   4, 3 frames, each rank's carry rows held to the one-process carry's.
   Each gathered frame against the one-process frame of the same weights
   (fp32 max-abs <= SLICE_FP32_TOL, bf16 >= SPATIAL_BF16_PSNR dB; bf16
   temporal frames at the one-process carry), the merged B1 statistics
   bit-identical on every rank, every rank's launches a frame equal to
   ``SPATIAL``. MultiStreamServer of temporal_512, SPATIAL_SLOTS
   streams, SPATIAL_TICKS, on dp_sp_mesh(2, 1) and (1, 2)'s layouts
   against the one-process server (fp32 within 1 LSB, its carry blocks
   SLICE_FP32_TOL; bf16 SPATIAL_BF16_PSNR). The negative control (one
   halo row a layer from the wrong shard) must fail the fp32 bar. Per
   rank: ms/frame, the exchange's bytes and ms, peak memory, labelled as
   gloo ranks sharing one card.
16. ``spatial_train`` (``spatial_train_phase``): spatially partitioned
   training (``parallel/spatial.py`` under autograd) on gloo ranks
   sharing the one card. B1's split backward
   (``ir2rgb::instance_norm_bwd_stats`` and
   ``ir2rgb::instance_norm_bwd_apply``) at every shard shape of the
   phase's steps (``sweep_b1.BWD_SHAPES``) against its plain versions
   (the sums also against their chunked reference in the plan's order),
   bf16 and fp32, one device kernel a call, the sums of two calls
   bit-identical, each row's sums route printed and every route taken;
   bf16 timed beside the plain versions, the library's (the formula in
   eager torch) and the bound, on a cold L2 as well where x and g reach
   SPLIT_COLD_BYTES, and summed over one ``SPLIT_TRAIN_STEP`` rank's
   launches (``sweep_b1.BWD_STEP``). Steps (``SPATIAL_TRAIN_CASES``):
   temporal_512 at full width on sp 2, fp32 and bf16, a window of 4
   frames, then fp32 with remat; pix2pixhd_512 on sp 2, fp32 and bf16, a
   step each; beside them, on the other pair of ranks, pix2pixhd_512 with
   WGAN-GP and cyclegan_256 on sp 2, fp32 and bf16, a step each;
   pix2pixhd_512 on dp 2 x sp 2, fp32, against one process's batch-2
   step; pix2pixhd_2048 bf16 on sp 4, 2 timed steps; temporal_1024 bf16
   with remat on sp 4, one timed window, its peak a rank beside one
   process's. Every rank's launches a step equal to ``SPATIAL_TRAIN``
   (no fused B1; statistics, apply, sums and dx apply for every norm,
   with remat the blocks' statistics and apply again in the backward,
   with WGAN-GP the penalty's D pass and both its split backwards), the
   merged statistics and summed sums bit-identical on every rank of a
   data row, every rank's count of exchanges equal (a second
   derivative's included), finite losses; each pix2pixhd_512,
   cyclegan_256 and temporal_512 step held to one process's step
   (window) from the same train state at SPATIAL_TRAIN_BARS, the fp32
   one with one process pinned to the partitioned forward point
   (``ShardPins``: rounding flips ReLU and L1 kinks); a WGAN-GP step's
   D_GP > 0 and, fp32, D's gradient from D_GP alone against one
   process's at that point; a CycleGAN's two pools against one
   process's; each remat step to the same step without remat (losses
   bit for bit, gradients within REMAT_GRAD_ATOL). The negative control
   (one halo row a layer from the wrong shard) must fail the fp32 bars.
   Beside the ranks' world, one ``torchrun`` of ``cli.train
   --train.spatial_devices 2 --dist_backend gloo`` for two steps of
   SPATIAL_TRAIN_CLI from a folder, rank 0's checkpoint read back. Per
   rank and step: ms, the exchange's bytes, calls and ms, the gradient
   all-reduce's bytes, peak memory, labelled as gloo ranks sharing one
   card.

The gloo ranks of phases 14-16 are one world of RANKS_WORLD processes
(``chip_smoke.py --ranks R PORT DIR``, ``ranks_main``), started once
after the parent's parts of phases 15 and 16 (``start_ranks``) and run
beside phase 14's part (a), then waited for (``ranks_phase``): a section
a phase, the cases of two ranks on ranks 0 and 1 (``pair_mesh``; phase
16's WGAN-GP and CycleGAN cases on ranks 2 and 3 beside them), those of
four on all of them.

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
import signal
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

# The netE phase: pix2pixhd_512 with the feature encoder (nef 16, 4 downs,
# the preset's defaults) and the edge channel. netE runs once a step on
# the real target, forward and backward (its gradient comes through G's
# losses); its B1 and ups are the headless trunk's pattern at nef wide.
# The input channels G and D gain move no kernel shape.
NETE_PRESET, NETE_NEF, NETE_DOWNS = "pix2pixhd_512", 16, 4


def nete_forward(size: int) -> tuple:
    """netE's forward at ``size``: B1 (shape, act) -> count, d2s (phase
    shape, C) -> count."""
    b1, d2s = _trunk(size, NETE_NEF, NETE_DOWNS, 0)
    return b1, Counter(d2s)


def nete_table(size: int) -> dict:
    """One unfrozen train step of the netE phase at ``size``."""
    base = train_table(NETE_PRESET, size)["unfrozen"]
    b1, d2s = nete_forward(size)
    return dict(b1=base["b1"] + b1, b1_bwd=base["b1_bwd"] + b1,
                d2s=base["d2s"] + d2s,
                s2d=base["s2d"] + Counter({(n, 2 * h, 2 * w, c): m for (
                    (n, h, w, _), c), m in d2s.items()}))


NETE = {"netE " + NETE_PRESET: nete_table(512),
        "netE " + NETE_PRESET + " 256": nete_table(256)}


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
            "instance_norm_stats": 0, "instance_norm_apply": 0,
            "instance_norm_bwd_stats": 0, "instance_norm_bwd_apply": 0,
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
            "instance_norm_act_bwd": 0, "instance_norm_stats": 0,
            "instance_norm_apply": 0, "instance_norm_bwd_stats": 0,
            "instance_norm_bwd_apply": 0, "tail_fused": len(t["tail"]),
            "d2s": len(t["d2s"]), "s2d": 0}


def spatial_per_frame(preset: str) -> dict:
    """Kernel launches of one served frame of ``preset`` on one rank of
    a spatially partitioned mesh (the ``SPATIAL`` table): every norm is
    B1 split, two launches (statistics, apply) and no fused one; the
    tail (B2, over the halo) and the ups (d2s) as unsharded."""
    want = per_frame(preset)
    norms = want["instance_norm_act"]
    return {**want, "instance_norm_act": 0, "instance_norm_stats": norms,
            "instance_norm_apply": norms}


def quant_per_frame(preset: str, mode: str) -> dict:
    """``per_frame`` in a quantized serving mode: the norms and ups are
    the same; under int8 the tail is an int8 conv + bias + tanh in
    PyTorch ops, not B2 (under int8_mixed its 3-wide conv stays fp and
    B2 serves it; under int8_w B2 takes the dequantized weight)."""
    want = per_frame(preset)
    if mode == "int8":
        want["tail_fused"] = 0
    return want


def _keys(tables, field):
    return {k for t in tables for v in t.values() for k in v[field]}


_STEPS = (list(TRAIN.values()) + list(TRAIN_256.values())
          + [t if "unfrozen" in t else {"unfrozen": t}
             for t in (*TRAIN_OPTIONS.values(), *NETE.values())])
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

# The spatial phase (``spatial_phase``): frames served with their rows
# spread over the sp gloo ranks of a dp×sp mesh on the one card
# (``parallel/spatial.py``), each held to the one-process frame of the
# same weights. Frame cases (preset, sp, dtypes, frames); then
# MultiStreamServer on SPATIAL_SERVER_MESHES ((dp, sp), world 2) with
# SPATIAL_SLOTS streams of SPATIAL_SERVER over SPATIAL_TICKS (the slots
# with a frame each tick); the negative control, SPATIAL_BROKEN (preset,
# sp, dtype), serves one frame with one halo row a layer taken from the
# wrong shard and must fail the fp32 bar.
SPATIAL_CASES = [("pix2pixhd_2048", 2, ("float32", "bf16"), 2),
                 ("pix2pixhd_512", 2, ("bf16",), 2),
                 ("pix2pixhd_2048", 4, ("float32", "bf16"), 2),
                 ("temporal_512", 4, ("float32", "bf16"), 3)]
SPATIAL_SERVER, SPATIAL_SLOTS = "temporal_512", 4
SPATIAL_TICKS = [(0, 1, 2, 3), (0, 2, 3), (0, 1, 2, 3)]
SPATIAL_SERVER_MESHES = [(2, 1), (1, 2)]
SPATIAL_BROKEN = ("pix2pixhd_512", 2, "float32")
SPATIAL_BF16_PSNR = 40.0
# the frame whose B1 split launches the kernel table's times sum over
SPLIT_FRAME = ("pix2pixhd_2048", 4)
# the split statistics of an fp32 input of mean 1e3 x std against
# float64: M2's relative error
SPLIT_LARGE_MEAN_REL = 1e-5
SPLIT_STATS_KEYS = ("ms", "plain_ms", "library_ms", "eager_ms", "bound_ms",
                    "fused_ms")
# the split statistics' shapes of at least this many bytes are timed on a
# cold L2 as well: from 16 MB a shape's reads repeated in a graph replay
# are partly L2 hits (the H100's L2 holds 50 MB)
SPLIT_COLD_BYTES = 16 << 20


def shard_table(table: dict, sp: int, n: int = 1) -> dict:
    """A ``SERVE`` entry's kernel shapes on one of ``sp`` ranks at batch
    ``n``: H / sp, the tail's x extended by 3 halo rows each side."""
    def at(shape, grow=0):
        return (n, shape[1] // sp + grow) + tuple(shape[2:])
    return dict(b1={(at(s), a): c for (s, a), c in table["b1"].items()},
                tail=[at(s, 6) for s in table["tail"]],
                d2s=[(at(s), c) for s, c in table["d2s"]])


# every (preset, sp, batch) the phase serves partitioned, and its shapes
SPATIAL_TABLES = {k: shard_table(SERVE[k[0]], k[1], k[2]) for k in sorted(
    {(p, sp, 1) for p, sp, _, _ in SPATIAL_CASES}
    | {(SPATIAL_SERVER, sp, SPATIAL_SLOTS // dp)
       for dp, sp in SPATIAL_SERVER_MESHES if sp > 1})}
SPATIAL = {p: spatial_per_frame(p) for p, _, _ in SPATIAL_TABLES}
B1_SPLIT_SHAPES = sorted({k for t in SPATIAL_TABLES.values()
                          for k in t["b1"]})
B2_SHAPES += sorted({x for t in SPATIAL_TABLES.values() for x in t["tail"]}
                    - set(B2_SHAPES))
D2S_SHAPES += sorted({k for t in SPATIAL_TABLES.values() for k in t["d2s"]}
                     - set(D2S_SHAPES))

# The spatial_train phase (``spatial_train_phase``): train steps with each
# frame's rows spread over the sp gloo ranks of a dp×sp mesh on the one
# card, the partitioned step held to one process's step of the same
# weights and batch. Cases (preset, dp, sp, dtypes, steps, remat, gp):
# the cases of two ranks run on a pair of ranks, those with WGAN-GP
# (``gp``) or a CycleGAN on ranks 2 and 3 beside the others on ranks 0
# and 1 (``pair_of``); all four ranks run the rest. A temporal preset's
# step is a window of its n_frames_total frames; a remat case follows the
# same case without remat and is held to it as well. The steps of
# SPATIAL_TRAIN_TIMED are timed alone (no reference).
# SPATIAL_TRAIN_BROKEN (preset, sp, dtype): one step with one halo row a
# layer from the wrong shard, which must fail the bars;
# SPATIAL_TRAIN_CLI: the preset of one torchrun of cli.train on sp 2 for
# two steps from a folder.
SPATIAL_TRAIN_CASES = [
    ("temporal_512", 1, 2, ("float32", "bf16"), 1, False, False),
    ("temporal_512", 1, 2, ("float32",), 1, True, False),
    ("pix2pixhd_512", 1, 2, ("float32", "bf16"), 1, False, False),
    ("pix2pixhd_512", 1, 2, ("float32", "bf16"), 1, False, True),
    ("cyclegan_256", 1, 2, ("float32", "bf16"), 1, False, False),
    ("pix2pixhd_512", 2, 2, ("float32",), 1, False, False),
    ("pix2pixhd_2048", 1, 4, ("bf16",), 2, False, False),
    ("temporal_1024", 1, 4, ("bf16",), 1, True, False)]
SPATIAL_TRAIN_TIMED = ("pix2pixhd_2048", "temporal_1024")
SPATIAL_TRAIN_BROKEN = ("pix2pixhd_512", 2, "float32")
SPATIAL_TRAIN_CLI = "resnet9_256"
# the limits on the ranks' world (every collective and the group's run)
# and on the torchrun of cli.train beside it
RANKS_TIMEOUT_S, CLI_TIMEOUT_S = 900, 420
# the step whose split backward launches the kernel table's times sum over
# (preset, dp, sp, remat, gp, rank)
SPLIT_TRAIN_STEP = ("pix2pixhd_512", 1, 2, False, False, 0)
# a remat step against the same step without remat: every gradient
# element (JAX's remat bar, tests/test_variants.py:83)
REMAT_GRAD_ATOL = 1e-6
# the timed presets whose one-process peak (two steps, no remat) rank 0
# also takes, beside the ranks' peaks
ONE_PROCESS_PEAK = ("temporal_1024",)
# the bars against one process (PERF.md §2): fp32 (TF32 off) the train
# bars, losses rel and each gradient tensor's ||d|| <= rel·||g|| +
# 1e-6·M; bf16 the bars PERF.md states for it: losses rel, and each
# network's whole gradient no further from one process's bf16 one than
# that is from one process's fp32 step of the same state, times the
# factor (a bias an instance norm follows has a zero gradient, which
# bf16 rounding turns into noise as large as the weights' gradients)
SPATIAL_TRAIN_BARS = {"float32": (1e-4, 1e-3), "bf16": (2e-2, 2.0)}


def shard_rows(h: int, sp: int, q: int) -> int:
    """Rank q's rows of ``h`` global rows over ``sp`` ranks (the
    partition ``parallel/spatial.py::bounds``: ⌊q·h/sp⌋ ...)."""
    return (q + 1) * h // sp - q * h // sp


# the enhancer levels of a local preset: (hw, ngf_n) each
_ENHANCERS = {"pix2pixhd_1024": [(1024, 32)],
              "pix2pixhd_2048": [(1024, 32), (2048, 16)],
              "temporal_512": [(512, 32)], "temporal_1024": [(1024, 32)]}


def remat_blocks(preset: str) -> Counter:
    """The B1 forward a remat recompute runs again in one frame's
    backward, of a local preset: every residual block's two norms (the
    trunk's 9 at its 16th resolution, each enhancer's 3 at its half)."""
    _, _, _, _, (hw, ngf) = _TRAIN_SPEC[preset]
    blocks = Counter({((1, hw >> 4, hw >> 4, ngf << 4), a): 9
                      for a in ("relu", "none")})
    for level, ngf_n in _ENHANCERS[preset]:
        blocks.update({((1, level // 2, level // 2, 2 * ngf_n), a): 3
                       for a in ("relu", "none")})
    return blocks


def pair_of(case) -> int:
    """The pair of ranks a two-rank case of SPATIAL_TRAIN_CASES runs on:
    1 (ranks 2 and 3) for WGAN-GP and CycleGAN, 0 (ranks 0 and 1) for the
    others."""
    preset, _, _, _, _, _, gp = case
    return int(gp or preset in _CYCLE)


def spatial_train_table(preset: str, sp: int, q: int, n: int = 1,
                        remat: bool = False, gp: bool = False) -> dict:
    """One unfrozen ``TRAIN`` step of ``preset`` (a temporal preset's
    window; with ``gp`` WGAN-GP's, ``train_table``'s) on rank q of ``sp``
    at batch ``n`` a rank: every shape's rows split as the partition
    splits them (the discriminator's 4x4 convs give uneven shards); with
    ``remat`` each frame's recomputed blocks' norms forward again. A
    WGAN-GP step's split backward runs twice on every norm of the
    penalty's D pass (the inner derivative's, and the outer backward's
    through the split backward's own, plain, derivative), as the fused
    B1 does."""
    t = train_table(preset, gp=True)["unfrozen"] if gp else \
        TRAIN[preset]["unfrozen"]
    b1 = t["b1"]
    if remat:
        b1 = b1 + _mul(remat_blocks(preset), _TRAIN_SPEC[preset][1])

    def at(shape):
        return (n, shard_rows(shape[1], sp, q)) + tuple(shape[2:])
    return dict(b1=Counter({(at(s), a): c for (s, a), c in b1.items()}),
                b1_bwd=Counter({(at(s), a): c
                                for (s, a), c in t["b1_bwd"].items()}),
                d2s=Counter({(at(s), c): m for (s, c), m in t["d2s"].items()}),
                s2d=Counter({at(s): m for s, m in t["s2d"].items()}))


def spatial_per_step(table: dict) -> dict:
    """Kernel launches of one partitioned train step on one rank: every
    norm of the step is B1 split, statistics and apply forward, the sums
    and apply backward, none fused, and none on a rank without rows."""
    def live(c):
        return sum(m for (s, _), m in c.items() if s[1])
    return {"instance_norm_act": 0, "instance_norm_act_bwd": 0,
            "instance_norm_stats": live(table["b1"]),
            "instance_norm_apply": live(table["b1"]),
            "instance_norm_bwd_stats": live(table["b1_bwd"]),
            "instance_norm_bwd_apply": live(table["b1_bwd"]),
            "tail_fused": 0, "d2s": sum(table["d2s"].values()),
            "s2d": sum(table["s2d"].values())}


# every (preset, dp, sp, remat, gp, rank) the phase trains on, and its
# table
SPATIAL_TRAIN = {(p, dp, sp, remat, gp, q): spatial_train_table(
    p, sp, q, remat=remat, gp=gp)
    for p, dp, sp, _, _, remat, gp in SPATIAL_TRAIN_CASES for q in range(sp)}
# the split forward's shard shapes of those steps that the frames' do not
# give it (the discriminators', a 1024 rank's), checked beside them; B3
# at their ups' shard shapes
B1_SPLIT_TRAIN_SHAPES = sorted(
    {k for t in SPATIAL_TRAIN.values() for k in t["b1"] if k[0][1]}
    - set(B1_SPLIT_SHAPES))
D2S_SHAPES += sorted({k for t in SPATIAL_TRAIN.values() for k in t["d2s"]}
                     - set(D2S_SHAPES))
S2D_SHAPES += sorted({k for t in SPATIAL_TRAIN.values() for k in t["s2d"]}
                     - set(S2D_SHAPES))
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# graph_ms captures REPS_LONG calls of a call longer than LONG_CALL_MS
# (a reading of such a graph spans >= 0.5 ms; the plain and library
# yardsticks of the large shapes are most of the kernel phases' time)
LONG_CALL_MS, REPS_LONG = 0.25, 2
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
TRAIN_STEPS, TIMED_STEPS, FIX_STEPS = 4, 3, 2
TRAIN_FP32_LOSS_RTOL, TRAIN_FP32_GRAD_REL = 1e-4, 1e-3
BF16_LOSS_REL = 0.05
# the quant phase: the modes beside "none", frames a mode through the
# stream, and the PSNR bar of int8 / int8_mixed fp32 card frames against
# the CPU's at the CPU's quantized inputs (QuantPins), beside max-abs;
# the share (beside a few activations) of each pinned conv's int8
# activations that the card's own input may quantize differently, and
# the PSNR bar of the unpinned frames
QUANT_MODES = ("int8", "int8_mixed", "int8_w")
QUANT_FRAMES, QUANT_MIN_PSNR, QUANT_TICK_SLOTS = 4, 40.0, 4
QUANT_MAX_FLIP_SHARE, QUANT_FLIP_ALLOWANCE = 0.01, 8
QUANT_UNPINNED_MIN_PSNR = 30.0
# the wrong layer those bars must catch: seeded noise of this share of
# its std added to the output of a frame's middle B1 call on the card
QUANT_PROBE_NOISE = 1e-2
# the netE phase: Voronoi cells an instance map, bf16 steps checked one by
# one, frames netE's features are collected over
NETE_CELLS, NETE_STEPS, NETE_FEATURE_FRAMES = 24, 3, 4
# the export phase: frames each artifact is held to the live path over
# (both streams reset before frame EXPORT_RESET_AT), frames timed, the
# bf16 / int8_mixed PSNR bar, the sealed multi-stream batch and its ticks
EXPORT_FRAMES, EXPORT_RESET_AT, EXPORT_TIMED = 8, 5, 5
EXPORT_MIN_PSNR = 40.0
EXPORT_SLOTS = 4
EXPORT_TICKS = [(0, 1, 2, 3), (0, 2, 3), (0, 1, 2, 3), (1, 3)]
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


# Timing depth (cut in PR 15 so that the whole run keeps a margin under
# its limit as phases are added): calls a CUDA-graph capture or an eager
# reading takes, and replays a graph reading takes the median of
TIMING_REPS, TIMING_REPLAYS = 8, 3


def cuda_ms(fn, reps: int = TIMING_REPS, warmup: int = 2) -> float:
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


def graph_ms(fn, reps: int = TIMING_REPS) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph, replayed between CUDA events, so Python launch overhead is out
    of the measurement; the median of TIMING_REPLAYS replays, so that one
    replay slowed by the card's clocks or its host does not set the
    reading. A
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
    for _ in range(TIMING_REPLAYS):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[TIMING_REPLAYS // 2]


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


def cold_ms(fn, flush: torch.Tensor, read: bool = False) -> float:
    """Device time of one ``fn`` call on a cold L2: ``flush`` (more than
    the 50 MB L2) is written before every call, or with ``read`` read (so
    that the L2 holds no dirty line that ``fn``'s reads must write back
    first), and the graph-replay time of the flush alone is taken off."""
    wipe = ((lambda: torch.amax(flush.view(torch.int32))) if read
            else flush.zero_)
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
    ms = cuda_ms(step, reps=15, warmup=3)
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
             "netD_B": SEED + 5, "netE": SEED + 6}


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


class ShardPins(KinkPins):
    """:class:`KinkPins` recorded on a spatially partitioned step: every
    conv output and split-B1 input and output this rank records with a
    graph (its rows), and the merged B1 statistics of every call, in the
    forward: a remat recompute in the backward records nothing (it
    replays the forward's values; one process's step without remat reads
    the forward's pins alone). :meth:`whole` joins the ranks' records of a
    data row along the rows, in rank order, for one process's step to
    replay."""

    @staticmethod
    def _recomputing() -> bool:
        # the autograd engine runs a graph task: a recompute's forward
        return torch._C._current_graph_task_id() != -1

    @contextlib.contextmanager
    def recording(self):
        from ir2rgb_tpu_torch.nn import ops
        conv, split = ops.conv, ops._split_instance_norm_act
        forward = ops._split_forward
        self._replay = False

        def stats(*a):
            y, mean, rstd, count = forward(*a)
            if self._recomputing():
                return y, mean, rstd, count
            return (y, *self._stats(mean, rstd), count)

        def pinned_conv(*a, **kw):
            y = conv(*a, **kw)
            return y if self._recomputing() else self.pin(y)

        def pinned_split(part, x, act, slope):
            if self._recomputing():
                return split(part, x, act, slope)
            return self.pin(split(part, self.pin(x), act, slope))
        ops.conv, ops._split_instance_norm_act = pinned_conv, pinned_split
        ops._split_forward = stats
        try:
            yield
        finally:
            ops.conv, ops._split_instance_norm_act = conv, split
            ops._split_forward = forward

    @classmethod
    def whole(cls, rows: list) -> "KinkPins":
        """Pins for one process from the records of a data row's ranks
        (each ``(saved, stats)``, in rank order)."""
        pins = KinkPins()
        pins.saved = [torch.cat(parts, dim=1)
                      for parts in zip(*(r[0] for r in rows))]
        pins.stats = list(rows[0][1])
        return pins


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


def remat_table(preset: str) -> dict:
    """One unfrozen remat train step of a local preset: ``TRAIN``'s, plus
    the B1 forward of every residual block's two norms again, recomputed
    in the backward (``remat_blocks``)."""
    t = TRAIN[preset]["unfrozen"]
    return dict(t, b1=t["b1"] + remat_blocks(preset))


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
    # the pairs folder stays for the parallel phase
    for sub in ("runs", "video"):
        shutil.rmtree(root / sub, ignore_errors=True)
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


# ---------------------------------------------------------------------------
# Quantized serving and netE
# ---------------------------------------------------------------------------

def with_quant(model, mode: str):
    """``model`` serving in quant ``mode``: ``generate`` reads the mode
    from the model's config at every call."""
    model.cfg = model.cfg.replace(infer=dataclasses.replace(
        model.cfg.infer, quant=mode))
    return model


def serve_model(preset: str, dtype: str, device: str, sd):
    """``preset``'s model for serving (no VGG), netG's weights ``sd``
    (None: the seeded init)."""
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.train import create_model
    cfg = PRESETS[preset]
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype=dtype),
        loss=dataclasses.replace(cfg.loss, no_vgg_loss=True))
    model = create_model(cfg, device=device)
    if sd is not None:
        model.netG.load_state_dict(sd)
    return model


@contextlib.contextmanager
def product_shapes():
    """The (M, K, N) of every int8 product run on the card inside the
    block (``quant.int_mm``, wrapped)."""
    from ir2rgb_tpu_torch.nn import quant
    real, shapes = quant.int_mm, set()

    def recording(a, b):
        if a.is_cuda:
            shapes.add((a.shape[0], a.shape[1], b.shape[0]))
        return real(a, b)
    quant.int_mm = recording
    try:
        yield shapes
    finally:
        quant.int_mm = real


def int_mm_check(shapes, gen: torch.Generator) -> list:
    """``torch._int_mm`` through the port's zero-padding
    (``quant.int_mm_cuda``) against the plain float64 product on the
    card, bit for bit, on full-range random int8 operands of each shape
    (the plain product in row chunks of 128 MB of float64)."""
    from ir2rgb_tpu_torch.nn import quant
    rows = []
    for m, k, n in sorted(shapes):
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        got = quant.int_mm_cuda(a, b)
        step = max(1, (1 << 27) // (8 * k))
        equal = got.dtype == torch.int32 and all(
            torch.equal(got[i:i + step],
                        quant.int_mm_reference(a[i:i + step], b))
            for i in range(0, m, step))
        rows.append(dict(m=m, k=k, n=n, equal=equal))
        del a, b, got
    bad = [(r["m"], r["k"], r["n"]) for r in rows if not r["equal"]]
    check(bool(rows) and not bad,
          f"quant: torch._int_mm equal bit for bit to the plain product at "
          f"{len(rows) - len(bad)} of {len(rows)} (M, K, N) (differ: "
          f"{bad[:4]})")
    return rows


class QuantPins:
    """The input of every int8 conv (``quant.conv``), recorded on one run
    and replayed in the same order on another, so that both devices
    quantize the same activations. Unpinned, an activation that the two
    devices' fp32 rounding puts on opposite sides of a rounding boundary
    moves one quantization level, and at full width the next layers'
    inputs differ by that much, which flips more: the frames part to the
    quantization noise's own level (33-37 dB card vs CPU at 256x256,
    NVIDIA H100 80GB HBM3, 700 W). Replayed, each conv's own input is
    what the card made of the previous pinned conv's input, so comparing
    it with the pin tests the layers between the two: ``flips`` counts,
    per call, the int8 activations the card's own input would quantize
    differently, out of ``sizes`` activations; a wrong layer flips a
    large share."""

    def __init__(self):
        self.saved, self.flips, self.sizes, self.replayed = [], [], [], 0

    @contextlib.contextmanager
    def _patched(self, replay: bool):
        from ir2rgb_tpu_torch.nn import quant
        real = quant.conv

        def conv(x, w, m, *a, **kw):
            if m == "int8" and not replay:
                self.saved.append(x.detach().cpu())
            elif m == "int8":
                pin = self.saved[self.replayed].to(x.device, x.dtype)
                self.replayed += 1
                own = quant._q8(x.float(), quant._act_scale(x))
                self.flips.append(int((own != quant._q8(
                    pin.float(), quant._act_scale(pin))).sum()))
                self.sizes.append(pin.numel())
                x = pin
            return real(x, w, m, *a, **kw)
        quant.conv = conv
        try:
            yield
        finally:
            quant.conv = real

    def recording(self):
        return self._patched(False)

    def replaying(self):
        return self._patched(True)

    def over_bar(self) -> list:
        """(call, flips, activations) of each conv flipped beyond
        QUANT_MAX_FLIP_SHARE of its activations + QUANT_FLIP_ALLOWANCE."""
        return [(i, f, n) for i, (f, n) in enumerate(zip(self.flips,
                                                         self.sizes))
                if f > QUANT_MAX_FLIP_SHARE * n + QUANT_FLIP_ALLOWANCE]

    def worst_share(self) -> float:
        return max((f / n for f, n in zip(self.flips, self.sizes)),
                   default=0.0)

    def again(self) -> "QuantPins":
        """The same recording, for another replay."""
        pins = QuantPins()
        pins.saved = self.saved
        return pins


@contextlib.contextmanager
def broken_norm(k: int):
    """Inside the block the card's ``k``-th B1 output (``ops``' instance
    norm) gets seeded noise of QUANT_PROBE_NOISE of its std: one wrong
    layer, which the quant phase's bars must catch."""
    from ir2rgb_tpu_torch.nn import ops
    real, calls = ops.fused_instance_norm_act, [0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def norm(x, *a, **kw):
        y = real(x, *a, **kw)
        if x.is_cuda:
            if calls[0] == k:
                noise = torch.randn(y.shape, generator=gen, device=y.device)
                y = y + (noise * (QUANT_PROBE_NOISE * y.float().std())
                         ).to(y.dtype)
            calls[0] += 1
        return y
    ops.fused_instance_norm_act = norm
    try:
        yield
    finally:
        ops.fused_instance_norm_act = real


def quant_preset(preset: str, card: str) -> dict:
    """``preset`` at full width in each quant mode beside "none": bf16
    frames through the stream (launches, ms/frame, peak, PSNR against
    "none"), then fp32 card frames against the CPU's at 256x256."""
    from ir2rgb_tpu_torch.infer import StreamingGenerator
    from ir2rgb_tpu_torch.infer.stream import _dev_normalize
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    bf16 = serve_model(preset, "bf16", "cuda", None)
    sd = seeded_state_dict(bf16.netG, SEED)
    bf16.netG.load_state_dict(sd)
    temporal = bf16.cfg.model.model == "temporal"
    hw = (bf16.cfg.data.crop_size,) * 2
    in_nc = bf16.cfg.model.input_nc
    rng = np.random.default_rng(SEED + 8)
    frames = [rng.integers(0, 256, hw + (in_nc,), dtype=np.uint8)
              for _ in range(QUANT_FRAMES)]
    x0 = _dev_normalize(torch.from_numpy(frames[0][None])).cuda()
    res, first, launches = {"preset": preset}, {}, Counter()
    for mode in ("none",) + QUANT_MODES:
        with_quant(bf16, mode)
        stream = StreamingGenerator(bf16, hw)
        list(stream.stream(frames[:2]))  # cuDNN's choices, the kept weights
        stream.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        outs = list(stream.stream(frames))
        torch.cuda.synchronize()
        counts, peak = launch_counts(), torch.cuda.max_memory_allocated()
        launches.update(counts)
        want = quant_per_frame(preset, mode)
        check(len(outs) == QUANT_FRAMES and all(
            o.shape == hw + (3,) and o.dtype == np.uint8 for o in outs),
            f"quant {preset} {mode}: {len(outs)} uint8 frames of "
            f"{hw + (3,)}")
        check(counts == {k: v * QUANT_FRAMES for k, v in want.items()},
              f"quant {preset} {mode}: launches {counts} over "
              f"{QUANT_FRAMES} frames (want {want} a frame)")
        if temporal:
            s = StreamingGenerator(bf16, hw)
            step = partial(s.push_device, x0)
        else:
            state = {"x": x0}

            def step():
                state["x"] = bf16.generate(state["x"])
        ms = cuda_ms(step, reps=5, warmup=2)
        first[mode] = bf16.generate(x0).float()
        res[mode] = dict(ms_per_frame=ms, peak_gib=peak / 2**30,
                         launches_per_frame=want)
        if mode != "none":
            res[mode]["bf16_psnr_vs_none_db"] = psnr(first[mode],
                                                     first["none"])
    del bf16, stream, first
    torch.cuda.empty_cache()

    # fp32 (TF32 off) card frames against the CPU's at 256x256; int8 and
    # int8_mixed at the CPU's quantized inputs (QuantPins) and unpinned,
    # then with one wrong layer (broken_norm), which must fail
    fp32 = serve_model(preset, "float32", "cuda", sd)
    cpu = serve_model(preset, "float32", "cpu", sd)
    a = _dev_normalize(torch.from_numpy(rng.integers(
        0, 256, (1, 256, 256, in_nc), dtype=np.uint8)))
    none32 = fp32.generate(a.cuda()).cpu()
    for mode in QUANT_MODES:
        pins = QuantPins()
        t0 = time.perf_counter()
        with pins.recording():
            y_cpu = with_quant(cpu, mode).generate(a)
        cpu_s = time.perf_counter() - t0
        y_free = with_quant(fp32, mode).generate(a.cuda()).cpu()
        with pins.replaying():
            y_card = fp32.generate(a.cuda()).cpu()
        err, p = float((y_card - y_cpu).abs().max()), psnr(y_card, y_cpu)
        free = psnr(y_free, y_cpu)
        res[mode].update(fp32_card_vs_cpu_max_abs=err,
                         fp32_card_vs_cpu_psnr_db=p,
                         fp32_unpinned_card_vs_cpu_psnr_db=free,
                         pinned_convs=len(pins.saved), flips=pins.flips,
                         activations=pins.sizes,
                         worst_flip_share=pins.worst_share(),
                         fp32_psnr_vs_none_db=psnr(y_free, none32),
                         cpu_s=cpu_s)
        check(pins.replayed == len(pins.saved)
              and (mode == "int8_w") == (not pins.saved),
              f"quant {preset} {mode}: {pins.replayed} of "
              f"{len(pins.saved)} int8 conv inputs replayed")
        check(err <= SLICE_FP32_TOL and p >= QUANT_MIN_PSNR,
              f"quant {preset} {mode}: fp32 card vs CPU at 256x256 "
              f"max-abs {err:.3g} (tol {SLICE_FP32_TOL}), PSNR {p:.2f} dB "
              f"(bar {QUANT_MIN_PSNR})")
        if pins.saved:
            over = pins.over_bar()
            check(not over,
                  f"quant {preset} {mode}: each int8 conv's own card input "
                  f"against the CPU's: {sum(pins.flips)} int8 activations "
                  f"flipped over {sum(f > 0 for f in pins.flips)} of "
                  f"{len(pins.flips)} convs, worst share "
                  f"{pins.worst_share():.3g} (bar {QUANT_MAX_FLIP_SHARE} + "
                  f"{QUANT_FLIP_ALLOWANCE}; over: {over[:4]})")
            check(free >= QUANT_UNPINNED_MIN_PSNR,
                  f"quant {preset} {mode}: unpinned fp32 card vs CPU at "
                  f"256x256 PSNR {free:.2f} dB (bar "
                  f"{QUANT_UNPINNED_MIN_PSNR})")
            k, bad = len(SERVE[preset]["b1"]) // 2, pins.again()
            with broken_norm(k), bad.replaying():
                y_bad = fp32.generate(a.cuda()).cpu()
            with broken_norm(k):
                y_bad_free = fp32.generate(a.cuda()).cpu()
            res[mode]["broken_layer"] = dict(
                b1_call=k, convs_over_bar=len(bad.over_bar()),
                worst_flip_share=bad.worst_share(),
                pinned_psnr_db=psnr(y_bad, y_cpu),
                unpinned_psnr_db=psnr(y_bad_free, y_cpu))
            check(bool(bad.over_bar()),
                  f"quant {preset} {mode}: B1 call {k} on the card with "
                  f"noise of {QUANT_PROBE_NOISE} of its std fails the flips "
                  f"bar: {len(bad.over_bar())} of {len(bad.flips)} convs "
                  f"over it, worst share {bad.worst_share():.3g}; PSNR "
                  f"{res[mode]['broken_layer']['pinned_psnr_db']:.2f} dB "
                  "pinned, "
                  f"{res[mode]['broken_layer']['unpinned_psnr_db']:.2f} "
                  "unpinned")
    res["launches"] = dict(launches)
    del fp32, cpu
    torch.cuda.empty_cache()
    print(f"quant {preset} ({card}), bf16 at {hw[0]}: " + "; ".join(
        f"{m} {res[m]['ms_per_frame']:.3f} ms/frame, launches B1/B2/d2s "
        + "/".join(str(res[m]["launches_per_frame"][k]) for k in (
            "instance_norm_act", "tail_fused", "d2s"))
        + f", {res[m]['peak_gib']:.2f} GiB"
        + (f", {res[m]['bf16_psnr_vs_none_db']:.2f} dB vs none"
           if m != "none" else "")
        for m in ("none",) + QUANT_MODES), flush=True)
    return res


def quant_tick(card: str) -> dict:
    """One ``MultiStreamServer`` tick of temporal_512 in int8_mixed, bf16,
    QUANT_TICK_SLOTS streams on as many physical rows: a served frame's
    launches, uint8 frames out."""
    from ir2rgb_tpu_torch.infer.multistream import MultiStreamServer
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    preset = "temporal_512"
    model = with_quant(serve_model(preset, "bf16", "cuda", None),
                       "int8_mixed")
    model.netG.load_state_dict(seeded_state_dict(model.netG, SEED))
    srv = MultiStreamServer(model, (512, 512), n_slots=QUANT_TICK_SLOTS)
    sids = [srv.open() for _ in range(QUANT_TICK_SLOTS)]
    rng = np.random.default_rng(SEED + 11)
    feed = [{sid: rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
             for sid in sids} for _ in range(2)]
    srv.step(feed[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = srv.step(feed[1])
    wall = (time.perf_counter() - t0) * 1e3
    counts, want = launch_counts(), quant_per_frame(preset, "int8_mixed")
    check(srv.physical_slots == QUANT_TICK_SLOTS and counts == want,
          f"quant tick {preset} int8_mixed x{QUANT_TICK_SLOTS}: launches "
          f"{counts} (want one frame's, {want}) on "
          f"{srv.physical_slots} rows")
    check(sorted(out) == sorted(sids) and all(
        o.shape == (512, 512, 3) and o.dtype == np.uint8
        for o in out.values()),
        f"quant tick: {len(out)} uint8 frames of (512, 512, 3)")
    del model, srv
    torch.cuda.empty_cache()
    return dict(preset=preset, mode="int8_mixed", slots=QUANT_TICK_SLOTS,
                launches=counts, wall_ms=wall)


def quant_phase(card: str) -> dict:
    """Every served preset in every quant mode (``quant_preset``), the
    int8_mixed tick, then ``torch._int_mm`` at every product shape those
    runs gave it."""
    with product_shapes() as shapes:
        presets = [quant_preset(p, card) for p in SERVE]
        tick = quant_tick(card)
    rows = int_mm_check(shapes, torch.Generator(device="cuda").manual_seed(
        SEED + 12))
    print(f"quant: torch._int_mm bit for bit at {len(rows)} product "
          f"shapes, M {min(r['m'] for r in rows)}-"
          f"{max(r['m'] for r in rows)}, K {min(r['k'] for r in rows)}-"
          f"{max(r['k'] for r in rows)}", flush=True)
    return dict(presets=presets, tick=tick, int_mm_shapes=rows)


def voronoi(rng, size: int, cells: int = NETE_CELLS) -> np.ndarray:
    """(1, size, size) int32 instance ids: each pixel the id of its
    nearest of ``cells`` random sites, the ids random below 2^24."""
    yy, xx = np.mgrid[:size, :size]
    best = np.full((size, size), np.inf)
    out = np.zeros((size, size), np.int32)
    for (sy, sx), i in zip(rng.integers(0, size, (cells, 2)),
                           rng.integers(0, 1 << 24, cells)):
        d = (yy - sy) ** 2 + (xx - sx) ** 2
        near = d < best
        out[near], best[near] = i, d[near]
    return out[None]


def nete_batch(size: int, device: str, seed: int) -> dict:
    """A batch-1 train batch with an instance map, from a numpy seed."""
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.uniform(
        -1, 1, (1, size, size, 3)).astype(np.float32)) for k in "ab"}
    batch["inst"] = torch.from_numpy(voronoi(rng, size))
    return {k: v.to(device) for k, v in batch.items()}


def nete_frame(size: int, frames: int = 1) -> dict:
    """Launches of ``frames`` netE forwards at ``size`` and one served
    frame of the netE phase's generator."""
    b1, d2s = nete_forward(size)
    want = per_frame(NETE_PRESET)
    want["instance_norm_act"] += frames * sum(b1.values())
    want["d2s"] += frames * sum(d2s.values())
    return want


class TailGrad:
    """The gradient at netE's tail conv output (pre-bias, pre-tanh),
    captured in a run: netE's tail bias gradient is its sum over the
    pixels. The instance norms right after G's head convs make the
    gradient at G's input sum to zero over every channel in exact
    arithmetic, so that sum is a small remainder of terms that cancel,
    and the CPU's fp32 reduction rounds it by 4.0e-5 where the card's
    rounds by 3.6e-9 (2.5 of the train bar card vs CPU at the pinned
    forward point; NVIDIA H100 80GB HBM3, 700 W): the bias is held
    through the float64 sums of each run's own gradient, the fp32 sums'
    rounding reported."""

    def __init__(self, netE):
        self.weight, self.grad = netE.model[netE.tail].weight, None

    @contextlib.contextmanager
    def capturing(self):
        from ir2rgb_tpu_torch.nn import ops
        real = ops.conv

        def keep(g):
            self.grad = g.detach().cpu()

        def conv(x, w, *a, **kw):
            y = real(x, w, *a, **kw)
            if w is self.weight and y.requires_grad:
                y.register_hook(keep)
            return y
        ops.conv = conv
        try:
            yield
        finally:
            ops.conv = real

    def exact_bias_grad(self) -> torch.Tensor:
        """The bias gradient, summed in float64."""
        return self.grad.double().sum((0, 1, 2))


def pool_grad_check(inst: torch.Tensor) -> dict:
    """netE's instance pooling, forward and backward, on the card against
    the CPU on the same features, ids and output gradient (fp32): the
    pooled features max-abs, the gradient ||delta|| / ||g_cpu||."""
    from ir2rgb_tpu_torch.nn.encoders import instance_wise_avg_pool
    rng = np.random.default_rng(SEED + 14)
    feat, g = (torch.from_numpy(rng.standard_normal(
        tuple(inst.shape) + (3,), dtype=np.float32)) for _ in range(2))

    def run(dev):
        f = feat.to(dev).requires_grad_(True)
        y = instance_wise_avg_pool(f, inst.to(dev))
        (gf,) = torch.autograd.grad(y, f, g.to(dev))
        return y.detach().cpu(), gf.cpu()
    (y_card, g_card), (y_cpu, g_cpu) = run("cuda"), run("cpu")
    out = dict(max_abs=float((y_card - y_cpu).abs().max()),
               grad_rel=float((g_card - g_cpu).norm() / g_cpu.norm()))
    check(out["max_abs"] <= 1e-6 and out["grad_rel"] <= TRAIN_FP32_GRAD_REL,
          f"netE pooling fp32 card vs CPU: pooled max-abs "
          f"{out['max_abs']:.3g} (tol 1e-6), gradient rel "
          f"{out['grad_rel']:.3g} (tol {TRAIN_FP32_GRAD_REL})")
    return out


def nete_phase(card: str) -> dict:
    """The netE phase of the module docstring."""
    from ir2rgb_tpu_torch.infer.features import (
        collect_dataset_features,
        kmeans,
        sample_feature_map,
    )
    from ir2rgb_tpu_torch.infer.stream import _dev_normalize
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    from ir2rgb_tpu_torch.nn.encoders import instance_edges
    sections = dict(model=dict(use_instance_feat=True,
                               use_instance_edges=True))
    key = "netE " + NETE_PRESET
    want = per_step(NETE[key])
    bf16, weights = seeded_model(NETE_PRESET, "bf16", 0, **sections)
    check(bf16.netE is not None and bf16.gen_cfg.input_nc == 7
          and bf16.disc_cfg.input_nc == 7,
          f"netE: G input {bf16.gen_cfg.input_nc}, D input "
          f"{bf16.disc_cfg.input_nc} channels (want 7 and 7)")
    batch = nete_batch(512, "cuda", SEED + 9)
    res, losses, launches = {"preset": NETE_PRESET, "size": 512}, [], \
        Counter()
    for i in range(NETE_STEPS):
        before = clone_params(bf16.netE)
        torch.cuda.synchronize()
        reset_launch_counts()
        m = bf16.train_step(batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        launches.update(counts)
        losses.append({k: float(v) for k, v in m.items()})
        check(counts == want, f"netE train step {i}: launches {counts} "
              f"(want {want})")
        check("inst_collisions" in losses[-1] and all(
            math.isfinite(v) for v in losses[-1].values()),
            f"netE train step {i}: losses {losses[-1]}")
        stuck = [k for k, v in changed(bf16.netE, before).items()
                 if k.endswith("weight") and not v]
        check(not stuck, f"netE train step {i}: {len(stuck)} netE "
              f"weight(s) did not move {stuck[:3]}")
    ms, peak, run = timed_steps(bf16, batch, TIMED_STEPS)
    check(run == {k: v * TIMED_STEPS for k, v in want.items()},
          f"netE train: launches {run} over {TIMED_STEPS} timed bf16 steps")
    launches.update(run)
    res.update(losses_bf16=losses, ms_per_step_bf16=ms,
               peak_bytes_bf16=peak)
    del bf16, before
    torch.cuda.empty_cache()

    # fp32 on the card against the CPU at 256x256, pinned as in the train
    # phase (KinkPins), netE's tail bias through float64 sums (TailGrad);
    # the collision count equal
    cpu = train_model(NETE_PRESET, "float32", "cpu", weights, **sections)
    card32 = train_model(NETE_PRESET, "float32", "cuda", weights,
                         **sections)
    b_cpu = nete_batch(256, "cpu", SEED + 10)
    b_card = {k: v.cuda() for k, v in b_cpu.items()}
    pins, tail_cpu, tail_card = KinkPins(), TailGrad(cpu.netE), TailGrad(
        card32.netE)
    with pins.recording(), tail_cpu.capturing():
        m_cpu = cpu.compute_grads(b_cpu)
    reset_launch_counts()
    m_card = card32.compute_grads(b_card)
    torch.cuda.synchronize()
    got256, want256 = launch_counts(), per_step(NETE[key + " 256"])
    launches.update(got256)
    check(got256 == want256, f"netE train fp32 at 256px: launches "
          f"{got256} (want {want256})")
    collisions = (float(m_card["inst_collisions"]),
                  float(m_cpu["inst_collisions"]))
    check(collisions[0] == collisions[1], f"netE: inst_collisions card "
          f"{collisions[0]} vs CPU {collisions[1]}")
    loss_rel = {k: abs(float(m_card[k]) - float(v)) / abs(float(v))
                for k, v in m_cpu.items() if k != "inst_collisions"}
    want_g = grads_of(cpu)
    free = {n: grad_bar(g, want_g[n], TRAIN_FP32_GRAD_REL)
            for n, g in grads_of(card32).items()}
    with pins.replaying(), tail_card.capturing():
        card32.compute_grads(b_card)
    check(pins.all_replayed(), f"netE train fp32 card vs CPU: "
          f"{pins.replayed} of {len(pins.saved)} pins replayed")
    got_g = grads_of(card32)
    bias = f"model.{card32.netE.tail}.bias"
    plain_bar = grad_bar(got_g["netE"], want_g["netE"], TRAIN_FP32_GRAD_REL)
    got_g["netE"] = dict(got_g["netE"], **{bias: tail_card.exact_bias_grad()})
    want_g["netE"] = dict(want_g["netE"],
                          **{bias: tail_cpu.exact_bias_grad()})
    worst = {n: grad_bar(g, want_g[n], TRAIN_FP32_GRAD_REL)
             for n, g in got_g.items()}
    rounding = {side: float((t.exact_bias_grad()
                             - m.netE.model[m.netE.tail].bias.grad.cpu()
                             .double()).norm())
                for side, t, m in (("card", tail_card, card32),
                                   ("cpu", tail_cpu, cpu))}
    check(max(loss_rel.values()) <= TRAIN_FP32_LOSS_RTOL,
          f"netE train fp32 card vs CPU at 256px: losses rel "
          f"{max(loss_rel.values()):.3g} (tol {TRAIN_FP32_LOSS_RTOL})")
    for name, (ratio, k) in worst.items():
        check(ratio <= 1.0, f"netE train fp32 card vs CPU at 256px: {name} "
              f"gradients, worst {k} at {ratio:.3g} of the bar; unpinned "
              f"{free[name][1]} at {free[name][0]:.3g}")
    print(f"netE tail bias gradient: fp32 as summed, card vs CPU, worst "
          f"{plain_bar[1]} at {plain_bar[0]:.3g} of the bar; the fp32 sums' "
          f"rounding ||fp32 - float64|| card {rounding['card']:.3g}, CPU "
          f"{rounding['cpu']:.3g}", flush=True)
    res.update(fp32_card_vs_cpu_loss_rel=loss_rel,
               inst_collisions=collisions,
               fp32_card_vs_cpu_worst_grad_pinned=worst,
               fp32_card_vs_cpu_worst_grad_unpinned=free,
               netE_fp32_summed_bias_worst=plain_bar,
               netE_tail_bias_fp32_rounding=rounding,
               pooling_fp32_card_vs_cpu=pool_grad_check(b_cpu["inst"]))

    # --infer.use_encoded_image: the real target's features, fp32 card vs
    # CPU at 256x256
    def encoded(model, b):
        feat = model.encode_features(b["b"], b["inst"])
        return model.generate(b["a"], feat=feat,
                              edges=instance_edges(b["inst"]))
    reset_launch_counts()
    y_card = encoded(card32, b_card)
    counts = launch_counts()
    launches.update(counts)
    err = float((y_card.cpu() - encoded(cpu, b_cpu)).abs().max())
    check(counts == nete_frame(256), f"netE encoded frame at 256px: "
          f"launches {counts} (want {nete_frame(256)})")
    check(err <= SLICE_FP32_TOL, f"netE use_encoded_image frame: fp32 card "
          f"vs CPU max-abs {err:.3g} at 256x256 (tol {SLICE_FP32_TOL})")
    res["encoded_frame_fp32_card_vs_cpu_max_abs"] = err
    del cpu, card32
    torch.cuda.empty_cache()

    # precompute -> cluster -> sample -> serve, bf16 at 512x512
    serve = train_model(NETE_PRESET, "bf16", "cuda", weights, **sections)
    rng = np.random.default_rng(SEED + 13)
    host = [{"b": rng.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8),
             "inst": voronoi(rng, 512)} for _ in range(NETE_FEATURE_FRAMES)]
    a = _dev_normalize(torch.from_numpy(rng.integers(
        0, 256, (1, 512, 512, 3), dtype=np.uint8))).cuda()
    inst = torch.from_numpy(host[0]["inst"]).cuda()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    feats = collect_dataset_features(serve, host)
    collect_s = time.perf_counter() - t0
    centers = kmeans(feats, serve.cfg.infer.n_clusters)
    feat = sample_feature_map(
        inst, torch.from_numpy(centers).cuda(),
        torch.Generator(device="cuda").manual_seed(SEED),
        serve.enc_cfg.num_instances)
    y = serve.generate(a, feat=feat, edges=instance_edges(inst))
    torch.cuda.synchronize()
    counts = launch_counts()
    launches.update(counts)
    want_f = nete_frame(512, NETE_FEATURE_FRAMES)
    check(counts == want_f, f"netE features: launches {counts} (want "
          f"{want_f}: {NETE_FEATURE_FRAMES} netE forwards and a frame)")
    rows = feat[0].reshape(-1, feat.shape[-1]).float().cpu().numpy()
    ids = host[0]["inst"].reshape(-1)
    one_each = all((rows[ids == i] == rows[ids == i][0]).all()
                   for i in np.unique(ids))
    zeros = serve.generate(a, edges=instance_edges(inst))
    check(feats.ndim == 2 and feats.shape[1] == 3 and len(centers) > 1
          and one_each and bool(torch.isfinite(y).all())
          and y.shape == (1, 512, 512, 3) and not torch.equal(y, zeros),
          f"netE features: {feats.shape[0]} instance vectors over "
          f"{NETE_FEATURE_FRAMES} frames -> {len(centers)} centers; every "
          f"instance one centroid {one_each}; a finite styled frame that "
          "differs from the zero-feature frame")
    res.update(launches=dict(launches), feature_vectors=int(feats.shape[0]),
               centers=int(len(centers)), collect_s=collect_s)
    del serve
    torch.cuda.empty_cache()
    print(f"netE {NETE_PRESET} b1 512px ({card}): {ms:.2f} ms/step bf16, "
          f"peak {peak / 2**30:.2f} GiB; fp32 card vs CPU at 256px losses "
          f"rel {max(loss_rel.values()):.3g}, worst gradient "
          f"{max(r for r, _ in worst.values()):.3g} of the bar; "
          f"inst_collisions {collisions[0]:.0f}; encoded frame max-abs "
          f"{err:.3g}", flush=True)
    return res


# ---------------------------------------------------------------------------
# Sealed serving artifacts
# ---------------------------------------------------------------------------

# device kernel names (substrings of the mangled names) -> launch counter
KERNEL_NODE_NAMES = {"in_fwd_kernel": "instance_norm_act",
                     "in_stats_kernel": "instance_norm_stats",
                     "in_bwd_kernel": "instance_norm_act_bwd",
                     "in_apply_kernel": "instance_norm_apply",
                     "tail_tc_kernel": "tail_fused",
                     "tail_kernel": "tail_fused", "d2s_kernel": "d2s"}


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (libcuda's graph API)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernels(fn) -> Counter:
    """What one call of ``fn`` puts on the card, by the nodes of a CUDA
    graph captured around the call (as ``device_kernels``): our kernels
    counted under their launch counters' names by the kernel's name
    (``cuGraphKernelNodeGetParams``, ``cuFuncGetName``), every node under
    ``"nodes"``. A node libcuda cannot name raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: plans, packings and the allocator's pool
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    lib = ctypes.CDLL("libcuda.so.1")
    ptr, out = ctypes.c_void_p, ctypes.POINTER
    lib.cuGraphGetNodes.argtypes = [ptr, ptr, out(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ptr, out(ctypes.c_int)]
    lib.cuGraphKernelNodeGetParams_v2.argtypes = [ptr, out(_KernelNodeParams)]
    lib.cuFuncGetName.argtypes = [out(ctypes.c_char_p), ptr]
    lib.cuKernelGetName.argtypes = [out(ctypes.c_char_p), ptr]

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned CUresult {rc}")

    g = ptr(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(lib.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ptr * n.value)()
    ok(lib.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts = Counter(nodes=n.value)
    for node in nodes:
        kind = ctypes.c_int()
        ok(lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
           "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = _KernelNodeParams()
        ok(lib.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
           "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            ok(lib.cuFuncGetName(ctypes.byref(name), params.func),
               "cuFuncGetName")
        else:
            ok(lib.cuKernelGetName(ctypes.byref(name), params.kern),
               "cuKernelGetName")
        text = name.value.decode()
        for key, counter in KERNEL_NODE_NAMES.items():
            if key in text:
                counts[counter] += 1
                break
    graph.reset()
    return counts


def u8_gap(a: np.ndarray, b: np.ndarray) -> dict:
    """uint8 frames ``a`` against ``b``: the largest LSB gap, the bytes
    that differ, PSNR (peak 255)."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return dict(max_lsb=int(d.max()), differing=int((d > 0).sum()),
                psnr_db=psnr(torch.from_numpy(a), torch.from_numpy(b),
                             peak=255.0))


def program_ops(fn) -> Counter:
    """The ``ir2rgb::`` op nodes of a loaded program's graph, by launch
    counter name."""
    names = {"instance_norm_act": "instance_norm_act",
             "instance_norm_act_bwd": "instance_norm_act_bwd",
             "tail_fused": "tail_fused", "d2s": "d2s", "s2d": "s2d"}
    out = Counter()
    for node in fn.graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith("ir2rgb."):
            out[names[target.split(".")[1]]] += 1
    return out


def export_case(preset: str, dtype: str, mode: str, sd, card: str,
                folder: Path, timed: bool = True) -> dict:
    """Export ``preset`` (netG ``sd``) in ``dtype`` and quant ``mode`` on
    the card, write, load and serve it, and hold it to the live
    ``StreamingGenerator`` of the same weights."""
    from ir2rgb_tpu_torch.infer import StreamingGenerator
    from ir2rgb_tpu_torch.infer.export import (
        export_serving_artifact,
        load_serving_artifact,
    )
    from ir2rgb_tpu_torch.infer.stream import _dev_normalize, _dev_quantize
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    tag = f"export {preset} {dtype} {mode}"
    res = dict(preset=preset, dtype=dtype, quant=mode)
    want = {k: v for k, v in quant_per_frame(preset, mode).items() if v}
    path = folder / f"{preset}_{dtype}_{mode}.ir2rgb"
    frame0 = np.random.default_rng(SEED + 7).integers(
        0, 256, (512, 512, 3), dtype=np.uint8)

    # cold start of the live path: build, load the weights, first frame
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = with_quant(serve_model(preset, dtype, "cuda", sd), mode)
    live = StreamingGenerator(model, (512, 512))
    live.push(frame0)
    res["live_cold_start_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    export_serving_artifact(model, (512, 512), str(path))
    res["export_s"] = time.perf_counter() - t0
    res["artifact_bytes"] = path.stat().st_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art = load_serving_artifact(str(path))
    art.push(frame0)
    res["artifact_cold_start_s"] = time.perf_counter() - t0
    ops = program_ops(art._fn)
    res["program_ops"] = dict(ops)
    check(ops == Counter(want), f"{tag}: the program's ir2rgb ops {dict(ops)}"
          f" (want {want}, a live frame's launches)")

    # the frames, each at the live stream's carry, both reset once
    temporal = art.temporal
    live.reset()
    art.reset()
    rng = np.random.default_rng(SEED + 8)
    frames = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
              for _ in range(EXPORT_FRAMES)]
    gaps, carry_err = [], []
    counts = Counter()
    for i, f in enumerate(frames):
        if i == EXPORT_RESET_AT:
            live.reset()
            art.reset()
        elif temporal:
            art._carry = live.carry.clone()
        torch.cuda.synchronize()
        reset_launch_counts()
        got = art.push(f)
        torch.cuda.synchronize()
        counts.update(launch_counts())
        gaps.append(u8_gap(got, live.push(f)))
        if temporal:
            carry_err.append(float((art.carry - live.carry).abs().max()))
    counts = {k: v for k, v in counts.items() if v}
    res.update(frames=gaps, carry_max_abs=carry_err, launches=counts)
    check(counts == {k: v * EXPORT_FRAMES for k, v in want.items()},
          f"{tag}: launches {counts} over {EXPORT_FRAMES} artifact frames "
          f"(want {want} a frame)")
    worst = max(g["max_lsb"] for g in gaps)
    low = min(g["psnr_db"] for g in gaps)
    if dtype == "float32":
        check(worst <= 1 and max(carry_err, default=0.0) <= SLICE_FP32_TOL,
              f"{tag}: frames within {worst} LSB of the live path (bar 1), "
              f"carry max-abs {max(carry_err, default=0.0):.3g} (bar "
              f"{SLICE_FP32_TOL}), over {EXPORT_FRAMES} frames")
    else:
        check(low >= EXPORT_MIN_PSNR,
              f"{tag}: frames {low:.2f} dB against the live path (bar "
              f"{EXPORT_MIN_PSNR}); largest gap {worst} LSB, "
              f"{max(g['differing'] for g in gaps)} bytes differ at most")

    # one frame captured in a CUDA graph: its kernels by name, both paths
    a_dev = torch.from_numpy(frames[0][None]).cuda()
    reset_launch_counts()
    nodes_art = graph_kernels(lambda: art.push_device(a_dev))
    counted = {k: v for k, v in launch_counts().items() if v}
    reset_launch_counts()
    nodes_live = graph_kernels(lambda: _dev_quantize(live.push_device(
        _dev_normalize(a_dev))))
    res.update(graph_nodes_artifact=dict(nodes_art),
               graph_nodes_live=dict(nodes_live))
    mine = {k: nodes_art[k] for k in want}
    check(mine == want and counted == {k: 2 * v for k, v in want.items()}
          and all(nodes_live[k] == v for k, v in want.items()),
          f"{tag}: a captured artifact frame's kernel nodes {mine} and its "
          f"live frame's equal {want}; {nodes_art['nodes']} graph nodes "
          f"(live {nodes_live['nodes']})")

    if timed:
        # ms/frame, the output fed back as the next input (temporal: and
        # the carry), CUDA events, three readings of each in turns (the
        # frames are host-bound, and the host's time swings); peak memory
        # over frames above the resident weights
        steps = {}
        for name, step_fn in (
                ("artifact", art.push_device),
                ("live", lambda x: _dev_quantize(live.push_device(
                    _dev_normalize(x))))):
            state = {"x": a_dev}

            def step(step_fn=step_fn, state=state):
                state["x"] = step_fn(state["x"])
            steps[name] = step
            res[f"{name}_ms_readings"] = []
        for _ in range(3):
            for name, step in steps.items():
                res[f"{name}_ms_readings"].append(
                    cuda_ms(step, reps=EXPORT_TIMED, warmup=3))
        for name, step in steps.items():
            res[f"{name}_ms_per_frame"] = sorted(
                res[f"{name}_ms_readings"])[1]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(4):
                step()
            torch.cuda.synchronize()
            res[f"{name}_frame_peak_bytes"] = \
                torch.cuda.max_memory_allocated() - base
        res["artifact_weight_bytes"] = sum(
            v.numel() * v.element_size() for v in art._params.values())
        print(f"{tag} ({card}): artifact {res['artifact_ms_per_frame']:.3f}"
              f" ms/frame vs live {res['live_ms_per_frame']:.3f}; cold start"
              f" {res['artifact_cold_start_s']:.2f} s vs live "
              f"{res['live_cold_start_s']:.2f} s; {res['artifact_bytes']} "
              f"bytes; frame peak {res['artifact_frame_peak_bytes'] / 2**20:.1f}"
              f" vs {res['live_frame_peak_bytes'] / 2**20:.1f} MiB; worst "
              f"{worst} LSB, {low:.2f} dB", flush=True)
    path.unlink()
    del art, live, model
    torch.cuda.empty_cache()
    return res


def export_tick(preset: str, sd, card: str, folder: Path) -> dict:
    """A multi-stream artifact of ``preset`` at EXPORT_SLOTS slots, bf16,
    against the live ``MultiStreamServer`` over EXPORT_TICKS (streams
    skip, one closes and reopens), each tick at the live carries."""
    from ir2rgb_tpu_torch.infer.export import export_multistream_artifact
    from ir2rgb_tpu_torch.infer.multistream import MultiStreamServer
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    tag = f"export {preset} x{EXPORT_SLOTS} tick bf16"
    path = folder / f"{preset}_x{EXPORT_SLOTS}.ir2rgb"
    model = serve_model(preset, "bf16", "cuda", sd)
    export_multistream_artifact(model, (512, 512), str(path),
                                n_slots=EXPORT_SLOTS)
    live = MultiStreamServer(model, (512, 512), n_slots=EXPORT_SLOTS)
    sealed = MultiStreamServer.from_artifact(str(path))
    check(sealed.model is None and sealed.physical_slots == EXPORT_SLOTS
          and live.physical_slots == EXPORT_SLOTS,
          f"{tag}: served with no model, {sealed.physical_slots} rows")
    ids = [(live.open(), sealed.open()) for _ in range(EXPORT_SLOTS)]
    rng = np.random.default_rng(SEED + 9)
    gaps, counts, held = [], Counter(), True
    want = {k: v for k, v in per_frame(preset).items() if v}
    for t, sending in enumerate(EXPORT_TICKS):
        if t == len(EXPORT_TICKS) - 1:  # slot 1 closes and reopens
            live.close(ids[1][0])
            sealed.close(ids[1][1])
            ids[1] = (live.open(), sealed.open())
        sealed._carry = live._carry.clone()
        before = sealed._carry.clone()
        frames = {k: rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
                  for k in sending}
        torch.cuda.synchronize()
        reset_launch_counts()
        got = sealed.step({ids[k][1]: f for k, f in frames.items()})
        torch.cuda.synchronize()
        counts.update(launch_counts())
        ref = live.step({ids[k][0]: f for k, f in frames.items()})
        gaps += [u8_gap(got[ids[k][1]], ref[ids[k][0]]) for k in frames]
        held &= all(torch.equal(sealed._carry[ids[k][1]],
                                before[ids[k][1]])
                    for k in range(EXPORT_SLOTS) if k not in frames)
    counts = {k: v for k, v in counts.items() if v}
    low = min(g["psnr_db"] for g in gaps)
    check(counts == {k: v * len(EXPORT_TICKS) for k, v in want.items()},
          f"{tag}: launches {counts} over {len(EXPORT_TICKS)} ticks (want "
          f"{want} a tick)")
    check(low >= EXPORT_MIN_PSNR and held,
          f"{tag}: every stream's frame {low:.2f} dB against the live "
          f"server (bar {EXPORT_MIN_PSNR}); largest gap "
          f"{max(g['max_lsb'] for g in gaps)} LSB; skipped carries held "
          f"{held}")
    path.unlink()
    del live, sealed, model
    torch.cuda.empty_cache()
    return dict(preset=preset, slots=EXPORT_SLOTS, frames=gaps,
                launches=counts)


def export_from_cpu(preset: str, sd, card: str, folder: Path) -> dict:
    """An fp32 artifact of ``preset`` exported from a model on the CPU,
    loaded on the card (the program moved by ``move_to_device_pass``) and
    held to the live fp32 path on the card."""
    from ir2rgb_tpu_torch.infer import StreamingGenerator
    from ir2rgb_tpu_torch.infer.export import (
        export_serving_artifact,
        load_serving_artifact,
    )
    tag = f"export {preset} float32 from the CPU"
    path = folder / f"{preset}_cpu.ir2rgb"
    cpu = serve_model(preset, "float32", "cpu", sd)
    export_serving_artifact(cpu, (512, 512), str(path))
    del cpu
    art = load_serving_artifact(str(path))
    live = StreamingGenerator(serve_model(preset, "float32", "cuda", sd),
                              (512, 512))
    rng = np.random.default_rng(SEED + 10)
    gaps = []
    for _ in range(2):
        f = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
        if art.temporal:
            art._carry = live.carry.clone()
        gaps.append(u8_gap(art.push(f), live.push(f)))
    on_card = all(v.is_cuda for v in art._params.values())
    worst = max(g["max_lsb"] for g in gaps)
    check(on_card and worst <= 1,
          f"{tag}: served on the card ({on_card}), frames within {worst} "
          "LSB of the live card path (bar 1)")
    path.unlink()
    del art, live
    torch.cuda.empty_cache()
    return dict(preset=preset, frames=gaps)


def export_phase(card: str) -> dict:
    """Sealed artifacts (``infer/export.py``) on the card, one shared set
    of seeded weights a preset: single-stream artifacts of pix2pixhd_512
    and temporal_512 at 512x512 in bf16 and fp32, an int8_mixed bf16
    pix2pixhd_512 artifact, a multi-stream temporal_512 artifact at
    EXPORT_SLOTS slots, and an artifact exported on the CPU served on the
    card."""
    folder = Path("build") / "artifacts"
    folder.mkdir(parents=True, exist_ok=True)
    sds = {p: seeded_state_dict(generator_skeleton(p), SEED)
           for p in ("pix2pixhd_512", "temporal_512")}
    cases = [export_case(p, dt, "none", sds[p], card, folder)
             for p in sds for dt in ("bf16", "float32")]
    cases.append(export_case("pix2pixhd_512", "bf16", "int8_mixed",
                             sds["pix2pixhd_512"], card, folder))
    tick = export_tick("temporal_512", sds["temporal_512"], card, folder)
    from_cpu = export_from_cpu("pix2pixhd_512", sds["pix2pixhd_512"], card,
                               folder)
    launches = Counter()
    for c in cases + [tick]:
        launches.update(c["launches"])
    return dict(cases=cases, tick=tick, from_cpu=from_cpu,
                launches=dict(launches))


T0 = time.perf_counter()  # the process's start, for a rank's timeline

# the parallel phase: the preset, its bf16 steps, and the limits on a
# subprocess (a launched CLI, a rank) and on the group's collectives
PARALLEL_PRESET = "pix2pixhd_512"
PARALLEL_STEPS = 2
PARALLEL_TIMEOUT_S = 240
# the fp32 DP step against the one-process step of the global batch: the
# CPU tests' bars (metrics rtol, gradients under the mixed bar, weights
# after the step atol: Adam's first update is about lr·sign(g))
PARALLEL_METRIC_RTOL, PARALLEL_GRAD_REL, PARALLEL_WEIGHT_ATOL = \
    1e-5, 1e-4, 5e-4


def start_group(cmd: list) -> subprocess.Popen:
    """``cmd`` started in a process group of its own (a torchrun and its
    workers are one group), its output piped."""
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def wait_group(procs: list, timeout: float) -> list:
    """Every process's (stdout, stderr), each waited for up to
    ``timeout`` s; on a timeout (or any error) every group still running
    is killed, and the call raises."""
    try:
        return [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


def parallel_batch(cfg) -> dict:
    """The global batch of the two-rank check: two batch-1 batches of
    ``train_batch`` (seeds SEED + 3, SEED + 4) stacked, on the card."""
    from ir2rgb_tpu_torch.profile_train import train_batch
    parts = [train_batch(cfg, SEED + 3 + i, "cuda") for i in range(2)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def parallel_section(rank: int, mesh, out: Path) -> None:
    """The parallel phase's gloo check on ranks 0 and 1 of the ranks'
    world (``ranks_main``), on the one card, over ``mesh``: their
    data-parallel mesh of world 2 (``pair_mesh``), then

    - one fp32 step (TF32 off, cuDNN deterministic) of PARALLEL_PRESET at
      full width on its row of the global batch of 2 (``parallel_batch``),
      the state replicated from rank 0; rank 0 holds it to one process's
      grad-accum 2 step of the global batch on the same weights (every
      metric, every gradient and the weights after the step, the
      PARALLEL_* bars) and to its batch-2 step (metrics and weights; the
      gradients' spread reported: cuDNN runs a pair with other
      algorithms than a single image);
    - PARALLEL_STEPS bf16 steps, each one's launches held to ``TRAIN`` at
      batch 1 and timed (CUDA synchronized around it), the gradient
      all-reduce's bytes and seconds read around it, and after each the
      two replicas' weights (and pool) held equal bit for bit (rank 0's
      broadcast and compared on rank 1).

    Writes its results to ``out/rank<rank>.json``; a failed check is in
    its ``failures``."""
    import torch.distributed as dist
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    from ir2rgb_tpu_torch.parallel import replicate, shard_batch
    from ir2rgb_tpu_torch.parallel import mesh as pmesh
    first_failure = len(failures)
    res = {"rank": rank, "backend": dist.get_backend(mesh.group),
           "up_s": time.perf_counter() - T0}
    want = per_step(TRAIN[PARALLEL_PRESET]["unfrozen"])

    # one fp32 step against one process's steps of the global batch of 2,
    # with cuDNN's deterministic algorithms (no atomics in a weight
    # gradient): (1) its grad-accum 2 step, which runs an image per pass
    # as a rank does, at the bars; (2) its batch-2 step, where cuDNN runs
    # the pair with other algorithms and rounding flips a few ReLU / L1
    # units across their kinks: metrics and weights at the bars, the
    # gradients' spread reported
    deterministic = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    dp32, weights = seeded_model(PARALLEL_PRESET, "float32")
    replicate(dp32, mesh)
    glob = parallel_batch(dp32.cfg)
    local = shard_batch(glob, mesh)
    reset_launch_counts()
    m_dp = {k: float(v) for k, v in dp32.train_step(local).items()}
    torch.cuda.synchronize()
    got = launch_counts()
    check(got == want, f"parallel rank {rank} fp32 step: launches {got} "
          f"(want {want}, TRAIN at batch 1)")
    res["fp32_launches"] = got
    if rank == 0:
        dp_params = {n: dict(net.named_parameters())
                     for n, net in nets_of(dp32).items()}
        dp_grads = grads_of(dp32)
        for tag, extra in (("accum2", dict(train=dict(grad_accum=2))),
                           ("batch2", {})):
            one = train_model(PARALLEL_PRESET, "float32", "cuda", weights,
                              **extra)
            m_one = {k: float(v) for k, v in one.train_step(glob).items()}
            want_g = {n: {k: v.cpu() for k, v in g.items()}
                      for n, g in grads_of(one).items()}
            worst = {n: grad_bar(dp_grads[n], want_g[n], PARALLEL_GRAD_REL)
                     for n in want_g}
            equal = all(torch.equal(dp_grads[n][k], g)
                        for n, gs in grads_of(one).items()
                        for k, g in gs.items())
            with torch.no_grad():
                gap = max(float((p - dp_params[n][k]).abs().max())
                          for n, net in nets_of(one).items()
                          for k, p in net.named_parameters())
            rel = {k: abs(m_dp[k] - v) / abs(v) for k, v in m_one.items()}
            res[f"fp32_vs_{tag}"] = dict(metrics_one=m_one, metric_rel=rel,
                                         worst_grad=worst,
                                         grads_bit_equal=equal,
                                         weight_max_abs=gap)
            what = f"parallel fp32 DP step vs one process ({tag})"
            check(set(m_dp) == set(m_one)
                  and max(rel.values()) <= PARALLEL_METRIC_RTOL,
                  f"{what}: metrics rel {rel} (tol {PARALLEL_METRIC_RTOL})")
            check(gap <= PARALLEL_WEIGHT_ATOL, f"{what}: weights after the "
                  f"step max |d| {gap:.3g} (atol {PARALLEL_WEIGHT_ATOL})")
            if tag == "accum2":
                for name, (ratio, key) in worst.items():
                    check(ratio <= 1.0, f"{what}: {name} gradients, worst "
                          f"{key} at {ratio:.3g} of the bar (||d|| <= "
                          f"{PARALLEL_GRAD_REL}·||g|| + 1e-6·M); bit-equal "
                          f"{equal}")
            del one, want_g
            torch.cuda.empty_cache()
        res["fp32_metrics_dp"] = m_dp
        del dp_params, dp_grads
    del dp32
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        deterministic
    res["fp32_done_s"] = time.perf_counter() - T0

    # bf16 steps: launches, time, the all-reduce, the replicas bit-equal
    dp16 = train_model(PARALLEL_PRESET, "bf16", "cuda", weights)
    replicate(dp16, mesh)
    reduce_grads, reduces = pmesh.all_reduce_grads, []

    def timed_reduce(nets, m):
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = reduce_grads(nets, m)
        torch.cuda.synchronize()
        reduces.append((n, time.perf_counter() - t))
        return n
    steps = []
    pmesh.all_reduce_grads = timed_reduce
    try:
        for i in range(PARALLEL_STEPS):
            torch.cuda.synchronize()
            reset_launch_counts()
            t = time.perf_counter()
            m = dp16.train_step(local)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            got = launch_counts()
            check(got == want, f"parallel rank {rank} bf16 step {i}: "
                  f"launches {got} (want {want})")
            check(all(math.isfinite(float(v)) for v in m.values()),
                  f"parallel rank {rank} bf16 step {i}: finite losses")
            state = {n: net.state_dict() for n, net in nets_of(dp16).items()}
            state["pool"] = dp16.state_dict()["pool"]
            diff = first_difference(state, pmesh.broadcast_state(state, mesh))
            check(diff is None, f"parallel rank {rank} bf16 step {i}: the "
                  f"replicas' weights and pool bit-equal (first difference "
                  f"{diff})")
            steps.append({"ms": ms, "launches": got,
                          "allreduce_bytes": reduces[-1][0],
                          "allreduce_ms": reduces[-1][1] * 1e3})
    finally:
        pmesh.all_reduce_grads = reduce_grads
    res["bf16_steps"] = steps
    res["bf16_done_s"] = time.perf_counter() - T0
    res["failures"] = failures[first_failure:]
    with open(out / f"rank{rank}.json", "w") as fh:
        json.dump(res, fh)
    del dp16
    torch.cuda.empty_cache()
    mesh.barrier()


def parallel_phase(card: str) -> dict:
    """Data-parallel training (``ir2rgb_tpu_torch/parallel/``) on the one
    card, PARALLEL_PRESET at full width and its crop size:

    (a) NCCL through the real launcher at world 1: ``torchrun --standalone
        --nproc_per_node 1 -m ir2rgb_tpu_torch.cli.train`` (``python -m
        torch.distributed.run``, the module torchrun runs) for
        PARALLEL_STEPS bf16 steps (``--deterministic``) on the first
        PARALLEL_STEPS pairs of train_cli's PNG folder, and the same
        command without torchrun (``cli.train``'s ``main`` in this
        process, with a fresh process's TF32 and cuDNN settings); the two
        checkpoints equal bit for bit (a one-rank average is the
        identity); ms/step of each from its metrics.jsonl (one record a
        step);
    (b) two ranks on the card over gloo (NCCL puts one rank on a card),
        ranks 0 and 1 of the ranks' world (``ranks_phase``,
        ``parallel_section``), a global batch of 2; read by
        ``parallel_report``.

    The launched run has PARALLEL_TIMEOUT_S; one that fails, hangs or
    exits non-zero fails the phase, and its process group is killed."""
    import shutil
    from ir2rgb_tpu_torch.data import write_synthetic_dataset
    root = Path("build") / "train_cli"
    if not (root / "pairs").exists():
        write_synthetic_dataset(str(root / "pairs"), n=CLI_PAIRS, size=572)
    res = {"preset": PARALLEL_PRESET}
    cli = ["-m", "ir2rgb_tpu_torch.cli.train", "--preset", PARALLEL_PRESET,
           "--model.compute_dtype", "bf16", "--deterministic",
           "--data.dataroot", str(root / "pairs"),
           "--data.max_dataset_size", str(PARALLEL_STEPS),
           "--train.checkpoints_dir", str(root / "parallel"),
           "--train.niter", "1", "--train.niter_decay", "0",
           "--train.niter_fix_global", "0", "--train.print_freq", "1",
           "--train.display_freq", "1000", "--train.save_latest_freq",
           "1000", "--dist_timeout", str(PARALLEL_TIMEOUT_S)]
    runs = ("torchrun_nccl_world1", "one_process")
    t0 = time.perf_counter()
    proc = start_group([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc_per_node", "1"] + cli
                       + ["--train.name", runs[0]])
    [(out, err)] = wait_group([proc], PARALLEL_TIMEOUT_S)
    rc, sec = proc.returncode, time.perf_counter() - t0
    check(rc == 0, f"parallel (a) {runs[0]}: exit {rc}" + (
        "" if rc == 0 else f"\n{err[-3000:]}"))
    # the same run without torchrun, in this process (its kernels built),
    # with a fresh process's TF32 and cuDNN settings, restored after
    from ir2rgb_tpu_torch.cli.train import main as cli_main
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        rc1 = cli_main(cli[2:] + ["--train.name", runs[1]])
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    check(rc1 == 0, f"parallel (a) {runs[1]} (in process): exit {rc1}")
    for name, seconds in zip(runs, (sec, time.perf_counter() - t0)):
        records = [json.loads(x) for x in open(
            root / "parallel" / name / "metrics.jsonl")]
        res[name] = {"seconds": seconds,
                     "steps": [r["step"] for r in records],
                     "ms_per_step": [r["step_time"] * 1e3 for r in records]}
    states = [torch.load(root / "parallel" / n / "ckpt" /
                         f"{PARALLEL_STEPS}.pt", map_location="cpu",
                         weights_only=False, mmap=True) for n in runs]
    for st in states:
        st.pop("config")
    diff = first_difference(*states)
    check(diff is None and states[0]["step"] == PARALLEL_STEPS,
          f"parallel (a): torchrun's NCCL world-1 checkpoint equals the "
          f"plain run's bit for bit (first difference {diff})")
    del states
    a = {n: res[n]["ms_per_step"] for n in runs}
    print(f"parallel (a) {PARALLEL_PRESET} bf16 b1 ({card}): ms/step "
          f"(steps 1-{PARALLEL_STEPS}, metrics.jsonl) torchrun NCCL world 1 "
          f"{[round(x, 2) for x in a['torchrun_nccl_world1']]} (process "
          f"{res[runs[0]]['seconds']:.1f} s), one process "
          f"{[round(x, 2) for x in a['one_process']]} (in process "
          f"{res[runs[1]]['seconds']:.1f} s)", flush=True)

    shutil.rmtree(root, ignore_errors=True)
    return res


def parallel_report(res: dict, folder: Path, card: str) -> None:
    """Part (b) of the parallel phase from its two ranks' results in
    ``folder`` (``parallel_section``), into ``res``."""
    ranks = [json.load(open(folder / f"rank{r}.json")) for r in range(2)]
    res["ranks"] = ranks
    for r in ranks:
        for f in r["failures"]:
            check(False, f"parallel (b) rank {r['rank']}: {f}")
    steps = ranks[0]["bf16_steps"]
    res["launches"] = {k: sum(s["launches"][k] for r in ranks
                              for s in r["bf16_steps"]) for k in PER_STEP}
    print(f"parallel (b) {PARALLEL_PRESET} 2 gloo ranks on one card, global "
          f"batch 2 ({card}; gloo stages CUDA tensors through the host): "
          f"bf16 ms/step {[round(s['ms'], 2) for s in steps]} (rank 0), "
          f"gradient all-reduce {steps[-1]['allreduce_bytes']} bytes in "
          f"{[round(s['allreduce_ms'], 2) for s in steps]} ms", flush=True)
    for tag in ("accum2", "batch2"):
        r = ranks[0][f"fp32_vs_{tag}"]
        print(f"parallel (b) fp32 DP step vs one process {tag}: metrics rel "
              f"max {max(r['metric_rel'].values()):.3g}, worst gradient "
              f"{ {n: [round(v[0], 3), v[1]] for n, v in r['worst_grad'].items()} } "
              f"of the {PARALLEL_GRAD_REL} bar, bit-equal "
              f"{r['grads_bit_equal']}, weights max |d| "
              f"{r['weight_max_abs']:.3g}", flush=True)


# ---------------------------------------------------------------------------
# The spatial phase: spatially partitioned serving on gloo ranks
# ---------------------------------------------------------------------------

def b1_split_phase(bw: float, gen: torch.Generator):
    """B1 split (``ir2rgb::instance_norm_stats`` and
    ``ir2rgb::instance_norm_apply``) at every shard shape of the spatial
    phase's frames (``B1_SPLIT_SHAPES``) and of the spatial_train phase's
    steps (``B1_SPLIT_TRAIN_SHAPES``, checked, not timed), bf16 and fp32,
    each held to its plain version on the card (the statistics to 1e-4
    relative, the
    apply at the fused forward's tolerances) with one device kernel a
    call, the statistics of two calls bit-identical; the statistics of an
    fp32 input of mean 1e3 x its std held to float64 at every shard
    shape (SPLIT_LARGE_MEAN_REL, relative M2); bf16 timed beside the
    plain version, the library's (``torch.var_mean`` over H, W;
    ``(x - mean) * rstd`` + act) and the bound (bytes), the statistics
    also beside the fused forward at the same shape (``fused_ms``) and,
    from SPLIT_COLD_BYTES, on a cold L2 (``cold_ms``, the L2 flushed by
    reads). A bf16 tensor off the 16-byte boundary of the kernel's loads
    must be refused with a ValueError."""
    from ir2rgb_tpu_torch.kernels import instance_norm as b1
    rows, timed_stats, large_mean = [], set(), set()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    # the worst error of each op and dtype: the statistics' (mean, or M2
    # relative), the apply's max |y - plain|; and the large-mean case's
    worst = {(op, d): 0.0 for op in ("stats", "apply")
             for d in ("bfloat16", "float32")}
    worst[("stats", "large mean")] = 0.0
    for (shape, act) in B1_SPLIT_SHAPES + B1_SPLIT_TRAIN_SHAPES:
        n, h, w, c = shape
        timed = (shape, act) in B1_SPLIT_SHAPES
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3
                 + 1).to(dtype)
            mean, m2 = b1.instance_norm_stats(x)
            again = b1.instance_norm_stats(x)
            mean_ref, m2_ref = b1.instance_norm_stats_reference(x.float())
            rstd = torch.rsqrt(m2 / (h * w) + b1.INSTANCE_NORM_EPS)
            y = b1.instance_norm_apply(x, mean, rstd, act)
            y_ref = b1.instance_norm_apply_reference(x.float(), mean, rstd,
                                                     act)
            torch.cuda.synchronize()
            stat_err = max(float((mean - mean_ref).abs().max()),
                           float(((m2 - m2_ref) / m2_ref).abs().max()))
            same = torch.equal(mean, again[0]) and torch.equal(m2, again[1])
            err = float((y.float() - y_ref).abs().max())
            for op, e in (("stats", stat_err), ("apply", err)):
                key = (op, dtype_name(dtype))
                worst[key] = max(worst[key], e)
            plan = b1.stats_plan_for(x)
            tag = (f"B1 split {shape} {act} {dtype_name(dtype)} (stats: "
                   f"{plan.channels} ch x {plan.chunks} chunks of "
                   f"{plan.chunk} px)")
            stats = lambda: b1.instance_norm_stats(x)  # noqa: E731
            apply = lambda: b1.instance_norm_apply(  # noqa: E731
                x, mean, rstd, act)
            kernels = (device_kernels(stats), device_kernels(apply))
            check(stat_err <= 1e-4 and err <= TOL[dtype] and same
                  and kernels == (1, 1),
                  f"{tag}: stats {stat_err:.3g} (tol 1e-4), two calls "
                  f"bit-identical {same}, max|y - plain| {err:.3g} (tol "
                  f"{TOL[dtype]}), {kernels} device kernel(s) per call "
                  "(want 1 each)")
            if dtype == torch.float32 and shape not in large_mean:
                large_mean.add(shape)
                big = (torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.float64) + 1e3).float()
                got = b1.instance_norm_stats(big)
                x64 = big.double()
                mean64 = x64.mean(dim=(1, 2))
                m2_64 = (x64 - mean64[:, None, None]).square().sum(
                    dim=(1, 2))
                rel = float(((got[1].double() - m2_64) / m2_64).abs().max())
                mean_rel = float(((got[0].double() - mean64)
                                  / mean64).abs().max())
                worst[("stats", "large mean")] = max(
                    worst[("stats", "large mean")], rel)
                check(rel <= SPLIT_LARGE_MEAN_REL,
                      f"B1 split stats {shape} float32 at mean 1e3 x std: "
                      f"M2 {rel:.3g} relative to float64 (tol "
                      f"{SPLIT_LARGE_MEAN_REL}), mean {mean_rel:.3g}")
            if dtype != torch.bfloat16 or not timed:
                continue
            x_nchw = x.permute(0, 3, 1, 2)
            xb = x.numel() * x.element_size()
            if shape not in timed_stats:
                timed_stats.add(shape)
                rows.append(dict(
                    name="stats", key=shape, shape=list(shape),
                    dtype=dtype_name(dtype), max_abs_err=stat_err,
                    device_kernels=kernels[0], plan=plan._asdict(),
                    ms=graph_ms(stats),
                    plain_ms=graph_ms(
                        lambda: b1.instance_norm_stats_reference(x)),
                    library_ms=graph_ms(lambda: torch.var_mean(
                        x_nchw, dim=(2, 3), correction=0)),
                    fused_ms=graph_ms(lambda: b1.instance_norm_act(x, act)),
                    cold_ms=(cold_ms(stats, flush, read=True)
                             if xb >= SPLIT_COLD_BYTES else None),
                    eager_ms=cuda_ms(stats),
                    bound_ms=(xb + 2 * n * c * 4) / bw * 1e3))
            m4, r4 = mean[:, None, None], rstd[:, None, None]
            rows.append(dict(
                name="apply", key=(shape, act), shape=list(shape), act=act,
                dtype=dtype_name(dtype), max_abs_err=err,
                device_kernels=kernels[1], ms=graph_ms(apply),
                plain_ms=graph_ms(lambda: b1.instance_norm_apply_reference(
                    x, mean, rstd, act)),
                library_ms=graph_ms(lambda: act_fn((x - m4) * r4, act)),
                eager_ms=cuda_ms(apply),
                bound_ms=(2 * xb + 2 * n * c * 4) / bw * 1e3))
    # a bf16 view 8 bytes off a 16-byte boundary, at a shape whose group
    # of 32 channels the kernel reads 16 bytes a load: refused before the
    # launch, where the loads would fault the card
    shape = B1_SPLIT_SHAPES[0][0]
    buf = torch.zeros(int(np.prod(shape)) + 4, dtype=torch.bfloat16,
                      device="cuda")
    off = buf[4:].view(shape)
    try:
        b1.instance_norm_stats_cuda(off)
        refused = ""
    except ValueError as e:
        refused = str(e)
    check(off.data_ptr() % 16 == 8 and "16-byte aligned" in refused,
          f"B1 split stats {shape} bf16 at {off.data_ptr() % 16} bytes past "
          f"16: refused ({refused or 'launched'})")
    return rows, worst


def crop_of(preset: str) -> int:
    from ir2rgb_tpu_torch.config import PRESETS
    return PRESETS[preset].data.crop_size


def spatial_model(preset: str, dtype: str):
    """``preset`` at full width on the card, built to serve (no VGG), its
    G drawn by ``create_model`` from SEED: the same fp32 weights in every
    process and either dtype."""
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.train import create_model
    cfg = PRESETS[preset]
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype=dtype),
                      loss=dataclasses.replace(cfg.loss, no_vgg_loss=True))
    return create_model(cfg, device="cuda", seed=SEED)


def spatial_frames(preset: str, n: int) -> list:
    """``n`` seeded uint8 frames of ``preset``'s crop size, normalized on
    the card: (1, H, W, C) fp32 each."""
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.infer.stream import _dev_normalize
    cfg = PRESETS[preset]
    hw = (cfg.data.crop_size,) * 2
    rng = np.random.default_rng(SEED + 7)
    return [_dev_normalize(torch.from_numpy(rng.integers(
        0, 256, (1,) + hw + (cfg.model.input_nc,), dtype=np.uint8)).cuda())
        for _ in range(n)]


def spatial_ticks(preset: str) -> list:
    """The server's seeded uint8 frames: one dict {slot: frame} a tick."""
    from ir2rgb_tpu_torch.config import PRESETS
    cfg = PRESETS[preset]
    hw = (cfg.data.crop_size,) * 2
    rng = np.random.default_rng(SEED + 8)
    return [{s: rng.integers(0, 256, hw + (cfg.model.input_nc,),
                             dtype=np.uint8) for s in slots}
            for slots in SPATIAL_TICKS]


def serve_ticks(srv, ticks: list, start=None, end=None) -> tuple:
    """Every tick of ``ticks`` through ``srv.step`` (streams opened in
    slot order), ``start(i)`` before each and ``end(i, start's value)``
    after. Returns (outputs, carries: the server's carry after each
    tick, on the CPU)."""
    sids = [srv.open() for _ in range(SPATIAL_SLOTS)]
    outs, carries = [], []
    for i, t in enumerate(ticks):
        t0 = start(i) if start is not None else None
        outs.append(srv.step({sids[s]: f for s, f in t.items()}))
        if end is not None:
            end(i, t0)
        carries.append(srv._carry.cpu())
    return outs, carries


def spatial_bar(got: torch.Tensor, want: torch.Tensor, dtype: str) -> dict:
    """A partitioned frame (or carry rows) against the one-process one:
    max-abs and PSNR (peak 2), and whether the dtype's bar holds (fp32
    max-abs <= SLICE_FP32_TOL, bf16 >= SPATIAL_BF16_PSNR dB)."""
    got, want = got.float().cpu(), want.float().cpu()
    err, db = float((got - want).abs().max()), psnr(got, want)
    ok = (err <= SLICE_FP32_TOL if dtype == "float32"
          else db >= SPATIAL_BF16_PSNR)
    return dict(max_abs=err, psnr_db=db, ok=ok)


def spatial_refs(folder: Path) -> None:
    """The one-process frames (and carries) of every frame case and of the
    negative control, and the one-process server's outputs and carries,
    written under ``folder`` for the ranks."""
    from ir2rgb_tpu_torch.infer import MultiStreamServer, StreamingGenerator
    cases = {(p, d): n for p, _, ds, n in SPATIAL_CASES for d in ds}
    cases.setdefault(SPATIAL_BROKEN[::2], 1)
    for d in ("float32", "bf16"):
        cases.setdefault((SPATIAL_SERVER, d), 0)
    for (preset, dtype), n in sorted(cases.items()):
        model = spatial_model(preset, dtype)
        hw = (model.cfg.data.crop_size,) * 2
        stream = StreamingGenerator(model, hw)
        frames, carries = [], []
        for a in spatial_frames(preset, n):
            frames.append(stream.push_device(a).cpu())
            carries.append(None if stream.carry is None
                           else stream.carry.cpu())
        torch.save({"frames": frames, "carries": carries},
                   folder / f"ref_{preset}_{dtype}.pt")
        if preset == SPATIAL_SERVER:
            srv = MultiStreamServer(model, hw, n_slots=SPATIAL_SLOTS)
            outs, carries = serve_ticks(srv, spatial_ticks(SPATIAL_SERVER))
            torch.save({"outs": outs, "carries": carries},
                       folder / f"server_{dtype}.pt")
            del srv
        del model, stream
        torch.cuda.empty_cache()


def spatial_section(rank: int, pair, folder: Path) -> None:
    """The spatial phase's cases on the ranks' world (``ranks_main``), gloo
    ranks sharing the one card, by group size: on ranks 0 and 1 (size 2,
    ``pair``) every frame case of SPATIAL_CASES with sp 2 on a dp 1 x sp
    2 mesh (``pair_mesh``), the server on each of SPATIAL_SERVER_MESHES
    and the negative control; then on all four ranks (size 4) every case
    with sp 4 on ``dp_sp_mesh(1, 4)``. Per frame: the
    launches held to ``SPATIAL``, ms (CUDA synchronized around it), the
    exchange's bytes and ms (every ``mesh.all_reduce_bytes``, the
    output's gather included, synchronized around it), the merged B1
    statistics' digest (the first frame of a case, SHA-256 of every
    merged mean and rstd in order), the frame against the one-process
    frame (rank 0: every rank returns the same gathered frame), the
    carry's rows against the one-process carry's (every rank). A
    temporal bf16 frame (or tick) starts from the one-process carry's
    rows before it, as the serve and export phases hold a frame at the
    same carry: with random weights the feedback through the carry
    multiplies a difference ~5x a frame, and free-running bf16 streams
    part whatever the arithmetic (fp32 runs free). Writes
    ``folder/rank<size>_<rank>.json`` for each group it ran in; a failed
    check is in its ``failures``."""
    import hashlib
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    from ir2rgb_tpu_torch.parallel import spatial
    from ir2rgb_tpu_torch.parallel import mesh as pmesh
    xfer, merged = [0, 0.0], []
    reduce_bytes, merge = pmesh.all_reduce_bytes, spatial.merge_stats

    def timed_reduce(t, group, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = reduce_bytes(t, group, device)
        torch.cuda.synchronize()
        xfer[0] += t.numel() * t.element_size()
        xfer[1] += time.perf_counter() - t0
        return y

    def kept_merge(*args):
        mean, rstd = merge(*args)
        merged.append(torch.stack([mean, rstd]).clone())
        return mean, rstd
    pmesh.all_reduce_bytes, spatial.merge_stats = timed_reduce, kept_merge

    def frame_start():
        torch.cuda.synchronize()
        reset_launch_counts()
        xfer[:] = [0, 0.0]
        merged.clear()
        return time.perf_counter()

    def frame_end(t0, rec, want):
        torch.cuda.synchronize()
        got = launch_counts()
        digest = hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in merged)).hexdigest()
        rec.update(ms=(time.perf_counter() - t0) * 1e3, launches=got,
                   exchange_bytes=xfer[0], exchange_ms=xfer[1] * 1e3,
                   merges=len(merged), stats_digest=digest)
        check(got == want, f"spatial {rec['tag']} rank {rank}: launches "
              f"{got} (want {want}, SPATIAL)")

    try:
        for world in (2, 4):
            if rank < world:
                _spatial_group(rank, world, pair, folder, frame_start,
                               frame_end)
    finally:
        pmesh.all_reduce_bytes, spatial.merge_stats = reduce_bytes, merge


def _spatial_group(rank, world, pair, folder, frame_start, frame_end):
    """``spatial_section``'s cases on the group of size ``world``."""
    from ir2rgb_tpu_torch.infer import MultiStreamServer, StreamingGenerator
    from ir2rgb_tpu_torch.parallel import spatial
    first_failure = len(failures)
    res = {"rank": rank, "world": world, "up_s": time.perf_counter() - T0,
           "frames": [], "ticks": []}
    for preset, sp, dtypes, n in SPATIAL_CASES:
        if sp != world:
            continue
        mesh = mesh_of(1, sp, rank, pair)
        h = crop_of(preset) // sp
        for dtype in dtypes:
            model = spatial_model(preset, dtype)
            ref = torch.load(folder / f"ref_{preset}_{dtype}.pt")
            hw = (model.cfg.data.crop_size,) * 2
            stream = StreamingGenerator(model, hw, mesh=mesh)
            torch.cuda.reset_peak_memory_stats()
            for i, a in enumerate(spatial_frames(preset, n)):
                rec = {"tag": f"{preset} sp {sp} {dtype} frame {i}"}
                if stream.carry is not None and dtype == "bf16" and i:
                    stream._carry = ref["carries"][i - 1][
                        :, rank * h:(rank + 1) * h].cuda()
                t0 = frame_start()
                y = stream.push_device(a)
                frame_end(t0, rec, SPATIAL[preset])
                if rank == 0:
                    rec["frame"] = spatial_bar(y, ref["frames"][i], dtype)
                    check(rec["frame"]["ok"] and y.shape == a.shape[:3]
                          + (3,), f"spatial {rec['tag']}: the gathered "
                          f"frame against one process {rec['frame']}")
                if stream.carry is not None:
                    want = ref["carries"][i][:, rank * h:(rank + 1) * h]
                    rec["carry"] = spatial_bar(stream.carry, want, dtype)
                    check(rec["carry"]["ok"], f"spatial {rec['tag']} "
                          f"rank {rank}: its carry rows against one "
                          f"process's {rec['carry']}")
                rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                res["frames"].append(rec)
            del model, stream, ref
            torch.cuda.empty_cache()
    if world == 2:
        ticks = spatial_ticks(SPATIAL_SERVER)
        meshes = [mesh_of(dp, sp, rank, pair)
                  for dp, sp in SPATIAL_SERVER_MESHES]
        for dtype in ("float32", "bf16"):
            model = spatial_model(SPATIAL_SERVER, dtype)
            ref = torch.load(folder / f"server_{dtype}.pt",
                             weights_only=False)
            hw = (model.cfg.data.crop_size,) * 2
            for mesh in meshes:
                dp, sp = mesh.dp, mesh.sp
                want = (SPATIAL if sp > 1 else
                        {p: per_frame(p) for p in SERVE})[SPATIAL_SERVER]
                srv = MultiStreamServer(model, hw, n_slots=SPATIAL_SLOTS,
                                        mesh=mesh)
                recs = []
                b = SPATIAL_SLOTS // dp
                h = crop_of(SPATIAL_SERVER) // sp

                def block(t):
                    return t[mesh.dp_rank * b:(mesh.dp_rank + 1) * b,
                             mesh.sp_rank * h:(mesh.sp_rank + 1) * h]

                def start(i):
                    if dtype == "bf16" and i:
                        srv._carry = block(ref["carries"][i - 1]).cuda()
                    return frame_start()

                def end(i, t0):
                    recs.append({"tag": f"server dp {dp} sp {sp} "
                                        f"{dtype} tick {i}"})
                    frame_end(t0, recs[-1], want)
                outs, carries = serve_ticks(srv, ticks, start, end)
                for i, rec in enumerate(recs):
                    gaps = [u8_gap(outs[i][s], ref["outs"][i][s])
                            for s in ref["outs"][i]]
                    rec["frames"] = gaps
                    ok = (sorted(outs[i]) == sorted(ref["outs"][i]) and (
                        max(g["max_lsb"] for g in gaps) <= 1
                        if dtype == "float32" else min(
                            g["psnr_db"] for g in gaps)
                        >= SPATIAL_BF16_PSNR))
                    rec["carry"] = spatial_bar(
                        carries[i], block(ref["carries"][i]), dtype)
                    check(ok and rec["carry"]["ok"],
                          f"spatial {rec['tag']} rank {rank}: frames "
                          f"{gaps} (fp32 <= 1 LSB, bf16 >= "
                          f"{SPATIAL_BF16_PSNR} dB), carry block "
                          f"{rec['carry']}")
                res["ticks"] += recs
                del srv
            del model
            torch.cuda.empty_cache()

        # the negative control: the row above rank 1's first row, at
        # every layer, taken from the last shard's rows instead
        preset, sp, dtype = SPATIAL_BROKEN
        source = spatial._source

        def wrong(p, n, mode):
            return source(n - 1 if p == n // 2 - 1 else p, n, mode)
        model = spatial_model(preset, dtype)
        ref = torch.load(folder / f"ref_{preset}_{dtype}.pt")
        hw = (model.cfg.data.crop_size,) * 2
        spatial._source = wrong
        spatial.halo_plan.cache_clear()
        try:
            stream = StreamingGenerator(model, hw,
                                        mesh=mesh_of(1, sp, rank, pair))
            y = stream.push_device(spatial_frames(preset, 1)[0])
        finally:
            spatial._source = source
            spatial.halo_plan.cache_clear()
        res["broken"] = spatial_bar(y, ref["frames"][0], dtype)
        check(not res["broken"]["ok"], f"spatial negative control "
              f"({preset} sp {sp} {dtype}, one halo row a layer from the "
              f"wrong shard) fails the bar: {res['broken']}")
        del model, stream
        torch.cuda.empty_cache()
    res["failures"] = failures[first_failure:]
    res["done_s"] = time.perf_counter() - T0
    with open(folder / f"rank{world}_{rank}.json", "w") as fh:
        json.dump(res, fh)




def spatial_phase(card: str, bw: float, gen: torch.Generator,
                  folder: Path) -> dict:
    """Spatially partitioned serving (``parallel/spatial.py``) on the one
    card: B1 split at every shard shape (``b1_split_phase``; B2 at the
    extended tail shapes and d2s at the shard shapes are in the kernel
    phases), then the one-process references (``spatial_refs``) written
    under ``folder`` for the ranks' world (``ranks_phase``,
    ``spatial_section``), whose results ``spatial_report`` reads. The
    ranks are gloo processes sharing one card: their exchanges stage
    through the host, so their times are not a multi-card speedup."""
    t0 = time.perf_counter()
    split_rows, split_worst = b1_split_phase(bw, gen)
    res = {"b1_split_s": time.perf_counter() - t0,
           "b1_split_worst": {f"{op} {d}": v
                              for (op, d), v in split_worst.items()},
           "b1_split_rows": split_rows}
    folder.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    spatial_refs(folder)
    res["refs_s"] = time.perf_counter() - t0
    return res


def spatial_report(res: dict, folder: Path, card: str) -> None:
    """The spatial phase's checks and lines from its ranks' results in
    ``folder`` (``spatial_section``), into ``res``."""
    ranks = [json.load(open(folder / f"rank{world}_{r}.json"))
             for world in (2, 4) for r in range(world)]
    for r in ranks:
        for f in r["failures"]:
            check(False, f"spatial group {r['world']} rank {r['rank']}: {f}")
    # the merged statistics: the same bits on every rank of a case
    for world in (2, 4):
        mine = [r for r in ranks if r["world"] == world]
        for i, rec in enumerate(mine[0]["frames"]):
            digests = {r["frames"][i]["stats_digest"] for r in mine}
            check(len(digests) == 1 and rec["merges"] > 0,
                  f"spatial {rec['tag']}: the {rec['merges']} merged B1 "
                  f"statistics bit-identical on the {world} ranks")
    res["launches"] = dict(sum((Counter(f["launches"]) for r in ranks
                                for f in r["frames"] + r["ticks"]),
                               Counter()))
    res["ranks"] = ranks
    label = f"gloo ranks sharing one card: host staging, not a " \
            f"multi-card speedup ({card})"
    for world in (2, 4):
        mine = [r for r in ranks if r["world"] == world]
        for i, rec in enumerate(mine[0]["frames"]):
            per = [r["frames"][i] for r in mine]
            frame = rec.get("frame", {})
            print(f"spatial {rec['tag']}: ms/frame per rank "
                  f"{[round(f['ms'], 1) for f in per]}, exchange "
                  f"{rec['exchange_bytes']} B in "
                  f"{[round(f['exchange_ms'], 1) for f in per]} ms, peak "
                  f"{max(f['peak_gib'] for f in per):.2f} GiB a rank, "
                  f"max-abs {frame.get('max_abs', float('nan')):.3g}, "
                  f"{frame.get('psnr_db', float('nan')):.2f} dB; {label}",
                  flush=True)
    for rec in next(r for r in ranks if r["world"] == 2 and
                    r["rank"] == 0)["ticks"]:
        print(f"spatial {rec['tag']}: {rec['ms']:.1f} ms, exchange "
              f"{rec['exchange_bytes']} B in {rec['exchange_ms']:.1f} ms, "
              f"worst frame {max(g['max_lsb'] for g in rec['frames'])} LSB / "
              f"{min(g['psnr_db'] for g in rec['frames']):.2f} dB; {label}",
              flush=True)
    broken = next(r for r in ranks if r["world"] == 2 and r["rank"] == 0)
    res["broken"] = broken["broken"]
    print(f"spatial negative control: {broken['broken']}", flush=True)


def b1_split_bwd_phase(bw: float, gen: torch.Generator):
    """The split backward (``ir2rgb::instance_norm_bwd_stats`` and
    ``ir2rgb::instance_norm_bwd_apply``) at every shard shape of the
    spatial_train phase's steps (``sweep_b1.BWD_SHAPES``), bf16 and fp32,
    each held to its plain version on the card (the sums to 1e-4 of their
    largest, and so to their chunked reference, which adds in the plan's
    order; dx at the fused backward's tolerances over max|dx|), one
    device kernel a call, the sums of two calls bit-identical, each row
    with the route its sums plan takes, and each of the three routes
    (one level, one cluster, clusters and tickets) taken; bf16 timed
    (CUDA-graph replay) beside the plain version, the library's (the
    same formula as eager torch in x's dtype) and the bound (bytes: x and
    g read once, dx written once), and on a cold L2 (``cold_ms``, the
    flush read) where x and g reach SPLIT_COLD_BYTES."""
    from ir2rgb_tpu_torch.kernels import instance_norm as b1
    from ir2rgb_tpu_torch.sweep_b1 import BWD_SHAPES
    rows = []
    worst = {(op, d): 0.0 for op in ("sums", "apply")
             for d in ("bfloat16", "float32")}
    routes = Counter()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for (shape, act) in BWD_SHAPES:
        n, h, w, c = shape
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=gen, device="cuda") * 3
                 + 1).to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            x32 = x.float()
            mean = x32.mean(dim=(1, 2)).contiguous()
            rstd = torch.rsqrt(x32.var(dim=(1, 2), unbiased=False)
                               + b1.INSTANCE_NORM_EPS).contiguous()
            # a shard's pixels and those of the rest of the frame
            count = float(h * w * 2)
            sums = b1.instance_norm_bwd_stats(x, mean, rstd, g, act)
            again = b1.instance_norm_bwd_stats(x, mean, rstd, g, act)
            s1, s2 = sums
            r1, r2 = b1.instance_norm_bwd_stats_reference(x, mean, rstd, g,
                                                          act)
            dx = b1.instance_norm_bwd_apply(x, mean, rstd, g, s1, s2, count,
                                            act)
            ref = b1.instance_norm_bwd_apply_reference(x, mean, rstd, g, s1,
                                                       s2, count, act)
            torch.cuda.synchronize()
            sum_err = max(float((s1 - r1).abs().max() / r1.abs().max()),
                          float((s2 - r2).abs().max() / r2.abs().max()))
            same = torch.equal(sums, again)
            err = float((dx.float() - ref.float()).abs().max()
                        / ref.float().abs().max())
            for op, e in (("sums", sum_err), ("apply", err)):
                key = (op, dtype_name(dtype))
                worst[key] = max(worst[key], e)
            plan = b1.bwd_stats_plan_for(x, act)
            routes[plan.route] += 1
            # the sums in the plan's order (chunks, cluster ranks, then
            # the clusters of a slab), plain fp32 within a chunk
            chunked = b1.instance_norm_bwd_stats_chunked_reference(
                x, mean, rstd, g, plan, act)
            chunk_err = float(((sums - chunked).abs().amax(dim=(1, 2))
                               / chunked.abs().amax(dim=(1, 2))).max())

            def sums():
                return b1.instance_norm_bwd_stats(x, mean, rstd, g, act)

            def apply():
                return b1.instance_norm_bwd_apply(x, mean, rstd, g, s1, s2,
                                                  count, act)
            kernels = (device_kernels(sums), device_kernels(apply))
            tag = (f"B1 split bwd {shape} {act} {dtype_name(dtype)} (sums: "
                   f"route {plan.route}, {plan.channels} ch x {plan.chunks} "
                   f"chunks of {plan.chunk} px in clusters of {plan.k})")
            check(sum_err <= 1e-4 and chunk_err <= 1e-4 and err <= TOL[dtype]
                  and same and kernels == (1, 1),
                  f"{tag}: sums {sum_err:.3g} of their largest (tol 1e-4), "
                  f"{chunk_err:.3g} from the chunked order (tol 1e-4), "
                  f"two calls bit-identical {same}, dx {err:.3g} of max|dx| "
                  f"(tol {TOL[dtype]}), {kernels} device kernel(s) per call "
                  "(want 1 each)")
            if dtype != torch.bfloat16:
                continue
            m4, r4 = mean[:, None, None].to(dtype), rstd[:, None, None].to(
                dtype)

            def eager_gp():
                xh = (x - m4) * r4
                gp = (g * (xh > 0) if act == "relu" else
                      torch.where(xh >= 0, g, g * 0.2)
                      if act == "leaky_relu" else g)
                return xh, gp

            def lib_sums():
                xh, gp = eager_gp()
                return gp.sum(dim=(1, 2)), (gp * xh).sum(dim=(1, 2))
            a4 = (s1 / count)[:, None, None].to(dtype)
            b4 = (s2 / count)[:, None, None].to(dtype)

            def lib_apply():
                xh, gp = eager_gp()
                return r4 * (gp - a4 - xh * b4)
            xb = x.numel() * x.element_size()
            stats_b = 4 * n * c * 4
            cold = 2 * xb >= SPLIT_COLD_BYTES
            rows.append(dict(
                name="sums", key=(shape, act), shape=list(shape), act=act,
                dtype=dtype_name(dtype), max_abs_err=sum_err,
                chunked_err=chunk_err,
                device_kernels=kernels[0], plan=plan._asdict(),
                ms=graph_ms(sums),
                cold_ms=cold_ms(sums, flush, read=True) if cold else None,
                plain_ms=graph_ms(lambda: b1.instance_norm_bwd_stats_reference(
                    x, mean, rstd, g, act)),
                library_ms=graph_ms(lib_sums),
                bound_ms=(2 * xb + stats_b) / bw * 1e3))
            rows.append(dict(
                name="apply", key=(shape, act), shape=list(shape), act=act,
                dtype=dtype_name(dtype), max_abs_err=err,
                device_kernels=kernels[1],
                ms=graph_ms(apply),
                cold_ms=cold_ms(apply, flush, read=True) if cold else None,
                plain_ms=graph_ms(
                    lambda: b1.instance_norm_bwd_apply_reference(
                        x, mean, rstd, g, s1, s2, count, act)),
                library_ms=graph_ms(lib_apply),
                bound_ms=(3 * xb + stats_b) / bw * 1e3))
    check(all(routes[r] for r in ("one", "cluster", "tickets")),
          f"B1 split bwd: the sums plans take every route (one level, one "
          f"cluster, clusters and tickets): {dict(routes)}")
    return rows, worst


def spatial_train_batch(cfg, n: int) -> dict:
    """The global batch of ``n`` frames of the spatial_train phase: ``n``
    batch-1 batches of ``train_batch`` (seeds SEED + 3 ...) stacked, on
    the card."""
    from ir2rgb_tpu_torch.profile_train import train_batch
    parts = [train_batch(cfg, SEED + 3 + i, "cuda") for i in range(n)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def spatial_train_section(rank: int, pair, folder: Path) -> None:
    """The spatial_train phase's cases on the ranks' world
    (``ranks_main``), gloo ranks sharing the one card, by group size:
    every case of SPATIAL_TRAIN_CASES with ``dp * sp == 2`` on its pair of
    ranks (``pair_of``: ranks 0 and 1, with the negative control, beside
    ranks 2 and 3; ``pair_mesh``), then every case with ``dp * sp == 4``
    on all four (``dp_sp_mesh``), from seeded weights replicated from the
    mesh's rank 0 (cuDNN deterministic, TF32 off). Each step:
    the launches held to ``SPATIAL_TRAIN`` (``spatial_per_step``; with
    remat the blocks' norms run forward again in the backward), ms (CUDA
    synchronized around it), the exchange's bytes, calls and ms (halos,
    statistics and sums, a remat recompute's replayed ones included), the
    gradient all-reduce's bytes, the digests of the merged B1 statistics
    and of the summed backward sums (SHA-256 in order; the parent holds
    them equal on every rank of a data row), peak memory, finite losses.
    The mesh's rank 0 of a case with a reference runs one process's step
    of the global batch (a temporal preset's window) from the same train
    state after each step (an fp32 one pinned to the partitioned forward
    point, ``ShardPins``, frame by frame; a bf16 one beside one process's
    fp32 step, the bf16 bar's yardstick) and holds the partitioned step to
    it at SPATIAL_TRAIN_BARS; a remat case's reference is one process's
    step without remat (the recompute records no pins). A WGAN-GP step
    also holds D_GP > 0 and finite and, in fp32, D's gradient from D_GP
    alone (``gp_alone``: summed over the ranks) to one process's at the
    pinned point; a CycleGAN's step its two pools to one process's (fp32
    within SLICE_FP32_TOL, bf16 >= BF16_MIN_PSNR dB). A remat case's step is
    also held to the same case's step without remat, run before it from
    the same state: losses bit for bit, every gradient within
    REMAT_GRAD_ATOL. On the group of 2 the negative control follows: one
    fp32 step with one halo row a layer from the wrong shard, which must
    fail the bars. Writes ``folder/train<size>_<rank>.json`` for each
    group size it ran in (its ranks in ``group``); a failed check is in
    its ``failures``."""
    import hashlib
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    from ir2rgb_tpu_torch.parallel import replicate, shard_batch, spatial
    from ir2rgb_tpu_torch.parallel import mesh as pmesh
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    # bytes, seconds and calls of the exchange
    xfer, grads_xfer, merged = [0, 0.0, 0], [0], []
    reduce_bytes = pmesh.all_reduce_bytes
    merge, sum_stats = spatial.merge_stats, spatial.Shards.sum_stats
    reduce_grads = pmesh.all_reduce_grads

    def timed_reduce(t, group, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = reduce_bytes(t, group, device)
        torch.cuda.synchronize()
        xfer[0] += t.numel() * t.element_size()
        xfer[1] += time.perf_counter() - t0
        xfer[2] += 1
        return y

    def kept_merge(*args):
        mean, rstd = merge(*args)
        merged.append(torch.stack([mean, rstd]).clone())
        return mean, rstd

    def kept_sums(self, t):
        total = sum_stats(self, t)
        merged.append(total.clone())
        return total

    def counted_grads(nets, mesh):
        grads_xfer[0] = reduce_grads(nets, mesh)
        return grads_xfer[0]
    pmesh.all_reduce_bytes, spatial.merge_stats = timed_reduce, kept_merge
    spatial.Shards.sum_stats = kept_sums
    pmesh.all_reduce_grads = counted_grads

    def step(model, batch, tag, want, hook=None):
        """One train step; ``hook``: a :func:`gp_alone` list, whose
        launches are not the step's."""
        torch.cuda.synchronize()
        reset_launch_counts()
        xfer[:] = [0, 0.0, 0]
        merged.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in model.train_step(batch).items()}
        torch.cuda.synchronize()
        launches = Counter(launch_counts())
        launches.subtract(sum((h[1] for h in hook or ()), Counter()))
        rec = {"tag": tag, "ms": (time.perf_counter() - t0) * 1e3,
               "launches": dict(launches), "metrics": m,
               "exchange_bytes": xfer[0], "exchange_ms": xfer[1] * 1e3,
               "exchanges": xfer[2],
               "allreduce_bytes": grads_xfer[0], "merges": len(merged),
               "digest": hashlib.sha256(b"".join(
                   t.cpu().numpy().tobytes() for t in merged)).hexdigest(),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        check(rec["launches"] == want, f"spatial_train {tag} rank {rank}: "
              f"launches {rec['launches']} (want {want}, SPATIAL_TRAIN)")
        check(all(math.isfinite(v) for v in m.values()),
              f"spatial_train {tag} rank {rank}: finite losses {m}")
        return rec

    def flat_grads(m):
        return {n: torch.cat([v.detach().reshape(-1).float().cpu()
                              for v in g.values()])
                for n, g in grads_of(m).items()}

    def versus(model, ref_m, ref, tag, dtype, ref32=None):
        """The partitioned step (metrics of ``model``'s last step) against
        one process's (``ref_m``, ``ref``'s gradients; ``ref32``: one
        process's fp32 step of the same state, the bf16 bar's yardstick)."""
        loss_rel, grad_rel = SPATIAL_TRAIN_BARS[dtype]
        got = res["steps"][-1]["metrics"]
        rel = {k: abs(got[k] - v) / max(abs(v), 1e-12)
               for k, v in ref_m.items()}
        want_g = {n: {k: v.cpu() for k, v in g.items()}
                  for n, g in grads_of(ref).items()}
        mine = grads_of(model)
        worst = {n: grad_bar(mine[n], want_g[n], grad_rel) for n in want_g}
        a, b = flat_grads(model), flat_grads(ref)
        whole = {n: float((a[n] - b[n]).norm() / b[n].norm()) for n in b}
        out = dict(tag=tag, metric_rel=rel, worst_grad=worst,
                   net_grad_rel=whole)
        if ref32 is None:
            grads_ok = all(r <= 1.0 for r, _ in worst.values())
        else:
            c = flat_grads(ref32)
            floor = {n: float((b[n] - c[n]).norm() / b[n].norm()) for n in b}
            out["bf16_vs_fp32_rel"] = floor
            grads_ok = all(whole[n] <= grad_rel * floor[n] for n in b)
        out["ok"] = (set(got) == set(ref_m) and max(rel.values()) <= loss_rel
                     and grads_ok)
        return out

    def shared_pins(pins, mesh):
        """Rank 0: one process's pins from every rank's records (through
        files in ``folder``): a data row's rows joined, the data rows
        joined along the batch (``KinkPins``' merge); None elsewhere.
        The partitioned forward is a ~1e-7 rounding away from one
        process's, and the step's gradient is piecewise smooth: ReLU,
        LeakyReLU and the L1 losses' signs (the VGG loss an L1 of ReLU
        features) flip across their kinks and move a gradient by ~1%
        (ROADMAP §C, traps for comparisons), so one process replays the
        partitioned forward point (:class:`KinkPins`)."""
        if mesh.rank:
            torch.save((pins.saved, pins.stats),
                       folder / f"pins{world}_{rank}.pt")
        mesh.barrier()
        if mesh.rank:
            return None
        recs = [(pins.saved, pins.stats)] + [
            torch.load(folder / f"pins{world}_{rank + r}.pt")
            for r in range(1, world)]
        rows = [ShardPins.whole(recs[d * mesh.sp:(d + 1) * mesh.sp])
                for d in range(mesh.dp)]
        out = rows[0]
        for more in rows[1:]:
            out.saved += more.saved
            out.stats += more.stats
        out.merge = mesh.dp
        return out

    # the seeded weights of each preset and rank 0's one-process models,
    # (preset, dtype, variant) -> model, made once and reloaded with the
    # step's state before each reference step
    weights_of, kept = {}, {}

    def sections_of(remat=False, gp=False):
        out = dict(model=dict(remat=remat))
        if gp:
            out["loss"] = dict(gan_mode="wgangp")
        return out

    def seeded(preset, dtype, remat=False, gp=False):
        sections = sections_of(remat, gp)
        if preset not in weights_of:
            model, weights_of[preset] = seeded_model(preset, dtype,
                                                     **sections)
            return model
        return train_model(preset, dtype, "cuda", weights_of[preset],
                           **sections)

    def one_process(preset, dtype, variant, gp=False):
        key = (preset, dtype, variant, gp)
        if key not in kept:
            kept[key] = train_model(preset, dtype, "cuda",
                                    weights_of[preset],
                                    **sections_of(gp=gp))
        return kept[key]

    def gp_alone(model):
        """Wrap ``model``'s ``loss_and_metrics`` to take D's gradient from
        the D_GP term alone in each pass, before the step's backward: a
        list of (the gradients, the kernel launches they took)."""
        out, inner = [], model.loss_and_metrics

        def wrapped(batch, freeze_trunk=False):
            loss_g, loss_d, m = inner(batch, freeze_trunk)
            before = Counter(launch_counts())
            names, params = zip(*model.netD.named_parameters())
            got = torch.autograd.grad(m["D_GP"], params, retain_graph=True,
                                      allow_unused=True)
            launches = Counter(launch_counts())
            launches.subtract(before)
            out.append(({k: torch.zeros_like(p) if g is None else g.detach()
                         for k, p, g in zip(names, params, got)}, launches))
            return loss_g, loss_d, m
        model.loss_and_metrics = wrapped
        return out

    def summed(grads, mesh):
        """A partitioned step's per-rank gradients summed over the ranks
        and divided by ``dp``, as ``all_reduce_grads`` does."""
        import torch.distributed as dist
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.dp
        out, i = {}, 0
        for k, g in grads.items():
            out[k] = flat[i:i + g.numel()].view_as(g)
            i += g.numel()
        return out

    def pools_versus(model, one, dtype):
        """A CycleGAN's pools (whole frames on every rank) against one
        process's after the same step."""
        out = {}
        for k, p in model.pool.items():
            q = one.pool[k]
            n = int(q.count)
            a, b = p.buffer[:n].float(), q.buffer[:n].float()
            out[k] = dict(count=(int(p.count), n),
                          max_abs=float((a - b).abs().max()),
                          psnr=psnr(a, b))
        ok = all(v["count"][0] == v["count"][1] > 0 and (
            v["max_abs"] <= SLICE_FP32_TOL if dtype == "float32"
            else v["psnr"] >= BF16_MIN_PSNR) for v in out.values())
        return dict(out, ok=ok)

    import torch.distributed as dist
    # ranks 2 and 3's pair (every rank of the world makes the group)
    pairs = (pair, dist.new_group([2, 3]))
    try:
        for world in (2, 4):
            first_failure = len(failures)
            mine = rank // 2 if world == 2 else 0
            base = 2 * mine if world == 2 else 0
            res = {"rank": rank, "world": world,
                   "group": list(range(base, base + world)),
                   "up_s": time.perf_counter() - T0, "steps": [],
                   "one_process_peak_gib": {}}
            # the gradients and metrics of each plain case that a remat
            # case follows, by (preset, dp, sp, dtype, step)
            plain = {}
            remat_cases = {c[:3] for c in SPATIAL_TRAIN_CASES if c[5]}
            for case in SPATIAL_TRAIN_CASES:
                preset, dp, sp, dtypes, steps, remat, gp = case
                if dp * sp != world or (world == 2
                                        and pair_of(case) != mine):
                    continue
                # one preset's one-process models at a time
                for key in [k for k in kept if k[0] != preset]:
                    del kept[key]
                torch.cuda.empty_cache()
                mesh = mesh_of(dp, sp, rank - base, pairs[mine])
                want = spatial_per_step(SPATIAL_TRAIN[(
                    preset, dp, sp, remat, gp, mesh.sp_rank)])
                for dtype in dtypes:
                    model = seeded(preset, dtype, remat, gp)
                    replicate(model, mesh)
                    glob = spatial_train_batch(model.cfg, dp)
                    local = shard_batch(glob, mesh)
                    timed = preset in SPATIAL_TRAIN_TIMED
                    refs = [] if mesh.rank or timed else ["one"]
                    ones = {t: one_process(preset, dtype, t, gp)
                            for t in refs}
                    one32 = (one_process(preset, "float32", "one", gp)
                             if ones and dtype == "bf16" else None)
                    for i in range(steps):
                        # the references start from the step's train state
                        for one in (*ones.values(), one32):
                            if one is not None:
                                one.load_state_dict(model.state_dict())
                        tag = (f"{preset}{' wgangp' if gp else ''} dp "
                               f"{dp} sp {sp} {dtype}"
                               f"{' remat' if remat else ''} step {i}")
                        # bf16 is held to one process's bf16-vs-fp32
                        # spread, which dwarfs the kinks: its references
                        # run unpinned
                        pins = (ShardPins() if not timed
                                and dtype == "float32" else None)
                        # D's gradient from D_GP alone, fp32 (pinned)
                        hook = (gp_alone(model) if gp and pins is not None
                                else None)
                        with (pins.recording() if pins is not None
                              else contextlib.nullcontext()):
                            res["steps"].append(step(model, local, tag,
                                                     want, hook))
                        rec = res["steps"][-1]
                        rec.update(case=(preset, dp, sp, dtype, remat, gp),
                                   i=i)
                        if gp:
                            check(rec["metrics"]["D_GP"] > 0,
                                  f"spatial_train {tag} rank {rank}: D_GP "
                                  f"{rec['metrics']['D_GP']} > 0")
                        if hook is not None:
                            del model.loss_and_metrics
                            gp_got = summed(hook[0][0], mesh)
                        key = (preset, dp, sp, dtype, i)
                        if not remat and (preset, dp, sp) in remat_cases:
                            plain[key] = (rec["metrics"], flat_grads(model))
                        elif key in plain:
                            rec["remat_vs_plain"] = remat_versus(
                                rec["metrics"], flat_grads(model),
                                *plain.pop(key))
                            check(rec["remat_vs_plain"]["ok"],
                                  f"spatial_train {tag} rank {rank} against "
                                  f"the step without remat: "
                                  f"{rec['remat_vs_plain']}")
                        replay = shared_pins(pins, mesh) if pins else None
                        ref_m = {}
                        for t, one in ones.items():
                            one_hook = (gp_alone(one) if hook is not None
                                        else None)
                            with (replay.replaying() if replay
                                  else contextlib.nullcontext()):
                                ref_m[t] = {k: float(v) for k, v in
                                            one.train_step(glob).items()}
                            check(replay is None or replay.all_replayed(),
                                  f"spatial_train {tag} vs {t}: every pin "
                                  "replayed")
                            if one_hook is not None:
                                del one.loss_and_metrics
                                worst = grad_bar(
                                    gp_got, {k: v.cpu() for k, v in
                                             one_hook[0][0].items()},
                                    SPATIAL_TRAIN_BARS[dtype][1])
                                rec["d_from_gp_" + t] = worst
                                check(worst[0] <= 1.0, f"spatial_train "
                                      f"{tag} vs {t}: D's gradient from "
                                      f"D_GP alone, worst {worst[1]} at "
                                      f"{worst[0]:.3g} of the bar")
                        if one32 is not None:
                            one32.train_step(glob)
                        for t, one in ones.items():
                            v = versus(model, ref_m[t], one,
                                       f"{tag} vs {t}", dtype, one32)
                            if isinstance(model.pool, dict):
                                v["pools"] = pools_versus(model, one, dtype)
                                v["ok"] = v["ok"] and v["pools"]["ok"]
                            rec["vs_" + t] = v
                            check(v["ok"], f"spatial_train {v['tag']}: "
                                  f"metrics rel {v['metric_rel']}, worst "
                                  f"gradient tensor {v['worst_grad']}, each "
                                  f"network's {v['net_grad_rel']}"
                                  f"{', pools ' + str(v['pools']) if 'pools' in v else ''}"
                                  f" (bars {SPATIAL_TRAIN_BARS[dtype]})")
                        del pins, replay, hook
                    del model
                    torch.cuda.empty_cache()
                    if timed and preset in ONE_PROCESS_PEAK:
                        if rank == 0:
                            res["one_process_peak_gib"][preset] = \
                                one_process_peak(preset, dtype,
                                                 weights_of[preset], glob)
                        mesh.barrier()
            if world == 2 and mine == 0:
                # the negative control: the row above rank 1's first row,
                # at every layer, taken from the last shard's rows instead
                preset, sp, dtype = SPATIAL_TRAIN_BROKEN
                mesh = mesh_of(1, sp, rank, pair)
                model = seeded(preset, dtype)
                replicate(model, mesh)
                glob = spatial_train_batch(model.cfg, 1)
                local = shard_batch(glob, mesh)
                source = spatial._source

                def wrong(p, n, mode):
                    return source(n - 1 if p == n // 2 - 1 else p, n, mode)
                one = None
                if rank == 0:
                    for key in [k for k in kept if k[0] != preset]:
                        del kept[key]
                    one = one_process(preset, dtype, "one")
                    one.load_state_dict(model.state_dict())
                spatial._source = wrong
                spatial.halo_plan.cache_clear()
                try:
                    res["steps"].append(step(
                        model, local, "negative control",
                        spatial_per_step(SPATIAL_TRAIN[(
                            preset, 1, sp, False, False, mesh.sp_rank)])))
                finally:
                    spatial._source = source
                    spatial.halo_plan.cache_clear()
                if rank == 0:
                    ref_m = {k: float(v) for k, v in
                             one.train_step(glob).items()}
                    res["broken"] = versus(model, ref_m, one,
                                           "negative control", dtype)
                    check(not res["broken"]["ok"], "spatial_train negative "
                          f"control ({preset} sp {sp} {dtype}, one halo row "
                          "a layer from the wrong shard) fails the bars: "
                          f"{res['broken']}")
                del model, one
            kept.clear()
            torch.cuda.empty_cache()
            res["failures"] = failures[first_failure:]
            res["done_s"] = time.perf_counter() - T0
            with open(folder / f"train{world}_{rank}.json", "w") as fh:
                json.dump(res, fh)
    finally:
        pmesh.all_reduce_bytes, spatial.merge_stats = reduce_bytes, merge
        spatial.Shards.sum_stats = sum_stats
        pmesh.all_reduce_grads = reduce_grads
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def one_process_peak(preset: str, dtype: str, weights, batch) -> float:
    """Peak memory (GiB) of two steps of ``preset`` in one process on the
    card, without remat, from ``weights`` on the global ``batch``."""
    model = train_model(preset, dtype, "cuda", weights)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        model.train_step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model
    torch.cuda.empty_cache()
    return peak


def remat_versus(metrics: dict, grads: dict, plain_metrics: dict,
                 plain_grads: dict) -> dict:
    """A remat step against the same step without remat (flat gradients a
    network): its losses bit for bit, every gradient element within
    REMAT_GRAD_ATOL (JAX's bar for remat, ``tests/test_variants.py:83``),
    and whether they are bit for bit."""
    gap = {n: float((grads[n] - g).abs().max()) for n, g in
           plain_grads.items()}
    same = all(torch.equal(grads[n], g) for n, g in plain_grads.items())
    losses = metrics == plain_metrics
    return dict(losses_equal=losses, grad_max_abs=gap, grads_bit_equal=same,
                ok=losses and max(gap.values()) <= REMAT_GRAD_ATOL)


def start_train_cli(folder: Path):
    """Start ``torchrun`` of ``cli.train --train.spatial_devices 2`` (gloo,
    world 2, the one card) for two steps of SPATIAL_TRAIN_CLI from a
    folder of two synthetic pairs; (the process, its run directory)."""
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.data import write_synthetic_dataset
    cfg = PRESETS[SPATIAL_TRAIN_CLI]
    data = folder / "data"
    write_synthetic_dataset(str(data), n=2, size=cfg.data.load_size)
    proc = start_group([
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", "2", "-m", "ir2rgb_tpu_torch.cli.train",
        "--preset", SPATIAL_TRAIN_CLI, "--model.compute_dtype", "bf16",
        "--train.spatial_devices", "2", "--dist_backend", "gloo",
        "--data.dataroot", str(data), "--data.batch_size", "1",
        "--train.name", "sp_cli", "--train.checkpoints_dir",
        str(folder / "runs"), "--train.niter", "1", "--train.niter_decay",
        "0", "--train.print_freq", "1", "--dist_timeout",
        str(CLI_TIMEOUT_S)])
    return proc, folder / "runs" / "sp_cli"


def finish_train_cli(proc, run: Path) -> dict:
    """Wait for :func:`start_train_cli`'s run and read rank 0's checkpoint
    of step 2 back."""
    (o, e), = wait_group([proc], CLI_TIMEOUT_S)
    res = {"exit": proc.returncode}
    ckpt = run / "ckpt" / "2.pt"
    res["checkpoint"] = ckpt.exists()
    if ckpt.exists():
        state = torch.load(ckpt, map_location="cpu", weights_only=False)
        res["step"] = int(state["step"])
        res["finite"] = all(bool(torch.isfinite(v).all())
                            for v in state["netG"].values())
    res["loss_lines"] = (sum(1 for _ in open(run / "loss_log.txt"))
                         if (run / "loss_log.txt").exists() else 0)
    check(proc.returncode == 0 and res.get("step") == 2
          and res.get("finite") and res["loss_lines"] > 0,
          f"spatial_train cli.train on sp 2 (torchrun, gloo): {res}"
          + ("" if proc.returncode == 0 else f"\n{o[-3000:]}\n{e[-3000:]}"))
    return res


def spatial_train_phase(card: str, bw: float, gen: torch.Generator) -> dict:
    """Spatially partitioned training (``parallel/spatial.py`` under
    autograd) on the one card: the split backward's kernels at every
    shard shape (``b1_split_bwd_phase``); its steps run on the ranks'
    world (``ranks_phase``, ``spatial_train_section``), whose results
    ``spatial_train_report`` reads."""
    t0 = time.perf_counter()
    rows, worst = b1_split_bwd_phase(bw, gen)
    return {"b1_split_bwd_s": time.perf_counter() - t0,
            "b1_split_bwd_worst": {f"{op} {d}": v
                                   for (op, d), v in worst.items()},
            "b1_split_bwd_rows": rows}


def spatial_train_report(res: dict, folder: Path, card: str) -> None:
    """The spatial_train phase's checks and lines from its ranks' results
    in ``folder`` (``spatial_train_section``), into ``res`` (the cli
    run's, ``res["cli"]``, read by ``ranks_phase``)."""
    ranks = [json.load(open(folder / f"train{world}_{r}.json"))
             for world in (2, 4) for r in range(RANKS_WORLD)]
    for r in ranks:
        for f in r["failures"]:
            check(False, f"spatial_train group {r['group']} rank "
                  f"{r['rank']}: {f}")
    # each group of ranks that ran the same cases, in rank order
    groups = [[r for r in ranks if r["world"] == world
               and r["group"][0] == base]
              for world, base in ((2, 0), (2, 2), (4, 0))]
    # the merged statistics and backward sums: the same bits on every
    # rank of a data row (all of a group's ranks when dp is 1)
    for mine in groups:
        world = len(mine)
        for i, rec in enumerate(mine[0]["steps"]):
            dp = rec.get("case", (None, 1))[1]
            for d in range(dp):
                row = mine[d * (world // dp):(d + 1) * (world // dp)]
                digests = {r["steps"][i]["digest"] for r in row}
                check(len(digests) == 1 and rec["merges"] > 0,
                      f"spatial_train {rec['tag']}: the {rec['merges']} "
                      f"merged statistics and sums bit-identical on data "
                      f"row {d}'s ranks")
            calls = [r["steps"][i]["exchanges"] for r in mine]
            check(len(set(calls)) == 1, f"spatial_train {rec['tag']}: "
                  f"every rank makes the same exchanges {calls}")
    res["launches"] = dict(sum((Counter(s["launches"]) for r in ranks
                                for s in r["steps"]
                                if s["tag"] != "negative control"),
                               Counter()))
    res["ranks"] = ranks
    label = f"gloo ranks sharing one card: host staging, not a " \
            f"multi-card speedup ({card})"
    for mine in groups:
        for i, rec in enumerate(mine[0]["steps"]):
            per = [r["steps"][i] for r in mine]
            vs = {k: (max(v["metric_rel"].values()),
                      {n: w[0] for n, w in v["worst_grad"].items()},
                      v["net_grad_rel"], v.get("pools"))
                  for k, v in rec.items() if k.startswith("vs_")}
            vs.update({k: v for k, v in rec.items()
                       if k.startswith("d_from_gp_")})
            one = mine[0]["one_process_peak_gib"].get(
                rec.get("case", [""])[0])
            print(f"spatial_train {rec['tag']}: ms/step per rank "
                  f"{[round(s['ms'], 1) for s in per]}, exchange "
                  f"{rec['exchange_bytes']} B in {rec['exchanges']} calls, "
                  f"{[round(s['exchange_ms'], 1) for s in per]} ms, gradient "
                  f"all-reduce {rec['allreduce_bytes']} B, peak a rank "
                  f"{[round(s['peak_gib'], 2) for s in per]} GiB"
                  + ("" if one is None else
                     f" (one process, no remat: {one:.2f} GiB)")
                  + f"; against one process (worst loss rel, worst gradient "
                  f"tensor's share of the bar, each network's ||d||/||g||, "
                  f"the pools; D's gradient from D_GP alone):"
                  f" {vs}" + ("" if "remat_vs_plain" not in rec else
                              f"; against the step without remat "
                              f"{rec['remat_vs_plain']}") + f"; {label}",
                  flush=True)
    broken = next(r for r in ranks if r["world"] == 2 and r["rank"] == 0)
    res["broken"] = broken["broken"]
    print(f"spatial_train negative control: {broken['broken']}", flush=True)
    for r in res["b1_split_bwd_rows"]:
        print(f"  B1 split bwd {r['name']} {r['shape']} {r['act']:10s} ms "
              f"{r['ms']:.4f} plain {r['plain_ms']:.4f} lib "
              f"{r['library_ms']:.4f} bound {r['bound_ms']:.4f}")


# ---------------------------------------------------------------------------
# The ranks' world: the parallel, spatial and spatial_train phases' gloo
# ranks, one group of processes for all three
# ---------------------------------------------------------------------------

RANKS_WORLD = 4


def pair_mesh(pair, rank: int, dp: int, sp: int):
    """``dp_sp_mesh(dp, sp)``'s layout (``dp * sp == 2``) over ranks 0 and
    1 of the ranks' world, whose group is ``pair``: a data-parallel mesh
    of two for sp 1, a dp 1 x sp 2 mesh (``pair`` its sp group) else."""
    from ir2rgb_tpu_torch.parallel import DataParallelMesh
    if dp * sp != 2:
        raise ValueError(f"a pair of ranks holds no dp {dp} x sp {sp} mesh")
    return DataParallelMesh(2, rank, 0, torch.device("cuda:0"), pair, sp=sp,
                            sp_group=pair if sp == 2 else None)


def mesh_of(dp: int, sp: int, rank: int, pair):
    """The dp×sp mesh of a case: over ranks 0 and 1 (``pair_mesh``) for
    two ranks, ``dp_sp_mesh`` over the whole world for four (every rank
    must then call it, in the same order)."""
    from ir2rgb_tpu_torch.parallel import dp_sp_mesh
    if dp * sp == 2:
        return pair_mesh(pair, rank, dp, sp)
    return dp_sp_mesh(dp, sp, device="cuda:0")


def ranks_main(rank: int, port: int, out: str) -> int:
    """One of the RANKS_WORLD gloo ranks on the one card (``chip_smoke.py
    --ranks R PORT DIR``): up once, then the parallel phase's two ranks
    (``parallel_section``, ranks 0 and 1), the spatial phase's cases
    (``spatial_section``) and the spatial_train phase's
    (``spatial_train_section``), the world's barrier after each; each
    section's seconds on this rank in ``DIR/ranks<rank>.json``. Exits 1
    on a failed check."""
    import torch.distributed as dist
    from ir2rgb_tpu_torch import set_parity_mode
    from ir2rgb_tpu_torch.parallel import multihost
    warnings.filterwarnings("ignore", message="VGG perceptual loss")
    folder = Path(out)
    torch.cuda.set_device(0)
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=RANKS_WORLD, process_id=rank,
                         backend="gloo", timeout_s=RANKS_TIMEOUT_S)
    set_parity_mode()
    # every rank makes the pair's group, ranks 0 and 1 use it
    pair = dist.new_group([0, 1])
    res = {"rank": rank, "up_s": time.perf_counter() - T0, "seconds": {}}
    for name, section in (("parallel", parallel_section),
                          ("spatial", spatial_section),
                          ("spatial_train", spatial_train_section)):
        t0 = time.perf_counter()
        if name != "parallel":
            section(rank, pair, folder / name)
        elif rank < 2:
            section(rank, pair_mesh(pair, rank, 2, 1), folder / name)
        torch.cuda.empty_cache()
        dist.barrier()
        res["seconds"][name] = time.perf_counter() - t0
    res["failures"] = list(failures)
    with open(folder / f"ranks{rank}.json", "w") as fh:
        json.dump(res, fh)
    dist.barrier()
    dist.destroy_process_group()
    return 1 if failures else 0


def start_ranks(folder: Path) -> tuple:
    """Start the ranks' world (``ranks_main``, RANKS_WORLD processes
    sharing the one card over gloo) on ``folder``, which holds the spatial
    phase's references, and beside it one torchrun of cli.train on sp 2
    (``start_train_cli``): (the cli run, the ranks, the start)."""
    import socket
    (folder / "parallel").mkdir(parents=True, exist_ok=True)
    (folder / "spatial_train").mkdir(parents=True, exist_ok=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    cli = start_train_cli(folder / "cli")
    procs = [start_group([sys.executable, __file__, "--ranks", str(r),
                          str(port), str(folder)])
             for r in range(RANKS_WORLD)]
    return cli, procs, t0


def ranks_phase(card: str, parallel: dict, spatial: dict,
                spatial_train: dict, folder: Path, started: tuple) -> None:
    """Wait for the ranks' world (``start_ranks``, RANKS_TIMEOUT_S) and the
    torchrun of cli.train beside it (the sections' times are then not a
    lone group's, nor are the parallel section's beside the parallel
    phase's torchrun); then each phase's report into its result:
    ``parallel`` (b), ``spatial``, ``spatial_train`` (with ``cli``), and
    each section's seconds (rank 0's) as ``ranks_s``."""
    cli, procs, t0 = started
    try:
        outs = wait_group(procs, RANKS_TIMEOUT_S)
    finally:
        spatial_train["cli"] = finish_train_cli(*cli)
        spatial_train["cli_s"] = time.perf_counter() - t0
    lost = False
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        path = folder / f"ranks{r}.json"
        lost |= not path.exists()
        # a rank whose checks failed still writes its results
        check(p.returncode == 0, f"ranks' world rank {r}: exit "
              f"{p.returncode}" + ("" if path.exists() else
                                   f"\n{o[-3000:]}\n{e[-3000:]}"))
    if lost:
        raise RuntimeError("the ranks' world: a rank failed (above)")
    seconds = json.load(open(folder / "ranks0.json"))["seconds"]
    for res, report, name in ((parallel, parallel_report, "parallel"),
                              (spatial, spatial_report, "spatial"),
                              (spatial_train, spatial_train_report,
                               "spatial_train")):
        res["ranks_s"] = seconds[name]
        report(res, folder / name, card)
    print(f"spatial_train cli: {spatial_train['cli']}", flush=True)
    print(f"ranks' world ({RANKS_WORLD} gloo ranks, one card): seconds a "
          f"section on rank 0 {seconds}", flush=True)


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
    if sys.argv[1:2] == ["--ranks"]:
        return ranks_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
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
    quant = phase("quant", quant_phase, card)
    nete = phase("netE", nete_phase, card)
    export = phase("export", export_phase, card)
    # the parent's parts of the last three phases, then their gloo ranks,
    # one world for all three (ranks_phase)
    import shutil
    ranks_dir = Path("build") / "ranks"
    shutil.rmtree(ranks_dir, ignore_errors=True)
    spatial = phase("spatial", spatial_phase, card, bw, gen,
                    ranks_dir / "spatial")
    spatial_train = phase("spatial_train", spatial_train_phase, card, bw,
                          gen)
    # the ranks' start and their parallel section beside parallel (a)
    started = start_ranks(ranks_dir)
    parallel = phase("parallel", parallel_phase, card)
    phase("ranks", ranks_phase, card, parallel, spatial, spatial_train,
          ranks_dir, started)
    shutil.rmtree(ranks_dir, ignore_errors=True)
    # each of the three phases: its parent's part and its ranks' section
    by_phase = {name: seconds[name] + res["ranks_s"] for name, res in (
        ("parallel", parallel), ("spatial", spatial),
        ("spatial_train", spatial_train))}

    # launches summed over every path's counted runs: 8 served frames a
    # preset, and each preset's bf16 steps and timed bf16 and fp32 steps
    by_path = {**{"serve " + s["preset"]: s["launches"] for s in slices},
               **{"train " + t["preset"]: t["launches"] for t in trains},
               "train_options": options["launches"],
               **{"train_cli " + p: c for p, c in cli["launches"].items()},
               **{"serve " + p: c for p, c in serve["launches"].items()},
               **{"quant " + q["preset"]: q["launches"]
                  for q in quant["presets"]},
               "quant tick": quant["tick"]["launches"],
               "netE": nete["launches"],
               "export": export["launches"],
               "parallel": parallel["launches"],
               "spatial": spatial["launches"],
               "spatial_train": spatial_train["launches"]}
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
    # B1 split over one rank's frame of SPLIT_FRAME (preset, sp), bf16
    split_counts = SPATIAL_TABLES[SPLIT_FRAME + (1,)]["b1"]
    stats_counts = Counter()  # per shape, over both activations
    for (s, _), c in split_counts.items():
        stats_counts[s] += c
    split_frame = {
        "stats": per_path_totals(
            [r for r in spatial["b1_split_rows"] if r["name"] == "stats"],
            stats_counts, SPLIT_STATS_KEYS),
        "apply": per_path_totals(
            [r for r in spatial["b1_split_rows"] if r["name"] == "apply"],
            split_counts)}
    # the split backward over one rank's partitioned step of
    # SPLIT_TRAIN_STEP (preset, dp, sp, remat, gp, rank), bf16
    from ir2rgb_tpu_torch.sweep_b1 import BWD_STEP
    bwd_counts = Counter(BWD_STEP)
    split_bwd = {name: per_path_totals(
        [r for r in spatial_train["b1_split_bwd_rows"] if r["name"] == name],
        bwd_counts, ("ms", "plain_ms", "library_ms", "bound_ms"))
        for name in ("sums", "apply")}

    def bwd_cold(name):
        return {f"{r['shape']} {r['act']}": dict(cold_ms=r["cold_ms"],
                                                 bound_ms=r["bound_ms"])
                for r in spatial_train["b1_split_bwd_rows"]
                if r["name"] == name and r["cold_ms"] is not None}
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
            "instance_norm_stats",
            "ir2rgb_tpu_torch/kernels/csrc/instance_norm.cu",
            "ir2rgb_tpu/kernels/instance_norm.py:136",
            total["instance_norm_stats"], split_frame["stats"],
            spatial["b1_split_worst"]["stats bfloat16"],
            f"times: one {SPLIT_FRAME[0]} frame on one of {SPLIT_FRAME[1]} "
            f"ranks ({sum(stats_counts.values())} launches at its shard "
            "shapes), bf16; max_abs_err: of mean or relative M2; library: "
            "torch.var_mean over H, W; fused_ms: the fused forward at "
            "the same shapes; cold_ms_by_shape: a call on a cold L2 at the "
            "shapes of SPLIT_COLD_BYTES and more",
            fused_ms=split_frame["stats"]["fused_ms"],
            cold_ms_by_shape={str(r["shape"]): r["cold_ms"]
                              for r in spatial["b1_split_rows"]
                              if r.get("cold_ms") is not None},
            max_abs_err_fp32=spatial["b1_split_worst"]["stats float32"],
            max_rel_m2_err_large_mean=spatial["b1_split_worst"][
                "stats large mean"],
            device_kernels_per_call=max(r["device_kernels"]
                                        for r in spatial["b1_split_rows"]),
            launches_by_path=path_launches("instance_norm_stats")),
        kernel_entry(
            "instance_norm_apply",
            "ir2rgb_tpu_torch/kernels/csrc/instance_norm.cu",
            "ir2rgb_tpu/kernels/instance_norm.py:136",
            total["instance_norm_apply"], split_frame["apply"],
            spatial["b1_split_worst"]["apply bfloat16"],
            f"times: one {SPLIT_FRAME[0]} frame on one of {SPLIT_FRAME[1]} "
            f"ranks ({SPATIAL[SPLIT_FRAME[0]]['instance_norm_apply']} "
            "launches), bf16; max_abs_err: the applied y; library: "
            "(x - mean) * rstd + act",
            max_abs_err_fp32=spatial["b1_split_worst"]["apply float32"],
            launches_by_path=path_launches("instance_norm_apply")),
        dict(name="instance_norm_bwd_stats", route="cuda",
             source="ir2rgb_tpu_torch/kernels/csrc/instance_norm.cu",
             replaces="ir2rgb_tpu/kernels/instance_norm.py:201",
             launches=total["instance_norm_bwd_stats"],
             max_abs_err=spatial_train["b1_split_bwd_worst"]["sums bfloat16"],
             max_rel_err_fp32=spatial_train["b1_split_bwd_worst"][
                 "sums float32"],
             ms=split_bwd["sums"]["ms"],
             plain_ms=split_bwd["sums"]["plain_ms"],
             bound_ms=split_bwd["sums"]["bound_ms"], bound_by="bytes",
             library_ms=split_bwd["sums"]["library_ms"],
             per=f"times: one partitioned step of {SPLIT_TRAIN_STEP[0]} on "
                 f"rank {SPLIT_TRAIN_STEP[5]} of dp {SPLIT_TRAIN_STEP[1]} x "
                 f"sp {SPLIT_TRAIN_STEP[2]} ({sum(bwd_counts.values())} "
                 "launches at its shard shapes), bf16; max_abs_err: of the "
                 "sums, relative to their largest; library: the formula "
                 "in eager torch; cold_ms_by_shape: a call on a cold L2 "
                 "where x and g reach SPLIT_COLD_BYTES",
             device_kernels_per_call=max(
                 r["device_kernels"] for r in
                 spatial_train["b1_split_bwd_rows"] if r["name"] == "sums"),
             cold_ms_by_shape=bwd_cold("sums"),
             launches_by_path=path_launches("instance_norm_bwd_stats")),
        dict(name="instance_norm_bwd_apply", route="cuda",
             source="ir2rgb_tpu_torch/kernels/csrc/instance_norm.cu",
             replaces="ir2rgb_tpu/kernels/instance_norm.py:201",
             launches=total["instance_norm_bwd_apply"],
             max_abs_err=spatial_train["b1_split_bwd_worst"][
                 "apply bfloat16"],
             max_rel_err_fp32=spatial_train["b1_split_bwd_worst"][
                 "apply float32"],
             ms=split_bwd["apply"]["ms"],
             plain_ms=split_bwd["apply"]["plain_ms"],
             bound_ms=split_bwd["apply"]["bound_ms"], bound_by="bytes",
             library_ms=split_bwd["apply"]["library_ms"],
             per="as instance_norm_bwd_stats; max_abs_err: dx relative to "
                 "max|dx|",
             device_kernels_per_call=max(
                 r["device_kernels"] for r in
                 spatial_train["b1_split_bwd_rows"] if r["name"] == "apply"),
             cold_ms_by_shape=bwd_cold("apply"),
             launches_by_path=path_launches("instance_norm_bwd_apply")),
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
    print("quant " + json.dumps(quant))
    print("netE " + json.dumps(nete))
    print("export " + json.dumps(export))
    print("parallel " + json.dumps(parallel))
    print("spatial " + json.dumps({k: v for k, v in spatial.items()
                                   if k != "b1_split_rows"}))
    print("spatial_train " + json.dumps(
        {k: v for k, v in spatial_train.items()
         if k not in ("b1_split_bwd_rows", "ranks")}))
    t = split_bwd
    print(f"  B1 split bwd over one {SPLIT_TRAIN_STEP} rank's step, bf16: "
          f"sums {t['sums']['ms']:.4f} ms (bound {t['sums']['bound_ms']:.4f},"
          f" plain {t['sums']['plain_ms']:.4f}, lib "
          f"{t['sums']['library_ms']:.4f}); apply {t['apply']['ms']:.4f} ms "
          f"(bound {t['apply']['bound_ms']:.4f}, plain "
          f"{t['apply']['plain_ms']:.4f}, lib "
          f"{t['apply']['library_ms']:.4f})")
    for r in spatial["b1_split_rows"]:
        more = "" if r["name"] != "stats" else (
            f" fused fwd {r['fused_ms']:.4f}"
            + ("" if r["cold_ms"] is None else
               f" cold-L2 {r['cold_ms']:.4f} ("
               f"{r['bound_ms'] / r['cold_ms']:.0%} of bound)")
            + f" ({r['bound_ms'] / r['ms']:.0%} of bound, "
            f"{r['library_ms'] / r['ms']:.2f}x var_mean); plan "
            f"{r['plan']['channels']} ch x {r['plan']['chunks']} chunks of "
            f"{r['plan']['chunk']} px")
        print(f"  B1 split {r['name']} {r['shape']} {r.get('act', ''):10s} "
              f"ms {r['ms']:.4f} plain {r['plain_ms']:.4f} lib "
              f"{r['library_ms']:.4f} bound {r['bound_ms']:.4f} eager "
              f"{r['eager_ms']:.4f}{more}")
    t = split_frame["stats"]
    print(f"  B1 split stats over one {SPLIT_FRAME[0]} sp-{SPLIT_FRAME[1]} "
          f"rank's frame ({sum(stats_counts.values())} launches), bf16: "
          f"{t['ms']:.4f} ms (bound "
          f"{t['bound_ms']:.4f}: {t['bound_ms'] / t['ms']:.0%}; var_mean "
          f"{t['library_ms']:.4f}, fused forward {t['fused_ms']:.4f})")
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
    print("phase seconds with their ranks' sections " + json.dumps(by_phase))
    # everything above in one file, for runs whose output is cut short
    out = Path("build")
    out.mkdir(exist_ok=True)
    with open(out / "chip_smoke.json", "w") as fh:
        json.dump({"card": card, "seconds": seconds,
                   "seconds_with_ranks": by_phase, "failures": failures,
                   "slices": slices, "trains": trains,
                   "train_options": options, "train_cli": cli,
                   "serve": serve, "quant": quant, "netE": nete,
                   "export": export, "parallel": parallel,
                   "spatial": spatial, "spatial_train": spatial_train,
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
