"""Time kernel B1 under every launch plan the card can run, at the shapes
of the pix2pixhd_512 generator and discriminator: the evidence behind
``kernels/instance_norm.py::_plan``'s rules, and their check on another
card.

    python -m ir2rgb_tpu_torch.sweep_b1 [--dtype bf16|float32] [--top 4]

prints, per (shape, direction), one JSON line: the plan ``_plan`` picks
with its time, and the fastest plans; device ms from CUDA-graph replay,
and for each plan how many of its clusters the card holds at once.

    python -m ir2rgb_tpu_torch.sweep_b1 --stats [--dtype bf16|float32]

does the same for the split B1's statistics kernel at the shard shapes
of the partitioned frames (``STATS_SHAPES``): per shape one JSON line
with the plan ``_stats_plan`` picks, one level and grids of 1/2 to 8
blocks an SM (``stats_plans``), ``torch.var_mean`` and the byte bound:
the evidence behind ``_stats_plan``'s rules.

    python -m ir2rgb_tpu_torch.sweep_b1 --bwd-stats [--dtype bf16|float32] \
        [--parent FILE]

times the split backward's sums kernel (``in_bwd_stats_kernel``) at every
shape of its path (``BWD_SHAPES``) under each route its plan may take
(one level, one cluster of k chunks, clusters merged by tickets), beside
the plan ``_bwd_stats_plan`` picks, the formula in eager torch and the
byte bound, and the apply kernel: one JSON line a shape (where x and g
reach ``COLD_BYTES``, both kernels on a cold L2 as well), then one with
both kernels' sums over the launches of one ``pix2pixhd_512`` rank's
partitioned step on sp 2 (``BWD_STEP``). The evidence behind
``_bwd_stats_plan``'s rules. With ``--parent``, an earlier design's
``instance_norm.cu`` whose split-backward entries take the C signatures
of commit a5dba9e (the sums on the forward statistics' plan and
tickets), e.g. ``git show a5dba9e:ir2rgb_tpu_torch/kernels/csrc/
instance_norm.cu > build/parent_instance_norm.cu``: built into
``build/sweep_parent/`` and timed beside this tree's, parent, new, new,
parent. Needs one CUDA device.

    python -m ir2rgb_tpu_torch.sweep_b1 --act-switch

the evidence for the split backward's activation as a template argument
(``act_grad_t<kAct>``): a variant of this tree's ``instance_norm.cu``
(``runtime_act_source``) whose two split-backward kernels read the
activation at run time instead (one instantiation a dtype and lane, the
switch ``act_grad`` in the inner loop), built into ``build/sweep_act/``.
Prints each ``instance_norm.cu``'s ``nvcc`` time (alone, twice each),
then per (shape, act) of ``BWD_SHAPES``, bf16 and fp32, both kernels
timed template, runtime, runtime, template and whether their bits agree,
then the sums over ``BWD_STEP``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time
from pathlib import Path

import torch

from ir2rgb_tpu_torch.kernels import _build
from ir2rgb_tpu_torch.kernels import instance_norm as b1
from ir2rgb_tpu_torch.profile_stream import card_line

SHAPES = [(1, 512, 512, 32), (1, 256, 256, 64), (1, 128, 128, 128),
          (1, 64, 64, 256), (1, 32, 32, 512), (1, 16, 16, 1024),
          (1, 129, 129, 128), (1, 65, 65, 256), (1, 66, 66, 512),
          (1, 65, 65, 128), (1, 33, 33, 256), (1, 34, 34, 512)]
# the statistics kernel's shapes: every shard shape of chip_smoke.py's
# partitioned frames (B1_SPLIT_SHAPES)
STATS_SHAPES = [
    (1, 1, 2, 512), (1, 1, 4, 512), (1, 2, 4, 512), (1, 2, 8, 512),
    (1, 4, 8, 512), (1, 4, 16, 512), (1, 4, 16, 1024), (1, 8, 16, 512),
    (1, 8, 16, 1024), (1, 8, 32, 256), (1, 8, 32, 512), (1, 8, 32, 1024),
    (1, 16, 32, 256), (1, 16, 32, 512), (1, 16, 32, 1024), (1, 16, 64, 128),
    (1, 16, 64, 256), (1, 16, 64, 512), (1, 32, 64, 128), (1, 32, 64, 256),
    (1, 32, 64, 512), (1, 32, 128, 64), (1, 32, 128, 128), (1, 32, 128, 256),
    (1, 64, 128, 64), (1, 64, 128, 128), (1, 64, 128, 256), (1, 64, 256, 64),
    (1, 64, 256, 128), (1, 128, 256, 64), (1, 128, 256, 128),
    (1, 128, 512, 32), (1, 128, 512, 64), (1, 256, 512, 32), (1, 256, 512, 64),
    (1, 256, 1024, 32), (1, 512, 1024, 32), (1, 512, 2048, 16),
    (1, 1024, 2048, 16), (4, 8, 16, 1024), (4, 16, 32, 512), (4, 32, 64, 256),
    (4, 64, 128, 128), (4, 128, 256, 64), (4, 256, 512, 32)]
# the statistics kernel's shapes that chip_smoke.py's partitioned steps
# give it beside those (B1_SPLIT_TRAIN_SHAPES): the discriminators', a
# 1024 rank's, a cyclegan_256 sp-2 rank's, netE's on a 512 sp-2 rank
STATS_TRAIN_SHAPES = [
    (1, 8, 33, 256), (1, 8, 34, 512), (1, 9, 33, 256), (1, 9, 34, 512),
    (1, 15, 31, 512), (1, 16, 31, 512), (1, 16, 32, 256), (1, 16, 33, 256),
    (1, 16, 65, 128), (1, 16, 65, 256), (1, 16, 66, 512), (1, 17, 33, 256),
    (1, 17, 34, 512), (1, 17, 65, 128), (1, 17, 65, 256), (1, 17, 66, 512),
    (1, 32, 64, 128), (1, 32, 64, 256), (1, 32, 65, 128), (1, 32, 65, 256),
    (1, 32, 129, 128), (1, 32, 129, 256), (1, 32, 130, 512), (1, 33, 65, 128),
    (1, 33, 65, 256), (1, 33, 66, 512), (1, 33, 129, 128), (1, 33, 129, 256),
    (1, 33, 130, 512), (1, 64, 128, 64), (1, 64, 129, 128), (1, 64, 257, 128),
    (1, 64, 257, 256), (1, 64, 258, 512), (1, 65, 129, 128),
    (1, 65, 257, 128), (1, 65, 257, 256), (1, 65, 258, 512),
    (1, 128, 256, 32), (1, 128, 513, 128), (1, 129, 513, 128),
    (1, 256, 512, 16)]
# the split backward's shapes: every (shape, act) with rows that
# chip_smoke.py's partitioned steps give it (its SPATIAL_TRAIN launch
# tables), at which chip_smoke.py checks the two kernels, and the
# launches of each in one pix2pixhd_512 rank's step on sp 2
# (SPATIAL_TRAIN[SPLIT_TRAIN_STEP])
BWD_SHAPES = [
    ((1, 1, 2, 512), "none"), ((1, 1, 4, 512), "none"),
    ((1, 2, 4, 512), "none"), ((1, 2, 8, 512), "none"),
    ((1, 4, 8, 512), "none"), ((1, 4, 16, 512), "none"),
    ((1, 8, 16, 512), "none"), ((1, 8, 16, 1024), "none"),
    ((1, 8, 16, 1024), "relu"), ((1, 8, 32, 256), "none"),
    ((1, 8, 32, 1024), "none"), ((1, 8, 32, 1024), "relu"),
    ((1, 8, 33, 256), "leaky_relu"), ((1, 8, 34, 512), "leaky_relu"),
    ((1, 9, 33, 256), "leaky_relu"), ((1, 9, 34, 512), "leaky_relu"),
    ((1, 15, 31, 512), "leaky_relu"), ((1, 16, 31, 512), "leaky_relu"),
    ((1, 16, 32, 256), "leaky_relu"), ((1, 16, 32, 256), "none"),
    ((1, 16, 32, 256), "relu"), ((1, 16, 32, 512), "relu"),
    ((1, 16, 33, 256), "leaky_relu"), ((1, 16, 64, 128), "none"),
    ((1, 16, 64, 512), "relu"), ((1, 16, 65, 128), "leaky_relu"),
    ((1, 16, 65, 256), "leaky_relu"), ((1, 16, 66, 512), "leaky_relu"),
    ((1, 17, 33, 256), "leaky_relu"), ((1, 17, 34, 512), "leaky_relu"),
    ((1, 17, 65, 128), "leaky_relu"), ((1, 17, 65, 256), "leaky_relu"),
    ((1, 17, 66, 512), "leaky_relu"), ((1, 32, 64, 128), "leaky_relu"),
    ((1, 32, 64, 128), "none"), ((1, 32, 64, 128), "relu"),
    ((1, 32, 64, 256), "none"), ((1, 32, 64, 256), "relu"),
    ((1, 32, 65, 128), "leaky_relu"), ((1, 32, 65, 256), "leaky_relu"),
    ((1, 32, 128, 64), "none"), ((1, 32, 128, 256), "relu"),
    ((1, 32, 129, 128), "leaky_relu"), ((1, 32, 129, 256), "leaky_relu"),
    ((1, 32, 130, 512), "leaky_relu"), ((1, 33, 65, 128), "leaky_relu"),
    ((1, 33, 65, 256), "leaky_relu"), ((1, 33, 66, 512), "leaky_relu"),
    ((1, 33, 129, 128), "leaky_relu"), ((1, 33, 129, 256), "leaky_relu"),
    ((1, 33, 130, 512), "leaky_relu"), ((1, 64, 128, 64), "none"),
    ((1, 64, 128, 64), "relu"), ((1, 64, 128, 128), "relu"),
    ((1, 64, 129, 128), "leaky_relu"), ((1, 64, 256, 128), "relu"),
    ((1, 64, 257, 128), "leaky_relu"), ((1, 64, 257, 256), "leaky_relu"),
    ((1, 64, 258, 512), "leaky_relu"), ((1, 65, 129, 128), "leaky_relu"),
    ((1, 65, 257, 128), "leaky_relu"), ((1, 65, 257, 256), "leaky_relu"),
    ((1, 65, 258, 512), "leaky_relu"), ((1, 128, 256, 32), "relu"),
    ((1, 128, 256, 64), "none"), ((1, 128, 256, 64), "relu"),
    ((1, 128, 512, 64), "none"), ((1, 128, 512, 64), "relu"),
    ((1, 128, 513, 128), "leaky_relu"), ((1, 129, 513, 128), "leaky_relu"),
    ((1, 256, 512, 16), "relu"), ((1, 256, 512, 32), "relu"),
    ((1, 256, 1024, 32), "none"), ((1, 256, 1024, 32), "relu"),
    ((1, 512, 2048, 16), "relu")]
BWD_STEP = {
    ((1, 8, 16, 1024), "none"): 9, ((1, 8, 16, 1024), "relu"): 10,
    ((1, 16, 32, 512), "relu"): 2, ((1, 16, 33, 256), "leaky_relu"): 3,
    ((1, 17, 34, 512), "leaky_relu"): 3, ((1, 32, 64, 256), "relu"): 2,
    ((1, 32, 65, 128), "leaky_relu"): 3, ((1, 32, 65, 256), "leaky_relu"): 3,
    ((1, 33, 66, 512), "leaky_relu"): 3, ((1, 64, 128, 128), "relu"): 2,
    ((1, 64, 129, 128), "leaky_relu"): 3, ((1, 128, 256, 64), "none"): 3,
    ((1, 128, 256, 64), "relu"): 6, ((1, 256, 512, 32), "relu"): 2}
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published rate
# a flush of more than the H100's 50 MB L2, and the bytes of x and g from
# which --bwd-stats times a shape on a cold L2 as well (its reads repeated
# in a graph replay are partly L2 hits)
FLUSH_BYTES, COLD_BYTES = 128 << 20, 16 << 20


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms of one ``fn`` call: ``reps`` calls in one CUDA graph,
    replayed between CUDA events; the median of five replays."""
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


def cold_ms(fn, flush: torch.Tensor) -> float:
    """Device ms of one ``fn`` call on a cold L2: ``flush`` is read before
    every call (so that no dirty line is written back during ``fn``'s
    reads), and the flush's own time is taken off."""
    def wipe():
        return torch.amax(flush.view(torch.int32))
    return graph_ms(lambda: (wipe(), fn())) - graph_ms(wipe)


def plans(hw: int, c: int, itemsize: int, bwd: bool, bf16: bool):
    """Every plan the kernel takes and the card can run at this shape."""
    cgs, ks = b1._choices(hw, c, itemsize)
    for route in ("smem", "l2"):
        for cg in cgs:
            for k in ks:
                p = b1._make_plan(hw, c, itemsize, bwd, cg, k, route)
                if (p.smem_bytes <= b1._SMEM_OPTIN
                        and b1.max_clusters(p, bwd, bf16) > 0):
                    yield p


def stats_plans(n: int, hw: int, c: int, itemsize: int):
    """The statistics plans at this shape: one chunk a slab (one level),
    and the chunks that give grids of at most 1/2 to 8 blocks an SM of an
    H100, each of at least one load a thread."""
    cg = b1._choices(hw, c, itemsize)[0][0]
    slabs = n * (c // (cg * 4))
    rows = b1._stats_rows(cg * 4, itemsize)
    chunks = {hw} | {max(rows, -(-hw // max(1, blocks // slabs)))
                     for blocks in (66, 132, 264, 396, 528, 1056)}
    return [b1._make_stats_plan(hw, c, itemsize, cg, k)
            for k in sorted(chunks, reverse=True)]


def sweep_stats(dtype, card: str, gen: torch.Generator) -> None:
    for shape in STATS_SHAPES:
        n, h, w, c = shape
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(
            dtype)
        chosen = b1.stats_plan_for(x)
        plans = stats_plans(n, h * w, c, x.element_size())
        rows = [dict(ms=graph_ms(lambda p=p: b1.instance_norm_stats_cuda(
            x, plan=p)), blocks=n * p.groups * p.chunks, **p._asdict())
            for p in plans + [chosen] * (chosen not in plans)]
        xb = x.numel() * x.element_size()
        print(json.dumps(dict(
            shape=list(shape), dtype=str(dtype)[6:], card=card, bytes=xb,
            bound_ms=(xb + 2 * n * c * 4) / HBM_BYTES_PER_S * 1e3,
            chosen=chosen._asdict(),
            chosen_ms=next(r["ms"] for r in rows
                           if r["chunk"] == chosen.chunk),
            var_mean_ms=graph_ms(lambda: torch.var_mean(
                x.permute(0, 3, 1, 2), dim=(2, 3), correction=0)),
            plans=rows)), flush=True)


def bwd_stats_plans(n: int, hw: int, c: int, itemsize: int, clusters,
                    wave: int):
    """The sums kernel's plans at this shape: one level; one cluster of k
    chunks a slab for every k of 2 to 16 the card holds a cluster a slab
    of; and clusters of 1, 4, 8 or 16 blocks, m of them a slab, merged by
    tickets, up to two waves of blocks."""
    cg = b1._choices(hw, c, itemsize)[0][0]
    slabs = n * (c // (cg * 4))
    out = [(1, 1)]
    out += [(k, k) for k in range(2, 17) if clusters(k) >= slabs]
    for k in (1, 4, 8, 16):
        for m in (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256):
            if (k * m * slabs <= 2 * wave
                    and (k == 1 or clusters(k) >= slabs)):
                out.append((k * m, k))
    plans = []
    for chunks, k in out:
        try:
            plans.append(b1._make_bwd_stats_plan(hw, c, itemsize, cg, chunks,
                                                 k))
        except ValueError:
            pass
    return plans


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def load_parent(source: Path) -> ctypes.CDLL:
    """The parent design's kernels: ``source`` (its instance_norm.cu)
    with this tree's errors.cu and headers, built into
    build/sweep_parent/, with its sums, occupancy and apply signatures."""
    out = _build.BUILD_DIR / "sweep_parent"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libparent.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    f"-I{_build.CSRC}", "-o", str(so), str(source),
                    str(_build.CSRC / "errors.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in (
            ("ir2rgb_instance_norm_bwd_stats",
             [_P] * 8 + [_I] * 7 + [_I, _F, _I, _P]),
            ("ir2rgb_instance_norm_bwd_stats_occupancy", [_I, _I, _I, _P]),
            ("ir2rgb_instance_norm_bwd_apply",
             [_P] * 7 + [_I, _I, _I, _F, _I, _F, _I, _P])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def parent_bwd_stats_plan(lib, n: int, hw: int, c: int, itemsize: int,
                          sms: int):
    """The parent design's plan: the forward statistics' (``_stats_plan``)
    with the sums kernel's shared memory and occupancy."""
    def smem(p):
        return (8 * 2 * p.channels + 2 * 256) * 4
    one = b1._stats_plan(n, hw, c, itemsize, sms, 1)
    out = ctypes.c_int()
    _build.check(lib.ir2rgb_instance_norm_bwd_stats_occupancy(
        one.cg, smem(one), int(itemsize == 2), ctypes.byref(out)),
        "parent occupancy")
    p = b1._stats_plan(n, hw, c, itemsize, sms, out.value)
    return p, smem(p)


def parent_fns(lib, x, g, mean, rstd, a1, a2, act, count, sms, stream):
    """The parent design's sums (on its own plan; ``.out``: its (s1, s2),
    ``.plan``) and apply (from the sums a1, a2) at x's shape."""
    n, h, w, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    pp, psmem = parent_bwd_stats_plan(lib, n, h * w, c, x.element_size(),
                                      sms)
    s1 = torch.empty((n, c), device="cuda")
    s2 = torch.empty_like(s1)
    part = torch.empty(max(1, n * c * pp.chunks * 2), device="cuda")
    tickets = torch.zeros(n * pp.groups, dtype=torch.int32, device="cuda")
    dx = torch.empty_like(x)

    def sums():
        _build.check(lib.ir2rgb_instance_norm_bwd_stats(
            x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), n, h * w, c, pp.cg, pp.chunks, pp.chunk,
            psmem, b1.ACTS[act], 0.2, int(bf16), stream()), "parent sums")
    sums.out, sums.plan = (s1, s2), pp

    def apply():
        _build.check(lib.ir2rgb_instance_norm_bwd_apply(
            x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            a1.data_ptr(), a2.data_ptr(), dx.data_ptr(), n, h * w, c, count,
            b1.ACTS[act], 0.2, int(bf16), stream()), "parent apply")
    return {"sums_parent": sums, "apply_parent": apply}


def sweep_bwd_stats(dtype, card: str, gen: torch.Generator,
                    parent: Path = None) -> None:
    lib = load_parent(parent) if parent else None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    bf16 = dtype == torch.bfloat16
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    keys = ["sums_ms", "sums_bound_ms", "apply_ms", "apply_bound_ms",
            "eager_ms"]
    if lib:
        keys += ["sums_parent_ms", "apply_parent_ms"]
    totals = dict.fromkeys(keys, 0.0)
    for shape, act in BWD_SHAPES:
        n, h, w, c = shape
        hw = h * w
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(
            dtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        x32 = x.float()
        mean = x32.mean(dim=(1, 2)).contiguous()
        rstd = torch.rsqrt(x32.var(dim=(1, 2), unbiased=False)
                           + b1.INSTANCE_NORM_EPS).contiguous()
        count = float(2 * hw)
        item = x.element_size()
        chosen = b1.bwd_stats_plan_for(x, act)
        cg = chosen.cg
        resident = b1.bwd_stats_resident(cg, act, bf16)
        plans = bwd_stats_plans(
            n, hw, c, item, lambda k: b1.bwd_stats_clusters(k, cg, act, bf16),
            sms * resident)
        rows = [dict(ms=graph_ms(lambda p=p: b1.instance_norm_bwd_stats_cuda(
            x, mean, rstd, g, act, plan=p)), **p._asdict()) for p in plans]
        best = {}
        for r in rows:
            if r["route"] not in best or r["ms"] < best[r["route"]]["ms"]:
                best[r["route"]] = r
        sums = b1.instance_norm_bwd_stats_cuda(x, mean, rstd, g, act)
        a1, a2 = sums[0], sums[1]

        def new_sums():
            return b1.instance_norm_bwd_stats_cuda(x, mean, rstd, g, act)

        def new_apply():
            return b1.instance_norm_bwd_apply_cuda(x, mean, rstd, g, a1, a2,
                                                   count, act)
        fns = {"sums": new_sums, "apply": new_apply}
        extra = {}
        if lib:
            fns.update(parent_fns(lib, x, g, mean, rstd, a1, a2, act, count,
                                  sms, stream))
            new = new_sums()
            fns["sums_parent"]()
            s1, s2 = fns["sums_parent"].out
            torch.cuda.synchronize()
            extra = dict(parent_plan=fns["sums_parent"].plan._asdict(),
                         parent_agrees=bool(
                             torch.allclose(new[0], s1, rtol=1e-4, atol=1e-3)
                             and torch.allclose(new[1], s2, rtol=1e-4,
                                                atol=1e-3)))
        xb = x.numel() * item
        # x and g of 16 MB and more: timed on a cold L2 as well
        cold = 2 * xb >= COLD_BYTES
        t, tc = {}, {}
        for op in ("sums", "apply"):
            order = ((f"{op}_parent", op, op, f"{op}_parent") if lib
                     else (op, op))
            for name in order:
                t.setdefault(name, []).append(graph_ms(fns[name]))
                if cold:
                    tc.setdefault(name, []).append(cold_ms(fns[name], flush))
        t = {k: sum(v) / len(v) for k, v in t.items()}
        tc = {k: sum(v) / len(v) for k, v in tc.items()}
        m4 = mean[:, None, None].to(dtype)
        r4 = rstd[:, None, None].to(dtype)

        def eager():
            xh = (x - m4) * r4
            gp = (g * (xh > 0) if act == "relu" else
                  torch.where(xh >= 0, g, g * 0.2)
                  if act == "leaky_relu" else g)
            return gp.sum(dim=(1, 2)), (gp * xh).sum(dim=(1, 2))
        stats_b = 2 * n * c * 4  # two (N, C) fp32 tensors
        line = dict(
            shape=list(shape), act=act, dtype=str(dtype)[6:], card=card,
            bytes=xb, chosen=chosen._asdict(), chosen_ms=t["sums"],
            eager_ms=graph_ms(eager),
            bound_ms=(2 * xb + 2 * stats_b) / HBM_BYTES_PER_S * 1e3,
            routes={k: dict(ms=v["ms"], chunks=v["chunks"], k=v["k"])
                    for k, v in best.items()},
            apply=dict(ms=t["apply"],
                       bound_ms=(3 * xb + 2 * stats_b) / HBM_BYTES_PER_S
                       * 1e3),
            plans=[{k: r[k] for k in ("chunks", "k", "route", "ms")}
                   for r in rows], **extra)
        if lib:
            line.update(parent_ms=t["sums_parent"])
            line["apply"]["parent_ms"] = t["apply_parent"]
        if cold:
            line["cold"] = tc
        print(json.dumps(line), flush=True)
        times = BWD_STEP.get((shape, act), 0)
        vals = dict(sums_ms=t["sums"], sums_bound_ms=line["bound_ms"],
                    apply_ms=t["apply"],
                    apply_bound_ms=line["apply"]["bound_ms"],
                    eager_ms=line["eager_ms"])
        if lib:
            vals.update(sums_parent_ms=t["sums_parent"],
                        apply_parent_ms=t["apply_parent"])
        for key, val in vals.items():
            totals[key] += times * val
    print(json.dumps(dict(step="pix2pixhd_512 sp 2, one rank",
                          launches=sum(BWD_STEP.values()),
                          dtype=str(dtype)[6:], card=card, **totals)),
          flush=True)


def _swap(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"runtime_act_source: {old!r} found "
                         f"{src.count(old)} times, not once")
    return src.replace(old, new)


def runtime_act_source(src: str) -> str:
    """``instance_norm.cu`` with the split backward's kernels reading the
    activation at run time: ``in_bwd_stats_kernel`` from its plan,
    ``in_bwd_apply_kernel`` as an argument, through ``act_grad``'s switch,
    and one instantiation a dtype and lane (``act_dispatch`` always takes
    kind 0). Raises where this tree's source has drifted from the text it
    edits."""
    for name, bounds in (("in_bwd_stats_kernel", "kStatsThreads, 2"),
                         ("in_bwd_apply_kernel", "256, 2")):
        src = _swap(src, f"template <typename T, int kCh, int kAct>\n"
                    f"__global__ void __launch_bounds__({bounds})\n{name}(",
                    f"template <typename T, int kCh>\n"
                    f"__global__ void __launch_bounds__({bounds})\n{name}(")
    src = _swap(src, "act_grad_t<kAct>(b[j], xh, slope)",
                "act_grad(b[j], xh, p.act, slope)")
    k_line = "  int k;         // blocks per cluster (1: no cluster)\n"
    src = _swap(src, k_line,
                k_line + "  int act;       // the activation (ACTS)\n")
    src = _swap(src, "const BwdStatsPlan p{n, hw, c, cg, chunks, chunk, k};",
                "const BwdStatsPlan p{n, hw, c, cg, chunks, chunk, k, act};")
    src = _swap(src, "int c, int lb, float inv, float slope) {",
                "int c, int lb, float inv, int act, float slope) {")
    src = _swap(src, "act_grad_t<kAct>(gv[j], xh, slope)",
                "act_grad(gv[j], xh, act, slope)")
    src = _swap(src, "static_cast<T*>(dx), hw, c, lb, inv, slope);",
                "static_cast<T*>(dx), hw, c, lb, inv, act, slope);")
    src = _swap(src, """  switch (act) {
    case 1: return f(BwdKind<T, kCh, 1>{});
    case 2: return f(BwdKind<T, kCh, 2>{});
    case 3: return f(BwdKind<T, kCh, 3>{});
    default: return f(BwdKind<T, kCh, 0>{});
  }""", "  (void)act;\n  return f(BwdKind<T, kCh, 0>{});")
    src, n = re.subn(
        r"in_bwd_(stats|apply)_kernel<([^<>]*?),\s*K::kActivation>",
        r"in_bwd_\1_kernel<\2>", src)
    if n != 5:
        raise ValueError(f"runtime_act_source: {n} kernel references "
                         "by activation, not 5")
    return src


def _nvcc_s(src: Path, obj: Path) -> float:
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
                    "-c", str(src), "-o", str(obj)], check=True)
    return time.perf_counter() - t0


def sweep_act_switch(card: str, gen: torch.Generator) -> None:
    out = _build.BUILD_DIR / "sweep_act"
    out.mkdir(parents=True, exist_ok=True)
    tree = _build.CSRC / "instance_norm.cu"
    variant = out / "instance_norm.cu"
    variant.write_text(runtime_act_source(tree.read_text()))
    nvcc = {"template": [], "runtime": []}
    for _ in range(2):
        for name, src in (("template", tree), ("runtime", variant)):
            nvcc[name].append(_nvcc_s(src, out / f"{name}.o"))
    print(json.dumps(dict(card=card, nvcc_s=nvcc)), flush=True)
    so = out / "libact.so"
    others = [str(f) for f in sorted(_build.CSRC.glob("*.cu")) if f != tree]
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    f"-I{_build.CSRC}", "-o", str(so), str(out / "runtime.o"),
                    *others], check=True)
    rt = ctypes.CDLL(str(so))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(rt, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    rt.ir2rgb_error_string.argtypes = [ctypes.c_int]
    rt.ir2rgb_error_string.restype = ctypes.c_char_p
    libs = {"template": _build.lib(), "runtime": rt}
    totals = {}
    try:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype)[6:]
            for shape, act in BWD_SHAPES:
                h, w = shape[1:3]
                x = (torch.randn(shape, generator=gen, device="cuda") * 3
                     + 1).to(dtype)
                g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                x32 = x.float()
                mean = x32.mean(dim=(1, 2)).contiguous()
                rstd = torch.rsqrt(x32.var(dim=(1, 2), unbiased=False)
                                   + b1.INSTANCE_NORM_EPS).contiguous()
                count = float(2 * h * w)
                t, outs = {}, {}
                for name in ("template", "runtime", "runtime", "template"):
                    _build._lib = libs[name]
                    sums = b1.instance_norm_bwd_stats_cuda(x, mean, rstd, g,
                                                           act)
                    outs[name] = (sums, b1.instance_norm_bwd_apply_cuda(
                        x, mean, rstd, g, sums[0], sums[1], count, act))
                    t.setdefault(f"sums_{name}_ms", []).append(graph_ms(
                        lambda: b1.instance_norm_bwd_stats_cuda(
                            x, mean, rstd, g, act)))
                    t.setdefault(f"apply_{name}_ms", []).append(graph_ms(
                        lambda: b1.instance_norm_bwd_apply_cuda(
                            x, mean, rstd, g, sums[0], sums[1], count, act)))
                t = {k: sum(v) / len(v) for k, v in t.items()}
                same = all(torch.equal(a, b) for a, b in zip(
                    outs["template"], outs["runtime"]))
                print(json.dumps(dict(shape=list(shape), act=act, dtype=dn,
                                      same_bits=same, **t)), flush=True)
                for k, v in t.items():
                    key = f"{dn} {k}"
                    totals[key] = (totals.get(key, 0.0)
                                   + BWD_STEP.get((shape, act), 0) * v)
    finally:
        _build._lib = libs["template"]
    print(json.dumps(dict(step="pix2pixhd_512 sp 2, one rank",
                          launches=sum(BWD_STEP.values()), card=card,
                          **totals)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "float32"))
    ap.add_argument("--top", type=int, default=4)
    ap.add_argument("--stats", action="store_true",
                    help="the split B1's statistics kernel")
    ap.add_argument("--bwd-stats", action="store_true",
                    help="the split backward's sums and apply kernels")
    ap.add_argument("--act-switch", action="store_true",
                    help="the split backward with the activation as a "
                         "template argument against a runtime switch")
    ap.add_argument("--parent", type=Path, default=None,
                    help="with --bwd-stats: a parent design's "
                         "instance_norm.cu to time beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_b1 needs a CUDA device")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.stats:
        sweep_stats(dtype, card, gen)
        return
    if args.bwd_stats:
        sweep_bwd_stats(dtype, card, gen, args.parent)
        return
    if args.act_switch:
        sweep_act_switch(card, gen)
        return
    for shape in SHAPES:
        n, h, w, c = shape
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(
            dtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        _, mean, rstd = b1.instance_norm_act(x, "relu")
        for bwd in (False, True):
            rows = []
            for p in plans(h * w, c, x.element_size(), bwd,
                           dtype == torch.bfloat16):
                if bwd:
                    fn = lambda p=p: b1.instance_norm_act_bwd_cuda(  # noqa
                        x, mean, rstd, g, "relu", plan=p)
                else:
                    fn = lambda p=p: b1.instance_norm_act_cuda(  # noqa
                        x, "relu", plan=p)
                rows.append((graph_ms(fn), p))
            rows.sort(key=lambda r: r[0])
            chosen = b1.plan_for(x, bwd)
            bf16 = dtype == torch.bfloat16
            print(json.dumps(dict(
                shape=list(shape), dtype=args.dtype,
                direction="bwd" if bwd else "fwd", card=card,
                chosen=chosen._asdict(),
                chosen_ms=next(t for t, p in rows if p == chosen),
                chosen_max_clusters=b1.max_clusters(chosen, bwd, bf16),
                fastest=[dict(ms=t, max_clusters=b1.max_clusters(p, bwd, bf16),
                              **p._asdict())
                         for t, p in rows[:args.top]])), flush=True)


if __name__ == "__main__":
    main()
