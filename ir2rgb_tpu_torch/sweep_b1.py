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
the evidence behind ``_stats_plan``'s rules. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from ir2rgb_tpu_torch.kernels import instance_norm as b1
from ir2rgb_tpu_torch.profile_stream import card_line

SHAPES = [(1, 512, 512, 32), (1, 256, 256, 64), (1, 128, 128, 128),
          (1, 64, 64, 256), (1, 32, 32, 512), (1, 16, 16, 1024),
          (1, 129, 129, 128), (1, 65, 65, 256), (1, 66, 66, 512),
          (1, 65, 65, 128), (1, 33, 33, 256), (1, 34, 34, 512)]
# the statistics kernel's shapes: every shard shape of chip_smoke.py's
# partitioned frames (B1_SPLIT_SHAPES)
STATS_SHAPES = [
    (1, 4, 16, 1024), (1, 8, 16, 1024), (1, 8, 32, 512), (1, 8, 32, 1024),
    (1, 16, 32, 512), (1, 16, 32, 1024), (1, 16, 64, 256), (1, 16, 64, 512),
    (1, 32, 64, 256), (1, 32, 64, 512), (1, 32, 128, 128),
    (1, 32, 128, 256), (1, 64, 128, 128), (1, 64, 128, 256),
    (1, 64, 256, 64), (1, 64, 256, 128), (1, 128, 256, 64),
    (1, 128, 256, 128), (1, 128, 512, 32), (1, 128, 512, 64),
    (1, 256, 512, 32), (1, 256, 512, 64), (1, 256, 1024, 32),
    (1, 512, 1024, 32), (1, 512, 2048, 16), (1, 1024, 2048, 16),
    (4, 8, 16, 1024), (4, 16, 32, 512), (4, 32, 64, 256),
    (4, 64, 128, 128), (4, 128, 256, 64), (4, 256, 512, 32)]
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published rate


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "float32"))
    ap.add_argument("--top", type=int, default=4)
    ap.add_argument("--stats", action="store_true",
                    help="the split B1's statistics kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_b1 needs a CUDA device")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.stats:
        sweep_stats(dtype, card, gen)
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
