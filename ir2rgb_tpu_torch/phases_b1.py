"""Where one launch of kernel B1 spends its time, per block.

    python -m ir2rgb_tpu_torch.phases_b1            # the fused kernels
    python -m ir2rgb_tpu_torch.phases_b1 --split    # the split kernels

builds an instrumented copy of ``kernels/csrc/instance_norm.cu`` under
``build/phases_b1/`` (the kernels the port ships are not touched), runs
each case once warm, and prints one JSON line per case. Needs one CUDA
device.

The fused forward and backward (``in_fwd_kernel``, ``in_bwd_kernel``):
the device clock (``%globaltimer``) at the start and at the end of each
phase (load, reduce, cluster merge, apply), at the largest and the
smallest shapes of the pix2pixhd_512 path. On the L2 route "load" is
empty and "reduce" reads the share from global memory. Each line: the
plan, the blocks, how far apart they started and when the last ended,
and each phase's mean and max over the blocks, in µs from the first
block's start.

``--split``: the split B1's three reduction and apply kernels
(``in_stats_kernel``, ``in_bwd_stats_kernel``, ``in_bwd_apply_kernel``),
whose fixed cost a launch the globaltimer cannot resolve. Thread 0 of
each block reads the SM's cycle counter (``clock64``) at the start, at
the end of each phase of ``SPLIT_ANCHORS`` and at its exit, each reading
after an instruction that uses a value of that phase (a load's data
lands before the reading); ``%globaltimer`` gives only the blocks' start
skew and when the last block ended. Cycles become µs by a calibration
kernel that reads both clocks over 2 ms. Each line (``SPLIT_CASES``): the
plan, the blocks, each phase's mean and max over the blocks that ran it,
each block's whole time, the start skew, the last end, and the kernel's
device time (CUDA-graph replay) with and without the stamps, beside an
empty kernel's (the card's floor a launch in a graph).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from ir2rgb_tpu_torch.kernels import _build
from ir2rgb_tpu_torch.kernels import instance_norm as b1
from ir2rgb_tpu_torch.profile_stream import card_line

PHASES = ("load", "reduce", "merge", "apply")
# per kernel, the source lines that open each phase and the one that
# closes the last; a stamp is taken just before each
ANCHORS = {
    "in_fwd_kernel": ("  const Where w(p, R::kThreads);",
                      "  // the share's mean",
                      "  // merge the cluster's shares",
                      "  float mean[N], rstd[N];",
                      "  cluster_wait();"),
    "in_bwd_kernel": ("  const Where w(p, R::kThreads);",
                      "  float mean[N], rstd[N];",
                      "  cluster.sync();",
                      "  float gm[N], gx[N];",
                      "  cluster_wait();"),
}
CASES = [((1, 256, 256, 64), torch.bfloat16),
         ((1, 256, 256, 64), torch.float32),
         ((1, 512, 512, 32), torch.bfloat16),
         ((1, 128, 128, 128), torch.bfloat16),
         ((1, 16, 16, 1024), torch.bfloat16),
         ((1, 16, 16, 1024), torch.float32)]
MAX_BLOCKS = 8192

# The split kernels' phases: per kernel, (phase, anchor, value, when): a
# clock reading after `value` is used, placed just before `anchor` (the
# first match after the previous one), on the iteration `when` holds (or
# always). The phase is the time from the previous reading (the block's
# start for the first) to this one; "exit" runs from the last reading to
# the block's end (every return of the kernel and its closing brace).
SPLIT_ANCHORS = {
    "in_stats_kernel": (
        ("stats", "  float tot = 0.f, mean[kCh], m2[kCh], sum[kCh];",
         "sh[0]", None),
        ("first_batch",
         "    const int nb = min(kStatsBatch, (cnt - q0 + rows - 1) / rows);",
         "__uint_as_float(r[0].x)", "q0 == row"),
        ("loop", "  float* red = reinterpret_cast<float*>(smem);",
         "sum[0] + m2[0]", None),
        ("col_sum", "  const int slab = n * (p.c / cs) + grp;", "m2[0]",
         None),
        ("write_partial", "  if (p.chunks == 1) return;", "0.f", None),
        ("ticket", "  if (!last) return;", "0.f", None),
        ("merge", "  if (run == 0) {", "b", None)),
    "in_bwd_stats_kernel": (
        ("stats",
         "#pragma unroll\n  for (int j = 0; j < 2 * kCh; ++j) v[j] = 0.f;",
         "mu[0] + rs[kCh - 1]", None),
        ("first_batch",
         "#pragma unroll\n    for (int i = 0; i < kStatsBatch; ++i)\n"
         "      if (q0 + i * rows < cnt) {\n        float a[kCh], b[kCh];",
         "__uint_as_float(rx[0].x) + __uint_as_float(rg[0].x)",
         "q0 == row"),
        ("loop", "  const float blk = block_sums<2 * kCh>(v, red, cv);",
         "v[0]", None),
        ("block_sums", "  const int t = threadIdx.x;", "blk", None),
        ("cluster_push", "  if (clustered) {\n    cluster_arrive_release();",
         "0.f", None),
        ("cluster_barrier", "  if (rank != 0) return;", "0.f", None),
        ("cluster_merge", "  const int m = p.chunks / p.k;", "s", None),
        ("ticket", "  if (!last || !mine) return;", "0.f", None),
        ("merge", "  *out = tot;", "tot", None)),
    "in_bwd_apply_kernel": (
        ("stats",
         "#pragma unroll\n  for (int j = 0; j < kCh; ++j) {\n"
         "    a[j] *= inv;",
         "mu[0] + rs[0] + a[0] + b[0]", None),
        ("first_batch",
         "#pragma unroll\n    for (int i = 0; i < kStatsBatch; ++i) {\n"
         "      const int q = q0 + i * step;",
         "__uint_as_float(rx[0].x) + __uint_as_float(rg[0].x)",
         "q0 == blockIdx.x * rows + row"),),
}
SPLIT_CLOCKS = 12  # readings a block: its start, up to 10 phases, its exit
# (shape, dtype, act): the smallest shapes of sweep_b1.BWD_SHAPES (the
# trunk's (1,8,16,1024) shard both ways, the
# discriminator's narrowest), (1,64,128,128) and (1,256,512,32) (16 and
# 128 chunks a slab under the statistics kernel's plan) and the sums'
# slowest shape
SPLIT_CASES = [((1, 8, 16, 1024), torch.bfloat16, "relu"),
               ((1, 8, 16, 1024), torch.bfloat16, "none"),
               ((1, 8, 16, 1024), torch.float32, "relu"),
               ((1, 16, 32, 512), torch.bfloat16, "relu"),
               ((1, 16, 33, 256), torch.bfloat16, "leaky_relu"),
               ((1, 64, 128, 128), torch.bfloat16, "relu"),
               ((1, 64, 129, 128), torch.bfloat16, "leaky_relu"),
               ((1, 256, 512, 32), torch.bfloat16, "relu"),
               ((1, 512, 2048, 16), torch.bfloat16, "relu")]

STAMPS = f"""
__device__ unsigned long long g_b1_stamps[{MAX_BLOCKS}][{len(PHASES) + 1}];
__device__ __forceinline__ void b1_stamp(int i) {{
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    g_b1_stamps[blockIdx.x + blockIdx.y * gridDim.x][i] = t;
  }}
}}
__device__ unsigned long long g_b1_clk[{MAX_BLOCKS}][{SPLIT_CLOCKS}];
__device__ unsigned long long g_b1_gt[{MAX_BLOCKS}][2];
__device__ float g_b1_sink;
__device__ __forceinline__ int b1_bid() {{
  return blockIdx.x + blockIdx.y * gridDim.x;
}}
__device__ __forceinline__ unsigned long long b1_globaltimer() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}}
__device__ __forceinline__ void b1_clk_begin() {{
  if (threadIdx.x == 0 && b1_bid() < {MAX_BLOCKS}) {{
    g_b1_gt[b1_bid()][0] = b1_globaltimer();
    g_b1_clk[b1_bid()][0] = clock64();
  }}
}}
// reading i, after an add that uses v: the warp issues in order, so the
// reading waits for v's load to land
__device__ __forceinline__ void b1_clk(int i, float v) {{
  if (threadIdx.x == 0 && b1_bid() < {MAX_BLOCKS}) {{
    unsigned long long t;
    float o;
    asm volatile("add.f32 %1, %2, 0f00000000;\\n\\tmov.u64 %0, %%clock64;"
                 : "=l"(t), "=f"(o) : "f"(v) : "memory");
    g_b1_clk[b1_bid()][i] = t;
    if (o == 1.2345e-30f) g_b1_sink = o;
  }}
}}
__device__ __forceinline__ void b1_clk_end() {{
  if (threadIdx.x == 0 && b1_bid() < {MAX_BLOCKS}) {{
    g_b1_clk[b1_bid()][{SPLIT_CLOCKS - 1}] = clock64();
    g_b1_gt[b1_bid()][1] = b1_globaltimer();
  }}
}}
"""

ENTRIES = f"""
extern "C" int ir2rgb_b1_stamps(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, g_b1_stamps, sizeof(g_b1_stamps));
}}
extern "C" int ir2rgb_b1_clocks(void* clk, void* gt) {{
  cudaError_t e = cudaMemcpyFromSymbol(clk, g_b1_clk, sizeof(g_b1_clk));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(gt, g_b1_gt, sizeof(g_b1_gt));
  return (int)e;
}}
extern "C" int ir2rgb_b1_clocks_clear() {{
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_b1_clk);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_b1_clk));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_b1_gt);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_b1_gt));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}}
__global__ void b1_calibrate_kernel(unsigned long long* out, long long ns) {{
  const unsigned long long g0 = b1_globaltimer();
  const long long c0 = clock64();
  unsigned long long g1 = g0;
  while (g1 - g0 < (unsigned long long)ns) g1 = b1_globaltimer();
  out[0] = clock64() - c0;
  out[1] = g1 - g0;
}}
// SM cycles a ns over a 2 ms spin of one thread
extern "C" int ir2rgb_b1_calibrate(double* cycles_per_ns) {{
  unsigned long long* d = nullptr;
  unsigned long long h[2] = {{0, 0}};
  cudaError_t e = cudaMalloc(&d, sizeof(h));
  if (e != cudaSuccess) return (int)e;
  b1_calibrate_kernel<<<1, 1>>>(d, 2000000);
  e = cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  cudaFree(d);
  *cycles_per_ns = h[1] ? (double)h[0] / (double)h[1] : 0.0;
  return (int)e;
}}
__global__ void b1_null_kernel() {{}}
// an empty launch of `blocks` blocks of 256 threads: the floor a launch
extern "C" int ir2rgb_b1_null(int blocks, void* stream) {{
  b1_null_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}}
"""


def _body(src: str, kernel: str):
    """(start, end) of ``kernel``'s body in ``src``: just after its
    opening brace, and at its closing brace."""
    at = src.find(f"\n{kernel}(")
    if at < 0:
        raise ValueError(f"instance_norm.cu: no kernel {kernel}")
    start = src.index("{", at) + 1
    depth, i = 1, start
    while depth:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
    return start, i - 1


def _instrument_split(src: str, kernel: str, anchors) -> str:
    """``kernel``'s body with a reading at its start, one before each
    anchor and one at every exit."""
    start, end = _body(src, kernel)
    body = src[start:end]
    at = 0
    for i, (phase, anchor, value, when) in enumerate(anchors, 1):
        j = body.find(anchor, at)
        if j < 0:
            raise ValueError(f"{kernel}: anchor of phase {phase!r} not "
                             "found; update SPLIT_ANCHORS to the kernel's "
                             "source")
        mark = f"b1_clk({i}, {value});"
        mark = f"  if ({when}) {mark}\n" if when else f"  {mark}\n"
        body = body[:j] + mark + body[j:]
        at = j + len(mark) + len(anchor)
    body = re.sub(r"\breturn;", "{ b1_clk_end(); return; }", body)
    body = "\n  b1_clk_begin();" + body + "  b1_clk_end();\n"
    return src[:start] + body + src[end:]


def instrumented_source() -> str:
    """instance_norm.cu with a globaltimer stamp before each anchor of each
    fused kernel, clock readings in the split kernels, and entry points
    that copy the stamps to the host."""
    src = (_build.CSRC / "instance_norm.cu").read_text()
    head = "namespace {\n"
    if head not in src:
        raise ValueError("instance_norm.cu: no anonymous namespace to "
                         "instrument")
    src = src.replace(head, STAMPS + head, 1)
    for kernel, anchors in ANCHORS.items():
        at = src.index(f"{kernel}(")
        for i, anchor in enumerate(anchors):
            j = src.find(anchor, at)
            if j < 0:
                raise ValueError(f"{kernel}: anchor {anchor!r} not found; "
                                 "update ANCHORS to the kernel's source")
            mark = f"  b1_stamp({i});\n"
            src = src[:j] + mark + src[j:]
            at = j + len(mark) + len(anchor)
    for kernel, anchors in SPLIT_ANCHORS.items():
        src = _instrument_split(src, kernel, anchors)
    return src + ENTRIES


def load_instrumented() -> ctypes.CDLL:
    """Build the instrumented library into build/phases_b1/ and load it
    with the port's C signatures."""
    out = _build.BUILD_DIR / "phases_b1"
    out.mkdir(parents=True, exist_ok=True)
    (out / "instance_norm.cu").write_text(instrumented_source())
    so = out / "libb1_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    f"-I{_build.CSRC}", "-o", str(so),
                    str(out / "instance_norm.cu"),
                    str(_build.CSRC / "errors.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build._SIGNATURES.items():
        if name.startswith("ir2rgb_instance_norm"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.ir2rgb_error_string.argtypes = [ctypes.c_int]
    lib.ir2rgb_error_string.restype = ctypes.c_char_p
    for name, argtypes in (("ir2rgb_b1_stamps", [ctypes.c_void_p]),
                           ("ir2rgb_b1_clocks", [ctypes.c_void_p] * 2),
                           ("ir2rgb_b1_clocks_clear", []),
                           ("ir2rgb_b1_calibrate",
                            [ctypes.POINTER(ctypes.c_double)]),
                           ("ir2rgb_b1_null", [ctypes.c_int,
                                               ctypes.c_void_p])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def fused(lib: ctypes.CDLL, card: str, gen: torch.Generator) -> None:
    stamps = np.zeros((MAX_BLOCKS, len(PHASES) + 1), np.uint64)
    for shape, dtype in CASES:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(
            dtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        _, mean, rstd = b1.instance_norm_act(x, "relu")
        for bwd in (False, True):
            if bwd:
                run = lambda: b1.instance_norm_act_backward(  # noqa: E731
                    x, mean, rstd, g, "relu")
            else:
                run = lambda: b1.instance_norm_act(x, "relu")  # noqa: E731
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            _build.check(lib.ir2rgb_b1_stamps(stamps.ctypes.data),
                         "copy B1 stamps")
            p = b1.plan_for(x, bwd)
            blocks = shape[0] * p.groups * p.k
            t = stamps[:blocks].astype(np.int64)
            t = (t - t[:, 0].min()) / 1e3
            ph = np.diff(t, axis=1)
            print(json.dumps(dict(
                shape=list(shape), dtype=str(dtype).split(".")[-1],
                direction="bwd" if bwd else "fwd", card=card,
                plan=p._asdict(), blocks=blocks,
                start_spread_us=round(float(t[:, 0].max()), 3),
                end_us=round(float(t[:, -1].max()), 3),
                phase_mean_us={k: round(float(v), 3)
                               for k, v in zip(PHASES, ph.mean(0))},
                phase_max_us={k: round(float(v), 3)
                              for k, v in zip(PHASES, ph.max(0))})),
                flush=True)


def split_summary(clk: np.ndarray, gt: np.ndarray, phases, per_ns: float
                  ) -> dict:
    """Per phase, the mean and max µs over the blocks that ran it (both
    its readings set), each block's whole time, the start skew and the
    last block's end, from one launch's readings."""
    ran = clk[:, 0] > 0
    c = clk[ran].astype(np.int64)
    g = gt[ran].astype(np.int64)
    names = list(phases) + ["exit"]
    stamps = list(range(1, len(phases) + 1)) + [SPLIT_CLOCKS - 1]
    prev = np.zeros(len(c), np.int64)  # index of the last reading so far
    mean, peak = {}, {}
    for name, i in zip(names, stamps):
        have = c[:, i] > 0
        d = (c[have, i] - c[np.flatnonzero(have), prev[have]]) / per_ns / 1e3
        if len(d):
            mean[name] = round(float(d.mean()), 3)
            peak[name] = round(float(d.max()), 3)
        prev[have] = i
    whole = (c[:, SPLIT_CLOCKS - 1] - c[:, 0]) / per_ns / 1e3
    return dict(blocks=int(ran.sum()),
                phase_mean_us=mean, phase_max_us=peak,
                block_mean_us=round(float(whole.mean()), 3),
                block_max_us=round(float(whole.max()), 3),
                start_spread_us=round(float(np.ptp(g[:, 0])) / 1e3, 3),
                end_us=round(float(g[:, 1].max() - g[:, 0].min()) / 1e3, 3))


def split(lib: ctypes.CDLL, card: str, gen: torch.Generator) -> None:
    from ir2rgb_tpu_torch.sweep_b1 import graph_ms
    shipped = _build.lib()
    clk = np.zeros((MAX_BLOCKS, SPLIT_CLOCKS), np.uint64)
    gt = np.zeros((MAX_BLOCKS, 2), np.uint64)
    per_ns = ctypes.c_double()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    null_ms = {blocks: graph_ms(lambda b=blocks: _build.check(
        lib.ir2rgb_b1_null(b, stream()), "null kernel"))
        for blocks in (1, 132, 264)}
    print(json.dumps(dict(kernel="empty", card=card, ms=null_ms)),
          flush=True)
    for shape, dtype, act in SPLIT_CASES:
        n, h, w, c = shape
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(
            dtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        mean, m2 = b1.instance_norm_stats(x)
        rstd = torch.rsqrt(m2 / (h * w) + b1.INSTANCE_NORM_EPS)
        s1, s2 = b1.instance_norm_bwd_stats(x, mean, rstd, g, act)
        runs = {
            "in_stats_kernel": (lambda: b1.instance_norm_stats(x),
                                b1.stats_plan_for(x)._asdict()),
            "in_bwd_stats_kernel": (
                lambda: b1.instance_norm_bwd_stats(x, mean, rstd, g, act),
                b1.bwd_stats_plan_for(x, act)._asdict()),
            "in_bwd_apply_kernel": (
                lambda: b1.instance_norm_bwd_apply(
                    x, mean, rstd, g, s1, s2, float(2 * h * w), act),
                b1._card_bwd_apply_plan(n, h * w, c, x.element_size(), act,
                                        x.device.index)._asdict()),
        }
        for kernel, (run, plan) in runs.items():
            _build._lib = shipped
            ms = graph_ms(run)
            _build._lib = lib
            ms_stamped = graph_ms(run)
            _build.check(lib.ir2rgb_b1_clocks_clear(), "clear clocks")
            run()
            torch.cuda.synchronize()
            _build.check(lib.ir2rgb_b1_clocks(clk.ctypes.data,
                                              gt.ctypes.data), "copy clocks")
            _build.check(lib.ir2rgb_b1_calibrate(ctypes.byref(per_ns)),
                         "calibrate clocks")
            phases = [a[0] for a in SPLIT_ANCHORS[kernel]]
            print(json.dumps(dict(
                kernel=kernel, shape=list(shape),
                dtype=str(dtype).split(".")[-1], act=act, card=card,
                plan=plan, ms=ms, ms_stamped=ms_stamped,
                cycles_per_ns=round(per_ns.value, 4),
                **split_summary(clk, gt, phases, per_ns.value))),
                flush=True)
    _build._lib = shipped


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--split", action="store_true",
                    help="the split kernels' clock readings")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phases_b1 needs a CUDA device")
    lib = load_instrumented()
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.split:
        split(lib, card, gen)
        return
    _build._lib = lib  # the wrappers launch the instrumented kernels
    fused(lib, card, gen)


if __name__ == "__main__":
    main()
