"""Where one launch of kernel B2's tensor-core route spends its time, and
how its tile height plays: per block, the device clock (``%globaltimer``)
and the SM at the start and end of each phase (copy of the window,
products, epilogue), at every bf16 tail shape of ``chip_smoke.py``; and
the device time of the shipped kernel at each tile height it is built
for (16 and 8 output rows).

    python -m ir2rgb_tpu_torch.phases_b2

builds an instrumented copy of ``kernels/csrc/tail_fused.cu`` under
``build/phases_b2/`` (the kernels the port ships are not touched) and
prints one JSON line per (shape, tile rows): the blocks, the most that
shared one SM at once, how far apart they started and when the last
ended, each phase's mean and max over the blocks in µs, and the shipped
kernel's device ms (CUDA-graph replay, median of five). Needs one CUDA
device.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import subprocess

import numpy as np
import torch

from ir2rgb_tpu_torch.kernels import _build
b2 = importlib.import_module("ir2rgb_tpu_torch.kernels.tail_fused")
from ir2rgb_tpu_torch.profile_stream import card_line
from ir2rgb_tpu_torch.sweep_b1 import graph_ms

PHASES = ("copy", "products", "epilogue")
# source lines of tail_tc_kernel that open each phase, and the kernel's
# last line; a stamp is taken just before each
ANCHORS = ("  const __nv_bfloat16* xin = x + (size_t)n * h * w * C;",
           "  // ldmatrix.x4 row address of this lane",
           "  const float b0 = __ldg(bias)",
           "}\n\ntemplate <int KS, int TH>\nint launch_tc(")
SHAPES = [(1, 512, 512, 32), (1, 512, 512, 64), (1, 1024, 1024, 32),
          (1, 2048, 2048, 16), (2, 72, 40, 32)]
ROWS = (16, 8)
MAX_BLOCKS = 16384

STAMPS = f"""
__device__ unsigned long long g_b2_stamps[{MAX_BLOCKS}][{len(PHASES) + 2}];
__device__ __forceinline__ void b2_stamp(int i) {{
  if (threadIdx.x == 0) {{
    unsigned long long t;
    unsigned int sm;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    asm volatile("mov.u32 %0, %smid;" : "=r"(sm));
    const int blk = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    g_b2_stamps[blk][i] = t;
    if (i == 0) g_b2_stamps[blk][{len(PHASES) + 1}] = sm;
  }}
}}
"""


def instrumented_source() -> str:
    """tail_fused.cu with a stamp before each anchor of tail_tc_kernel
    (a barrier before the last, so that it marks the block's end) and an
    entry point that copies the stamps to the host."""
    src = (_build.CSRC / "tail_fused.cu").read_text()
    head = "namespace {\n"
    if head not in src:
        raise ValueError("tail_fused.cu: no anonymous namespace to "
                         "instrument")
    src = src.replace(head, STAMPS + head, 1)
    at = src.index("tail_tc_kernel(")
    for i, anchor in enumerate(ANCHORS):
        j = src.find(anchor, at)
        if j < 0:
            raise ValueError(f"tail_tc_kernel: anchor {anchor!r} not found; "
                             "update ANCHORS to the kernel's source")
        if i == len(ANCHORS) - 1:
            mark = f"  __syncthreads();\n  b2_stamp({i});\n"
        else:
            mark = f"  b2_stamp({i});\n"
        src = src[:j] + mark + src[j:]
        at = j + len(mark) + len(anchor)
    return src + ('\nextern "C" int ir2rgb_b2_stamps(void* host) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, g_b2_stamps, "
                  "sizeof(g_b2_stamps));\n}\n")


def load(so, source=None) -> ctypes.CDLL:
    """Load a kernel library (building ``source`` into ``so`` first when
    given) with the tail's C signature."""
    if source is not None:
        so.parent.mkdir(parents=True, exist_ok=True)
        cu = so.with_suffix(".cu")
        cu.write_text(source)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                        f"-I{_build.CSRC}", "-o", str(so), str(cu)],
                       check=True)
    lib = ctypes.CDLL(str(so))
    lib.ir2rgb_tail_fused_tc.argtypes = _build._SIGNATURES[
        "ir2rgb_tail_fused_tc"]
    lib.ir2rgb_tail_fused_tc.restype = ctypes.c_int
    return lib


def launcher(lib, x, wk, b32, th):
    """A call of the bf16 route on ``lib`` at tile height ``th``."""
    n, h, w, c = x.shape
    smem = b2.tc_smem(c, th)

    def run():
        y = torch.empty((n, h, w, 3), device=x.device, dtype=x.dtype)
        code = lib.ir2rgb_tail_fused_tc(
            x.data_ptr(), wk.data_ptr(), b32.data_ptr(), y.data_ptr(), n, h,
            w, c, th, smem, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"tail_fused_tc: CUDA error {code}")
        return y
    return run


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("phases_b2 needs a CUDA device")
    shipped = load(_build.build())
    probe = load(_build.BUILD_DIR / "phases_b2" / "libb2_phases.so",
                 instrumented_source())
    probe.ir2rgb_b2_stamps.argtypes = [ctypes.c_void_p]
    probe.ir2rgb_b2_stamps.restype = ctypes.c_int
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stamps = np.zeros((MAX_BLOCKS, len(PHASES) + 2), np.uint64)
    for shape in SHAPES:
        n, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        wt = torch.randn((7, 7, c, 3), generator=gen, device="cuda") * 0.05
        bias = torch.randn(3, generator=gen, device="cuda") * 0.1
        wk, b32 = b2.packed(wt, bias, torch.bfloat16)
        want = b2.tail_fused_reference(x, wt, bias).float()
        for th in ROWS:
            if 2 * (b2.tc_smem(c, th) + b2._BLOCK_RESERVED) > b2._SM_SMEM:
                shares = 1
            else:
                shares = 2
            run = launcher(shipped, x, wk, b32, th)
            err = float((run().float() - want).abs().max())
            ms = graph_ms(run)
            timed = launcher(probe, x, wk, b32, th)
            for _ in range(3):
                timed()
            torch.cuda.synchronize()
            if probe.ir2rgb_b2_stamps(stamps.ctypes.data):
                raise RuntimeError("copy B2 stamps")
            blocks = n * -(-h // th) * -(-w // b2._TC_TW)
            t = stamps[:blocks, :len(PHASES) + 1].astype(np.int64)
            sm = stamps[:blocks, -1].astype(np.int64)
            t = (t - t[:, 0].min()) / 1e3
            ph = np.diff(t, axis=1)
            # most blocks resident on one SM at once: at each block's
            # start, the blocks of its SM that started and had not ended
            together = max(int(((sm == sm[i]) & (t[:, 0] <= t[i, 0])
                                & (t[:, -1] > t[i, 0])).sum())
                           for i in range(0, blocks, max(1, blocks // 512)))
            print(json.dumps(dict(
                shape=list(shape), tile_rows=th, shipped_rows=b2.tc_layout(
                    c)[0], card=card, ms=round(ms, 5), max_abs_err=err,
                blocks=blocks, blocks_an_sm_by_smem=shares,
                most_blocks_on_one_sm=together,
                start_spread_us=round(float(t[:, 0].max()), 3),
                end_us=round(float(t[:, -1].max()), 3),
                phase_mean_us={k: round(float(v), 3)
                               for k, v in zip(PHASES, ph.mean(0))},
                phase_max_us={k: round(float(v), 3)
                              for k, v in zip(PHASES, ph.max(0))})),
                flush=True)


if __name__ == "__main__":
    main()
