"""Where one launch of kernel B1 spends its time: per block, the device
clock (``%globaltimer``) at the start and at the end of each phase (load,
reduce, cluster merge, apply) of the forward and backward kernels, at the
largest and the smallest shapes of the pix2pixhd_512 path. On the L2
route "load" is empty and "reduce" reads the share from global memory.

    python -m ir2rgb_tpu_torch.phases_b1

builds an instrumented copy of ``kernels/csrc/instance_norm.cu`` under
``build/phases_b1/`` (the kernels the port ships are not touched), runs
each case once warm, and prints one JSON line per (shape, dtype,
direction): the plan, the blocks, how far apart they started and when the
last ended, and each phase's mean and max over the blocks, in µs from the
first block's start. Needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
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

STAMPS = f"""
__device__ unsigned long long g_b1_stamps[{MAX_BLOCKS}][{len(PHASES) + 1}];
__device__ __forceinline__ void b1_stamp(int i) {{
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    g_b1_stamps[blockIdx.x + blockIdx.y * gridDim.x][i] = t;
  }}
}}
"""


def instrumented_source() -> str:
    """instance_norm.cu with a stamp before each anchor of each kernel and
    an entry point that copies the stamps to the host."""
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
    return src + ('\nextern "C" int ir2rgb_b1_stamps(void* host) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, g_b1_stamps, "
                  "sizeof(g_b1_stamps));\n}\n")


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
    lib.ir2rgb_b1_stamps.argtypes = [ctypes.c_void_p]
    lib.ir2rgb_b1_stamps.restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("phases_b1 needs a CUDA device")
    lib = load_instrumented()
    _build._lib = lib  # the wrappers launch the instrumented kernels
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
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


if __name__ == "__main__":
    main()
