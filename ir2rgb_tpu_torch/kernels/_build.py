"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface under ``build/`` at the repository root. The library is named by
a hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses it. It is loaded with ``ctypes``: every pointer and the stream
travel as ``ctypes.c_void_p``, and each entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

Nothing here runs at import time: the first kernel launch builds.
:func:`check` and :func:`check_device` are the wrappers' two refusals: a
CUDA error from a launch, and a tensor on a device no op implements.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures (ctypes argtypes) of the entry points in csrc/
_SIGNATURES = {
    # x, y, mean, rstd, n, hw, c, k, share, cg, tile, smem_bytes, act,
    # slope, eps, is_bf16, stream
    "ir2rgb_instance_norm_act": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _F, _F, _I, _P],
    # x, g, mean, rstd, dx, n, hw, c, k, share, cg, tile, smem_bytes, act,
    # slope, is_bf16, stream
    "ir2rgb_instance_norm_act_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _I, _F, _I, _P],
    # x, mean, m2, part, tickets, n, hw, c, cg, chunks, chunk, smem_bytes,
    # is_bf16, stream
    "ir2rgb_instance_norm_stats": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _P],
    # cg, smem_bytes, is_bf16, out (int*)
    "ir2rgb_instance_norm_stats_occupancy": [_I, _I, _I, _P],
    # x, g, mean, rstd, sums, part, tickets, n, hw, c, cg, chunks, chunk,
    # k, act, slope, is_bf16, stream
    "ir2rgb_instance_norm_bwd_stats": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # cg, act, is_bf16, out (int*)
    "ir2rgb_instance_norm_bwd_stats_occupancy": [_I, _I, _I, _P],
    # k, cg, act, is_bf16, out (int*)
    "ir2rgb_instance_norm_bwd_stats_max_clusters": [_I, _I, _I, _I, _P],
    # x, g, mean, rstd, s1, s2, dx, n, hw, c, lb, blocks, inv (1 / count),
    # act, slope, is_bf16, stream
    "ir2rgb_instance_norm_bwd_apply": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _F, _I, _F, _I, _P],
    # c, act, is_bf16, out (int*)
    "ir2rgb_instance_norm_bwd_apply_occupancy": [_I, _I, _I, _P],
    # x, mean, rstd, y, n, hw, c, act, slope, is_bf16, stream
    "ir2rgb_instance_norm_apply": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                   _P],
    # k, tile, smem_bytes, bwd, is_bf16, out (int*)
    "ir2rgb_instance_norm_max_clusters": [_I, _I, _I, _I, _I, _P],
    # src, dst, n, hs, ws, cw, unit_bytes, to_image, stream
    "ir2rgb_d2s": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, w4, b, y, n, h, w, c, pix_stride, smem_bytes, stream
    "ir2rgb_tail_fused": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, wfrag, b, y, n, h, w, c, th, smem_bytes, stream
    "ir2rgb_tail_fused_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from ir2rgb_tpu_torch/kernels/csrc")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in srcs + hdrs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libir2rgb_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu (one nvcc each, in parallel) and link the .so."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    srcs, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for cmd, _, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"$ {' '.join(cmd)}\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        part = Path(tmp) / so.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(part),
                *(str(obj) for _, obj, _ in procs)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(link)}\n"
                               f"{res.stdout}")
        os.replace(part, so)  # atomic: a concurrent builder sees all or none
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.ir2rgb_error_string.argtypes = [ctypes.c_int]
            handle.ir2rgb_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib().ir2rgb_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_device(t, what: str) -> None:
    """Raise unless ``t`` lies on the CPU (the ops' plain versions) or a
    CUDA device (the kernels): on any other device, ``meta`` included, a
    wrapper refuses rather than run an op's fake implementation."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} takes a CPU or CUDA tensor, not "
                         f"{t.device.type}")


# the ops' namespace; the library object must live as long as its ops
_LIBRARY = torch.library.Library("ir2rgb", "DEF")


def define_op(schema: str, cpu, cuda, fake):
    """Register ``ir2rgb::<schema>``: ``cpu`` (the plain version) as its
    CPU kernel, ``cuda`` (the launch) as its CUDA kernel and ``fake``
    (the outputs' shapes, dtypes and strides) for tracing, so that
    ``torch.export`` keeps each call as one node. The op has no autograd
    kernel: the autograd Functions around it call it where no graph is
    recorded.

    Returns the call the wrappers make: the op while a program is
    exported (``infer/export.py``; a loaded program calls the op too),
    else the same implementation for the first argument's device,
    directly. The dispatcher's Python kernel costs ~9-17 us of host time
    a call on an H100 machine (``op_overhead.py``; ``PERF.md`` §6), and
    eager serving and training are host-bound."""
    name = schema.split("(", 1)[0]
    _LIBRARY.define(schema)
    _LIBRARY.impl(name, cpu, "CPU")
    _LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"ir2rgb::{name}", fake, lib=_LIBRARY)
    op = getattr(torch.ops.ir2rgb, name).default

    def call(*args):
        if torch.compiler.is_exporting():
            return op(*args)
        return (cpu if args[0].device.type == "cpu" else cuda)(*args)
    call.op = op
    return call
