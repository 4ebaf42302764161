"""Hand-written Hopper kernels of the port, with their plain versions.

- B1 ``instance_norm``: fused instance norm + activation, forward and
  backward (replaces ``ir2rgb_tpu/kernels/instance_norm.py``);
- B2 ``tail_fused``: reflect-pad + 7x7 conv + bias + tanh output tail
  (replaces ``ir2rgb_tpu/kernels/tail_fused.py``);
- B3 ``d2s``: 2x depth-to-space and its inverse, each the other's
  gradient (replaces ``ir2rgb_tpu/kernels/d2s.py``).

There is no switch and no fallback: a CPU tensor takes a kernel's plain
version, a CUDA tensor launches the kernel or raises. Each wrapper counts
its launches (:func:`launch_counts`).

The package attribute ``tail_fused`` is the wrapper function; the module
of the same name is ``sys.modules["ir2rgb_tpu_torch.kernels.tail_fused"]``.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import d2s as _d2s
from . import instance_norm as _instance_norm
from . import tail_fused as _tail_fused
from .d2s import d2s_fn
from .tail_fused import tail_fused


def fused_instance_norm_act(x: torch.Tensor, act: str = "relu",
                            negative_slope: float = 0.2) -> torch.Tensor:
    """Instance norm + activation over NHWC ``x`` (kernel B1),
    differentiable through the B1 backward kernel."""
    return _instance_norm.instance_norm_act_fn(
        x, act, negative_slope=negative_slope)


def launch_counts() -> Dict[str, int]:
    """Kernel launches made through the wrappers since the last reset."""
    return {"instance_norm_act": _instance_norm.launches,
            "instance_norm_act_bwd": _instance_norm.bwd_launches,
            "tail_fused": _tail_fused.launches,
            "d2s": _d2s.launches["d2s"],
            "s2d": _d2s.launches["s2d"]}


def reset_launch_counts() -> None:
    _instance_norm.launches = 0
    _instance_norm.bwd_launches = 0
    _tail_fused.launches = 0
    _d2s.launches.update(d2s=0, s2d=0)


__all__ = ["d2s_fn", "fused_instance_norm_act", "launch_counts",
           "reset_launch_counts", "tail_fused"]
