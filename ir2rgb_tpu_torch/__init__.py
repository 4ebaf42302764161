"""PyTorch/CUDA port of ir2rgb_tpu for NVIDIA Hopper.

Mirrors the JAX package's module names (``config``, ``data``, ``nn``,
``kernels``, ``checkpoint``, ``train``, ``infer``, ``obs``, ``cli``) so
each counterpart is found under the same path. Imports ``torch`` only:
never ``jax`` and nothing of ``ir2rgb_tpu``. Public functions take and
return NHWC tensors, the JAX package's layout; entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""

from .runtime import resolve_device, set_parity_mode

__all__ = ["resolve_device", "set_parity_mode"]
