"""PyTorch/CUDA port of ir2rgb_tpu for NVIDIA Hopper.

Mirrors the JAX package's module names (``config``, ``data``, ``nn``,
``kernels``, ``checkpoint``, ``train``, ``infer``, ``obs``, ``cli``) so
each counterpart is found under the same path. Imports ``torch`` only:
never ``jax`` and nothing of ``ir2rgb_tpu``. Public functions take and
return NHWC tensors, the JAX package's layout; entry points run on the
CUDA device unless the caller passes ``device="cpu"``.

Exports resolve on first use (``_lazy.py``), so importing a host-only
module such as ``infer.server`` imports no torch.
"""

_EXPORTS = {
    "resolve_device": ".runtime",
    "set_parity_mode": ".runtime",
}

__all__ = sorted(_EXPORTS)

from ir2rgb_tpu_torch._lazy import lazy_exports  # noqa: E402

__getattr__ = lazy_exports(__name__, _EXPORTS, globals())
