"""Observability: loss logs, metrics, TensorBoard events, image
galleries and MJPEG video (copies of the JAX package's ``obs``).

Exports resolve on first use (``_lazy.py``): ``obs.video`` imports
without torch.
"""

_EXPORTS = {
    "AsyncImageWriter": ".writer",
    "HTMLPage": ".html",
    "MJPEGAviWriter": ".video",
    "Visualizer": ".visualizer",
    "read_mjpeg_avi": ".video",
}

__all__ = sorted(_EXPORTS)

from ir2rgb_tpu_torch._lazy import lazy_exports  # noqa: E402

__getattr__ = lazy_exports(__name__, _EXPORTS, globals())
