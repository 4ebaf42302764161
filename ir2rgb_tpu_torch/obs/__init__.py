"""Observability: loss logs, metrics, TensorBoard events, image
galleries and MJPEG video (copies of the JAX package's ``obs``)."""

from .html import HTMLPage
from .video import MJPEGAviWriter, read_mjpeg_avi
from .visualizer import Visualizer
from .writer import AsyncImageWriter

__all__ = ["AsyncImageWriter", "HTMLPage", "MJPEGAviWriter", "Visualizer",
           "read_mjpeg_avi"]
