"""Training/inference observability.

Rebuild of the reference's ``util/visualizer.py`` (SURVEY.md §2.4, §5):
- console loss lines every ``print_freq`` steps;
- append-only ``loss_log.txt`` (same greppable format);
- periodic image grids to ``<run_dir>/web/images/`` with an HTML index;
- plus (new) a structured ``metrics.jsonl`` for machine consumption and
  optional ``torch.profiler`` trace capture around annotated spans.

The port's copy of ``ir2rgb_tpu/obs/visualizer.py``;
``torch.profiler`` takes the place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Mapping, Optional

import numpy as np

from .html import HTMLPage
from .writer import AsyncImageWriter


class Visualizer:
    def __init__(self, run_dir: str, name: str = "experiment"):
        self.run_dir = run_dir
        self.name = name
        os.makedirs(run_dir, exist_ok=True)
        self.web_dir = os.path.join(run_dir, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        # PNG writes go to worker threads (native libpng encoder) so the
        # step loop never blocks on image encode; flush() barriers
        self.writer = AsyncImageWriter()
        self.log_path = os.path.join(run_dir, "loss_log.txt")
        self.jsonl_path = os.path.join(run_dir, "metrics.jsonl")
        self._display_history = []  # (epoch, step, [(fname, label)])
        # TensorBoard event files (SURVEY.md §5 metrics row) — native
        # dependency-free writer; `tensorboard --logdir <run_dir>` works
        from .tb import TBEventWriter
        self.tb = TBEventWriter(os.path.join(run_dir, "tb"))
        with open(self.log_path, "a") as fh:
            fh.write(f"================ Training Loss ({time.strftime('%c')})"
                     f" ================\n")

    # ------------------------------------------------------------------

    def print_current_errors(self, epoch: int, step: int,
                             errors: Mapping[str, float],
                             step_time: float) -> None:
        msg = (f"(epoch: {epoch}, iters: {step}, time: {step_time:.3f}) "
               + " ".join(f"{k}: {v:.3f}" for k, v in errors.items()))
        print(msg, flush=True)
        with open(self.log_path, "a") as fh:
            fh.write(msg + "\n")
        with open(self.jsonl_path, "a") as fh:
            fh.write(json.dumps({"epoch": epoch, "step": step,
                                 "step_time": step_time, **{
                                     k: float(v) for k, v in errors.items()
                                 }}) + "\n")
        self.tb.add_scalars(
            {f"loss/{k}": float(v) for k, v in errors.items()
             } | {"perf/step_time": step_time}, step)

    # ------------------------------------------------------------------

    def display_current_results(self, visuals: Mapping[str, np.ndarray],
                                epoch: int, step: int) -> None:
        """visuals: name -> uint8 HWC image."""
        names = []
        for label, img in visuals.items():
            fname = f"epoch{epoch:03d}_step{step:07d}_{label}.png"
            self.writer.write(os.path.join(self.img_dir, fname), img)
            names.append((fname, label))
        # barrier the queued PNGs before publishing the page that links
        # them — otherwise the live dashboard transiently references
        # images not yet on disk (cheap at display_freq cadence)
        self.writer.flush()
        # the reference dashboard keeps ALL epochs on the page, newest
        # first — rebuild from the accumulated history, not just this row
        self._display_history.insert(0, (epoch, step, names))
        page = HTMLPage(self.web_dir, f"Experiment: {self.name}")
        for ep, st, row in self._display_history:
            page.add_header(f"epoch {ep}, step {st}")
            page.add_images([n for n, _ in row], [l for _, l in row])
        page.save()

    def save_images(self, page: HTMLPage, visuals: Mapping[str, np.ndarray],
                    image_path: str, width: int = 256) -> None:
        """Reference visualizer.save_images analog for test-time galleries.

        Files are keyed by the frame's parent folder + basename: a
        multi-video dataroot (A/vid000/0001.png, A/vid001/0001.png) has
        colliding basenames, and keying on the basename alone silently
        overwrote earlier videos' gallery images."""
        from ir2rgb_tpu_torch.data.video import is_virtual_frame, \
            split_virtual
        if is_virtual_frame(image_path):
            # AVI virtual frames ("clip.avi#000042"): splitext would
            # collapse every frame to "clip", and '#' is an URL fragment
            # separator — key as clip_000042 instead
            file, idx = split_virtual(image_path)
            image_path = os.path.join(
                os.path.dirname(file),
                f"{os.path.splitext(os.path.basename(file))[0]}_{idx:06d}")
        base = os.path.splitext(os.path.basename(image_path))[0]
        parent = os.path.basename(os.path.dirname(image_path))
        short = f"{parent}_{base}" if parent not in ("", "A", "testA",
                                                     "test") else base
        page.add_header(short)
        names, caps = [], []
        for label, img in visuals.items():
            fname = f"{short}_{label}.png"
            self.writer.write(os.path.join(page.img_dir, fname), img)
            names.append(fname)
            caps.append(label)
        page.add_images(names, caps, width)

    def flush(self) -> None:
        """Barrier: all queued gallery images are on disk (raises any
        worker error). Call before reading the files back or exiting."""
        self.writer.flush()
        self.tb.flush()

    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def profile(self, name: str, enabled: bool = True):
        """A named span in a ``torch.profiler`` trace
        (``record_function``)."""
        if not enabled:
            yield
            return
        import torch
        with torch.profiler.record_function(name):
            yield

    def start_profiler_trace(self, logdir: Optional[str] = None) -> None:
        """Trace host and CUDA activity until ``stop_profiler_trace``,
        which writes a Chrome trace under ``logdir`` (default
        ``<run_dir>/trace``)."""
        import torch
        from torch.profiler import ProfilerActivity
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._trace_dir = logdir or os.path.join(self.run_dir, "trace")
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()

    def stop_profiler_trace(self) -> str:
        """Stop the trace and write it; returns the trace file's path."""
        prof, self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(self._trace_dir, exist_ok=True)
        path = os.path.join(self._trace_dir,
                            f"trace_{int(time.time())}.json")
        prof.export_chrome_trace(path)
        return path
