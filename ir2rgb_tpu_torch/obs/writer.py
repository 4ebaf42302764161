"""Asynchronous image writer — PNG encodes off the train/serve hot path.

The reference's visualizer writes gallery PNGs synchronously on the
training thread (SURVEY.md §2.4 util/visualizer rows), stalling the step
loop for several ms per image at every display interval. Here writes go
through a bounded queue drained by worker threads that call the native
libpng encoder (``data/native.py::encode_png`` — no GIL held during the
write, level-1 compression), so the device stays busy while the host
encodes. ``flush()`` barriers before anything reads the files back
(HTML galleries, tests); worker errors are re-raised there rather than
swallowed.

The port's copy of ``ir2rgb_tpu/obs/writer.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Tuple

import numpy as np

_SENTINEL = (None, None)


class AsyncImageWriter:
    def __init__(self, workers: int = 2, max_queue: int = 64):
        self._q: "queue.Queue[Tuple[Optional[str], Optional[np.ndarray]]]" \
            = queue.Queue(maxsize=max_queue)
        self._error: Optional[BaseException] = None
        self._workers = max(1, workers)
        self._threads: List[threading.Thread] = []
        self._start_lock = threading.Lock()

    def _ensure_workers(self) -> None:
        # lazy: a Visualizer that never displays an image costs no threads
        if self._threads:
            return
        with self._start_lock:
            if self._threads:
                return
            for _ in range(self._workers):
                t = threading.Thread(target=self._worker, daemon=True)
                t.start()
                self._threads.append(t)

    def _worker(self) -> None:
        # the import itself can fail (broken install, circular-import
        # regression): it must surface via _error like any encode error —
        # a worker that dies BEFORE the consume loop would leave queued
        # tasks undrained and deadlock flush()/write() silently
        encode_png = None
        try:
            from ir2rgb_tpu_torch.data.native import encode_png
        except BaseException as e:
            if self._error is None:
                self._error = e
        while True:
            path, img = self._q.get()
            try:
                if path is None:
                    return
                if encode_png is None:
                    continue  # import failed; error already recorded
                encode_png(path, img)
            except BaseException as e:  # surfaced on flush/close
                if self._error is None:
                    self._error = e
            finally:
                self._q.task_done()

    def write(self, path: str, img: np.ndarray) -> None:
        """Queue one HWC/HW uint8 image; blocks only when the (bounded)
        queue is full — backpressure instead of unbounded memory."""
        self._ensure_workers()
        self._q.put((path, np.asarray(img)))

    def flush(self) -> None:
        """Wait until every queued image is on disk; raise any worker
        error."""
        self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.flush()
        for _ in self._threads:
            self._q.put(_SENTINEL)
        for t in self._threads:
            t.join()
        self._threads = []
