"""Dependency-free MJPEG/AVI video writer.

The reference family's video workflows (temporal models, webcam/serving
demos) assemble output frames into a video file via ffmpeg/opencv
(SURVEY.md §2.4 util row — unverifiable against the empty mount); this
environment has neither, so the container is written directly: a RIFF
AVI-1.0 file whose stream is Motion-JPEG ('MJPG') — every mainstream
player (ffmpeg, VLC, browsers via transcode, opencv) reads it, and each
frame is an independent baseline JPEG produced by the native
libjpeg-turbo encoder (native/decoder.cpp::i2r_encode_jpeg_mem, GIL-free)
with a PIL fallback.

Layout written (AVI-1.0 with the mandatory idx1 index):

    RIFF 'AVI '
      LIST 'hdrl'
        avih                    main header (frame count patched on close)
        LIST 'strl'  strh+strf  one 'vids'/'MJPG' stream
      LIST 'movi'   00dc ...    one chunk per frame (even-padded)
      idx1                      keyframe index (every MJPEG frame is one)

Frame count/sizes are unknown until close(), so avih.dwTotalFrames,
strh.dwLength and the RIFF/movi sizes are back-patched — the standard
single-pass AVI recipe. Frames must share one geometry (a video has one
frame size); dtype uint8, HWC with C in {1, 3} (gray frames are encoded
as grayscale JPEGs; players upsample).

The port's copy of ``ir2rgb_tpu/obs/video.py``.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

from ir2rgb_tpu_torch.data import native

_AVIF_HASINDEX = 0x00000010
_AVIIF_KEYFRAME = 0x00000010


class MJPEGAviWriter:
    """Single-pass MJPEG AVI writer; use as a context manager.

    >>> with MJPEGAviWriter("out.avi", fps=30) as w:
    ...     for frame in frames:   # (H, W, 3) uint8
    ...         w.add(frame)
    """

    def __init__(self, path: str, fps: float = 30.0, quality: int = 90):
        if fps <= 0:
            raise ValueError(f"fps must be positive, got {fps}")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "wb")
        self.path = path
        self.quality = int(quality)
        # dwScale/dwRate as a rational so e.g. 29.97 survives exactly
        self._scale, self._rate = _fps_to_rational(fps)
        self._hw: Optional[Tuple[int, int]] = None
        self._index: list = []  # (offset_in_movi, size) per frame
        self._max_chunk = 0
        self._movi_start = 0  # file offset of the 'movi' LIST size field
        self._closed = False

    # -- public API --------------------------------------------------

    def add(self, frame: np.ndarray) -> None:
        """Append one HWC (or HW) uint8 frame."""
        arr = np.asarray(frame)
        if arr.dtype != np.uint8:
            raise TypeError(f"video frames must be uint8, got {arr.dtype}")
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.ndim != 3 or arr.shape[2] not in (1, 3):
            raise ValueError(f"expected HWC frame with 1 or 3 channels, "
                             f"got shape {arr.shape}")
        if self._hw is None:
            self._hw = (arr.shape[0], arr.shape[1])
            self._write_headers()
        elif self._hw != (arr.shape[0], arr.shape[1]):
            raise ValueError(
                f"frame size changed mid-video: {arr.shape[:2]} after "
                f"{self._hw} (a video stream has one geometry)")
        payload = native.encode_jpeg(arr, self.quality)
        f = self._f
        # offset recorded relative to the byte after the 'movi' fourcc,
        # as players expect from idx1 entries
        off = f.tell() - (self._movi_start + 12)
        f.write(b"00dc" + struct.pack("<I", len(payload)))
        f.write(payload)
        if len(payload) & 1:  # RIFF chunks are even-aligned
            f.write(b"\x00")
        self._index.append((off, len(payload)))
        self._max_chunk = max(self._max_chunk, len(payload))

    @property
    def frames(self) -> int:
        return len(self._index)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        f = self._f
        try:
            if self._hw is None:
                # zero frames: emit a minimal valid header so the file
                # isn't truncated garbage
                self._hw = (2, 2)
                self._write_headers()
            self._patch_sizes(self._write_idx1())
        finally:
            f.close()

    def __enter__(self) -> "MJPEGAviWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- container plumbing ------------------------------------------

    def _write_headers(self) -> None:
        h, w = self._hw
        f = self._f
        usec = int(round(1e6 * self._scale / self._rate))
        avih = struct.pack(
            "<14I", usec, 0, 0, _AVIF_HASINDEX,
            0,          # dwTotalFrames — patched on close
            0, 1,       # dwInitialFrames, dwStreams
            0, w, h, 0, 0, 0, 0)
        strh = struct.pack(
            "<4s4s10I4h", b"vids", b"MJPG", 0, 0, 0,
            self._scale, self._rate, 0,
            0,          # dwLength (frames) — patched on close
            0,          # dwSuggestedBufferSize — patched on close
            0xFFFFFFFF, 0,  # dwQuality (driver default), dwSampleSize
            0, 0, w, h)     # rcFrame: left, top, right, bottom
        strf = struct.pack(
            "<I2i2H2I2i2I", 40, w, h, 1, 24, 0x47504A4D,  # 'MJPG'
            w * h * 3, 0, 0, 0, 0)
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)
        f.write(b"RIFF" + struct.pack("<I", 0) + b"AVI ")  # size patched
        hdrl_start = f.tell()
        f.write(hdrl)
        # absolute offsets of the fields back-patched on close, derived
        # from the blob structure: LIST hdr (12) -> avih chunk hdr (8) ->
        # avih payload; dwTotalFrames is its 5th DWORD. strh payload sits
        # after the avih chunk (8+56) + strl LIST hdr (12) + chunk hdr
        # (8); dwLength is 32 bytes in.
        self._total_frames_off = hdrl_start + 12 + 8 + 16
        self._strh_length_off = hdrl_start + 12 + 8 + 56 + 12 + 8 + 32
        self._movi_start = f.tell()
        f.write(b"LIST" + struct.pack("<I", 4) + b"movi")  # size patched

    def _write_idx1(self) -> int:
        """Append the idx1 chunk; returns its start offset."""
        start = self._f.tell()
        entries = b"".join(
            b"00dc" + struct.pack("<3I", _AVIIF_KEYFRAME, off + 4, size)
            for off, size in self._index)
        self._f.write(_chunk(b"idx1", entries))
        return start

    def _patch_sizes(self, idx1_start: int) -> None:
        f = self._f
        end = f.tell()
        n = len(self._index)
        f.seek(4)
        f.write(struct.pack("<I", end - 8))          # RIFF size
        f.seek(self._total_frames_off)
        f.write(struct.pack("<I", n))                # avih.dwTotalFrames
        f.seek(self._strh_length_off)                # strh.dwLength +
        f.write(struct.pack("<2I", n, self._max_chunk))  # ...BufferSize
        f.seek(self._movi_start + 4)                 # movi LIST size:
        f.write(struct.pack("<I", idx1_start - self._movi_start - 8))
        f.seek(0, os.SEEK_END)


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) & 1 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", 4 + len(payload)) + fourcc + payload


def _fps_to_rational(fps: float) -> Tuple[int, int]:
    """(dwScale, dwRate) with rate/scale == fps; NTSC rates kept exact."""
    if abs(fps - round(fps)) < 1e-9:
        return 1, int(round(fps))
    if abs(fps - 30000 / 1001) < 1e-3:
        return 1001, 30000
    if abs(fps - 24000 / 1001) < 1e-3:
        return 1001, 24000
    return 1000, int(round(fps * 1000))


def read_mjpeg_avi(path: str) -> Tuple[np.ndarray, float]:
    """Decode an MJPEG AVI back to ((N, H, W, C) uint8, fps).

    Round-trip verification/debug utility (tests, notebooks) — walks the
    movi chunks directly rather than trusting idx1, so it also validates
    the writer's structure. Uses PIL for the per-frame JPEG decode.
    """
    import io

    from PIL import Image

    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI file")
    # fps from strh's exact scale/rate rational (avih's µs-per-frame
    # field is a rounded derivative); fall back to avih when absent
    try:
        i = data.index(b"strh") + 8
        scale, rate = struct.unpack_from("<2I", data, i + 20)
        fps = rate / scale if scale else 0.0
    except ValueError:
        i = data.index(b"avih")
        usec = struct.unpack_from("<I", data, i + 8)[0]
        fps = 1e6 / usec if usec else 0.0
    # find the movi LIST, then walk its chunks
    j = data.index(b"LIST", 12)
    while data[j + 8:j + 12] != b"movi":
        j = data.index(b"LIST", j + 4)
    movi_end = j + 8 + struct.unpack_from("<I", data, j + 4)[0]
    p = j + 12
    frames = []
    while p + 8 <= movi_end:
        fourcc = data[p:p + 4]
        size = struct.unpack_from("<I", data, p + 4)[0]
        if fourcc == b"00dc" and size:
            img = Image.open(io.BytesIO(data[p + 8:p + 8 + size]))
            a = np.asarray(img, np.uint8)
            frames.append(a[..., None] if a.ndim == 2 else a)
        p += 8 + size + (size & 1)
    if not frames:
        return np.zeros((0, 0, 0, 0), np.uint8), fps
    return np.stack(frames), fps
