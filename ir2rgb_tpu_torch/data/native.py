"""ctypes binding for the native C++ frame decoder (native/decoder.cpp).

The port's copy of ``ir2rgb_tpu/data/native.py``. It loads the same
``<repo>/native/libi2rdecode.so`` (running ``make -C native`` first
when the file is missing) and exposes ``decode_batch``; where the
library cannot load (the toolchain or libjpeg / libpng missing) it
decodes with PIL instead, so the Python-only path works everywhere.
``decoder_in_use()`` says which of the two a process runs. This is host
decode; the device path starts at the uint8 batch.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libi2rdecode.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    with _LIB_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        try:
            if not os.path.exists(_SO_PATH):
                subprocess.run(["make", "-C", _NATIVE_DIR],
                               check=True, capture_output=True)
            lib = ctypes.CDLL(_SO_PATH)
            lib.i2r_decode_batch.restype = ctypes.c_int
            lib.i2r_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.i2r_decode_resize.restype = ctypes.c_int
            lib.i2r_decode_resize.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.i2r_encode_png.restype = ctypes.c_int
            lib.i2r_encode_png.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.i2r_encode_png_batch.restype = ctypes.c_int
            lib.i2r_encode_png_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            if hasattr(lib, "i2r_decode_ids_batch"):  # older cached .so
                lib.i2r_decode_ids_batch.restype = ctypes.c_int
                lib.i2r_decode_ids_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int32),
                ]
            if hasattr(lib, "i2r_encode_jpeg_mem"):  # older cached .so
                lib.i2r_encode_jpeg_mem.restype = ctypes.c_long
                lib.i2r_encode_jpeg_mem.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                ]
            if hasattr(lib, "i2r_decode_jpeg_mem_batch"):  # older .so
                lib.i2r_decode_jpeg_mem_batch.restype = ctypes.c_int
                lib.i2r_decode_jpeg_mem_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_long),
                    ctypes.POINTER(ctypes.c_long),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8),
                ]
            _LIB = lib
        except Exception:
            _LIB_FAILED = True
        return _LIB


def native_available() -> bool:
    return _load() is not None


def decoder_in_use() -> str:
    """"native" (the C++ thread pool of libi2rdecode.so) or "pil"."""
    return "native" if native_available() else "pil"


def decode_batch(paths: List[str], out_h: int, out_w: int,
                 gray: bool = False, threads: int = 0) -> np.ndarray:
    """Decode+resize a list of images to (N, H, W, C) uint8.

    Uses the C++ thread pool when available; PIL otherwise. Failed decodes
    raise (native path zeroes the slot and reports a count)."""
    if any("#" in p for p in paths):
        from .video import decode_mixed_batch, is_virtual_frame
        if any(is_virtual_frame(p) for p in paths):
            # MJPEG/AVI virtual frame paths ("clip.avi#000042") — route
            # to the container reader (which decodes plain paths in the
            # batch via _decode_plain_batch, never back through here)
            return decode_mixed_batch(paths, out_h, out_w, gray, threads)
        # just an image file with '#' in its name — decode normally
    return _decode_plain_batch(paths, out_h, out_w, gray, threads)


def _decode_plain_batch(paths: List[str], out_h: int, out_w: int,
                        gray: bool, threads: int = 0) -> np.ndarray:
    """File-path decode (no virtual-frame dispatch) — decode_batch's
    engine, also called directly by video.decode_mixed_batch."""
    c = 1 if gray else 3
    lib = _load()
    if lib is None:
        return _decode_batch_pil(paths, out_h, out_w, gray)
    out = np.empty((len(paths), out_h, out_w, c), np.uint8)
    arr = (ctypes.c_char_p * len(paths))(
        *[p.encode() for p in paths])
    failures = lib.i2r_decode_batch(
        arr, len(paths), out_h, out_w, int(gray), threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if failures:
        bad = _find_bad_paths(paths)
        raise IOError(f"native decoder failed on {failures}/{len(paths)} "
                      f"images; unreadable: {bad[:5]}")
    return out


def decode_ids_batch(paths: List[str], out_h: int, out_w: int,
                     threads: int = 0) -> np.ndarray:
    """Decode instance/semantic id maps to (N, H, W) int32 with NEAREST
    resize (ids never blend) — the pix2pixHD --instance_feat / --label_nc
    input path. Native thread pool for PNGs; PIL for anything else (and
    for any file the native path rejects), preserving the file's native
    id space: gray values, palette indices, or folded 24-bit RGB."""
    virtual = [p for p in paths if "#" in p and ".avi" in p.lower()]
    if virtual:
        # id maps must be lossless — JPEG (the only AVI codec here)
        # would blend/shift class ids at block boundaries
        raise ValueError(
            f"instance/label id maps cannot come from MJPEG video "
            f"(lossy JPEG frames corrupt integer ids): {virtual[0]}. "
            f"Provide id maps as PNG frame folders.")
    lib = _load()
    if lib is not None and hasattr(lib, "i2r_decode_ids_batch") and paths:
        out = np.empty((len(paths), out_h, out_w), np.int32)
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        failures = lib.i2r_decode_ids_batch(
            arr, len(paths), out_h, out_w, threads,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if not failures:
            return out
        # non-PNG or unreadable files in the batch: redo the whole batch
        # via PIL so every slot is correct (failed slots are unmarked)
    return _decode_ids_pil(paths, out_h, out_w)


def _decode_ids_pil(paths: List[str], out_h: int, out_w: int) -> np.ndarray:
    from PIL import Image
    out = np.empty((len(paths), out_h, out_w), np.int32)
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            if im.size != (out_w, out_h):
                im = im.resize((out_w, out_h), Image.NEAREST)
            a = np.asarray(im)
        if a.ndim == 3:  # RGB-encoded ids: fold channels into one id
            a = (a[..., 0].astype(np.int32) * 65536
                 + a[..., 1].astype(np.int32) * 256
                 + a[..., 2].astype(np.int32))
        out[i] = a.astype(np.int32)
    return out


def _find_bad_paths(paths: List[str]) -> List[str]:
    """Second pass via PIL to name the corrupt/truncated files in an
    error message (the C ABI only reports a failure count)."""
    from PIL import Image
    bad = []
    for p in paths:
        try:
            with Image.open(p) as im:
                im.convert("RGB")
        except Exception:
            bad.append(p)
    return bad or ["<none reproducible via PIL>"]


def _decode_batch_pil(paths: List[str], out_h: int, out_w: int,
                      gray: bool) -> np.ndarray:
    from PIL import Image
    c = 1 if gray else 3
    out = np.empty((len(paths), out_h, out_w, c), np.uint8)
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            im = im.convert("L" if gray else "RGB")
            if im.size != (out_w, out_h):
                im = im.resize((out_w, out_h), Image.BILINEAR)
            a = np.asarray(im, np.uint8)
        out[i] = a[..., None] if gray else a
    return out


def encode_png(path: str, img: np.ndarray) -> None:
    """Write an HWC (or HW) uint8 image as PNG — native libpng encoder
    (compression level 1, no GIL during the write) when available, PIL
    otherwise. The serve/gallery write path (obs.AsyncImageWriter)."""
    arr = np.ascontiguousarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    lib = _load()
    if lib is None or arr.shape[2] not in (1, 3):
        from PIL import Image
        pil_arr = arr[..., 0] if arr.shape[2] == 1 else arr
        Image.fromarray(pil_arr).save(path)
        return
    rc = lib.i2r_encode_png(
        path.encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        arr.shape[0], arr.shape[1], arr.shape[2])
    if rc:
        raise IOError(f"native PNG encode failed: {path}")


def decode_jpeg_mem_batch(blob: np.ndarray, offsets: np.ndarray,
                          sizes: np.ndarray, out_h: int, out_w: int,
                          gray: bool = False, threads: int = 0
                          ) -> np.ndarray:
    """Decode JPEG byte ranges inside one uint8 blob to (N, H, W, C)
    uint8 — MJPEG/AVI frames read in a single file pass (data/video.py).
    C++ thread pool when available; PIL otherwise. Raises on any failed
    frame (a video with an undecodable frame is corrupt, not sparse)."""
    n = len(offsets)
    c = 1 if gray else 3
    offs = np.ascontiguousarray(offsets, np.int64)
    szs = np.ascontiguousarray(sizes, np.int64)
    blob = np.ascontiguousarray(blob, np.uint8)
    lib = _load()
    if lib is not None and hasattr(lib, "i2r_decode_jpeg_mem_batch") and n:
        out = np.empty((n, out_h, out_w, c), np.uint8)
        failures = lib.i2r_decode_jpeg_mem_batch(
            blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            szs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            n, out_h, out_w, int(gray), threads,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if failures:
            raise IOError(f"native MJPEG decode failed on {failures}/{n} "
                          f"frames (corrupt video stream?)")
        return out
    import io

    from PIL import Image
    out = np.empty((n, out_h, out_w, c), np.uint8)
    for i, (o, s) in enumerate(zip(offs, szs)):
        with Image.open(io.BytesIO(blob[o:o + s].tobytes())) as im:
            im = im.convert("L" if gray else "RGB")
            if im.size != (out_w, out_h):
                im = im.resize((out_w, out_h), Image.BILINEAR)
            a = np.asarray(im, np.uint8)
        out[i] = a[..., None] if gray else a
    return out


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """Encode an HWC (or HW) uint8 image to JPEG bytes in memory —
    libjpeg-turbo without the GIL when the native lib is available, PIL
    otherwise. Frame payload for the MJPEG/AVI video writer
    (obs.video.MJPEGAviWriter)."""
    arr = np.ascontiguousarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    lib = _load()
    if lib is not None and hasattr(lib, "i2r_encode_jpeg_mem") \
            and arr.shape[2] in (1, 3):
        # worst-case JPEG output is bounded well under raw + header slack
        cap = arr.size * 2 + (1 << 16)
        out = np.empty(cap, np.uint8)
        n = lib.i2r_encode_jpeg_mem(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            arr.shape[0], arr.shape[1], arr.shape[2], int(quality),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n > 0:
            return out[:n].tobytes()
        # fall through to PIL on error (e.g. zero-sized image)
    import io

    from PIL import Image
    pil_arr = arr[..., 0] if arr.shape[2] == 1 else arr
    buf = io.BytesIO()
    Image.fromarray(pil_arr).save(buf, "JPEG", quality=int(quality))
    return buf.getvalue()


def encode_png_batch(paths: List[str], imgs: np.ndarray,
                     threads: int = 0) -> None:
    """Thread-pooled PNG write of an (N, H, W, C) uint8 stack."""
    arr = np.ascontiguousarray(imgs, np.uint8)
    lib = _load()
    if lib is None or arr.shape[3] not in (1, 3):
        for p, im in zip(paths, arr):
            encode_png(p, im)
        return
    cp = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    failures = lib.i2r_encode_png_batch(
        cp, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        arr.shape[0], arr.shape[1], arr.shape[2], arr.shape[3], threads)
    if failures:
        raise IOError(f"native PNG encode failed on {failures} images")
