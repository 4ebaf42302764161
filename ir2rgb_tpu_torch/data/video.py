"""MJPEG/AVI video files as dataset inputs.

IR/thermal cameras commonly record Motion-JPEG AVI; the reference
workflow required pre-extracting frame folders with ffmpeg before
training (SURVEY.md §2.3 — frame folders are the only input the family's
``image_folder`` understands). Here a ``.avi`` file IS a frame folder:
``folder.make_dataset`` expands each video into virtual frame paths
``clip.avi#000042``, and the decode funnel (``native.decode_batch``)
routes those through this module — one buffered read per file per batch,
then the native thread-pooled in-memory JPEG decoder
(native/decoder.cpp::i2r_decode_jpeg_mem_batch), PIL fallback included.

Only MJPEG streams are supported (fourcc MJPG/mjpg/dmb1, or raw-JPEG
'00db' chunks); compressed codecs (H.264 etc.) need a system decoder
this environment doesn't ship — the error says so explicitly. The writer
side lives in obs/video.py; the two round-trip in tests/test_avi_input.py.

The port's copy of ``ir2rgb_tpu/data/video.py`` (plain Python
and numpy; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, List, Tuple

import numpy as np

AVI_EXTENSIONS = (".avi",)

# frame index width in virtual paths: zero-padded so lexicographic sort
# equals frame order (folder.make_dataset sorts paths)
_IDX_WIDTH = 6


def is_avi_file(name: str) -> bool:
    return name.lower().endswith(AVI_EXTENSIONS)


def is_virtual_frame(path: str) -> bool:
    """True for ``<file>.avi#<NNNNNN>`` virtual frame paths."""
    file, sep, idx = path.rpartition("#")
    return bool(sep) and is_avi_file(file) and idx.isdigit()


def split_virtual(path: str) -> Tuple[str, int]:
    file, _, idx = path.rpartition("#")
    return file, int(idx)


def frame_paths(avi_path: str) -> List[str]:
    """Expand a video file into its virtual per-frame paths."""
    n = avi_index(avi_path).n
    return [f"{avi_path}#{i:0{_IDX_WIDTH}d}" for i in range(n)]


def sequence_key(path: str) -> str:
    """Grouping key for 'which video does this frame belong to':
    the container file for virtual frames, the directory otherwise.
    (cli/infer.py resets the temporal carry on key change; temporal
    indexing groups windows by it.)"""
    if is_virtual_frame(path):
        return split_virtual(path)[0]
    return os.path.dirname(path)


class AviIndex:
    """Parsed frame directory of one MJPEG AVI: byte ranges + geometry."""

    __slots__ = ("offsets", "sizes", "n", "fps", "hw")

    def __init__(self, offsets: np.ndarray, sizes: np.ndarray, fps: float,
                 hw: Tuple[int, int]):
        self.offsets = offsets  # int64, absolute file offsets of payloads
        self.sizes = sizes      # int64
        self.n = len(offsets)
        self.fps = fps
        self.hw = hw            # (H, W) from the strf BITMAPINFOHEADER


_CACHE: Dict[str, Tuple[float, "AviIndex"]] = {}
_CACHE_LOCK = threading.Lock()


def avi_index(path: str) -> AviIndex:
    """Index a video's frames (cached per file by mtime — the prefetch
    thread and size checks hit the same files repeatedly)."""
    mtime = os.path.getmtime(path)
    with _CACHE_LOCK:
        hit = _CACHE.get(path)
        if hit is not None and hit[0] == mtime:
            return hit[1]
    idx = _parse_avi(path)
    with _CACHE_LOCK:
        _CACHE[path] = (mtime, idx)
    return idx


def _parse_avi(path: str) -> AviIndex:
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise ValueError(f"{path}: not a RIFF AVI file")
        fps = 0.0
        hw = (0, 0)
        stream = 0
        movi_pos = movi_size = None
        idx1 = None
        # walk top-level chunks; descend only into the LISTs we need
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            fourcc, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            start = f.tell()
            if fourcc == b"LIST":
                kind = f.read(4)
                if kind == b"hdrl":
                    fps, hw, stream = _parse_hdrl(f.read(size - 4), path)
                    f.seek(start + size + (size & 1))
                    continue
                if kind == b"movi":
                    movi_pos, movi_size = start - 8, size
                    f.seek(start + size + (size & 1))
                    continue
                f.seek(start + size + (size & 1))
            elif fourcc == b"idx1":
                idx1 = f.read(size)
                f.seek(start + size + (size & 1))
            else:
                f.seek(start + size + (size & 1))
        if movi_pos is None:
            raise ValueError(f"{path}: no movi list (truncated AVI?)")
        ids = (b"%02ddc" % stream, b"%02ddb" % stream)
        if idx1:
            offs, sizes = _index_from_idx1(f, idx1, movi_pos, ids)
        else:
            offs, sizes = _index_from_movi(f, movi_pos, movi_size, ids)
    return AviIndex(np.asarray(offs, np.int64), np.asarray(sizes, np.int64),
                    fps, hw)


def _parse_hdrl(data: bytes, path: str
                ) -> Tuple[float, Tuple[int, int], int]:
    """Find the VIDEO stream among the hdrl's strh entries (a camera
    MJPEG often carries an audio track, sometimes listed first): fps
    from its strh scale/rate, geometry from the strf that follows it,
    and the stream's index (movi chunk ids are '<NN>dc'). MJPEG check
    on that stream only."""
    streams = []
    i = data.find(b"strh")
    while i >= 0:
        streams.append(i)
        i = data.find(b"strh", i + 4)
    for n, i in enumerate(streams):
        if data[i + 8:i + 12] != b"vids":
            continue
        handler = data[i + 12:i + 16]
        if handler not in (b"MJPG", b"mjpg", b"dmb1",
                           b"\x00\x00\x00\x00", b"    "):
            raise ValueError(
                f"{path}: video stream is {handler!r}, not MJPG — only "
                f"Motion-JPEG AVIs decode here (re-encode with e.g. "
                f"ffmpeg -c:v mjpeg, or extract frames to a folder)")
        scale, rate = struct.unpack_from("<2I", data, i + 28)
        fps = rate / scale if scale else 0.0
        hw = (0, 0)
        j = data.find(b"strf", i)  # this stream's format chunk
        if j >= 0:
            w, h = struct.unpack_from("<2i", data, j + 12)
            hw = (abs(h), abs(w))  # negative biHeight = top-down
        return fps, hw, n
    raise ValueError(f"{path}: no video ('vids') stream in the AVI "
                     f"header ({len(streams)} stream(s) found)")


def _index_from_idx1(f, idx1: bytes, movi_pos: int, ids: Tuple[bytes, bytes]
                     ) -> Tuple[List[int], List[int]]:
    """idx1 entries -> absolute payload ranges for the video stream's
    chunk ids. The offset convention is ambiguous in the wild (relative
    to the 'movi' fourcc vs absolute file offsets); disambiguate by
    checking where a chunk header actually sits, the way ffmpeg does."""
    entries = [struct.unpack_from("<4s3I", idx1, k)
               for k in range(0, len(idx1) - 15, 16)]
    entries = [(ck, off, sz) for ck, fl, off, sz in entries if ck in ids]
    if not entries:
        return [], []
    base = movi_pos + 8  # offsets measured from the 'movi' fourcc
    _, off0, _ = entries[0]
    f.seek(base + off0)
    if f.read(4) not in ids:
        base = 0  # absolute-offset variant
        f.seek(off0)
        if f.read(4) not in ids:
            raise ValueError("idx1 offsets match neither convention; "
                             "falling back to a movi scan would hide real "
                             "corruption — refusing")
    offs = [base + off + 8 for _, off, _ in entries]
    sizes = [sz for _, _, sz in entries]
    return offs, sizes


def _index_from_movi(f, movi_pos: int, movi_size: int,
                     ids: Tuple[bytes, bytes]
                     ) -> Tuple[List[int], List[int]]:
    """No idx1: scan the movi list chunk-by-chunk (header reads only)."""
    offs, sizes = [], []
    p = movi_pos + 12
    end = movi_pos + 8 + movi_size
    f.seek(p)
    while p + 8 <= end:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        fourcc, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if fourcc in ids and size:
            offs.append(p + 8)
            sizes.append(size)
        p += 8 + size + (size & 1)
        f.seek(p)
    return offs, sizes


def avi_native_size(path: str) -> Tuple[int, int]:
    """(H, W) of a video's frames — loader._native_size analog, from the
    strf header (no frame decode)."""
    hw = avi_index(path).hw
    if hw == (0, 0):
        # header lacked strf dims: decode frame 0's JPEG header via PIL
        from PIL import Image
        import io
        idx = avi_index(path)
        with open(path, "rb") as f:
            f.seek(int(idx.offsets[0]))
            blob = f.read(int(idx.sizes[0]))
        with Image.open(io.BytesIO(blob)) as im:
            return im.size[1], im.size[0]
    return hw


def decode_mixed_batch(paths: List[str], out_h: int, out_w: int,
                       gray: bool = False, threads: int = 0) -> np.ndarray:
    """Decode a batch that may mix virtual AVI frames and plain image
    files, preserving order. Frames are grouped per container so each
    video is read in one buffered pass (coalesced spans), then decoded
    by the native thread pool."""
    from . import native

    c = 1 if gray else 3
    out = np.empty((len(paths), out_h, out_w, c), np.uint8)
    plain = [(i, p) for i, p in enumerate(paths) if not is_virtual_frame(p)]
    if plain:
        dec = native._decode_plain_batch([p for _, p in plain], out_h,
                                         out_w, gray, threads)
        for (i, _), img in zip(plain, dec):
            out[i] = img
    by_file: Dict[str, List[Tuple[int, int]]] = {}
    for i, p in enumerate(paths):
        if is_virtual_frame(p):
            file, fr = split_virtual(p)
            by_file.setdefault(file, []).append((i, fr))
    for file, items in by_file.items():
        idx = avi_index(file)
        frames = [fr for _, fr in items]
        bad = [fr for fr in frames if fr >= idx.n]
        if bad:
            raise IndexError(f"{file}: frame {bad[0]} requested but the "
                             f"video has {idx.n} frames")
        blob, offs, sizes = _read_spans(file, idx, frames)
        dec = native.decode_jpeg_mem_batch(blob, offs, sizes, out_h, out_w,
                                           gray=gray, threads=threads)
        for (i, _), img in zip(items, dec):
            out[i] = img
    return out


def _read_spans(file: str, idx: AviIndex, frames: List[int]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read the requested frames' payloads into one blob. Consecutive
    frames coalesce into single reads (the common sequential-batch case
    is one read for the whole span)."""
    offs = idx.offsets[frames]
    sizes = idx.sizes[frames]
    order = np.argsort(offs, kind="stable")
    blob = np.empty(int(sizes.sum()), np.uint8)
    new_offs = np.empty(len(frames), np.int64)
    pos = 0
    with open(file, "rb") as f:
        k = 0
        while k < len(order):
            # coalesce a run of byte-adjacent payloads into one read
            j = k
            run_end = offs[order[k]] + sizes[order[k]]
            while (j + 1 < len(order)
                   and offs[order[j + 1]] <= run_end + 8):
                j += 1
                run_end = max(run_end, offs[order[j]] + sizes[order[j]])
            run_start = int(offs[order[k]])
            f.seek(run_start)
            span = np.frombuffer(f.read(int(run_end - run_start)), np.uint8)
            for t in range(k, j + 1):
                i = order[t]
                s, n = int(offs[i] - run_start), int(sizes[i])
                blob[pos:pos + n] = span[s:s + n]
                new_offs[i] = pos
                pos += n
            k = j + 1
    return blob, new_offs, sizes
