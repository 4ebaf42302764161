"""Frame-folder discovery.

Rebuild of the reference's ``data/image_folder.py`` + aligned/temporal
dataset indexing (SURVEY.md §2.3): recursive walk filtering image
extensions, sorted so paired IR (``A/``) and RGB (``B/``) folders align by
index; temporal mode groups per-video subfolders into frame sequences.

Supported layouts:
- ``root/A/*.png`` + ``root/B/*.png`` — aligned pairs by sorted order;
- ``root/trainA`` / ``root/trainB`` (phase-prefixed variant);
- ``root/A/<video>/*.png`` + ``root/B/<video>/*.png`` — temporal sequences.

The port's copy of ``ir2rgb_tpu/data/folder.py`` (plain Python
and numpy; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff",
                  ".webp")


def is_image_file(name: str) -> bool:
    return name.lower().endswith(IMG_EXTENSIONS)


def make_dataset(directory: str,
                 max_size: Optional[int] = None) -> List[str]:
    """Sorted recursive list of frame paths (reference make_dataset).

    MJPEG/AVI video files count as frame folders: each ``clip.avi``
    expands into virtual per-frame paths ``clip.avi#000042`` that the
    decode funnel resolves through data/video.py — IR cameras commonly
    record MJPEG AVI, and the reference required pre-extracting frames
    with ffmpeg first."""
    from .video import frame_paths, is_avi_file
    paths: List[str] = []
    for root, _, files in sorted(os.walk(directory)):
        for f in sorted(files):
            if is_image_file(f):
                paths.append(os.path.join(root, f))
            elif is_avi_file(f):
                paths.extend(frame_paths(os.path.join(root, f)))
    if max_size is not None:
        paths = paths[:max_size]
    return paths


def _resolve_ab_dirs(root: str, phase: str) -> Tuple[str, str]:
    candidates = [
        (os.path.join(root, f"{phase}A"), os.path.join(root, f"{phase}B")),
        (os.path.join(root, "A", phase), os.path.join(root, "B", phase)),
        (os.path.join(root, "A"), os.path.join(root, "B")),
    ]
    for a, b in candidates:
        if os.path.isdir(a) and os.path.isdir(b):
            return a, b
    raise FileNotFoundError(
        f"no A/B (IR/RGB) folder pair under {root} for phase {phase}; "
        f"tried {[c for c in candidates]}")


def _check_counts_match(a_paths: List[str], b_paths: List[str],
                        a_dir: str, b_dir: str) -> None:
    """A/B pairing is by sorted index, so a count mismatch means a file
    is missing somewhere — truncating would silently misalign every pair
    after a mid-sequence gap (wrong RGB target for ~half the dataset).
    Fail loudly with the first divergent basename instead."""
    if len(a_paths) == len(b_paths):
        return
    hint = ""
    a_names = [os.path.splitext(os.path.basename(p))[0] for p in a_paths]
    b_names = [os.path.splitext(os.path.basename(p))[0] for p in b_paths]
    for i, (an, bn) in enumerate(zip(a_names, b_names)):
        if an != bn:
            hint = (f"; first basename divergence at sorted index {i}: "
                    f"A={an!r} vs B={bn!r}")
            break
    raise ValueError(
        f"A/B frame count mismatch: {len(a_paths)} files under {a_dir} "
        f"vs {len(b_paths)} under {b_dir}{hint}. Pairing is by sorted "
        f"index, so a missing file would silently misalign every later "
        f"pair — fix the dataset (or remove the unpaired frames).")


def find_single_images(root: str, phase: str = "test",
                       max_size: Optional[int] = None
                       ) -> List[Tuple[str, str]]:
    """Input-only dataset (the family's ``--dataset_mode single``):
    IR frames with no ground-truth RGB. Accepts the usual A-folder
    layouts or a flat image folder as the root itself. Each item pairs
    the frame with itself so the decode/transform path stays uniform;
    the infer CLI skips target metrics/galleries in this mode."""
    candidates = [os.path.join(root, f"{phase}A"),
                  os.path.join(root, "A", phase),
                  os.path.join(root, "A")]
    for a_dir in candidates:
        if os.path.isdir(a_dir):
            paths = make_dataset(a_dir)
            if paths:
                pairs = [(p, p) for p in paths]
                return pairs[:max_size] if max_size is not None else pairs
    # flat-folder fallback: the root itself holds the frames. Refuse if
    # the root looks like a PAIRED dataset layout — the recursive sweep
    # would silently interleave ground-truth B frames (and other phases)
    # into the inputs instead of erroring.
    import re
    paired_subs = [d for d in sorted(os.listdir(root))
                   if os.path.isdir(os.path.join(root, d))
                   and re.fullmatch(r"(train|test|val)?[AB]|"
                                    r"(train|test|val)(A|B|Inst)", d)]
    if paired_subs:
        raise FileNotFoundError(
            f"dataset_mode=single found no {phase}A/ input folder under "
            f"{root}, but the root contains paired-layout folders "
            f"{paired_subs} — refusing to sweep them as inputs. Point "
            f"--data.dataroot at the input folder itself, or add a "
            f"{phase}A/ split.")
    paths = make_dataset(root)
    if paths:
        pairs = [(p, p) for p in paths]
        return pairs[:max_size] if max_size is not None else pairs
    raise FileNotFoundError(
        f"no input frames under {root} for phase {phase} "
        f"(tried {candidates} and the root itself)")


def find_aligned_pairs(root: str, phase: str = "train",
                       max_size: Optional[int] = None
                       ) -> List[Tuple[str, str]]:
    """Index-aligned (IR, RGB) path pairs."""
    a_dir, b_dir = _resolve_ab_dirs(root, phase)
    a_paths = make_dataset(a_dir)
    b_paths = make_dataset(b_dir)
    _check_counts_match(a_paths, b_paths, a_dir, b_dir)
    pairs = list(zip(a_paths, b_paths))
    if max_size is not None:
        pairs = pairs[:max_size]
    return pairs


def find_unaligned_sets(root: str, phase: str = "train",
                        max_size: Optional[int] = None
                        ) -> Tuple[List[str], List[str]]:
    """Independent A-side and B-side path lists for UNPAIRED training
    (the family's ``--dataset_mode unaligned``, the CycleGAN data layout:
    ``trainA/`` and ``trainB/`` hold unrelated image sets; no index
    alignment or count matching — pairing happens randomly at batch
    time in the loader)."""
    a_dir, b_dir = _resolve_ab_dirs(root, phase)
    a_paths = make_dataset(a_dir, max_size)
    b_paths = make_dataset(b_dir, max_size)
    if not a_paths or not b_paths:
        raise FileNotFoundError(
            f"dataset_mode=unaligned needs images in both {a_dir} "
            f"({len(a_paths)} found) and {b_dir} ({len(b_paths)} found)")
    return a_paths, b_paths


def find_temporal_sequences(root: str, phase: str = "train",
                            n_frames: int = 4,
                            stride: int = 1,
                            max_size: Optional[int] = None
                            ) -> List[List[Tuple[str, str]]]:
    """Sliding windows of n_frames aligned (IR, RGB) pairs per video.

    Videos are subfolders of A/ and B/; flat folders are treated as one
    video (sequential frames).
    """
    a_dir, b_dir = _resolve_ab_dirs(root, phase)
    subdirs = sorted(d for d in os.listdir(a_dir)
                     if os.path.isdir(os.path.join(a_dir, d)))
    videos: List[List[Tuple[str, str]]] = []
    if subdirs:
        for d in subdirs:
            a_paths = make_dataset(os.path.join(a_dir, d))
            b_paths = make_dataset(os.path.join(b_dir, d))
            _check_counts_match(a_paths, b_paths,
                                os.path.join(a_dir, d),
                                os.path.join(b_dir, d))
            videos.append(list(zip(a_paths, b_paths)))
    else:
        a_paths = make_dataset(a_dir)
        b_paths = make_dataset(b_dir)
        _check_counts_match(a_paths, b_paths, a_dir, b_dir)
        # a flat folder is one video — unless it holds .avi containers,
        # where each file is its own sequence (frames from different
        # videos must never share a temporal window)
        from .video import sequence_key
        pairs = list(zip(a_paths, b_paths))
        groups: dict = {}
        for pa, pb in pairs:
            groups.setdefault(sequence_key(pa), []).append((pa, pb))
        videos.extend(groups[k] for k in sorted(groups))
    windows: List[List[Tuple[str, str]]] = []
    for frames in videos:
        for start in range(0, len(frames) - n_frames + 1, stride):
            windows.append(frames[start:start + n_frames])
    if max_size is not None:
        windows = windows[:max_size]
    return windows


def find_inst_maps(root: str, phase: str = "train",
                   max_size: Optional[int] = None) -> Optional[List[str]]:
    """Optional instance-map folder (pix2pixHD --instance_feat surface):
    ``root/<phase>Inst``, ``root/Inst/<phase>`` or ``root/Inst`` of
    id-valued images aligned by sorted order with the A/B pairs. Returns
    None when the dataset carries no instance maps."""
    candidates = [
        os.path.join(root, f"{phase}Inst"),
        os.path.join(root, "Inst", phase),
        os.path.join(root, "Inst"),
    ]
    for d in candidates:
        if os.path.isdir(d):
            paths = make_dataset(d)
            if max_size is not None:
                paths = paths[:max_size]
            return paths
    return None
