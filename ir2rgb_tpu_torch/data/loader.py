"""Host-side frame loader with background prefetch.

The port's copy of ``ir2rgb_tpu/data/loader.py``, on the port's
``Config``. The host's only jobs are file decode and resize to
``load_size`` uint8 (variable-size work) and a prefetch thread that
keeps the next batch ready; all augmentation runs on the device
(``data/transforms.py``). Batches are numpy uint8; the epoch order comes
from ``np.random.RandomState(cfg.train.seed)``, so one config gives the
same order in both packages.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ir2rgb_tpu_torch.config import Config
from ir2rgb_tpu_torch.parallel.mesh import local_rows
from .folder import find_aligned_pairs, find_temporal_sequences


def _decode_resize(path: str, target_hw, gray: bool = False
                   ) -> np.ndarray:
    from .native import decode_batch
    return decode_batch([path], target_hw[0], target_hw[1], gray=gray)[0]


def _decode_many(paths: List[str], target_hw,
                 gray: bool = False) -> np.ndarray:
    """Batch decode+resize — C++ thread pool when available, PIL fallback
    (data/native.py)."""
    from .native import decode_batch
    return decode_batch(list(paths), target_hw[0], target_hw[1], gray=gray)


def _native_size(path: str):
    from .video import avi_native_size, is_avi_file, is_virtual_frame, \
        split_virtual
    if is_virtual_frame(path):
        # one header parse per container (cached) covers all its frames
        path = split_virtual(path)[0]
    if is_avi_file(path):
        return avi_native_size(path)
    from PIL import Image
    with Image.open(path) as im:
        return im.size[1], im.size[0]  # (H, W)


def _decode_inst(paths: List[str], target_hw) -> np.ndarray:
    """Instance/semantic id maps -> (B, H, W) int32. NEAREST resize only
    — ids must never blend (pix2pixHD --instance_feat / --label_nc
    paths). C++ thread pool for PNGs, PIL fallback (data/native.py)."""
    from .native import decode_ids_batch
    return decode_ids_batch(list(paths), target_hw[0], target_hw[1])


def resolve_target_hw(preprocess: str, load_size: int,
                      first_image: str):
    """Host-side decode target per the reference's resize_or_crop modes
    (SURVEY.md §2.3): resize_and_crop -> (S, S); scale_width[-and_crop] ->
    width = S, height aspect-preserved from the dataset's native size
    (rounded to a multiple of 4 for the s2d/stride pipeline); crop/none ->
    native size. Static per-run so every batch has one shape."""
    if preprocess == "resize_and_crop":
        return load_size, load_size
    h, w = _native_size(first_image)
    if preprocess in ("scale_width", "scale_width_and_crop"):
        th = max(4, int(round(h * load_size / w / 4)) * 4)
        return th, load_size
    if preprocess in ("crop", "none"):
        return (h // 4) * 4, (w // 4) * 4
    raise ValueError(f"unknown preprocess mode: {preprocess}")


class DataLoader:
    """Iterable over uint8 host batches.

    Aligned mode yields {'a': (B,S,S,Ca), 'b': (B,S,S,Cb)}; temporal mode
    {'a': (B,T,S,S,Ca), 'b': ...}. S = load_size; device-side transforms
    crop to crop_size.
    """

    def __init__(self, cfg: Config, phase: Optional[str] = None,
                 shuffle: Optional[bool] = None,
                 shard: Optional[tuple] = None):
        d = cfg.data
        self.cfg = cfg
        self.phase = phase or d.phase
        self.load_size = d.load_size
        self.preprocess = d.preprocess
        self.batch_size = d.batch_size
        self.gray_a = cfg.model.input_nc == 1
        # label_nc > 0: the A side is integer class-id maps — decode via
        # the NEAREST-resize id path (bilinear would blend class ids);
        # the model one-hot encodes on device (train/model.encode_label)
        self.label_a = cfg.model.label_nc > 0
        if d.dataset_mode not in ("aligned", "temporal", "single",
                                  "unaligned"):
            raise ValueError(
                f"unknown dataset_mode {d.dataset_mode!r} "
                "(aligned | unaligned | temporal | single)")
        self.temporal = d.dataset_mode == "temporal"
        self.single = d.dataset_mode == "single"
        self.unaligned = d.dataset_mode == "unaligned"
        if self.label_a and self.temporal:
            raise ValueError(
                "label_nc (semantic-label input) + temporal dataset_mode "
                "are not combined (matches train/model.create_model)")
        if d.dataset_mode == "unaligned" and (
                self.label_a or cfg.model.use_instance_feat
                or cfg.model.use_instance_edges):
            raise ValueError(
                "dataset_mode=unaligned (unpaired CycleGAN data) does "
                "not combine with label_nc / instance maps (matches "
                "train/cycle.create_cycle_model)")
        self.b_items: Optional[List[str]] = None
        if self.temporal:
            self.items: Sequence = find_temporal_sequences(
                d.dataroot, self.phase, d.n_frames_total,
                max_size=d.max_dataset_size)
        elif self.single:
            from .folder import find_single_images
            self.items = find_single_images(d.dataroot, self.phase,
                                            max_size=d.max_dataset_size)
        elif self.unaligned:
            # UNPAIRED sets (CycleGAN layout): epoch indexes the A side;
            # each item draws an independent B frame — random when
            # shuffling, index-aligned modulo len(B) under serial_batches
            # (the family's unaligned_dataset semantics)
            from .folder import find_unaligned_sets
            a_paths, b_paths = find_unaligned_sets(
                d.dataroot, self.phase, max_size=d.max_dataset_size)
            if d.direction == "BtoA":
                a_paths, b_paths = b_paths, a_paths
            self.items = [(p,) for p in a_paths]
            self.b_items = b_paths
        else:
            self.items = find_aligned_pairs(d.dataroot, self.phase,
                                            max_size=d.max_dataset_size)
        if d.direction not in ("AtoB", "BtoA"):
            raise ValueError(f"unknown direction {d.direction!r} "
                             "(AtoB | BtoA)")
        if d.direction == "BtoA" and not (self.single or self.unaligned):
            # reference --which_direction BtoA: swap the pair so the
            # model learns the reverse mapping (aligned_dataset swap)
            if self.temporal:
                self.items = [tuple((pb, pa) for pa, pb in w)
                              for w in self.items]
            else:
                self.items = [(pb, pa) for pa, pb in self.items]
        self.inst_paths = None
        if ((cfg.model.use_instance_feat or cfg.model.use_instance_edges)
                and not self.temporal and not self.unaligned):
            from .folder import find_inst_maps
            self.inst_paths = find_inst_maps(d.dataroot, self.phase,
                                             max_size=d.max_dataset_size)
            if self.inst_paths is None:
                raise FileNotFoundError(
                    f"use_instance_feat/use_instance_edges is on but no "
                    f"instance-map folder "
                    f"({self.phase}Inst / Inst/{self.phase} / Inst) exists "
                    f"under {d.dataroot}")
            if len(self.inst_paths) != len(self.items):
                # positional pairing below — a count mismatch would
                # silently misalign maps or IndexError mid-epoch
                raise ValueError(
                    f"instance-map count ({len(self.inst_paths)}) != "
                    f"image-pair count ({len(self.items)}) under "
                    f"{d.dataroot}; every A/B pair needs exactly one "
                    f"instance map")
        if not self.items:
            raise FileNotFoundError(
                f"no data under {d.dataroot} (phase {self.phase})")
        if len(self.items) < self.batch_size:
            # epoch() drops the final partial batch (static shapes), so
            # fewer items than one batch would make __iter__ spin
            # forever yielding nothing — fail at construction.
            raise ValueError(
                f"dataset has {len(self.items)} item(s) under "
                f"{d.dataroot} (phase {self.phase}) but batch_size is "
                f"{self.batch_size}; partial batches are dropped, so no "
                f"batch could ever be produced. Lower --data.batch_size "
                f"or add data.")
        # this rank's rows of each global batch (all of them: one process)
        world, rank = shard or (1, 0)
        accum = max(1, cfg.train.grad_accum) if world > 1 else 1
        self.rows = local_rows(self.batch_size, world, rank, accum).tolist()
        self.shuffle = (not d.serial_batches if shuffle is None else shuffle)
        self._rng = np.random.RandomState(cfg.train.seed)
        first = (self.items[0][0][0] if self.temporal else self.items[0][0])
        self.target_hw = resolve_target_hw(self.preprocess, self.load_size,
                                           first)
        if self.preprocess != "resize_and_crop":
            # crop/none/scale_width size the whole run off the first image
            # (static shapes); a mixed-resolution dataset would be
            # silently stretched to the first file's geometry, so error
            # instead (the reference operated per-image and never
            # distorted)
            self._check_uniform_native_sizes()

    # at most this many header opens on the startup path; the rest of the
    # dataset is verified lazily, one batch ahead, in the prefetch thread
    SIZE_CHECK_STARTUP_CAP = 256

    def _check_uniform_native_sizes(self) -> None:
        """Reject mixed-resolution datasets in crop/none/scale_width modes
        (the decoder would silently stretch to the first file's geometry).

        Opening every file's header at init would be O(N) PIL opens
        before step 0 on a 100k-frame dataset. So init checks a strided
        sample capped at
        ``SIZE_CHECK_STARTUP_CAP`` (catches most mixed datasets
        immediately, O(1) startup), and every remaining file is verified
        the first time a batch touches it (``_verify_native_sizes``, in
        the prefetch thread, overlapped with compute) — same error,
        amortized cost, each file opened at most once."""
        if self.temporal:
            # overlapping windows repeat frames — check each file once
            paths = list(dict.fromkeys(
                p for w in self.items for pair in w for p in pair))
        else:
            paths = list(dict.fromkeys(
                p for pair in self.items for p in pair))
            if self.b_items is not None:
                paths += [p for p in self.b_items if p not in paths]
        self._size_ref_path = paths[0]
        self._size_ref = _native_size(paths[0])
        self._size_checked = {paths[0]}
        cap = self.SIZE_CHECK_STARTUP_CAP
        stride = max(1, len(paths) // cap)
        for p in paths[::stride][:cap]:
            self._verify_one_size(p)

    def _verify_one_size(self, path: str) -> None:
        from .video import is_virtual_frame, split_virtual
        if is_virtual_frame(path):
            # all frames of one container share its strf geometry —
            # check (and record) per file, not per frame
            path = split_virtual(path)[0]
        if path in self._size_checked:
            return
        size = _native_size(path)
        self._size_checked.add(path)
        if size != self._size_ref:
            raise ValueError(
                f"preprocess mode {self.preprocess!r} requires a "
                f"uniform native resolution (static shapes), "
                f"but {self._size_ref_path} is {self._size_ref[0]}x"
                f"{self._size_ref[1]} while {path} is "
                f"{size[0]}x{size[1]}. Use resize_and_crop, or "
                f"pre-resize the dataset.")

    def _verify_native_sizes(self, paths) -> None:
        """Lazy remainder of the uniform-size check (no-op for files
        already verified; skipped entirely in resize_and_crop mode)."""
        if self.preprocess == "resize_and_crop":
            return
        for p in paths:
            self._verify_one_size(p)

    def __len__(self) -> int:
        return len(self.items) // self.batch_size

    def _epoch_order(self) -> List[int]:
        order = list(range(len(self.items)))
        if self.shuffle:
            self._rng.shuffle(order)
        return order

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        """One pass; final partial batch dropped (static shapes)."""
        order = self._epoch_order()
        for i in range(0, len(order) - self.batch_size + 1,
                       self.batch_size):
            idxs = [order[i + r] for r in self.rows]
            if self.temporal:
                windows = [self.items[j] for j in idxs]
                t = len(windows[0])
                a_paths = [pa for w in windows for pa, _ in w]
                b_paths = [pb for w in windows for _, pb in w]
                self._verify_native_sizes(a_paths + b_paths)
                a = _decode_many(a_paths, self.target_hw, self.gray_a)
                b = _decode_many(b_paths, self.target_hw)
                th, tw = self.target_hw
                yield {
                    "a": a.reshape(len(windows), t, th, tw, -1),
                    "b": b.reshape(len(windows), t, th, tw, -1),
                    "paths": [[pa for pa, _ in w] for w in windows],
                }
            elif self.unaligned:
                # unpaired draw: A by epoch order, B independently —
                # uniform-random under shuffle (each A frame meets a
                # different B every epoch, the CycleGAN regime), or
                # index mod len(B) under serial_batches (reproducible
                # fixed pairing, the family's --serial_batches)
                a_paths = [self.items[j][0] for j in idxs]
                if self.shuffle:
                    # drawn for the whole global batch on every rank
                    b_all = self._rng.randint(0, len(self.b_items),
                                              size=self.batch_size)
                    b_idx = [b_all[r] for r in self.rows]
                else:
                    b_idx = [j % len(self.b_items) for j in idxs]
                b_paths = [self.b_items[int(j)] for j in b_idx]
                self._verify_native_sizes(a_paths + b_paths)
                yield {
                    "a": _decode_many(a_paths, self.target_hw,
                                      self.gray_a),
                    "b": _decode_many(b_paths, self.target_hw),
                    "paths": [[p] for p in a_paths],
                }
            else:
                pairs = [self.items[j] for j in idxs]
                self._verify_native_sizes([p for pair in pairs
                                           for p in pair])
                if self.label_a:
                    a = _decode_inst([pa for pa, _ in pairs],
                                     self.target_hw)[..., None]
                else:
                    a = _decode_many([pa for pa, _ in pairs],
                                     self.target_hw, self.gray_a)
                if self.single:
                    # input-only mode pairs each frame with itself — reuse
                    # the decoded array instead of decoding the same file
                    # twice (infer discards 'b' in single mode)
                    b = a
                else:
                    b = _decode_many([pb for _, pb in pairs],
                                     self.target_hw)
                batch = {"a": a, "b": b,
                         "paths": [[pa] for pa, _ in pairs]}
                if self.inst_paths is not None:
                    batch["inst"] = _decode_inst(
                        [self.inst_paths[j] for j in idxs], self.target_hw)
                yield batch

    def __iter__(self):
        """Endless prefetched stream over repeating epochs."""
        return _prefetch(self._endless(), depth=2)

    def _endless(self):
        while True:
            yield from self.epoch()


def _prefetch(it: Iterator, depth: int = 2) -> Iterator:
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(sentinel)
        except BaseException as e:  # propagate to the consumer — a decode
            q.put(e)                # error must not silently end the epoch

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def create_dataloader(cfg: Config, phase: Optional[str] = None,
                      shuffle: Optional[bool] = None) -> DataLoader:
    """Reference ``CreateDataLoader`` analog."""
    return DataLoader(cfg, phase=phase, shuffle=shuffle)
