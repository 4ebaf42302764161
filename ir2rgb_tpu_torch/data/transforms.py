"""Paired augmentation on the batch's device — the port of
``ir2rgb_tpu/data/transforms.py`` (``preprocess_pair_batch``,
``preprocess_sequence_batch``).

The host decodes and resizes frames to ``load_size`` uint8; the random
crop, the horizontal flip and the [0, 255] -> [-1, 1] normalize run here,
on whatever device the uint8 batch lies on, with **the same crop offset
and flip for the IR and the RGB frame of a pair** (and for its instance
map), and one decision per temporal window.

Each transform is split in two:

- **drawing** the per-item parameters (:func:`draw_crop_flip`: crop
  offsets and flip bits) on the host from a CPU ``torch.Generator``, so a
  CPU run and a card run with the same seed crop alike, and nothing waits
  for the device;
- **applying** them (:func:`apply_crop_flip`, :func:`normalize`): slices,
  flips and arithmetic on the device.

The draws are the port's own bits, not ``jax.random``'s; the apply takes
any parameters, so a test can hand it the ones the JAX package chose.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch


class CropFlip(NamedTuple):
    """Per-item spatial parameters: (B,) crop offsets and flip bits, on
    the CPU."""

    oy: torch.Tensor
    ox: torch.Tensor
    flip: torch.Tensor


def draw_crop_flip(n: int, h: int, w: int, crop: Optional[int],
                   flip: bool, generator: torch.Generator) -> CropFlip:
    """``n`` items' random crop offsets (uniform in [0, h - crop] and
    [0, w - crop]; none when ``crop`` is None) and, when ``flip``, a fair
    flip bit each, drawn in that order from ``generator`` (a CPU one)."""
    zeros = torch.zeros(n, dtype=torch.int64)
    if crop is None:
        oy = ox = zeros
    else:
        if crop > h or crop > w:
            raise ValueError(f"crop {crop} is larger than the {h}x{w} "
                             "frame")
        oy = torch.randint(0, h - crop + 1, (n,), generator=generator)
        ox = torch.randint(0, w - crop + 1, (n,), generator=generator)
    bits = (torch.rand(n, generator=generator) < 0.5 if flip
            else zeros.bool())
    return CropFlip(oy, ox, bits)


def center_crop(n: int, h: int, w: int, crop: Optional[int]) -> CropFlip:
    """The eval path's parameters: a centered crop, no flip."""
    zeros = torch.zeros(n, dtype=torch.int64)
    if crop is None:
        return CropFlip(zeros, zeros, zeros.bool())
    return CropFlip(zeros + (h - crop) // 2, zeros + (w - crop) // 2,
                    zeros.bool())


def apply_crop_flip(x: torch.Tensor, p: CropFlip,
                    crop: Optional[int]) -> torch.Tensor:
    """Item i of ``x`` (B, ..., H, W, C: a frame batch or a batch of
    windows) cropped at (``p.oy[i]``, ``p.ox[i]``) to ``crop`` x ``crop``
    (no crop when None) and flipped along W where ``p.flip[i]``, on
    ``x``'s device."""
    items = []
    for i, (oy, ox, fl) in enumerate(zip(p.oy.tolist(), p.ox.tolist(),
                                         p.flip.tolist())):
        xi = x[i]
        if crop is not None:
            xi = xi[..., oy:oy + crop, ox:ox + crop, :]
        items.append(xi.flip(-2) if fl else xi)
    return torch.stack(items)


# 1/127.5 rounded to float32, the constant the JAX package's compiled
# transform multiplies by (XLA turns the division into this product)
_INV_127_5 = float(torch.tensor(1 / 127.5, dtype=torch.float32))


def normalize(x_uint8: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [-1, 1] float32: ``x * fp32(1/127.5) - 1`` rounded once
    (a fused multiply-add), bit for bit what the JAX package's compiled
    ``x.astype(f32) / 127.5 - 1.0`` gives. The product and the difference
    are exact in float64, so one rounding to float32 at the end is the
    fused result on any device."""
    return (x_uint8.to(torch.float64) * _INV_127_5 - 1.0).to(torch.float32)


def _draw(x: torch.Tensor, crop: Optional[int], train: bool,
          no_flip: bool, generator: Optional[torch.Generator]) -> CropFlip:
    n, h, w = x.shape[0], x.shape[-3], x.shape[-2]
    if not train:
        return center_crop(n, h, w, crop)
    return draw_crop_flip(n, h, w, crop, not no_flip, generator)


def preprocess_pair_batch(a_uint8: torch.Tensor, b_uint8: torch.Tensor,
                          generator: Optional[torch.Generator],
                          crop_size: Optional[int], no_flip: bool = False,
                          train: bool = True,
                          inst: Optional[torch.Tensor] = None,
                          label_a: bool = False, unpaired: bool = False
                          ) -> Dict[str, torch.Tensor]:
    """(B, loadH, loadW, C) uint8 pairs -> the augmented batch.

    - ``train``: a random crop to ``crop_size`` and a random flip (none
      with ``no_flip``), the same for both frames of a pair;
      ``crop_size=None`` flips only (the scale_width / none preprocess
      modes). Eval (``train=False``): the center crop, no flip.
    - ``inst``: (B, loadH, loadW) instance ids under the pair's transform,
      never normalized, int32.
    - ``label_a``: the A side is a (B, H, W, 1) class-id map, cropped and
      flipped like the image but emitted as int32 ids.
    - ``unpaired``: the A and B frames are unrelated, so each side draws
      its own crop and flip (A's first); not with ``inst`` or
      ``label_a``.
    """
    if unpaired and (inst is not None or label_a):
        raise ValueError("unpaired transforms do not combine with "
                         "inst/label maps")
    p = _draw(a_uint8, crop_size, train, no_flip, generator)
    pb = _draw(b_uint8, crop_size, train, no_flip, generator) \
        if unpaired and train else p
    a = apply_crop_flip(a_uint8, p, crop_size)
    out = {"a": a.to(torch.int32) if label_a else normalize(a),
           "b": normalize(apply_crop_flip(b_uint8, pb, crop_size))}
    if inst is not None:
        out["inst"] = apply_crop_flip(inst[..., None], p,
                                      crop_size)[..., 0].to(torch.int32)
    return out


def preprocess_sequence_batch(a_uint8: torch.Tensor, b_uint8: torch.Tensor,
                              generator: Optional[torch.Generator],
                              crop_size: Optional[int],
                              no_flip: bool = False, train: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """(B, T, loadH, loadW, C) uint8 windows -> the augmented batch, with
    one crop and flip decision per window: every frame of a sequence
    gets the same spatial transform. Otherwise as
    :func:`preprocess_pair_batch`."""
    p = _draw(a_uint8, crop_size, train, no_flip, generator)
    return {"a": normalize(apply_crop_flip(a_uint8, p, crop_size)),
            "b": normalize(apply_crop_flip(b_uint8, p, crop_size))}
