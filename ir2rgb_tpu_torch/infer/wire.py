"""The uint8 serving wire: frames cross host <-> device as uint8 and are
normalised and quantised on the device, bit-identically to the JAX
package (``ir2rgb_tpu/infer/stream.py``). A label model's frames are
class ids and cross as raw id bytes.

This module imports torch and numpy only, so a sealed serving artifact
(``infer/export.py``) serves with it and no model code.
"""

from __future__ import annotations

import numpy as np
import torch


def _dev_normalize(a_u8: torch.Tensor) -> torch.Tensor:
    """uint8 frame -> [-1,1] float32 on the device. Bit-identical to the
    host-side ``a.astype(np.float32) / 127.5 - 1.0`` (u8->f32 is exact;
    the same IEEE division and subtraction)."""
    return a_u8.to(torch.float32) / 127.5 - 1.0


def _dev_quantize(fake: torch.Tensor) -> torch.Tensor:
    """[-1,1] frame -> uint8 on the device; mirrors tensor2im's
    clip/scale/truncate, so the device->host copy moves 1 byte/px."""
    arr = (torch.clamp(fake.to(torch.float32), -1, 1) + 1.0) * 127.5
    return arr.to(torch.uint8)


def host_to_wire_u8(a: np.ndarray, label: bool) -> np.ndarray:
    """Host-side conversion of a non-uint8 frame to the uint8 wire:

    - image frames: [-1, 1] floats quantise like tensor2im;
    - label frames (label_nc > 0): class ids round/clip to the id byte.
    """
    if label:
        return np.clip(np.round(a.astype(np.float32)), 0,
                       255).astype(np.uint8)
    return ((np.clip(a.astype(np.float32), -1, 1) + 1.0)
            * 127.5).astype(np.uint8)
