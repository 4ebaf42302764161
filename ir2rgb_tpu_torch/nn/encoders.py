"""The instance-boundary map of pix2pixHD's input — the port's copy of
``ir2rgb_tpu/nn/encoders.py::instance_edges``. The feature encoder netE
of that module is not ported yet."""

from __future__ import annotations

import torch


def instance_edges(inst: torch.Tensor) -> torch.Tensor:
    """Binary instance-boundary map, the reference's ``get_edges``: both
    pixels on each side of an id change are marked, horizontally and
    vertically.

    inst: (B, H, W) integer ids -> (B, H, W, 1) float32 in {0, 1}."""
    dh = inst[:, :, 1:] != inst[:, :, :-1]
    dv = inst[:, 1:, :] != inst[:, :-1, :]
    e = torch.zeros(inst.shape, dtype=torch.bool, device=inst.device)
    e[:, :, 1:] |= dh
    e[:, :, :-1] |= dh
    e[:, 1:, :] |= dv
    e[:, :-1, :] |= dv
    return e[..., None].to(torch.float32)
