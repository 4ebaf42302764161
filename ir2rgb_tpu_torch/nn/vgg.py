"""VGG19 feature extractor for the perceptual loss — the port of
``ir2rgb_tpu/nn/vgg.py``.

torchvision's VGG19 ``features`` up to relu5_1, in five stages that end at
relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1; the loss compares the five
stage outputs. The module keeps torchvision's indices (``features.{idx}``,
ReLU and max-pool slots in between), so the convs of a torchvision
``vgg19().features`` state_dict load with ``strict=False`` (the convs past
relu5_1 and the classifier are not used).

Weights come from a file or from a seed; nothing is downloaded.
- :func:`load_vgg19_npz`: an ``.npz`` made by the JAX package's
  ``cli/convert.py vgg19`` (keys ``conv{i}_w`` HWIO and ``conv{i}_b``);
- :meth:`Vgg19.init_random`: the JAX package's documented fallback
  (``vgg.py:76-94``), He-normal weights N(0, 2 / (9 cin)) and zero biases,
  drawn from a numpy seed.

Input convention: NHWC images in [-1, 1]. The forward converts them to
ImageNet-normalised RGB, ``((x + 1) / 2 - mean) / std``, in fp32, then runs
the trunk in ``dtype`` (bf16 when the generator computes in bf16,
``model.py:286-290``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from . import ops
from .generators import Slot

# torchvision vgg19.features indices of the 13 convs through conv5_1, with
# (cin, cout); the max pools sit at 4, 9, 18 and 27, a ReLU after each conv
VGG_CONVS = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
             (10, 128, 256), (12, 256, 256), (14, 256, 256), (16, 256, 256),
             (19, 256, 512), (21, 512, 512), (23, 512, 512), (25, 512, 512),
             (28, 512, 512)]
VGG_POOLS = (4, 9, 18, 27)
STAGE_ENDS = (1, 6, 11, 20, 29)  # the relu*_1 slots that end each stage

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Vgg19(nn.Module):
    """Five-stage VGG19 trunk; ``forward`` returns the stage outputs."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        convs = {idx: (cin, cout) for idx, cin, cout in VGG_CONVS}
        for idx in range(STAGE_ENDS[-1] + 1):
            if idx in convs:
                layers.append(nn.Conv2d(*convs[idx], 3, padding=1))
            elif idx in VGG_POOLS:
                layers.append(Slot("max_pool 2x2"))
            else:
                layers.append(Slot("relu"))
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    @torch.no_grad()
    def init_random(self, seed: int) -> "Vgg19":
        """He-normal weights, zero biases, from ``np.random.default_rng``."""
        rng = np.random.default_rng(seed)
        for idx, cin, _ in VGG_CONVS:
            conv = self.features[idx]
            w = rng.standard_normal(tuple(conv.weight.shape), np.float32)
            conv.weight.copy_(torch.from_numpy(w * np.sqrt(2.0 / (9 * cin),
                                                           dtype=np.float32)))
            conv.bias.zero_()
        return self

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
        h = (x.float() + 1.0) * 0.5
        h = (h - self.mean) / self.std
        if dtype is not None:
            h = h.to(dtype)
        feats = []
        for idx, layer in enumerate(self.features):
            if isinstance(layer, nn.Conv2d):
                h = ops.conv(h, layer.weight, layer.bias, padding=1)
            elif idx in VGG_POOLS:
                h = ops.max_pool2x2(h)
            else:
                h = torch.relu(h)
            if idx in STAGE_ENDS:
                feats.append(h)
        return feats


def vgg19_state_dict_from_npz(path: str) -> "dict[str, torch.Tensor]":
    """The :class:`Vgg19` state_dict from the JAX package's ``.npz``
    (``conv{i}_w`` HWIO -> ``features.{idx}.weight`` OIHW)."""
    with np.load(path) as data:
        sd = {}
        for i, (idx, cin, cout) in enumerate(VGG_CONVS):
            w = np.asarray(data[f"conv{i}_w"], np.float32)
            if w.shape != (3, 3, cin, cout):
                raise ValueError(f"{path}: conv{i}_w has shape {w.shape}, "
                                 f"want {(3, 3, cin, cout)}")
            sd[f"features.{idx}.weight"] = torch.from_numpy(
                np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
            sd[f"features.{idx}.bias"] = torch.from_numpy(
                np.asarray(data[f"conv{i}_b"], np.float32).copy())
    return sd


def load_vgg19_npz(path: str) -> Vgg19:
    """A CPU :class:`Vgg19` with the weights of ``path``."""
    with torch.device("meta"):
        vgg = Vgg19()
    vgg.load_state_dict(vgg19_state_dict_from_npz(path), assign=True)
    vgg.mean = torch.tensor(IMAGENET_MEAN)
    vgg.std = torch.tensor(IMAGENET_STD)
    return vgg
