"""The pix2pixHD feature encoder netE and the instance-map helpers — the
port of ``ir2rgb_tpu/nn/encoders.py``.

:class:`Encoder` is the reference family's ``Encoder`` (pix2pixHD
``models/networks.py``; keys ``model.*``): reflect-pad 3, c7s1-nef,
norm, ReLU; ``n_downsample_e`` stride-2 3x3 convs, each with its norm and
ReLU; as many transposed convs (k3 s2 p1 op1, run as the subpixel conv +
kernel B3's interleave, :class:`~ir2rgb_tpu_torch.nn.generators.Deconv`)
with norm and ReLU; reflect-pad 3, c7s1-feat_num, tanh in fp32. Its
instance norms are kernel B1; its tail is composed ops, as the JAX
encoder composes it (it trains). Conv biases follow the JAX package's
rule: none before a batch norm, the tail always.

Given an instance map, the output is pooled per instance: every pixel
takes the mean feature of its instance. The ids are hashed into a static
``num_instances``-segment space (:func:`hash_instance_ids`), and the
segment sums are ``index_add`` in fp32 (with atomics on a CUDA tensor, so
the pooled means are not bit-stable from run to run there), then gathered
back through the id map. Distinct ids whose hashes collide share one mean;
:func:`instance_collision_count` counts such segments. On a partitioned
frame the encoder runs on the rank's rows (its ops exchange what they
read) and the pooling adds the ranks' segment sums
(:func:`instance_feature_table`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ir2rgb_tpu_torch.parallel import spatial
from . import ops
from .generators import (
    Deconv,
    Slot,
    _check_divisible,
    _conv_norm_act,
    _norm_act,
    norm_layer,
    use_bias,
)

_HASH_MULT = 2654435761  # Knuth's multiplicative hash constant


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    input_nc: int = 3
    feat_num: int = 3        # reference --feat_num
    nef: int = 16            # reference --nef
    n_downsample_e: int = 4  # reference --n_downsample_E
    norm: str = "instance"
    # static cap of the segment id space (hashed ids are taken mod this)
    num_instances: int = 1024
    compute_dtype: torch.dtype = torch.float32


class Encoder(nn.Module):
    """netE: NHWC image in, (B, H, W, feat_num) features out in the
    compute dtype, pooled per instance when ``inst`` is given."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        bias, norm, n = use_bias(cfg.norm), cfg.norm, cfg.n_downsample_e
        ch = cfg.nef
        layers = [Slot("reflect_pad 3"),
                  nn.Conv2d(cfg.input_nc, ch, 7, bias=bias),
                  norm_layer(norm, ch), Slot("relu")]
        self.downs, self.ups = [], []
        for _ in range(n):
            self.downs.append(len(layers))
            layers += [nn.Conv2d(ch, ch * 2, 3, stride=2, padding=1,
                                 bias=bias),
                       norm_layer(norm, ch * 2), Slot("relu")]
            ch *= 2
        for _ in range(n):
            self.ups.append(len(layers))
            layers += [Deconv(ch, ch // 2, bias=bias),
                       norm_layer(norm, ch // 2), Slot("relu")]
            ch //= 2
        self.tail = len(layers) + 1
        layers += [Slot("reflect_pad 3"), nn.Conv2d(ch, cfg.feat_num, 7),
                   Slot("tanh")]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor,
                inst: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg, seq = self.cfg, self.model
        _check_divisible(x, cfg.n_downsample_e, "encoder (netE)")
        x = x.to(cfg.compute_dtype)
        h = _conv_norm_act(seq, 1, ops.reflect_pad(x, 3), cfg.norm)
        for i in self.downs:
            h = _conv_norm_act(seq, i, h, cfg.norm, stride=2, padding=1)
        for i in self.ups:
            h = _norm_act(seq[i + 1], seq[i](h), cfg.norm, "relu")
        tail = seq[self.tail]
        y = ops.conv(ops.reflect_pad(h, 3), tail.weight, tail.bias)
        feat = spatial.same_rows(torch.tanh(y.float()), y)
        if inst is not None:
            feat = instance_wise_avg_pool(feat, inst, cfg.num_instances)
        return feat.to(cfg.compute_dtype)


def define_e(cfg: EncoderConfig) -> Encoder:
    """netE for ``cfg`` (the reference ``define_G(..., 'encoder')``)."""
    return Encoder(cfg)


def hash_instance_ids(raw: torch.Tensor, num_instances: int) -> torch.Tensor:
    """Raw instance ids -> segment ids in [0, num_instances): the top bits
    of a 32-bit Knuth multiplicative hash, ``((uint32(raw) * 2654435761)
    >> 16) % num_instances``, as the JAX package computes it. The product
    is taken in int64 and its low 32 bits kept: a wrap-around of the int64
    product leaves those bits right. Returns int64."""
    r = raw.to(torch.int64) & 0xFFFFFFFF
    hashed = ((r * _HASH_MULT) & 0xFFFFFFFF) >> 16
    return hashed % num_instances


def _segments(inst: torch.Tensor, num_instances: int) -> torch.Tensor:
    """(B, H, W) ids -> (B, H·W) flat segment ids, image b's in
    [b·num_instances, (b + 1)·num_instances)."""
    b = inst.shape[0]
    ids = hash_instance_ids(inst.reshape(b, -1), num_instances)
    return ids + torch.arange(b, device=ids.device)[:, None] * num_instances


def instance_feature_table(feat: torch.Tensor, inst: torch.Tensor,
                           num_instances: int = 1024
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Per-segment pooled features: (B, num_instances, C) fp32 means,
    (B, num_instances) pixel counts (0 for an empty segment), and the
    (B, H·W) segment ids (hashed, not offset). Differentiable in
    ``feat``.

    On a partitioned frame (``spatial.active()``) ``feat`` holds this
    rank's rows and ``inst`` the whole frame's ids (id maps are not split
    over ``sp``): each rank sums its rows of every segment, the sums and
    counts are added over the ranks in rank order (differentiably,
    ``Shards.sum_over_ranks``), and the ids returned are its rows'."""
    b, h, w, c = feat.shape
    part = spatial.active()
    if part is not None:
        inst = part.rows_of(inst, feat)
    seg = _segments(inst, num_instances).reshape(-1)
    flat = feat.reshape(b * h * w, c).float()
    sums = flat.new_zeros((b * num_instances, c)).index_add(0, seg, flat)
    cnts = flat.new_zeros(b * num_instances).index_add(
        0, seg, flat.new_ones(b * h * w))
    if part is not None:
        both = part.sum_over_ranks(torch.cat([sums, cnts[:, None]], dim=1))
        sums, cnts = both[:, :c], both[:, c]
    means = sums / torch.clamp(cnts, min=1.0)[:, None]
    return (means.reshape(b, num_instances, c),
            cnts.reshape(b, num_instances),
            seg.reshape(b, h * w) % num_instances)


def instance_wise_avg_pool(feat: torch.Tensor, inst: torch.Tensor,
                           num_instances: int = 1024) -> torch.Tensor:
    """Each pixel's feature replaced by the mean over its instance (its
    hash segment): feat (B, H, W, C) float, inst (B, H, W) integer ids ->
    (B, H, W, C) fp32."""
    b, h, w, c = feat.shape
    means, _, ids = instance_feature_table(feat, inst, num_instances)
    seg = ids + torch.arange(b, device=ids.device)[:, None] * num_instances
    return spatial.same_rows(means.reshape(-1, c).index_select(
        0, seg.reshape(-1)).reshape(b, h, w, c), feat)


def instance_collision_count(inst: torch.Tensor,
                             num_instances: int = 1024) -> torch.Tensor:
    """Segments, summed over the batch, whose pixels carry more than one
    distinct raw id (those instances share one pooled style): a populated
    segment whose min raw id differs from its max. A 0-dim int64
    tensor."""
    b = inst.shape[0]
    raw = inst.reshape(-1).to(torch.int64)
    seg = _segments(inst, num_instances).reshape(-1)
    n = b * num_instances
    lo = raw.new_zeros(n).scatter_reduce(0, seg, raw, "amin",
                                         include_self=False)
    hi = raw.new_zeros(n).scatter_reduce(0, seg, raw, "amax",
                                         include_self=False)
    cnt = torch.bincount(seg, minlength=n)
    return ((cnt > 0) & (lo != hi)).sum()


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
