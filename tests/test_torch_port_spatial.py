"""Spatially partitioned serving of the port (``parallel/spatial.py``) on
the CPU, against the port's unsharded ops and frames and JAX's sharded
ones.

- In process, no group: every shard-aware op of ``nn/ops.py`` run on each
  rank's rows with the halo rows cut from the whole tensor
  (:class:`CutShards`), for sp 2, 4 and 8 (shards of one row included;
  the U-Net's k4 p1 op0 up, the dilated k4 p1 op1 up of 2H + 1 rows, a
  shrinking, a 3 -> 5 and an align_corners bilinear resize, whose
  outputs split unevenly), equals the unsharded op to 1e-6; B1's plain
  statistics merged over the
  shards, then its plain apply, equal ``instance_norm_act_reference``;
  B2's plain version over a halo equals ``tail_fused_reference``.
- In process, the ranks on threads (their collectives at a barrier): every quantized op (the convs, the
  subpixel deconv, the served tail) in int8, int8_w and int8_mixed on sp
  2, 4 and 8 over rows of different ranges equals the unsharded op to
  1e-6 (int8's activation scale merged over the ranks); netE's instance
  pooling and its gradient over shards equal ``instance_wise_avg_pool``;
  a quantized conv, and a local enhancer with netE's feature map or the
  edge channel, on two ranks equal the whole frame; the new ups and
  resizes on 3 rows over sp 2, 4 and 8 (shards of no rows in or out)
  equal the unsharded op and its gradient to 1e-6.
- Layout: ``dp_sp_mesh(2, 4)`` on 8 ranks of a fake process group is
  JAX's ``dp_sp_mesh(2, 4)`` (rank order and subgroups), and
  ``shard_batch``'s blocks are JAX's shards on conftest's 8 devices.
- One spawn of 4 gloo ranks (``python tests/test_torch_port_spatial.py
  PORT RANK OUT``, one torch thread each, 60 s timeouts): JAX's
  ``tests/test_parallel.py:99`` local enhancer at crop 32 on sp 4 (the
  trunk's bottom is shards of one row) and ``:165``'s temporal stream for
  3 frames on sp 4, each against the port's unsharded frames (1e-5) and
  JAX's sharded ones (1e-4), the carry's rows per rank; a
  ``MultiStreamServer`` of 4 temporal slots on dp 2 × sp 2 against the
  one-process server; a batch-norm generator's batch of 2 on dp 2 × sp 2
  (the moments over every rank's rows) against one process; the local
  enhancer in each quant mode on sp 4 against one process (1e-5; no
  int8 rounding tie flips at this seed, so nothing is pinned) and JAX's
  sharded frame of the mode (1e-4); an int8 batch of two frames of
  different ranges on dp 2 (a pair of ranks) and on dp 2 × sp 2 against
  one process's batch-2 frame and JAX's dp-sharded frame (the one
  activation scale spans the batch); a netE feature map and edges pushed
  whole on sp 4 against one process; ``unet_128`` (ngf 8, 128²: its
  inner levels have fewer rows than ranks) on sp 4 and a batch of 2 on
  dp 2 × sp 2 against one process (1e-5) and JAX's sharded frames
  (1e-4).
- Errors: pooled serving with a mesh (JAX's ``test_multistream.py:232``),
  a sealed artifact refuses a mesh.
"""

import importlib.util
import os
import pathlib
import signal
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from ir2rgb_tpu_torch.config import (  # noqa: E402
    Config,
    DataConfig,
    InferConfig,
    LossConfig,
    ModelConfig,
)
from ir2rgb_tpu_torch.infer import MultiStreamServer  # noqa: E402
from ir2rgb_tpu_torch.infer import StreamingGenerator  # noqa: E402
from ir2rgb_tpu_torch.kernels import instance_norm as pin  # noqa: E402
from ir2rgb_tpu_torch.kernels.tail_fused import (  # noqa: E402
    tail_fused_reference,
)
from ir2rgb_tpu_torch.nn import ops, quant  # noqa: E402
from ir2rgb_tpu_torch.nn.encoders import (  # noqa: E402
    instance_edges,
    instance_wise_avg_pool,
)
from ir2rgb_tpu_torch.nn.generators import _tail  # noqa: E402
from ir2rgb_tpu_torch.parallel import (  # noqa: E402
    dp_sp_mesh,
    multihost,
    shard_batch,
    spatial,
)
from ir2rgb_tpu_torch.parallel.mesh import DataParallelMesh  # noqa: E402
from ir2rgb_tpu_torch.train import create_model  # noqa: E402

TIMEOUT_S = 60
CROP, SP, FRAMES, SLOTS = 32, 4, 3, 4
# JAX's tests/test_parallel.py:99 (local enhancer) and :165 (temporal)
LOCAL = dict(model="pix2pixhd", net_g="local", ngf=8, n_downsample_global=2,
             n_blocks_global=2, n_blocks_local=1)
TEMPORAL = dict(model="temporal", net_g="resnet_6blocks", ngf=8,
                n_frames_g=2)
# the server's ticks: the slots with a frame
TICKS = [(0, 1, 2, 3), (0, 2), (0, 1, 2, 3)]
# batch norm's moments over dp x sp: a batch of 2 on dp 2 x sp 2
BATCH_NORM = dict(model="pix2pix", net_g="resnet_6blocks", ngf=8,
                  norm="batch")
QUANT_MODES = ("int8", "int8_w", "int8_mixed")
# the int8 batch on dp 2 (two ranks of their own group) and dp 2 x sp 2:
# two frames of different ranges, whose one activation scale spans both
RESNET = dict(model="pix2pix", net_g="resnet_6blocks", ngf=8)
RANGES = (1.0, 0.1)
# the local enhancer with netE's feature input and the edge channel
STYLED = dict(LOCAL, use_instance_feat=True, use_instance_edges=True)
# the U-Net at 128²: on sp 4 its 1-row level is one rank's and its 2-row
# level two ranks'
UNET, UNET_CROP = dict(model="pix2pix", net_g="unet_128", ngf=8), 128


# ---------------------------------------------------------------------------
# In process: each op on each rank's rows, halos cut from the whole tensor
# ---------------------------------------------------------------------------

class CutShards(spatial.Shards):
    """Rank ``rank`` of ``sp`` whose halo rows are cut from ``whole``, the
    unsharded input of the op under test."""

    def __init__(self, sp, rank, whole):
        super().__init__(sp, rank)
        self.whole = whole

    def exchange(self, x, plan):
        return self.whole[:, list(plan.foreign[self.rank])]


def _per_rank(fn, x, sp, bounds=False):
    """``fn`` of each rank's rows of ``x``; with ``bounds``, each with its
    output's partition."""
    h = x.shape[1] // sp
    outs = []
    for r in range(sp):
        part = CutShards(sp, r, x)
        with spatial.partitioned(part):
            y = fn(x[:, r * h:(r + 1) * h].contiguous())
        outs.append((y, part.bounds(y)) if bounds else y)
    return outs


def _seeded(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, shape).astype(np.float32))


W3 = _seeded((6, 4, 3, 3), 1)
W7 = _seeded((6, 4, 7, 7), 2)
B = _seeded((6,), 3)
WT = _seeded((4, 6, 3, 3), 4)  # a k3 p1 op1 transposed conv, IOHW
WT4 = _seeded((4, 6, 4, 4), 27) * 0.25  # the U-Net's k4 up
# op -> (fn, stride, rows it adds at each end: pads compare extended rows)
OPS = {
    "conv_k3_s1_p1": (lambda x: ops.conv(x, W3, B, 1, 1), 1, 0),
    "conv_k3_s2_p1": (lambda x: ops.conv(x, W3, B, 2, 1), 2, 0),
    "reflect_pad_1": (lambda x: ops.reflect_pad(x, 1), 1, 1),
    "reflect_pad_3": (lambda x: ops.reflect_pad(x, 3), 1, 3),
    "reflect_pad_3_conv_k7": (
        lambda x: ops.conv(ops.reflect_pad(x, 3), W7, B), 1, 0),
    "edge_pad_2": (lambda x: ops.replicate_pad(x, 2), 1, 2),
    "avg_pool_3_2_1": (lambda x: ops.avg_pool(x, 3, 2, 1), 2, 0),
    "deconv_k3_p1_op1": (lambda x: ops.deconv(x, WT, B[:6]), 1, 0),
    "resize_nearest": (lambda x: ops.resize_nearest(x, 2), 1, 0),
    "resize_bilinear": (
        lambda x: ops.resize_bilinear(x, (2 * _global_rows(x), 20)), 1, 0),
    # the U-Net's up; k4 p1 op1 (2H + 1 rows) and the dilated lowering
    "deconv_k4_p1_op0": (lambda x: ops.deconv(x, WT4, B, 1, 0), 1, 0),
    "deconv_k4_p1_op1": (lambda x: ops.deconv(x, WT4, B, 1, 1), 1, 0),
    "deconv_k3_p1_op1_dilated": (
        lambda x: ops.deconv(x, WT, B, lowering="dilated"), 1, 0),
    "resize_bilinear_shrink": (
        lambda x: ops.resize_bilinear(x, (max(1, _global_rows(x) // 3), 7)),
        1, 0),
    "resize_bilinear_3_to_5": (
        lambda x: ops.resize_bilinear(x, (5 * _global_rows(x) // 3, 7)),
        1, 0),
    "resize_bilinear_align_corners": (
        lambda x: ops.resize_bilinear(x, (5 * _global_rows(x) // 3, 13),
                                      align_corners=True), 1, 0),
}


def _global_rows(x):
    part = spatial.active()
    return x.shape[1] if part is None else part.global_rows(x)


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("op", sorted(OPS))
def test_shard_aware_op_equals_the_unsharded_op(op, sp):
    fn, stride, grow = OPS[op]
    # shards of one row: 8 rows, 16 where a stride-2 op halves them
    x = _seeded((2, 8 * stride, 10, 4), 5)
    want = fn(x)
    outs = _per_rank(fn, x, sp, bounds=True)
    h = x.shape[1] // sp
    for r, (got, b) in enumerate(outs):
        # a pad's extended rows; else the rows of the output's partition
        # (the even split, or uneven where the global rows do not split)
        ref = (want[:, r * h:(r + 1) * h + 2 * grow] if grow
               else want[:, b[r]:b[r + 1]])
        assert b[-1] == want.shape[1] or grow, (op, b)
        assert got.shape == ref.shape, (op, r)
        assert not ref.numel() or float((got - ref).abs().max()) <= 1e-6, \
            (op, r)


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("act", ["relu", "none", "leaky_relu"])
def test_b1_stats_merged_then_applied_equals_the_fused_reference(act, sp):
    x = _seeded((2, 8, 6, 8), 6) * 3 + 0.5
    want, mean_w, rstd_w = pin.instance_norm_act_reference(x, act)
    h = x.shape[1] // sp
    parts = [pin.instance_norm_stats_reference(x[:, r * h:(r + 1) * h])
             for r in range(sp)]
    mean, rstd = spatial.merge_stats(torch.stack([p[0] for p in parts]),
                                     torch.stack([p[1] for p in parts]),
                                     h * x.shape[2], pin.INSTANCE_NORM_EPS)
    assert float((mean - mean_w).abs().max()) <= 1e-6
    assert float((rstd - rstd_w).abs().max() / rstd_w.abs().max()) <= 1e-6
    for r in range(sp):
        got = pin.instance_norm_apply_reference(x[:, r * h:(r + 1) * h],
                                                mean, rstd, act)
        assert float((got - want[:, r * h:(r + 1) * h]).abs().max()) <= 1e-5


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_b2_over_a_halo_equals_the_whole_tail(sp):
    x = _seeded((1, 16, 12, 16), 7)
    w, b = _seeded((7, 7, 16, 3), 8) * 0.1, _seeded((3,), 9)
    want = tail_fused_reference(x, w, b)
    h = x.shape[1] // sp
    outs = _per_rank(lambda t: tail_fused_reference(
        spatial.active().halo(t, 3, 3, "reflect"), w, b)[:, 3:3 + h], x, sp)
    got = torch.cat(outs, dim=1)
    assert float((got - want).abs().max()) <= 1e-6


def test_a_stride_2_op_on_odd_shards_names_the_layer_and_sp():
    # a strided conv splits its output over the ranks, uneven or not
    # (tests/test_torch_port_spatial_train.py); a 2x2 max pool is row-local
    # and a generator's stages must split evenly: both name the layer, sp
    x = _seeded((1, 12, 8, 4), 10)
    with spatial.partitioned(CutShards(4, 1, x)), \
            pytest.raises(ValueError, match=r"max_pool 2x2.*sp = 4"):
        ops.max_pool2x2(x[:, 3:6])
    from ir2rgb_tpu_torch.nn.generators import GenConfig, define_g
    g = define_g(GenConfig(net_g="resnet_6blocks", ngf=4, input_nc=4))
    with spatial.partitioned(CutShards(4, 1, x)), torch.no_grad(), \
            pytest.raises(ValueError, match=r"resnet_6blocks.*sp = 4"):
        g(x[:, 3:6])


# ---------------------------------------------------------------------------
# In process, the ranks on threads: what a rank merges with the others
# (the quantized convs' activation scale, B1's statistics, netE's segment
# sums) meets the other threads at a barrier
# ---------------------------------------------------------------------------

@pytest.fixture
def threads(monkeypatch):
    """``threads(sp, fn)``: ``fn(rank)`` on ``sp`` thread ranks whose
    collectives meet at a barrier (``test_torch_port_spatial_train``'s
    ``on_ranks``), each with its own ``spatial.active()``; the results in
    rank order."""
    import test_torch_port_spatial_train as tr
    monkeypatch.setattr(spatial, "active",
                        lambda: getattr(tr._LOCAL, "shards", None))
    return lambda sp, fn: tr.on_ranks(sp, lambda r, part: fn(r))


TAIL = torch.nn.Conv2d(4, 3, 7)
with torch.no_grad():
    TAIL.weight.copy_(_seeded((3, 4, 7, 7), 16) * 0.1)
    TAIL.bias.copy_(_seeded((3,), 17))
# the quantized ops: (fn, stride); the served tail (B2, or int8 composed)
QUANT_OPS = {k: OPS[k][:2] for k in ("conv_k3_s1_p1", "conv_k3_s2_p1",
                                     "reflect_pad_3_conv_k7",
                                     "deconv_k3_p1_op1")}
QUANT_OPS["tail"] = (lambda x: _tail(TAIL, x, train=False), 1)


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("mode", QUANT_MODES)
@pytest.mark.parametrize("op", sorted(QUANT_OPS))
def test_quantized_op_on_shards_equals_the_unsharded_op(op, mode, sp,
                                                        threads,
                                                        monkeypatch):
    # int8_mixed's gate at 4 channels: these 4 -> 6 convs quantize, the
    # 3-wide tail does not; the rows' ranges differ, so a rank's own
    # amax is not the frame's
    monkeypatch.setattr(quant, "MIXED_MIN_CH", 4)
    fn, stride = QUANT_OPS[op]
    x = _seeded((2, 8 * stride, 10, 4), 5)
    x = x * torch.linspace(0.1, 1.0, x.shape[1])[None, :, None, None]
    h = x.shape[1] // sp

    def run(t):
        # the mode is a context variable: each thread enters its own
        with torch.inference_mode(), quant.using(mode):
            return fn(t)
    want = run(x)
    got = torch.cat(threads(sp, lambda r: run(x[:, r * h:(r + 1) * h])),
                    dim=1)
    assert got.shape == want.shape, op
    assert float((got - want).abs().max()) <= 1e-6, (op, mode)


# the ups and resizes that split their output unevenly, on fewer input
# rows than ranks (3 on sp 4 and 8, 1 on sp 2): shards of no rows in or
# out
FEW_ROWS = ("deconv_k4_p1_op0", "deconv_k4_p1_op1",
            "deconv_k3_p1_op1_dilated", "resize_bilinear_shrink",
            "resize_bilinear_3_to_5", "resize_bilinear_align_corners")


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("op", FEW_ROWS)
def test_op_on_fewer_rows_than_ranks_and_its_gradient(op, sp, threads):
    fn = OPS[op][0]
    rows = 3 if sp > 2 else 1
    x = _seeded((2, rows, 10, 4), 28)
    whole = x.clone().requires_grad_(True)
    want = fn(whole)
    cot = _seeded(tuple(want.shape), 29)
    (want_g,) = torch.autograd.grad((want * cot).sum(), whole)
    b = spatial.bounds(rows, sp)

    def rank(r):
        part = spatial.active()
        xr = part.tag(x[:, b[r]:b[r + 1]].clone().requires_grad_(True), b)
        y = fn(xr)
        out = part.bounds(y)
        (g,) = torch.autograd.grad((y * cot[:, out[r]:out[r + 1]]).sum(),
                                   xr)
        return y.detach(), out, g
    outs = threads(sp, rank)
    got = torch.cat([o[0] for o in outs], dim=1)
    grad = torch.cat([o[2] for o in outs], dim=1)
    assert any(b[r] == b[r + 1] or o[1][r] == o[1][r + 1]
               for r, o in enumerate(outs)), op
    assert got.shape == want.shape, op
    # against the largest entry where it exceeds 1
    for a, w in ((got, want.detach()), (grad, want_g)):
        assert float((a - w).abs().max()) <= 1e-6 * max(
            1.0, float(w.abs().max())), op


def _ids(seed, shape, n=6):
    """Instance ids: ``n`` random ids below 2^24, each pixel one of
    them."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, 1 << 24, n)
    return torch.from_numpy(ids[r.integers(0, n, shape)].astype(np.int32))


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_netE_pooling_over_shards_equals_instance_wise_avg_pool(sp,
                                                               threads):
    # each rank's rows of the features and the whole id map; the
    # gradient goes back through the ranks' sum (8 segments: ids share
    # one, as colliding hashed ids do)
    feat, inst = _seeded((2, 8, 6, 3), 18), _ids(19, (2, 8, 6))
    cot = _seeded((2, 8, 6, 3), 20)
    whole = feat.clone().requires_grad_(True)
    want = instance_wise_avg_pool(whole, inst, 8)
    (want_g,) = torch.autograd.grad((want * cot).sum(), whole)
    h = 8 // sp

    def rank(r):
        f = feat[:, r * h:(r + 1) * h].clone().requires_grad_(True)
        y = instance_wise_avg_pool(f, inst, 8)
        (g,) = torch.autograd.grad((y * cot[:, r * h:(r + 1) * h]).sum(), f)
        return y.detach(), g
    outs = threads(sp, rank)
    got = torch.cat([o[0] for o in outs], dim=1)
    grad = torch.cat([o[1] for o in outs], dim=1)
    assert float((got - want.detach()).abs().max()) <= 1e-6
    assert float((grad - want_g).abs().max()) <= 1e-6


@pytest.mark.parametrize("what", ["quant", "netE_features", "edges"])
def test_quant_netE_features_and_edges_serve_on_a_partition(what, threads):
    # what the parent refused on a partitioned frame (ROADMAP A16b items
    # 1 and 2, serving), on two thread ranks against the whole frame
    x = _seeded((1, CROP, CROP, 3), 21)
    h = CROP // 2
    if what == "quant":
        w = _seeded((8, 3, 3, 3), 22)

        def conv(t):
            with torch.no_grad(), quant.using("int8"):
                return ops.conv(t, w, padding=1)
        want = conv(x)
        outs = threads(2, lambda r: conv(x[:, r * h:(r + 1) * h]))
    else:
        model = _model(STYLED)
        inst = _ids(23, (1, CROP, CROP))
        extra = ({"feat": _seeded((1, CROP, CROP, 3), 24)}
                 if what == "netE_features"
                 else {"edges": instance_edges(inst)})
        want = model.generate(x, **extra)

        def rank(r):
            rows = slice(r * h, (r + 1) * h)
            return model.generate(x[:, rows], **{
                k: v[:, rows] for k, v in extra.items()})
        outs = threads(2, rank)
    got = torch.cat(outs, dim=1)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5, what


# ---------------------------------------------------------------------------
# chip_smoke.py's SPATIAL tables against a partitioned frame on the meta
# device (shapes only)
# ---------------------------------------------------------------------------

class MetaShards(spatial.Shards):
    """A middle rank whose exchanges return empty rows of the right
    shape: a partitioned forward on the meta device."""

    def exchange(self, x, plan):
        return x.new_empty((x.shape[0], len(plan.foreign[self.rank]))
                           + tuple(x.shape[2:]))

    def gather_stats(self, t):
        return t.new_empty((self.sp,) + tuple(t.shape))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# a rank process (the file run as a script) needs none of it
CS = _chip_smoke() if __name__ != "__main__" else None
# every preset on sp 4, and the phase's own shards
PARTITIONED = [] if CS is None else sorted(
    {(p, 4, 1) for p in CS.SERVE} | set(CS.SPATIAL_TABLES))


@pytest.mark.parametrize("key", PARTITIONED,
                         ids=lambda k: "-".join(map(str, k)))
def test_partitioned_frame_sends_chip_smokes_shapes(monkeypatch, key):
    from ir2rgb_tpu_torch import kernels
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.nn import define_g
    from ir2rgb_tpu_torch.train import network_configs
    preset, sp, n = key
    stats, b1, tails, d2s = {}, {}, [], []

    def count(table, k):
        table[k] = table.get(k, 0) + 1

    def norm_stats(x):
        count(stats, tuple(x.shape))
        mean = x.new_empty((x.shape[0], x.shape[3]))
        return mean, mean

    def norm_apply(x, mean, rstd, act, negative_slope=0.2):
        count(b1, (tuple(x.shape), act))
        return x

    def tail(x, w, b):
        tails.append(tuple(x.shape))
        return x[..., :3]

    def interleave(y, c):
        if y.shape[1]:  # an up of no rows here launches nothing
            d2s.append((tuple(y.shape), c))
        return y.new_empty((y.shape[0], 2 * y.shape[1], 2 * y.shape[2], c))
    monkeypatch.setattr(ops, "instance_norm_stats", norm_stats)
    monkeypatch.setattr(ops, "instance_norm_apply", norm_apply)
    monkeypatch.setattr(ops, "fused_instance_norm_act", None)
    monkeypatch.setattr(kernels, "tail_fused", tail)
    monkeypatch.setattr(ops, "d2s_fn", interleave)
    gen_cfg, _ = network_configs(PRESETS[preset])
    size = PRESETS[preset].data.crop_size
    # every rank: the U-Net's inner levels split unevenly, some ranks
    # owning none of a level's rows
    for q in range(sp):
        for got in (stats, b1, tails, d2s):
            got.clear()
        with torch.device("meta"), torch.no_grad(), \
                spatial.partitioned(MetaShards(sp, q)):
            y = define_g(gen_cfg)(torch.empty((n, size // sp, size,
                                               gen_cfg.input_nc)))
        table = CS.shard_table(CS.SERVE[preset], sp, n, q)
        if q == 1:
            assert table == CS.SPATIAL_TABLES.get(key, table)
        assert tuple(y.shape) == (n, size // sp, size, 3)
        assert b1 == table["b1"] and tails == table["tail"], q
        assert d2s == table["d2s"], q
        assert stats == {s: sum(c for (t, _), c in b1.items() if t == s)
                         for s, _ in b1}
        assert CS.spatial_per_frame(preset, sp, q, n) == {
            **CS.per_frame(preset), "instance_norm_act": 0,
            "instance_norm_stats": sum(stats.values()),
            "instance_norm_apply": sum(b1.values()),
            "tail_fused": len(tails), "d2s": len(d2s)}, q
    assert CS.spatial_per_frame(preset) == {
        **CS.per_frame(preset), "instance_norm_act": 0,
        "instance_norm_stats": sum(CS.SERVE[preset]["b1"].values()),
        "instance_norm_apply": sum(CS.SERVE[preset]["b1"].values())}


# ---------------------------------------------------------------------------
# Layout: the mesh and shard_batch against JAX's
# ---------------------------------------------------------------------------

def _fake_group(world, rank):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    torch.distributed.init_process_group("fake", rank=rank, world_size=world,
                                         store=FakeStore())


def test_dp_sp_mesh_2x4_is_the_mesh_jax_builds():
    from ir2rgb_tpu.parallel import dp_sp_mesh as jax_dp_sp_mesh
    jmesh = jax_dp_sp_mesh(2, 4)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(8):
        _fake_group(8, rank)
        try:
            m = dp_sp_mesh(2, 4, device="cpu")
            row = [int(i) for i in ids[m.dp_rank]]
            col = [int(i) for i in ids[:, m.sp_rank]]
            assert (m.dp, m.sp, m.world) == (2, 4, 8)
            assert ids[m.dp_rank, m.sp_rank] == rank
            get = torch.distributed.get_process_group_ranks
            assert get(m.sp_group) == row and get(m.dp_group) == col
        finally:
            torch.distributed.destroy_process_group()


def test_shard_batch_blocks_are_jaxs_shards():
    import jax
    from ir2rgb_tpu.parallel import dp_sp_mesh as jax_dp_sp_mesh
    from ir2rgb_tpu.parallel import shard_batch as jax_shard_batch
    r = np.random.default_rng(11)
    batch = {"img": r.standard_normal((2, 8, 8, 3)).astype(np.float32),
             "seq": r.standard_normal((2, 3, 8, 8, 3)).astype(np.float32),
             "inst": r.integers(0, 9, (2, 8, 8)).astype(np.int32),
             "label": np.arange(2, dtype=np.int32)}
    want = jax_shard_batch(batch, jax_dp_sp_mesh(2, 4))
    for rank in range(8):
        m = DataParallelMesh(8, rank, rank, torch.device("cpu"), sp=4)
        got = shard_batch(batch, m)
        for k, arr in want.items():
            [shard] = [s for s in arr.addressable_shards
                       if s.device.id == rank]
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(jax.device_get(
                                              shard.data)), err_msg=k)


def test_dp_sp_mesh_sp_without_a_group_of_dp_times_sp_raises():
    with pytest.raises(ValueError, match="nproc_per_node 8"):
        dp_sp_mesh(2, 4, devices=list(range(8)))
    _fake_group(4, 0)
    try:
        with pytest.raises(ValueError, match="has 4 rank"):
            dp_sp_mesh(1, 2)
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# Errors: pooled serving with a mesh, and what is out of this slice
# ---------------------------------------------------------------------------

def _model(arch, crop=CROP, **infer):
    cfg = Config(model=ModelConfig(**arch), data=DataConfig(crop_size=crop),
                 loss=LossConfig(no_vgg_loss=True),
                 infer=InferConfig(**infer))
    return create_model(cfg, device="cpu")


FAKE_SP2 = DataParallelMesh(2, 0, 0, torch.device("cpu"), sp=2)


def test_pooled_serving_with_a_mesh_raises():
    model = _model(TEMPORAL)
    with pytest.raises(ValueError, match="single-chip"):
        MultiStreamServer(model, (CROP, CROP), n_slots=4, physical_slots=2,
                          mesh=object())


@pytest.mark.parametrize("what", ["artifact", "multistream_artifact"])
def test_a_sealed_artifact_serves_one_card(what, tmp_path):
    # as the JAX package's loaders take no mesh
    from ir2rgb_tpu_torch.infer.export import load_serving_artifact
    with pytest.raises(ValueError, match="serves one card"):
        if what == "artifact":
            load_serving_artifact(str(tmp_path / "m.ir2rgb"), mesh=FAKE_SP2)
        else:
            MultiStreamServer.from_artifact(str(tmp_path / "m.ir2rgb"),
                                            mesh=FAKE_SP2)


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _frames(n, seed, c=3, size=CROP):
    r = np.random.default_rng(seed)
    return r.uniform(-1, 1, (n, 1, size, size, c)).astype(np.float32)


def _unet_frames():
    """Two U-Net frames: the first served alone on sp 4, both as a batch
    on dp 2 x sp 2."""
    return _frames(2, 16, size=UNET_CROP)[:, 0]


def _u8_ticks():
    r = np.random.default_rng(13)
    return [{s: r.integers(0, 256, (CROP, CROP, 3), dtype=np.uint8)
             for s in slots} for slots in TICKS]


def _u8_frames():
    r = np.random.default_rng(14)
    return [r.integers(0, 256, (CROP, CROP, 3), dtype=np.uint8)
            for _ in range(2)]


def _ranged():
    """Two frames, the second of a tenth of the first's range."""
    x = torch.from_numpy(_frames(2, 4)[:, 0])
    return x * torch.tensor(RANGES)[:, None, None, None]


def _styled_maps():
    """A netE feature map and the edges of an instance map, whole."""
    inst = _ids(25, (1, CROP, CROP))
    return _seeded((1, CROP, CROP, 3), 26), instance_edges(inst)


def _step_device(srv):
    """Two ``step_device`` ticks of the whole physical batch: (uint8 out,
    carry) after each."""
    r = np.random.default_rng(15)
    out = []
    for _ in range(2):
        frames = torch.from_numpy(r.integers(0, 256, (SLOTS, CROP, CROP, 3),
                                             dtype=np.uint8))
        out.append((srv.step_device(frames).clone(), srv._carry.clone()))
    return out


def _serve_ticks(srv, ticks):
    sids = [srv.open() for _ in range(SLOTS)]
    outs, carries = [], []
    for t in ticks:
        outs.append(srv.step({sids[s]: f for s, f in t.items()}))
        carries.append(srv._carry.clone())
    return outs, carries


def worker(port, rank, out):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=4, process_id=rank,
                         timeout_s=TIMEOUT_S)
    weights = torch.load(os.path.join(out, "weights.pt"))
    res = {}
    m14 = dp_sp_mesh(1, SP, device="cpu")
    try:
        dp_sp_mesh(1, 2)
    except ValueError as e:
        res["mismatch"] = str(e)
    local = _model(LOCAL)
    local.netG.load_state_dict(weights["local"])
    x = torch.from_numpy(_frames(1, 0)[0])
    s = StreamingGenerator(local, (CROP, CROP), mesh=m14)
    res["local"] = s.push_device(x)
    res["local_u8"] = list(s.stream(_u8_frames()))
    temporal = _model(TEMPORAL)
    temporal.netG.load_state_dict(weights["temporal"])
    s = StreamingGenerator(temporal, (CROP, CROP), mesh=m14)
    res["temporal"] = [(s.push_device(torch.from_numpy(f)), s.carry.clone())
                       for f in _frames(FRAMES, 1)]
    m22 = dp_sp_mesh(2, 2, device="cpu")
    srv = MultiStreamServer(temporal, (CROP, CROP), n_slots=SLOTS, mesh=m22)
    res["server"] = _serve_ticks(srv, _u8_ticks())
    res["server_rank"] = (m22.dp_rank, m22.sp_rank)
    srv = MultiStreamServer(temporal, (CROP, CROP), n_slots=SLOTS, mesh=m22)
    res["server_device"] = _step_device(srv)
    res["batch_norm"] = StreamingGenerator(
        _model(BATCH_NORM), (CROP, CROP), batch=2, mesh=m22).push_device(
            torch.from_numpy(_frames(2, 3)[:, 0]))
    # the quant modes on sp 4; netE's features and the edge channel
    for mode in QUANT_MODES:
        q = _model(LOCAL, quant=mode)
        q.netG.load_state_dict(weights["local"])
        res["local_" + mode] = StreamingGenerator(
            q, (CROP, CROP), mesh=m14).push_device(x)
    feat, edges = _styled_maps()
    res["styled"] = StreamingGenerator(
        _model(STYLED), (CROP, CROP), mesh=m14).push_device(
            x, feat=feat, edges=edges)
    # an int8 batch on dp 2 (ranks 0 and 1, and 2 and 3, each a pair of
    # their own) and on dp 2 x sp 2
    pairs = [torch.distributed.new_group(g) for g in ([0, 1], [2, 3])]
    pair = DataParallelMesh(2, rank % 2, 0, torch.device("cpu"),
                            pairs[rank // 2])
    resnet = _model(RESNET, quant="int8")
    resnet.netG.load_state_dict(weights["resnet"])
    for name, mesh in (("int8_dp2", pair), ("int8_dp2_sp2", m22)):
        res[name] = StreamingGenerator(resnet, (CROP, CROP), batch=2,
                                       mesh=mesh).push_device(_ranged())
    # the U-Net, whose inner levels have fewer rows than ranks
    unet = _model(UNET, UNET_CROP)
    unet.netG.load_state_dict(weights["unet"])
    xu, hw = torch.from_numpy(_unet_frames()), (UNET_CROP, UNET_CROP)
    res["unet_sp4"] = StreamingGenerator(unet, hw, mesh=m14).push_device(
        xu[:1])
    res["unet_dp2_sp2"] = StreamingGenerator(unet, hw, batch=2,
                                             mesh=m22).push_device(xu)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    m14.barrier()
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_weights(jmodel, seed):
    """JAX generator params of ``jmodel`` drawn as the reference's
    ``weights_init`` draws them (kernels N(0, 0.02), biases 0) from a
    numpy seed, without compiling JAX's init."""
    import jax
    shapes = jax.eval_shape(jmodel.g_init, jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (r.normal(0, 0.02, s.shape) if len(s.shape) > 1
                   else np.zeros(s.shape)).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, the port's one-process frames and JAX's
    sharded frames of the same weights (computed while the ranks run)."""
    import jax
    import jax.numpy as jnp
    from ir2rgb_tpu.config import Config as JConfig
    from ir2rgb_tpu.config import DataConfig as JDataConfig
    from ir2rgb_tpu.config import LossConfig as JLossConfig
    from ir2rgb_tpu.config import ModelConfig as JModelConfig
    from ir2rgb_tpu.infer.stream import StreamingGenerator as JStream
    from ir2rgb_tpu.parallel import batch_sharding, replicate
    from ir2rgb_tpu.parallel import dp_sp_mesh as jax_dp_sp_mesh
    from ir2rgb_tpu.train import create_model as jax_create_model
    from ir2rgb_tpu_torch.checkpoint import generator_state_dict_from_jax

    from ir2rgb_tpu.config import InferConfig as JInferConfig
    out = tmp_path_factory.mktemp("spatial")
    jm, params, sds = {}, {}, {}

    def jax_model(arch, quant="none", crop=CROP):
        return jax_create_model(JConfig(
            model=JModelConfig(**arch), data=JDataConfig(crop_size=crop),
            loss=JLossConfig(no_vgg_loss=True),
            infer=JInferConfig(quant=quant)), steps_per_epoch=10)
    for i, (name, arch, crop) in enumerate((
            ("local", LOCAL, CROP), ("temporal", TEMPORAL, CROP),
            ("resnet", RESNET, CROP), ("unet", UNET, UNET_CROP))):
        jm[name] = jax_model(arch, crop=crop)
        params[name] = _jax_weights(jm[name], i)
        sds[name] = generator_state_dict_from_jax(
            params[name], _model(arch, crop).gen_cfg)
    torch.save(sds, out / "weights.pt")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(r), str(out)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True) for r in range(4)]
    try:
        mesh = jax_dp_sp_mesh(1, SP)
        rep, xsh = replicate(mesh), batch_sharding(mesh)
        lm = jm["local"]
        x = _frames(1, 0)[0]
        jax_local = np.asarray(jax.jit(
            lambda p, a: lm.generate(p, a, train=False),
            in_shardings=(rep, xsh), out_shardings=xsh)(
                jax.device_put(params["local"], rep),
                jax.device_put(jnp.asarray(x), xsh)))
        def sharded(models, p, a, mesh):
            """Each of ``models``' generate (one jit) on ``mesh``."""
            rep, sh = replicate(mesh), batch_sharding(mesh)
            ys = jax.jit(lambda p, a: {k: m.generate(p, a, train=False)
                                       for k, m in models.items()},
                         in_shardings=(rep, sh), out_shardings=sh)(
                jax.device_put(p, rep), jax.device_put(jnp.asarray(a), sh))
            return {k: np.asarray(y) for k, y in ys.items()}
        jax_quant = sharded({m: jax_model(LOCAL, m) for m in QUANT_MODES},
                            params["local"], x, mesh)
        jax_int8_dp = sharded({"int8": jax_model(RESNET, "int8")},
                              params["resnet"], _ranged().numpy(),
                              jax_dp_sp_mesh(2, 1))["int8"]
        xu = _unet_frames()
        jax_unet = {
            "unet_sp4": sharded({"g": jm["unet"]}, params["unet"], xu[:1],
                                mesh)["g"],
            "unet_dp2_sp2": sharded({"g": jm["unet"]}, params["unet"], xu,
                                    jax_dp_sp_mesh(2, 2))["g"]}
        js = JStream(jm["temporal"], params["temporal"], (CROP, CROP),
                     mesh=mesh)
        jax_temporal = [np.asarray(js.push_device(jnp.array(f)))
                        for f in _frames(FRAMES, 1)]
        with torch.no_grad():
            local, temporal = _model(LOCAL), _model(TEMPORAL)
            local.netG.load_state_dict(sds["local"])
            temporal.netG.load_state_dict(sds["temporal"])
            one_local = local.generate(torch.from_numpy(x))
            one_local_u8 = list(StreamingGenerator(
                local, (CROP, CROP)).stream(_u8_frames()))
            s = StreamingGenerator(temporal, (CROP, CROP))
            one_temporal = [(s.push_device(torch.from_numpy(f)),
                             s.carry.clone()) for f in _frames(FRAMES, 1)]
            one_server = _serve_ticks(MultiStreamServer(
                temporal, (CROP, CROP), n_slots=SLOTS), _u8_ticks())
            one_server_device = _step_device(MultiStreamServer(
                temporal, (CROP, CROP), n_slots=SLOTS))
            one_batch_norm = _model(BATCH_NORM).generate(
                torch.from_numpy(_frames(2, 3)[:, 0]))
            one_quant = {}
            for m in QUANT_MODES:
                q = _model(LOCAL, quant=m)
                q.netG.load_state_dict(sds["local"])
                one_quant[m] = q.generate(torch.from_numpy(x))
            feat, edges = _styled_maps()
            one_styled = _model(STYLED).generate(torch.from_numpy(x),
                                                 feat=feat, edges=edges)
            resnet = _model(RESNET, quant="int8")
            resnet.netG.load_state_dict(sds["resnet"])
            one_int8 = resnet.generate(_ranged())
            int8_batch1 = torch.cat([resnet.generate(f[None])
                                     for f in _ranged()])
            unet = _model(UNET, UNET_CROP)
            unet.netG.load_state_dict(sds["unet"])
            both = unet.generate(torch.from_numpy(xu))
            one_unet = {"unet_sp4": unet.generate(torch.from_numpy(xu[:1])),
                        "unet_dp2_sp2": both}
    finally:
        try:
            outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
    bad = [f"rank {r} exited {p.returncode}:\n{e[-3000:]}"
           for r, (p, (_, e)) in enumerate(zip(procs, outs)) if p.returncode]
    assert not bad, "\n".join(bad)
    return dict(ranks=[torch.load(out / f"rank{r}.pt", weights_only=False)
                       for r in range(4)],
                jax_local=jax_local, jax_temporal=jax_temporal,
                one_local=one_local, one_temporal=one_temporal,
                one_server=one_server, one_batch_norm=one_batch_norm,
                one_local_u8=one_local_u8,
                one_server_device=one_server_device,
                jax_quant=jax_quant, one_quant=one_quant,
                one_styled=one_styled, jax_int8_dp=jax_int8_dp,
                one_int8=one_int8, int8_batch1=int8_batch1,
                one_unet=one_unet, jax_unet=jax_unet)


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def test_local_enhancer_on_sp4_equals_one_process_and_jax(ranks):
    for r in ranks["ranks"]:
        assert r["local"].shape == (1, CROP, CROP, 3)
        assert _gap(r["local"], ranks["one_local"]) <= 1e-5
        assert _gap(r["local"], ranks["jax_local"]) <= 1e-4
    assert "has 4 rank" in ranks["ranks"][0]["mismatch"]
    # the host wire: uint8 frames through the pipelined stream
    for r in ranks["ranks"]:
        for got, want in zip(r["local_u8"], ranks["one_local_u8"]):
            assert got.shape == (CROP, CROP, 3) and _gap(got, want) <= 1


def test_temporal_stream_on_sp4_equals_one_process_and_jax(ranks):
    h = CROP // SP
    for k, r in enumerate(ranks["ranks"]):
        for (got, carry), (want, want_carry), jax_out in zip(
                r["temporal"], ranks["one_temporal"], ranks["jax_temporal"]):
            assert _gap(got, want) <= 1e-5
            assert _gap(got, jax_out) <= 1e-4
            # each rank keeps its own rows of the carry
            assert carry.shape == (1, h, CROP, 3)
            assert _gap(carry, want_carry[:, k * h:(k + 1) * h]) <= 1e-5


def test_multistream_server_on_dp2_sp2_equals_one_process(ranks):
    outs_one, carries_one = ranks["one_server"]
    for r in ranks["ranks"]:
        outs, carries = r["server"]
        d, s = r["server_rank"]
        for got, want in zip(outs, outs_one):
            assert sorted(got) == sorted(want)
            for sid in want:  # uint8 frames: rounding may move one LSB
                assert _gap(got[sid], want[sid]) <= 1
        h = CROP // 2
        for got, want in zip(carries, carries_one):
            assert _gap(got, want[2 * d:2 * d + 2, s * h:(s + 1) * h]) <= 1e-5
        # the device path: the whole batch in and out on every rank
        for (got, carry), (want, want_carry) in zip(
                r["server_device"], ranks["one_server_device"]):
            assert got.shape == want.shape and _gap(got, want) <= 1
            assert _gap(carry, want_carry[2 * d:2 * d + 2,
                                          s * h:(s + 1) * h]) <= 1e-5


def test_batch_norm_on_dp2_sp2_takes_the_whole_batchs_moments(ranks):
    # two frames, one a data row, each split over its row's two ranks:
    # batch norm's statistics span all four ranks' rows
    for r in ranks["ranks"]:
        assert r["batch_norm"].shape == (2, CROP, CROP, 3)
        assert _gap(r["batch_norm"], ranks["one_batch_norm"]) <= 1e-5


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantized_local_enhancer_on_sp4_equals_one_process_and_jax(
        ranks, mode):
    # int8's activation scale merged over the ranks, int8_w's dequantized
    # weights, int8_mixed's width gate as in one process; no int8
    # rounding tie flips at this seed, so nothing is pinned
    for r in ranks["ranks"]:
        got = r["local_" + mode]
        assert got.shape == (1, CROP, CROP, 3)
        assert _gap(got, ranks["one_quant"][mode]) <= 1e-5
        assert _gap(got, ranks["jax_quant"][mode]) <= 1e-4


@pytest.mark.parametrize("layout", ["int8_dp2", "int8_dp2_sp2"])
def test_int8_batch_on_a_dp_mesh_scales_over_the_whole_batch(ranks, layout):
    # JAX's scale is one amax over the global batch: a rank's own frames'
    # would serve each frame as its batch-1 frame, another function
    want = ranks["one_int8"]
    assert _gap(ranks["int8_batch1"], want) > 1e-2
    for r in ranks["ranks"]:
        got = r[layout]
        assert got.shape == (2, CROP, CROP, 3)
        assert _gap(got, want) <= 1e-5
        assert _gap(got, ranks["jax_int8_dp"]) <= 1e-4


def test_netE_features_and_edges_on_sp4_equal_one_process(ranks):
    # the whole feature and edge maps pushed on every rank, cut to its rows
    for r in ranks["ranks"]:
        assert r["styled"].shape == (1, CROP, CROP, 3)
        assert _gap(r["styled"], ranks["one_styled"]) <= 1e-5


@pytest.mark.parametrize("layout", ["unet_sp4", "unet_dp2_sp2"])
def test_unet_on_a_mesh_equals_one_process_and_jax(ranks, layout):
    # its ups realigned to its skips at the levels of fewer rows than
    # ranks: the whole frames on every rank
    want, jax_out = ranks["one_unet"][layout], ranks["jax_unet"][layout]
    for r in ranks["ranks"]:
        got = r[layout]
        assert got.shape == want.shape == jax_out.shape
        assert _gap(got, want) <= 1e-5
        assert _gap(got, jax_out) <= 1e-4


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
