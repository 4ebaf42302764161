"""The dp×sp train step of the port (``parallel/spatial.py`` under
autograd) on the CPU, against the port's unsharded ops and step and JAX's
one-device step.

- In process, no group: the ``sp`` ranks are threads whose collectives
  meet at a barrier (:class:`ThreadShards`; ``spatial.active`` reads a
  thread-local partition), for sp 2, 4 and 8. Each shard-aware op runs on
  the uneven rows a 4x4 stride-2 conv leaves (shards of one row and of
  none included): its output and its gradients (input and weights) equal
  the unsharded op's to 1e-6; the halo passes the adjoint identity
  <halo(x), y> = <x, haloᵀ(y)> in float64 for every edge mode; the plain
  split backward (the sums, added over the shards, then the apply)
  equals ``instance_norm_act_backward_reference`` and JAX's
  ``_fused_bwd`` for every act to 1e-5; the multiscale D (every tap),
  VGG19 and the losses over uneven shards equal the whole frame's.
- ``multihost.global_batch`` and the step's draws on ``dp_sp_mesh(2,
  4)``'s layout: each rank's block, JAX's ``tests/test_parallel.py:
  192-213``.
- One spawn of 4 gloo ranks and, beside it, of 2 (``python tests/
  test_torch_port_spatial_train.py PORT RANK OUT steps|fit``, one torch
  thread each, 60 s timeouts), the counterpart of JAX's
  ``tests/test_parallel.py:278``: JAX's
  ``tests/test_parallel.py:127`` config (pix2pix, ``resnet_6blocks``,
  the n-layer D, ngf / ndf 8, crop 32, batch 8, no VGG) with JAX's
  weights on dp 2 × sp 2 and on dp 1 × sp 4, each held to JAX's
  one-device jitted step (losses rtol 2e-3, JAX's bar) and to the port's
  one-process step (losses rel ≤ 1e-5, each network's gradient ‖Δ‖ ≤
  1e-5·‖g‖, the parameters after one Adam step within JAX's atol 5e-4);
  and a 2-step ``Trainer`` run on dp 1 × sp 2 from a synthetic folder
  (the 2 ranks).
- Temporal windows on the same spawns (``resnet_6blocks``, ngf / ndf 8,
  crop 32, batch 2, T = 3 with dropout and a 2-frame pool): on dp 1 × sp
  4 (``n_frames_g`` 3), dp 2 × sp 2 and dp 1 × sp 2 (``n_frames_g`` 2),
  each window held to JAX's one-device jitted temporal ``train_step``
  (losses rtol 2e-3) with JAX's dropout masks and pool decisions handed
  to the ranks, and, drawing its own, to the port's one-process window
  (losses rel ≤ 1e-5, each network's gradient ‖Δ‖ ≤ 1e-5·‖g‖, the pool
  after the window the one-process pool's); remat on dp 1 × sp 4 against
  the same window without it (atol 1e-6, every rank's count of exchanges
  equal); a 2-step temporal ``Trainer`` run on sp 2 from a folder of
  videos. In process: the carry keeps the fakes' uneven partition, and a
  remat block's input is tagged again for its recompute.
- netE and the edge input on the 4 ranks, dp 2 × sp 2 (the port's
  netE test's pix2pixHD config, ids hashed into 4 segments so that they
  collide): the step held to JAX's one-device jitted step (losses rtol
  2e-3, ``inst_collisions`` equal) and to one process's step pinned to
  the partitioned forward (the step's bars above, netE's gradient too).
- The U-Net on the 2 ranks (``unet_256``, ngf 4, the n-layer D, 256²,
  batch 1, dropout; instance norm, and batch norm): its 1-row level one
  rank's, its ups realigned to its skips (``Shards.repartition``, whose
  values and transpose are checked in process on sp 2, 4 and 8), the
  dropout masks on uneven and empty shards; with JAX's masks held to
  JAX's one-device jitted step (losses rtol 2e-3), with its own to one
  process's step pinned to the partitioned forward (batch norm's
  outputs pinned too; the step's bars above).
- WGAN-GP, CycleGAN, netE, the edge input and the U-Net pass to the mesh.
"""

import contextlib
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
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
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from ir2rgb_tpu_torch.kernels import instance_norm as pin  # noqa: E402
from ir2rgb_tpu_torch.losses import (  # noqa: E402
    feature_matching_loss,
    gan_loss_d_parts,
    gan_loss_g,
    l1_loss,
    vgg_loss,
)
from ir2rgb_tpu_torch.nn import ops  # noqa: E402
from ir2rgb_tpu_torch.nn.discriminators import DiscConfig, define_d  # noqa: E402
from ir2rgb_tpu_torch.nn.generators import ResnetBlock, _tail  # noqa: E402
from ir2rgb_tpu_torch.nn.vgg import Vgg19  # noqa: E402
from ir2rgb_tpu_torch.parallel import (  # noqa: E402
    dp_sp_mesh,
    multihost,
    replicate,
    shard_batch,
    spatial,
)
from ir2rgb_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from ir2rgb_tpu_torch.train import create_model, image_pool  # noqa: E402
from ir2rgb_tpu_torch.train.model import next_carry  # noqa: E402

TIMEOUT_S = 60
CROP, BATCH = 32, 8
# JAX's tests/test_parallel.py:24-31 (its create_model's pool: 0 here)
BASE = dict(model="pix2pix", net_g="resnet_6blocks", net_d="n_layers",
            ngf=8, ndf=8)
LAYOUTS = [(2, 2), (1, 4)]  # (dp, sp) of the four ranks
# grad-accum 2 and the EMA on dp 1 x sp 4: (dp, sp, train overrides)
ACCUM_EMA = (1, 4, dict(grad_accum=2, ema_decay=0.5))
# temporal windows: (dp, sp, n_frames_g) on the four ranks and on the two;
# batch, frames; the layout that runs remat too
T_LAYOUTS = [(1, 4, 3), (2, 2, 2)]
T_PAIR = (1, 2, 2)
T_BATCH, T_FRAMES = 2, 3
T_REMAT = (1, 4, 3)


def _seeded(shape, seed, dtype=np.float32):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, shape).astype(dtype))


# ---------------------------------------------------------------------------
# In process: the ranks are threads
# ---------------------------------------------------------------------------

class ThreadGroup:
    """``sp`` threads' collectives: each all-reduce of a byte buffer meets
    at a barrier and sums the ranks' bytes (each written by one rank)."""

    def __init__(self, sp):
        self.sp = sp
        self.barrier = threading.Barrier(sp, timeout=TIMEOUT_S)
        self.slots = [None] * sp
        self.result = None

    def reduce(self, rank, buf):
        self.slots[rank] = buf.contiguous().reshape(-1).view(torch.uint8)
        self.barrier.wait()
        if rank == 0:
            total = self.slots[0].clone()
            for b in self.slots[1:]:
                total += b
            self.result = total
        self.barrier.wait()
        out = self.result.clone().view(buf.dtype).reshape(buf.shape)
        self.barrier.wait()
        return out


class ThreadShards(spatial.Shards):
    def __init__(self, group, rank):
        super().__init__(group.sp, rank)
        self.threads = group

    def _reduce(self, buf):
        return self.threads.reduce(self.rank, buf)


_LOCAL = threading.local()


@pytest.fixture(autouse=True)
def _thread_local_partition(monkeypatch):
    monkeypatch.setattr(spatial, "active",
                        lambda: getattr(_LOCAL, "shards", None))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the rank threads (and the spawned ranks) run side
    by side, and a loaded machine's cores are the other test files'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def on_ranks(sp, fn):
    """``fn(rank, shards)`` on ``sp`` threads, one a rank; the results in
    rank order (an exception on any rank fails the call)."""
    group = ThreadGroup(sp)
    out, errors = [None] * sp, []

    def run(rank):
        _LOCAL.shards = ThreadShards(group, rank)
        try:
            out[rank] = fn(rank, _LOCAL.shards)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
            group.barrier.abort()
        finally:
            _LOCAL.shards = None
    threads = [threading.Thread(target=run, args=(r,)) for r in range(sp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _rows(x, b, rank):
    return x[:, b[rank]:b[rank + 1]]


def _sharded_grads(sp, x, op, weights):
    """``op`` of ``x``'s even shards on ``sp`` thread ranks, each rank's
    output against its rows of a fixed cotangent: (the whole output, its
    partition, d/dx, d/dweights summed over the ranks)."""
    whole = op(x)
    cot = _seeded(tuple(whole.shape), 99)
    h = x.shape[1] // sp

    def rank(r, part):
        xr = x[:, r * h:(r + 1) * h].detach().clone().requires_grad_(True)
        y = op(xr)
        b = part.bounds(y)
        grads = torch.autograd.grad((y * _rows(cot, b, r)).sum(),
                                    [xr, *weights], allow_unused=True)
        return y.detach(), b, grads
    outs = on_ranks(sp, rank)
    y = torch.cat([o[0] for o in outs], dim=1)
    gx = torch.cat([o[2][0] for o in outs], dim=1)
    gw = [sum(o[2][1 + i] for o in outs) for i in range(len(weights))]
    return y, outs[0][1], gx, gw, cot


def _whole_grads(x, op, weights, cot):
    xw = x.detach().clone().requires_grad_(True)
    y = op(xw)
    return y, torch.autograd.grad((y * cot).sum(), [xw, *weights])


# weights of about 1 / sqrt(fan-in): activations of order 1
W4 = (_seeded((6, 4, 4, 4), 1) * 0.25).requires_grad_(True)  # first conv
B6 = _seeded((6,), 2).requires_grad_(True)
W44 = (_seeded((6, 6, 4, 4), 3) * 0.1).requires_grad_(True)  # the D's
W3 = (_seeded((6, 6, 3, 3), 4) * 0.15).requires_grad_(True)
W7 = (_seeded((3, 6, 7, 7), 5) * 0.06).requires_grad_(True)
B3 = _seeded((3,), 6).requires_grad_(True)
WT = (_seeded((6, 4, 3, 3), 7) * 0.15).requires_grad_(True)  # k3 p1 op1
B4 = _seeded((4,), 8).requires_grad_(True)


def _first(x):
    """A 4x4 stride-2 conv padded 2: 2R rows in, R + 1 out, split unevenly
    (and with ranks of no rows at sp 8)."""
    return ops.conv(x, W4, B6, 2, 2)


# op -> (fn of the uneven input, its weights)
TRAIN_OPS = {
    "conv_k4_s2_p2": (lambda h: ops.conv(h, W44, B6, 2, 2), [W44]),
    "conv_k4_s1_p2": (lambda h: ops.conv(h, W44, None, 1, 2), [W44]),
    "conv_k4_s1_p1": (lambda h: ops.conv(h, W44, B6, 1, 1), [W44]),
    "conv_k3_s1_p1": (lambda h: ops.conv(h, W3, B6, 1, 1), [W3]),
    "conv_k3_s2_p1": (lambda h: ops.conv(h, W3, B6, 2, 1), [W3]),
    "avg_pool_3_2_1": (lambda h: ops.avg_pool(h, 3, 2, 1), []),
    "reflect_pad_3_conv_k7": (
        lambda h: ops.conv(ops.reflect_pad(h, 3), W7, B3), [W7, B3]),
    "edge_pad_1_conv_k3": (
        lambda h: ops.conv(ops.replicate_pad(h, 1), W3, B6), [W3]),
    "deconv_k3_p1_op1": (lambda h: ops.deconv(h, WT, B4), [WT, B4]),
    "norm_leaky_relu": (lambda h: ops.norm_act(h, "instance", "leaky_relu"),
                        []),
    "norm_relu": (lambda h: ops.norm_act(h, "instance", "relu"), []),
    "norm_tanh": (lambda h: ops.norm_act(h, "instance", "tanh"), []),
    "train_tail": (lambda h: _tail(_TAIL, h, train=True), []),
}
_TAIL = torch.nn.Conv2d(6, 3, 7)
with torch.no_grad():
    _TAIL.weight.copy_(W7)
    _TAIL.bias.copy_(B3)


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("op", sorted(TRAIN_OPS))
def test_shard_aware_op_and_its_backward_equal_the_unsharded_ops(op, sp):
    fn, weights = TRAIN_OPS[op]
    weights = [W4, B6, *weights]
    if op == "train_tail":
        weights += [_TAIL.weight, _TAIL.bias]
    # 16 rows: the first conv leaves 9 rows, uneven on every sp, and
    # none on three of 8 ranks
    x = _seeded((2, 16, 10, 4), 7)

    def chain(t):
        return fn(_first(t))
    y, b, gx, gw, cot = _sharded_grads(sp, x, chain, weights)
    want, (wgx, *wgw) = _whole_grads(x, chain, weights, cot)
    assert b[-1] == want.shape[1] and y.shape == want.shape, (op, b)
    assert _gap(y, want.detach()) <= 1e-6, op
    # the gradients against their largest entry (a bias before a norm has
    # a zero gradient, up to rounding)
    scale = max(float(t.abs().max()) for t in (wgx, *wgw))
    for got, ref in ((gx, wgx), *zip(gw, wgw)):
        assert _gap(got, ref, scale) <= 1e-6, op


def _gap(got, want, scale=None):
    """max |got - want| over max(1, ``scale``), default max |want|."""
    scale = float(want.abs().max()) if scale is None else scale
    return float((got - want).abs().max()) / max(1.0, scale)


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("mode", spatial.MODES)
def test_halo_backward_is_the_exchanges_transpose(mode, sp):
    # uneven rows (9 over sp), windows of 3 rows above and 2 below
    x = _seeded((2, 9, 3, 2), 8, np.float64)
    b = spatial.bounds(9, sp)
    ys = [_seeded((2, b[r + 1] - b[r] + 5, 3, 2), 20 + r, np.float64)
          for r in range(sp)]

    def rank(r, part):
        xr = _rows(x, b, r).clone().requires_grad_(True)
        part.tag(xr, b)
        wins = tuple((b[q] - 3, b[q + 1] + 2) for q in range(sp))
        ext = part.window(xr, wins, mode)
        (gr,) = torch.autograd.grad(ext, xr, ys[r])
        return (float((ext * ys[r]).sum().detach()),
                float((xr * gr).sum().detach()))
    sides = on_ranks(sp, rank)
    lhs, rhs = sum(s[0] for s in sides), sum(s[1] for s in sides)
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_repartition_moves_the_rows_and_its_backward_is_the_transpose(sp):
    # 9 rows from the even-as-can-be split to one whose first ranks own
    # few rows or none (the U-Net's ups to their skips' split), and back
    x = _seeded((2, 9, 3, 2), 50, np.float64)
    src = spatial.bounds(9, sp)
    dst = (0,) + tuple(9 * q * q // (sp * sp) for q in range(1, sp + 1))
    ys = [_seeded((2, dst[r + 1] - dst[r], 3, 2), 60 + r, np.float64)
          for r in range(sp)]

    def rank(r, part):
        xr = part.tag(_rows(x, src, r).clone().requires_grad_(True), src)
        y = part.repartition(xr, dst)
        back = part.repartition(y, src)
        (gr,) = torch.autograd.grad(y, xr, ys[r])
        return (y.detach(), part.bounds(y), back.detach(),
                float((y * ys[r]).sum().detach()),
                float((xr * gr).sum().detach()))
    outs = on_ranks(sp, rank)
    for r, (y, b, back, _, _) in enumerate(outs):
        assert b == dst and torch.equal(y, _rows(x, dst, r))
        assert torch.equal(back, _rows(x, src, r))
    lhs, rhs = sum(o[3] for o in outs), sum(o[4] for o in outs)
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh", "none"])
def test_plain_split_backward_equals_the_fused_backward_and_jax(act, sp):
    from ir2rgb_tpu.kernels.instance_norm import _fused_bwd
    x = _seeded((2, 9, 6, 8), 9) * 3 + 0.5
    g = _seeded((2, 9, 6, 8), 10)
    _, mean, rstd = pin.instance_norm_act_reference(x, act)
    b = spatial.bounds(9, sp)
    sums = [pin.instance_norm_bwd_stats_reference(
        _rows(x, b, r), mean, rstd, _rows(g, b, r), act) for r in range(sp)]
    s1 = sum(s[0] for s in sums)
    s2 = sum(s[1] for s in sums)
    count = 9 * x.shape[2]
    got = torch.cat([pin.instance_norm_bwd_apply_reference(
        _rows(x, b, r), mean, rstd, _rows(g, b, r), s1, s2, count, act)
        for r in range(sp)], dim=1)
    want = pin.instance_norm_act_backward_reference(x, mean, rstd, g, act)
    (jax_dx,) = _fused_bwd(act, pin.INSTANCE_NORM_EPS, 0.2,
                           (x.numpy(), mean.numpy(), rstd.numpy()), g.numpy())
    assert float((got - want).abs().max()) <= 1e-5
    assert float((got - torch.from_numpy(np.array(jax_dx))).abs().max()) \
        <= 1e-5


def _d_losses(d, vgg, fake, real, cond):
    """The frame losses a step takes from D and the VGG, and every D tap."""
    pair_fake = torch.cat([cond, fake], dim=-1)
    pair_real = torch.cat([cond, real], dim=-1)
    out_fake, out_real = d(pair_fake), d(pair_real)
    d_real, d_fake = gan_loss_d_parts(out_real, out_fake)
    losses = [gan_loss_g(out_fake), d_real, d_fake,
              feature_matching_loss(out_fake, out_real, 3),
              l1_loss(fake, real)]
    if vgg is not None:
        losses.append(vgg_loss(vgg, fake, real))
    return losses, [t for scale in out_fake for t in scale]


@pytest.mark.parametrize("sp,size,with_vgg", [(2, 32, True), (4, 64, True),
                                              (8, 32, False)])
def test_d_vgg_and_losses_over_uneven_shards_equal_the_whole_frames(
        sp, size, with_vgg):
    d = define_d(DiscConfig(net_d="multiscale", input_nc=6, ndf=4, num_d=2))
    vgg = Vgg19().init_random(3) if with_vgg else None
    fake = _seeded((1, size, size, 3), 11).requires_grad_(True)
    real, cond = _seeded((1, size, size, 3), 12), _seeded((1, size, size, 3),
                                                          13)
    params = list(d.parameters())
    want, want_taps = _d_losses(d, vgg, fake, real, cond)
    want_g = [torch.autograd.grad(sum(want), [fake, *params])]
    h = size // sp

    def rank(r, part):
        f = fake[:, r * h:(r + 1) * h].detach().clone().requires_grad_(True)
        losses, taps = _d_losses(d, vgg, f, real[:, r * h:(r + 1) * h],
                                 cond[:, r * h:(r + 1) * h])
        grads = torch.autograd.grad(sum(losses), [f, *params])
        return ([float(v.detach()) for v in losses], [(t.detach(), part.bounds(t))
                                             for t in taps], grads)
    outs = on_ranks(sp, rank)
    for i, w in enumerate(want):
        got = sum(o[0][i] for o in outs)
        assert abs(got - float(w)) <= 1e-5 * max(1.0, abs(float(w))), i
    # every tap: the ranks' rows in order are the whole tap, the late
    # layers' shards uneven, some empty
    empty = 0
    for i, w in enumerate(want_taps):
        b = outs[0][1][i][1]
        assert all(o[1][i][1] == b for o in outs) and b[-1] == w.shape[1]
        empty += sum(b[q] == b[q + 1] for q in range(sp))
        got = torch.cat([o[1][i][0] for o in outs], dim=1)
        assert float((got - w.detach()).abs().max()) <= 1e-5, i
    if sp == 8:
        assert empty > 0
    gf = torch.cat([o[2][0] for o in outs], dim=1)
    assert _gap(gf, want_g[0][0]) <= 1e-5
    # each parameter's gradient: ‖Δ‖ ≤ 1e-5·‖g‖ + 1e-6·max‖g‖ (a bias
    # before a norm has a zero gradient, up to rounding)
    big = max(float(t.norm()) for t in want_g[0][1:])
    for k, ref in enumerate(want_g[0][1:]):
        got = sum(o[2][1 + k] for o in outs)
        assert float((got - ref).norm()) <= 1e-5 * float(ref.norm()) \
            + 1e-6 * big, k


def test_global_batch_hands_each_rank_its_block():
    # JAX's tests/test_parallel.py:192-213 on dp_sp_mesh(2, 4): a rank
    # feeds its data row's images and keeps its image rows of them, its
    # block of shard_batch's layout (the draws: the data row's, the same
    # on its sp ranks)
    from ir2rgb_tpu_torch.parallel import DataParallelMesh
    from ir2rgb_tpu_torch.parallel.mesh import draw, local_rows, sharded
    x = np.arange(8 * 4 * 4 * 3, dtype=np.float32).reshape(8, 4, 4, 3)
    for rank in range(8):
        mesh = DataParallelMesh(8, rank, rank, torch.device("cpu"), sp=4)
        rows = local_rows(8, mesh.dp, mesh.dp_rank)
        got = multihost.global_batch({"a": x[rows.numpy()]}, mesh,
                                     check=False)["a"]
        assert torch.equal(got, shard_batch({"a": x}, mesh)["a"])
        with sharded(mesh):
            drawn = draw(lambda n: torch.arange(n), 4)
        assert torch.equal(drawn, torch.arange(8)[rows])


@pytest.mark.parametrize("sp", [2, 4])
def test_temporal_carry_keeps_the_fakes_uneven_partition(sp):
    # a fake of 9 rows split unevenly: the carry after it keeps its
    # partition, so a conv of the carry reads the rows the whole carry's
    # conv reads (an untagged carry would be taken as an even split)
    fake, prev = _seeded((2, 9, 10, 3), 30), _seeded((2, 9, 10, 6), 31)
    w = _seeded((6, 6, 3, 3), 32) * 0.15
    b = spatial.bounds(9, sp)
    want = ops.conv(next_carry(fake, prev, 6), w, None, 1, 1)

    def rank(r, part):
        f = part.tag(_rows(fake, b, r).clone(), b)
        carry = next_carry(f, _rows(prev, b, r), 6)
        return part.bounds(carry), ops.conv(carry, w, None, 1, 1)
    outs = on_ranks(sp, rank)
    assert all(o[0] == b for o in outs)
    assert _gap(torch.cat([o[1] for o in outs], dim=1), want) <= 1e-6


@pytest.mark.parametrize("sp", [2, 4])
def test_remat_block_on_uneven_shards_equals_the_whole_block(sp):
    # a remat residual block with dropout over 9 rows split unevenly: its
    # output and gradients (input and weights) are the whole block's
    # without remat, the mask this rank's rows of the whole frame's draw;
    # its body, given the input's partition, tags a new tensor (what a
    # recompute may be handed) again and computes the same rows
    plain = ResnetBlock(6, use_dropout=True)
    block = ResnetBlock(6, use_dropout=True, remat=True)
    with torch.no_grad():
        for i, (a, q) in enumerate(zip(plain.parameters(),
                                       block.parameters())):
            a.copy_(_seeded(tuple(a.shape), 40 + i) * 0.15)
            q.copy_(a)
    x, cot = _seeded((2, 9, 10, 6), 33), _seeded((2, 9, 10, 6), 34)
    b = spatial.bounds(9, sp)
    xw = x.clone().requires_grad_(True)
    want = plain(xw, torch.Generator().manual_seed(7), train=True)
    want_g = torch.autograd.grad((want * cot).sum(),
                                 [xw, *plain.parameters()])
    params = list(block.parameters())

    def rank(r, part):
        xr = part.tag(_rows(x, b, r).clone().requires_grad_(True), b)
        y = block(xr, torch.Generator().manual_seed(7), train=True)
        grads = torch.autograd.grad((y * _rows(cot, b, r)).sum(),
                                    [xr, *params])
        mask = ops.dropout_mask(xr.shape, 0.5,
                                torch.Generator().manual_seed(7), b)
        with torch.no_grad():
            again = block._body(xr.detach().clone(), None, mask, b)
        return y.detach(), part.bounds(y), grads, again
    outs = on_ranks(sp, rank)
    assert all(o[1] == b for o in outs)
    assert all(torch.equal(o[0], o[3]) for o in outs)
    assert _gap(torch.cat([o[0] for o in outs], dim=1), want.detach()) \
        <= 1e-6
    scale = max(float(t.abs().max()) for t in want_g)
    assert _gap(torch.cat([o[2][0] for o in outs], dim=1), want_g[0],
                scale) <= 1e-6
    for i, ref in enumerate(want_g[1:]):
        assert _gap(sum(o[2][1 + i] for o in outs), ref, scale) <= 1e-6, i


# ---------------------------------------------------------------------------
# What a partitioned step covers reaches the mesh
# ---------------------------------------------------------------------------

# what the partitioned step covers beside JAX's test config: WGAN-GP and
# CycleGAN (tests/test_torch_port_spatial_gp.py), netE and the edge input
# (the ranks' netE step below), the U-Net (the pair's U-Net steps below)
IN_SLICE = {
    "wgangp": ({}, {"gan_mode": "wgangp"}),
    "cycle_gan": ({"model": "cycle_gan"}, {}),
    "netE": ({"use_instance_feat": True}, {}),
    "edges": ({"use_instance_edges": True}, {}),
    "unet": ({"net_g": "unet_256"}, {}),
}


@pytest.mark.parametrize("what", sorted(IN_SLICE))
def test_wgangp_and_cyclegan_pass_the_refusal_to_the_mesh(what, tmp_path):
    # the model builds and the trainer goes on to build its dp×sp mesh,
    # which needs a process group of 2 ranks (none here)
    from ir2rgb_tpu_torch.train import CycleGanModel, Trainer
    model, loss = IN_SLICE[what]
    cfg = Config(model=ModelConfig(**{**BASE, **model}),
                 data=DataConfig(crop_size=CROP, batch_size=2),
                 loss=LossConfig(no_vgg_loss=True, **loss),
                 train=TrainConfig(spatial_devices=2,
                                   checkpoints_dir=str(tmp_path)))
    built = create_model(cfg, device="cpu")
    assert isinstance(built, CycleGanModel) == (what == "cycle_gan")
    assert built.cfg.loss.gan_mode == cfg.loss.gan_mode
    with pytest.raises(ValueError, match="exceeds"):
        Trainer(built, cfg)


# ---------------------------------------------------------------------------
# The ranks: the step on dp 2 x sp 2 and dp 1 x sp 4, and a Trainer run
# ---------------------------------------------------------------------------

def _cfg(**train):
    return Config(model=ModelConfig(**BASE),
                  data=DataConfig(crop_size=CROP, batch_size=BATCH),
                  loss=LossConfig(no_vgg_loss=True, pool_size=0),
                  train=TrainConfig(**train))


def _batch():
    from ir2rgb_tpu_torch.data.synthetic import synthetic_pair_batch
    host = synthetic_pair_batch(BATCH, CROP)
    return {k: torch.from_numpy(host[k].astype(np.float32) / 127.5 - 1.0)
            for k in ("a", "b")}


def _grads(model):
    return {f"{net}.{k}": p.grad.clone()
            for net, mod in (*model.g_nets().items(),
                             *model.d_nets().items())
            for k, p in mod.named_parameters() if p.grad is not None}


def _weights(model):
    return {f"{net}.{k}": v.detach().clone()
            for net, mod in (*model.g_nets().items(),
                             *model.d_nets().items())
            for k, v in mod.state_dict().items()}


def step_case(weights, mesh=None, **train):
    """One train step of JAX's config (with ``train`` overrides) from its
    weights, on this rank's block (the whole batch without ``mesh``)."""
    model = create_model(_cfg(**train), device="cpu", steps_per_epoch=10,
                         seed=0 if mesh is None else 5 * mesh.rank)
    model.netG.load_state_dict(weights["netG"])
    model.netD.load_state_dict(weights["netD"])
    batch = _batch()
    if mesh is not None:
        replicate(model, mesh)
        batch = shard_batch(batch, mesh)
    metrics = model.train_step(batch)
    ema = {} if model.ema is None else {
        f"ema.{k}": v.clone() for k, v in model.ema["netG"].items()}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _grads(model), "weights": {**_weights(model), **ema}}


def fit_case(out):
    """A 2-step Trainer run from a synthetic folder on this rank's block:
    the loader's images of the data row, cut to this rank's rows."""
    from ir2rgb_tpu_torch.data import DataLoader, preprocess_pair_batch
    from ir2rgb_tpu_torch.parallel.mesh import image_rows, sharded
    from ir2rgb_tpu_torch.train import Trainer
    cfg = Config(model=ModelConfig(**{**BASE, "ngf": 4, "ndf": 4}),
                 data=DataConfig(dataroot=os.path.join(out, "data"),
                                 load_size=40, crop_size=CROP, batch_size=2),
                 loss=LossConfig(no_vgg_loss=True, pool_size=2),
                 train=TrainConfig(name="sp_fit",
                                   checkpoints_dir=os.path.join(out, "runs"),
                                   spatial_devices=2, niter=1, niter_decay=0,
                                   print_freq=1))
    trainer = Trainer(create_model(cfg, device="cpu", steps_per_epoch=2),
                      cfg)
    trainer.init_or_restore()
    loader = DataLoader(cfg, shard=(trainer.mesh.dp, trainer.mesh.dp_rank))
    gen = torch.Generator().manual_seed(1)

    def data():
        for host in loader:
            x = multihost.global_batch({k: np.ascontiguousarray(host[k])
                                        for k in "ab"}, trainer.mesh,
                                       whole_images=True)
            with sharded(trainer.mesh):
                batch = preprocess_pair_batch(x["a"], x["b"], gen, CROP,
                                              train=True)
            yield {k: image_rows(v, trainer.mesh).contiguous()
                   for k, v in batch.items()}
    trainer.fit(data(), total_steps=2)
    return {"step": trainer.model.step,
            "shape": tuple(trainer.model.pool.buffer.shape),
            "weights": _weights(trainer.model)}


# JAX's temporal config of the windows (its create_model's: the pool 2)
T_BASE = dict(model="temporal", net_g="resnet_6blocks", net_d="n_layers",
              ngf=8, ndf=8, use_dropout=True)


def _tcfg(g, remat=False):
    return Config(model=ModelConfig(**T_BASE, n_frames_g=g, remat=remat),
                  data=DataConfig(crop_size=CROP, batch_size=T_BATCH,
                                  n_frames_total=T_FRAMES),
                  loss=LossConfig(no_vgg_loss=True, pool_size=2),
                  train=TrainConfig())


def _windows():
    r = np.random.default_rng(3)
    return {k: torch.from_numpy(r.uniform(
        -1, 1, (T_BATCH, T_FRAMES, CROP, CROP, 3)).astype(np.float32))
        for k in ("a", "b")}


@contextlib.contextmanager
def _jax_draws(draws, mesh):
    """The window's dropout masks and pool decisions are JAX's (``draws``:
    the whole batch's, in the port's call order), this rank's block of
    each mask."""
    masks, pool = list(draws["masks"]), list(draws["pool"])
    saved = ops.dropout_mask, image_pool.draw_decisions

    def mask(shape, rate, generator, rows=None):
        m = masks.pop(0)
        if rows is None:
            return spatial.local_block(m, mesh)
        # the activation's partition: uneven at the U-Net's inner levels
        n = pmesh.local_rows(m.shape[0], mesh.dp, mesh.dp_rank)
        q = mesh.sp_rank
        return m[int(n[0]):int(n[-1]) + 1, rows[q]:rows[q + 1]]

    def decisions(n, size, generator):
        swap, idx = pool.pop(0)
        return torch.tensor(swap), torch.tensor(idx)
    ops.dropout_mask, image_pool.draw_decisions = mask, decisions
    try:
        yield
    finally:
        ops.dropout_mask, image_pool.draw_decisions = saved
    assert not masks and not pool


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pins_of(records, dp, sp):
    """One process's pins (``chip_smoke.KinkPins``) from every rank's
    ``ShardPins`` records (in rank order) of a dp×sp window: each data
    row's rows joined, the data rows joined along the batch."""
    cs = _chip_smoke()
    rows = [cs.ShardPins.whole(records[d * sp:(d + 1) * sp])
            for d in range(dp)]
    out = rows[0]
    for more in rows[1:]:
        out.saved += more.saved
        out.stats += more.stats
    out.merge = dp
    return out


def window_case(case, mesh=None, remat=False, draws=None, pins=None):
    """One temporal train step (a window) of ``case`` (``_jax_temporal``:
    its weights and n_frames_g) on this rank's block (the whole batch
    without ``mesh``), its own draws or JAX's (``draws``); with the pool
    after it and this rank's count of exchanges. ``pins``: with ``mesh``
    a ``chip_smoke.ShardPins`` that records the window's forward point,
    else pins that one process's window replays (``_pins_of``): the
    partitioned forward is a rounding away from one process's, which
    flips ReLU and L1 kinks and moved G's gradient by 0.4% unpinned."""
    model = create_model(_tcfg(case["g"], remat), device="cpu",
                         steps_per_epoch=10,
                         seed=0 if mesh is None else 5 * mesh.rank)
    model.netG.load_state_dict(case["weights"]["netG"])
    model.netD.load_state_dict(case["weights"]["netD"])
    batch = _windows()
    if mesh is not None:
        replicate(model, mesh)
        batch = shard_batch(batch, mesh)
    calls, reduce = [0], spatial.Shards._reduce

    def counted(self, buf):
        calls[0] += 1
        return reduce(self, buf)
    spatial.Shards._reduce = counted
    try:
        # the ranks and one process run the same CPU convolutions (a test
        # module that a worker imports, tests/torch_refs.py, turns oneDNN
        # off): their real taps then differ by the partition's rounding
        # alone, which the pins cover
        with torch.backends.mkldnn.flags(enabled=True), (
                _jax_draws(draws, mesh) if draws is not None
                else contextlib.nullcontext()), (
                contextlib.nullcontext() if pins is None else
                pins.recording() if mesh is not None else pins.replaying()):
            metrics = model.train_step(batch)
    finally:
        spatial.Shards._reduce = reduce
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _grads(model), "weights": _weights(model),
            "pool": (model.pool.buffer.clone(), int(model.pool.count)),
            "exchanges": calls[0]}


def window_runs(case, mesh, remat=False):
    """A window of ``case`` on ``mesh`` drawing its own (with its
    ``ShardPins`` records), one with JAX's draws and, with ``remat``, the
    first again with remat."""
    pins = _chip_smoke().ShardPins()
    out = {"own": window_case(case, mesh, pins=pins),
           "jax": window_case(case, mesh, draws=case["draws"])}
    out["pins"] = (pins.saved, pins.stats)
    if remat:
        out["remat"] = window_case(case, mesh, remat=True)
    return out


# netE and the edge channel on dp 2 x sp 2: the pix2pixHD config of the
# port's netE test against JAX (tests/test_torch_port_encoder.py) with
# the edges, no pool; 6 instance ids an image hashed into 4 segments, so
# that ids collide and inst_collisions counts
N_LAYOUT = (2, 2)
N_MODEL = dict(model="pix2pixhd", net_g="local", net_d="multiscale",
               num_d=2, ngf=4, ndf=8, n_downsample_global=2,
               n_blocks_global=1, n_blocks_local=1, use_instance_feat=True,
               use_instance_edges=True, feat_num=3, nef=4, n_downsample_e=2,
               num_instances=4)
N_BATCH = 2


def _ncfg():
    return Config(model=ModelConfig(**N_MODEL),
                  data=DataConfig(crop_size=CROP, batch_size=N_BATCH),
                  loss=LossConfig(no_vgg_loss=True, pool_size=0,
                                  lambda_l1=10.0))


def _nbatch():
    """Frames and instance maps: each pixel the id of its nearest of 6
    random sites, the ids random below 2^24."""
    r = np.random.default_rng(5)
    out = {k: torch.from_numpy(r.uniform(-1, 1, (N_BATCH, CROP, CROP, 3))
                               .astype(np.float32)) for k in ("a", "b")}
    yy, xx = np.mgrid[:CROP, :CROP]
    inst = np.empty((N_BATCH, CROP, CROP), np.int32)
    for i in range(N_BATCH):
        sites, ids = r.integers(0, CROP, (6, 2)), r.integers(0, 1 << 24, 6)
        d = ((yy[None] - sites[:, 0, None, None]) ** 2
             + (xx[None] - sites[:, 1, None, None]) ** 2)
        inst[i] = ids[d.argmin(0)]
    out["inst"] = torch.from_numpy(inst)
    return out


def nete_case(weights, mesh=None, pins=None):
    """One train step of the netE config from JAX's weights on this rank's
    block (the whole batch without ``mesh``; the id maps whole on every
    rank of a data row), its forward point recorded (``mesh``) or
    replayed (``pins``, as ``window_case``'s)."""
    model = create_model(_ncfg(), device="cpu", steps_per_epoch=10,
                         seed=0 if mesh is None else 5 * mesh.rank)
    for name in ("netG", "netE", "netD"):
        getattr(model, name).load_state_dict(weights[name])
    batch = _nbatch()
    if mesh is not None:
        replicate(model, mesh)
        batch = shard_batch(batch, mesh)
    with torch.backends.mkldnn.flags(enabled=True), (
            contextlib.nullcontext() if pins is None else
            pins.recording() if mesh is not None else pins.replaying()):
        metrics = model.train_step(batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _grads(model), "weights": _weights(model),
            "inst": tuple(batch["inst"].shape)}


# the U-Net on the two ranks (dp 1 x sp 2): unet_256 at 256² (its 1-row
# level one rank's, its ups realigned to its skips), ngf 4, the n-layer D,
# dropout on its three inner middle levels; instance norm (B1 split), and
# batch norm (the moments over both ranks' rows)
U_LAYOUT = (1, 2)
U_BASE = dict(model="pix2pix", net_g="unet_256", net_d="n_layers", ngf=4,
              ndf=8, use_dropout=True)
U_CROP, U_NORMS = 256, ("instance", "batch")


def _ucfg(norm):
    return Config(model=ModelConfig(**U_BASE, norm=norm),
                  data=DataConfig(crop_size=U_CROP, batch_size=1),
                  loss=LossConfig(no_vgg_loss=True, pool_size=0))


def _ubatch():
    r = np.random.default_rng(6)
    return {k: torch.from_numpy(r.uniform(-1, 1, (1, U_CROP, U_CROP, 3))
                                .astype(np.float32)) for k in ("a", "b")}


@contextlib.contextmanager
def _pinned_batch_norm(pins):
    """``pins`` also at every batch norm's output, in call order with the
    conv outputs: the moments summed over the ranks are a rounding away
    from one process's, which flips the ReLU and LeakyReLU kinks after
    them (unpinned, G's gradient moved by 1.5e-3)."""
    bn = ops.batch_norm
    ops.batch_norm = lambda *a, **kw: pins.pin(bn(*a, **kw))
    try:
        yield
    finally:
        ops.batch_norm = bn


def unet_case(case, mesh=None, draws=None, pins=None):
    """One train step of the U-Net config of ``case`` (``_jax_unet``: its
    norm and weights) on this rank's block (the whole batch without
    ``mesh``), its own dropout draws or JAX's (``draws``), its forward
    point recorded (``mesh``) or replayed (``pins``, as
    ``window_case``'s, batch norm's outputs too)."""
    model = create_model(_ucfg(case["norm"]), device="cpu",
                         steps_per_epoch=10,
                         seed=0 if mesh is None else 5 * mesh.rank)
    model.netG.load_state_dict(case["weights"]["netG"])
    model.netD.load_state_dict(case["weights"]["netD"])
    batch = _ubatch()
    if mesh is not None:
        replicate(model, mesh)
        batch = shard_batch(batch, mesh)
    with torch.backends.mkldnn.flags(enabled=True), (
            _jax_draws(draws, mesh) if draws is not None
            else contextlib.nullcontext()), (
            contextlib.nullcontext() if pins is None else
            pins.recording() if mesh is not None else pins.replaying()), (
            contextlib.nullcontext() if pins is None
            else _pinned_batch_norm(pins)):
        metrics = model.train_step(batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _grads(model), "weights": _weights(model)}


def unet_runs(case, mesh):
    """The U-Net step of ``case`` on ``mesh`` drawing its own (with its
    ``ShardPins`` records) and with JAX's draws."""
    pins = _chip_smoke().ShardPins()
    out = {"own": unet_case(case, mesh, pins=pins),
           "jax": unet_case(case, mesh, draws=case["draws"])}
    out["pins"] = (pins.saved, pins.stats)
    return out


def fit_temporal_case(out):
    """A 2-step temporal Trainer run from a synthetic folder of videos on
    this rank's block: the loader's windows of the data row, each frame
    cut to this rank's rows; the display gathers the first frame."""
    from ir2rgb_tpu_torch.data import DataLoader, preprocess_sequence_batch
    from ir2rgb_tpu_torch.parallel.mesh import image_rows, sharded
    from ir2rgb_tpu_torch.train import Trainer
    cfg = Config(model=ModelConfig(**{**T_BASE, "ngf": 4, "ndf": 4},
                                   n_frames_g=2),
                 data=DataConfig(dataroot=os.path.join(out, "videos"),
                                 dataset_mode="temporal",
                                 n_frames_total=T_FRAMES, load_size=40,
                                 crop_size=CROP, batch_size=1),
                 loss=LossConfig(no_vgg_loss=True, pool_size=2),
                 train=TrainConfig(name="sp_fit_temporal",
                                   checkpoints_dir=os.path.join(out, "runs"),
                                   spatial_devices=2, niter=1, niter_decay=0,
                                   print_freq=1, display_freq=1))
    trainer = Trainer(create_model(cfg, device="cpu", steps_per_epoch=2),
                      cfg)
    trainer.init_or_restore()
    loader = DataLoader(cfg, shard=(trainer.mesh.dp, trainer.mesh.dp_rank))
    gen = torch.Generator().manual_seed(1)
    shapes = []

    def data():
        for host in loader:
            x = multihost.global_batch({k: np.ascontiguousarray(host[k])
                                        for k in "ab"}, trainer.mesh,
                                       whole_images=True)
            with sharded(trainer.mesh):
                batch = preprocess_sequence_batch(x["a"], x["b"], gen, CROP,
                                                  train=True)
            batch = {k: image_rows(v, trainer.mesh).contiguous()
                     for k, v in batch.items()}
            shapes.append(tuple(batch["a"].shape))
            yield batch
    trainer.fit(data(), total_steps=2)
    return {"step": trainer.model.step, "shapes": shapes,
            "pool": (tuple(trainer.model.pool.buffer.shape),
                     int(trainer.model.pool.count)),
            "saved": trainer.ckpt.all_steps(),
            "weights": _weights(trainer.model)}


def worker(port, rank, out):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=4, process_id=rank,
                         timeout_s=TIMEOUT_S)
    weights = torch.load(os.path.join(out, "weights.pt"))
    res = {}
    for dp, sp in LAYOUTS:
        mesh = dp_sp_mesh(dp, sp, device="cpu")
        res[(dp, sp)] = step_case(weights, mesh)
    dp, sp, train = ACCUM_EMA
    res["accum_ema"] = step_case(weights, dp_sp_mesh(dp, sp, device="cpu"),
                                 **train)
    cases = torch.load(os.path.join(out, "temporal.pt"))
    for dp, sp, g in T_LAYOUTS:
        mesh = dp_sp_mesh(dp, sp, device="cpu")
        res[("temporal", dp, sp)] = window_runs(
            cases[g], mesh, remat=(dp, sp, g) == T_REMAT)
    pins = _chip_smoke().ShardPins()
    mesh = dp_sp_mesh(*N_LAYOUT, device="cpu")
    res["nete"] = nete_case(torch.load(os.path.join(out, "nete.pt")), mesh,
                            pins)
    res["nete"]["pins"] = (pins.saved, pins.stats)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    mesh.barrier()
    torch.distributed.destroy_process_group()


def fit_worker(port, rank, out):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=2, process_id=rank,
                         timeout_s=TIMEOUT_S)
    res = fit_case(out)
    torch.save(res, os.path.join(out, f"fit{rank}.pt"))
    dp, sp, g = T_PAIR
    cases = torch.load(os.path.join(out, "temporal.pt"))
    pair = {("temporal", dp, sp): window_runs(
        cases[g], dp_sp_mesh(dp, sp, device="cpu")),
        "fit": fit_temporal_case(out)}
    unets = torch.load(os.path.join(out, "unet.pt"))
    mesh = dp_sp_mesh(*U_LAYOUT, device="cpu")
    for norm in U_NORMS:
        pair[("unet", norm)] = unet_runs(unets[norm], mesh)
    torch.save(pair, os.path.join(out, f"pair{rank}.pt"))
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(out, n, job):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    return [subprocess.Popen(
        [sys.executable, __file__, str(port), str(r), str(out), job],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True) for r in range(n)]


def _wait(procs):
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    assert outs is not None, "a rank hung past its timeout"
    bad = [f"rank {r} exited {p.returncode}:\n{e[-3000:]}"
           for r, (p, (_, e)) in enumerate(zip(procs, outs)) if p.returncode]
    assert not bad, "\n".join(bad)


def _drawn(init, seed):
    """JAX parameters of ``init``'s structure drawn as the reference's
    ``weights_init`` from a numpy seed: kernels N(0, 0.02), the rest 0."""
    import jax
    import jax.numpy as jnp
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda t: jnp.asarray((r.normal(0, 0.02, t.shape)
                               if len(t.shape) > 1 else
                               np.zeros(t.shape)).astype(t.dtype)),
        jax.eval_shape(init, jax.random.PRNGKey(0)))


def _jax_temporal(g):
    """JAX's temporal model of the windows' config with n_frames_g ``g``,
    an initial state built as ``_jax_state`` builds it, and for the
    ranks: its weights as the port's and the draws JAX's ``train_step``
    makes from the state's key (``model.py:440``, ``:330``, ``:424-425``),
    in the port's call order: each frame's six blocks' dropout masks
    (``resnet_generator_apply`` splits the frame's key a block), then its
    pool decisions (``query_pool``: a key an item, split into the coin and
    the slot)."""
    import jax
    import jax.numpy as jnp
    from ir2rgb_tpu.config import Config as JConfig
    from ir2rgb_tpu.config import DataConfig as JDataConfig
    from ir2rgb_tpu.config import LossConfig as JLossConfig
    from ir2rgb_tpu.config import ModelConfig as JModelConfig
    from ir2rgb_tpu.train import create_model as jax_create_model
    from ir2rgb_tpu.train.image_pool import init_pool
    from ir2rgb_tpu.train.model import TrainState
    from ir2rgb_tpu_torch.checkpoint import (
        discriminator_state_dict_from_jax,
        generator_state_dict_from_jax,
    )
    jm = jax_create_model(JConfig(
        model=JModelConfig(**T_BASE, n_frames_g=g),
        data=JDataConfig(crop_size=CROP, batch_size=T_BATCH,
                         n_frames_total=T_FRAMES),
        loss=JLossConfig(no_vgg_loss=True, pool_size=2)), steps_per_epoch=10)
    gp, dp = _drawn(jm.g_init, 0), _drawn(jm.d_init, 1)
    state = TrainState(g_params=gp, d_params=dp, g_opt=jm.g_tx.init(gp),
                       d_opt=jm.d_tx.init(dp), step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(2),
                       pool=init_pool(2, (CROP, CROP, 3)))
    k_drop, k_pool = jax.random.split(jax.random.split(state.rng)[1])
    masks, pool = [], []
    block = (T_BATCH, CROP // 4, CROP // 4, 4 * T_BASE["ngf"])
    for kd in jax.random.split(k_drop, T_FRAMES):
        masks += [torch.from_numpy(np.asarray(jax.random.bernoulli(
            k, 0.5, block))) for k in jax.random.split(kd, 6)]
    for kp in jax.random.split(k_pool, T_FRAMES):
        draws = [jax.random.split(k) for k in jax.random.split(kp, T_BATCH)]
        pool.append(([bool(jax.random.bernoulli(ks)) for ks, _ in draws],
                     [int(jax.random.randint(ki, (), 0, 2))
                      for _, ki in draws]))
    pm = create_model(_tcfg(g), device="cpu")
    weights = {"netG": generator_state_dict_from_jax(
        jax.tree.map(np.asarray, gp), pm.gen_cfg),
        "netD": discriminator_state_dict_from_jax(
            jax.tree.map(np.asarray, dp), pm.disc_cfg)}
    return jm, state, {"g": g, "weights": weights,
                       "draws": {"masks": masks, "pool": pool}}


def _jax_unet(norm):
    """JAX's model of ``_ucfg(norm)``, an initial state built as
    ``_jax_state``'s and, for the ranks, its weights as the port's and
    the dropout masks JAX's ``train_step`` draws from the state's key
    (``model.py:440``, ``:330``; ``generators.py:763-767``) in the
    port's call order: the innermost dropout level's first."""
    import jax
    import jax.numpy as jnp
    from ir2rgb_tpu.config import Config as JConfig
    from ir2rgb_tpu.config import DataConfig as JDataConfig
    from ir2rgb_tpu.config import LossConfig as JLossConfig
    from ir2rgb_tpu.config import ModelConfig as JModelConfig
    from ir2rgb_tpu.train import create_model as jax_create_model
    from ir2rgb_tpu.train.image_pool import init_pool
    from ir2rgb_tpu.train.model import TrainState
    from ir2rgb_tpu_torch.checkpoint import (
        discriminator_state_dict_from_jax,
        generator_state_dict_from_jax,
    )
    jm = jax_create_model(JConfig(
        model=JModelConfig(**U_BASE, norm=norm),
        data=JDataConfig(crop_size=U_CROP, batch_size=1),
        loss=JLossConfig(no_vgg_loss=True, pool_size=0)), steps_per_epoch=10)
    r = np.random.default_rng(3)

    def gamma(path, t):
        # batch norm's gamma as the reference's weights_init draws it,
        # N(1, 0.02) (``ops.py:325-329``; 0 would zero every norm)
        if getattr(path[-1], "key", None) != "gamma":
            return t
        return jnp.asarray((1.0 + r.normal(0, 0.02, t.shape))
                           .astype(t.dtype))
    g, d = (jax.tree_util.tree_map_with_path(gamma, _drawn(init, seed))
            for init, seed in ((jm.g_init, 0), (jm.d_init, 1)))
    state = TrainState(g_params=g, d_params=d, g_opt=jm.g_tx.init(g),
                       d_opt=jm.d_tx.init(d), step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(2),
                       pool=init_pool(0, (U_CROP, U_CROP, 3)))
    k_drop = jax.random.split(jax.random.split(state.rng)[1])[0]
    # unet_256: 8 levels, dropout after the up norms of levels 6, 5, 4
    masks = [torch.from_numpy(np.asarray(jax.random.bernoulli(
        k, 0.5, (1, U_CROP >> i, U_CROP >> i, 8 * U_BASE["ngf"]))))
        for i, k in zip((6, 5, 4), jax.random.split(k_drop, 3))]
    pm = create_model(_ucfg(norm), device="cpu")
    weights = {"netG": generator_state_dict_from_jax(
        jax.tree.map(np.asarray, g), pm.gen_cfg),
        "netD": discriminator_state_dict_from_jax(
            jax.tree.map(np.asarray, d), pm.disc_cfg)}
    return jm, state, {"norm": norm, "weights": weights,
                       "draws": {"masks": masks, "pool": []}}


def _jax_nete():
    """JAX's netE model of ``_ncfg``, an initial state built as
    ``_jax_state``'s, and its weights as the port's."""
    import jax
    import jax.numpy as jnp
    from ir2rgb_tpu.config import Config as JConfig
    from ir2rgb_tpu.config import DataConfig as JDataConfig
    from ir2rgb_tpu.config import LossConfig as JLossConfig
    from ir2rgb_tpu.config import ModelConfig as JModelConfig
    from ir2rgb_tpu.train import create_model as jax_create_model
    from ir2rgb_tpu.train.image_pool import init_pool
    from ir2rgb_tpu.train.model import TrainState
    from ir2rgb_tpu_torch.checkpoint import (
        discriminator_state_dict_from_jax,
        encoder_state_dict_from_jax,
        generator_state_dict_from_jax,
    )
    jm = jax_create_model(JConfig(
        model=JModelConfig(**N_MODEL),
        data=JDataConfig(crop_size=CROP, batch_size=N_BATCH),
        loss=JLossConfig(no_vgg_loss=True, pool_size=0, lambda_l1=10.0)),
        steps_per_epoch=10)
    g, d = _drawn(jm.g_init, 0), _drawn(jm.d_init, 1)
    state = TrainState(g_params=g, d_params=d, g_opt=jm.g_tx.init(g),
                       d_opt=jm.d_tx.init(d), step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(2),
                       pool=init_pool(0, (CROP, CROP, 3)))
    pm = create_model(_ncfg(), device="cpu")
    g = jax.tree.map(np.asarray, g)
    return jm, state, {
        "netG": generator_state_dict_from_jax(g, pm.gen_cfg),
        "netE": encoder_state_dict_from_jax(g["netE"], pm.enc_cfg),
        "netD": discriminator_state_dict_from_jax(
            jax.tree.map(np.asarray, d), pm.disc_cfg)}


def _jax_state():
    """JAX's ``tests/test_parallel.py:127`` model and an initial state
    built as ``init_state`` builds it, with the reference's
    ``weights_init`` drawn from numpy seeds (kernels N(0, 0.02), the rest
    0; a jitted ``init_state`` takes ~10 s to compile here), and its
    weights as the port's."""
    import jax
    import jax.numpy as jnp
    from ir2rgb_tpu.train.image_pool import init_pool
    from ir2rgb_tpu.train.model import TrainState
    from ir2rgb_tpu.config import Config as JConfig
    from ir2rgb_tpu.config import DataConfig as JDataConfig
    from ir2rgb_tpu.config import LossConfig as JLossConfig
    from ir2rgb_tpu.config import ModelConfig as JModelConfig
    from ir2rgb_tpu.train import create_model as jax_create_model
    from ir2rgb_tpu_torch.checkpoint import (
        discriminator_state_dict_from_jax,
        generator_state_dict_from_jax,
    )
    jm = jax_create_model(JConfig(
        model=JModelConfig(**BASE),
        data=JDataConfig(crop_size=CROP, batch_size=BATCH),
        loss=JLossConfig(no_vgg_loss=True, pool_size=0)), steps_per_epoch=10)
    batch = {k: v.numpy() for k, v in _batch().items()}
    g, d = _drawn(jm.g_init, 0), _drawn(jm.d_init, 1)
    state = TrainState(g_params=g, d_params=d, g_opt=jm.g_tx.init(g),
                       d_opt=jm.d_tx.init(d), step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(2),
                       pool=init_pool(0, (CROP, CROP, 3)))
    pm = create_model(_cfg(), device="cpu")
    g = jax.tree.map(np.asarray, state.g_params)
    d = jax.tree.map(np.asarray, state.d_params)
    return jm, state, batch, {
        "netG": generator_state_dict_from_jax(g, pm.gen_cfg),
        "netD": discriminator_state_dict_from_jax(d, pm.disc_cfg)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' steps on both layouts, the two ranks' Trainer run,
    the port's one-process step and JAX's one-device step (computed while
    the ranks run)."""
    import jax
    from ir2rgb_tpu_torch.data import write_synthetic_dataset
    out = tmp_path_factory.mktemp("spatial_train")
    jm, state, batch, weights = _jax_state()
    torch.save(weights, out / "weights.pt")
    temporal = {g: _jax_temporal(g) for g in (2, 3)}
    torch.save({g: t[2] for g, t in temporal.items()}, out / "temporal.pt")
    njm, nstate, nweights = _jax_nete()
    torch.save(nweights, out / "nete.pt")
    unets = {norm: _jax_unet(norm) for norm in U_NORMS}
    torch.save({norm: u[2] for norm, u in unets.items()}, out / "unet.pt")
    write_synthetic_dataset(str(out / "data"), n=4, size=40)
    write_synthetic_dataset(str(out / "videos"), size=40, n_videos=2,
                            frames_per_video=4)
    procs = _spawn(out, 4, "steps") + _spawn(out, 2, "fit")
    try:
        _, m1 = jax.jit(jm.train_step)(state, batch)
        jax_metrics = {k: float(v) for k, v in m1.items()}
        one = step_case(weights)
        one_accum_ema = step_case(weights, **ACCUM_EMA[2])
        jax_windows = {}
        for g, (tjm, tstate, _) in temporal.items():
            _, m = jax.jit(tjm.train_step)(tstate, {
                k: v.numpy() for k, v in _windows().items()})
            jax_windows[g] = {k: float(v) for k, v in m.items()}
        _, m = jax.jit(njm.train_step)(nstate, {
            k: v.numpy() for k, v in _nbatch().items()})
        jax_nete = {k: float(v) for k, v in m.items()}
        jax_unets = {}
        for norm, (ujm, ustate, _) in unets.items():
            _, m = jax.jit(ujm.train_step)(ustate, {
                k: v.numpy() for k, v in _ubatch().items()})
            jax_unets[norm] = {k: float(v) for k, v in m.items()}
    finally:
        _wait(procs)
    res = dict(ranks=[torch.load(out / f"rank{r}.pt") for r in range(4)],
               fit=[torch.load(out / f"fit{r}.pt") for r in range(2)],
               pairs=[torch.load(out / f"pair{r}.pt") for r in range(2)],
               one=one, one_accum_ema=one_accum_ema, jax=jax_metrics)
    # one process's window at each layout's partitioned forward point
    res["windows"] = {}
    for dp, sp, g in T_LAYOUTS + [T_PAIR]:
        group = res["ranks"] if (dp, sp, g) != T_PAIR else res["pairs"]
        pins = _pins_of([r[("temporal", dp, sp)].pop("pins") for r in group],
                        dp, sp)
        res["windows"][(dp, sp, g)] = {
            "jax": jax_windows[g],
            "one": window_case(temporal[g][2], pins=pins),
            "replayed": pins.all_replayed()}
    # one process's netE step at the partitioned forward point
    pins = _pins_of([r["nete"].pop("pins") for r in res["ranks"]],
                    *N_LAYOUT)
    res["nete"] = {"jax": jax_nete, "one": nete_case(nweights, pins=pins),
                   "replayed": pins.all_replayed()}
    # one process's U-Net step at the partitioned forward point (batch
    # norm pins no statistics: its outputs and the conv outputs)
    res["unet"] = {}
    for norm in U_NORMS:
        pins = _pins_of([r[("unet", norm)].pop("pins")
                         for r in res["pairs"]], *U_LAYOUT)
        res["unet"][norm] = {
            "jax": jax_unets[norm],
            "one": unet_case(unets[norm][2], pins=pins),
            "replayed": pins.replayed == len(pins.saved) > 0
            and pins.stats_replayed == len(pins.stats)}
    return res


def _rel_norm(got, want):
    return float((got - want).norm()) / max(float(want.norm()), 1e-30)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda t: f"dp{t[0]}xsp{t[1]}")
def test_dp_sp_step_equals_jax_and_one_process(ranks, layout):
    rs = [r[layout] for r in ranks["ranks"]]
    one, jx = ranks["one"], ranks["jax"]
    # every rank holds one replica: the same metrics, grads and weights
    for r in rs[1:]:
        assert r["metrics"] == rs[0]["metrics"]
        for key in ("grads", "weights"):
            assert all(torch.equal(r[key][k], rs[0][key][k])
                       for k in rs[0][key]), key
    r0 = rs[0]
    assert r0["metrics"].keys() == jx.keys() == one["metrics"].keys()
    for k, v in jx.items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=2e-3,
                                   err_msg=k)
        got, want = r0["metrics"][k], one["metrics"][k]
        assert abs(got - want) <= 1e-5 * abs(want), k
    assert r0["grads"].keys() == one["grads"].keys()
    for net in ("netG", "netD"):
        keys = [k for k in one["grads"] if k.startswith(net + ".")]
        got = torch.cat([r0["grads"][k].reshape(-1) for k in keys])
        want = torch.cat([one["grads"][k].reshape(-1) for k in keys])
        assert _rel_norm(got, want) <= 1e-5, net
    # after one Adam step: JAX's bar (tests/test_parallel.py:80-85; the
    # first update is about lr·sign(g), and a bias before a norm has a
    # zero gradient up to rounding)
    for k, v in one["weights"].items():
        np.testing.assert_allclose(r0["weights"][k].numpy(), v.numpy(),
                                   atol=5e-4, err_msg=k)


def test_grad_accum_and_ema_on_dp1_sp4_equal_one_process(ranks):
    # two micro-batches a step, each partitioned, and the EMA shadow after
    # the update: the one-process step's, at the step's bars
    got, want = ranks["ranks"][0]["accum_ema"], ranks["one_accum_ema"]
    for r in ranks["ranks"][1:]:
        assert r["accum_ema"]["metrics"] == got["metrics"]
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-5 * abs(v), k
    for net in ("netG", "netD"):
        keys = [k for k in want["grads"] if k.startswith(net + ".")]
        a = torch.cat([got["grads"][k].reshape(-1) for k in keys])
        b = torch.cat([want["grads"][k].reshape(-1) for k in keys])
        assert _rel_norm(a, b) <= 1e-5, net
    assert any(k.startswith("ema.") for k in want["weights"])
    for k, v in want["weights"].items():
        np.testing.assert_allclose(got["weights"][k].numpy(), v.numpy(),
                                   atol=5e-4, err_msg=k)


def test_trainer_fit_on_sp2(ranks):
    f0, f1 = ranks["fit"]
    assert f0["step"] == f1["step"] == 2
    # the pool holds whole frames, the same on both ranks
    assert f0["shape"] == (2, CROP, CROP, 3)
    assert all(torch.equal(f0["weights"][k], f1["weights"][k])
               for k in f0["weights"])


@pytest.mark.parametrize("layout", T_LAYOUTS + [T_PAIR],
                         ids=lambda t: f"dp{t[0]}xsp{t[1]}-g{t[2]}")
def test_temporal_window_on_dp_sp_equals_jax_and_one_process(ranks, layout):
    dp, sp, g = layout
    group = ranks["ranks"] if layout != T_PAIR else ranks["pairs"]
    rs = [r[("temporal", dp, sp)] for r in group]
    want = ranks["windows"][layout]
    assert want["replayed"]
    for run in ("own", "jax"):
        # every rank holds one replica, the pool of whole frames included
        for r in rs[1:]:
            assert r[run]["metrics"] == rs[0][run]["metrics"], run
            for key in ("grads", "weights"):
                assert all(torch.equal(r[run][key][k], rs[0][run][key][k])
                           for k in rs[0][run][key]), (run, key)
            assert torch.equal(r[run]["pool"][0], rs[0][run]["pool"][0])
    # JAX's draws: JAX's one-device jitted window, at its bar
    got = rs[0]["jax"]["metrics"]
    assert got.keys() == want["jax"].keys()
    for k, v in want["jax"].items():
        np.testing.assert_allclose(got[k], v, rtol=2e-3, err_msg=k)
    # its own draws: the port's one-process window at the partitioned
    # forward point
    got, one = rs[0]["own"], want["one"]
    assert got["metrics"].keys() == one["metrics"].keys()
    for k, v in one["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-5 * abs(v), k
    assert got["grads"].keys() == one["grads"].keys()
    for net in ("netG", "netD"):
        keys = [k for k in one["grads"] if k.startswith(net + ".")]
        a = torch.cat([got["grads"][k].reshape(-1) for k in keys])
        b = torch.cat([one["grads"][k].reshape(-1) for k in keys])
        assert _rel_norm(a, b) <= 1e-5, net
    # the pool after the window: the same frames, filled as far (its
    # fakes are the partitioned forward's, a rounding from one process's)
    assert got["pool"][1] == one["pool"][1] == 2
    np.testing.assert_allclose(got["pool"][0].numpy(), one["pool"][0].numpy(),
                               atol=1e-5)
    for k, v in one["weights"].items():
        np.testing.assert_allclose(got["weights"][k].numpy(), v.numpy(),
                                   atol=5e-4, err_msg=k)


def test_temporal_remat_on_dp1_sp4_equals_the_window_without_it(ranks):
    # the recompute replays the blocks' exchanges in the backward, the
    # same ones on every rank, and changes nothing (JAX's remat bar,
    # tests/test_variants.py:83)
    dp, sp, _ = T_REMAT
    rs = [r[("temporal", dp, sp)] for r in ranks["ranks"]]
    calls = {r["remat"]["exchanges"] for r in rs}
    assert len(calls) == 1 and calls.pop() > rs[0]["own"]["exchanges"]
    assert len({r["own"]["exchanges"] for r in rs}) == 1
    for r in rs:
        got, want = r["remat"], r["own"]
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= 1e-6, k
        for k, v in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(),
                                       atol=1e-6, err_msg=k)


def test_temporal_trainer_fit_on_sp2(ranks):
    f0, f1 = (p["fit"] for p in ranks["pairs"])
    assert f0["step"] == f1["step"] == 2 and f0["saved"] == [2]
    # each step a window of this rank's rows of every frame
    assert set(f0["shapes"]) == set(f1["shapes"]) == {
        (1, T_FRAMES, CROP // 2, CROP, 3)}
    # the pool holds whole frames, filled by the two windows' six
    assert f0["pool"] == f1["pool"] == ((2, CROP, CROP, 3), 2)
    assert all(torch.equal(f0["weights"][k], f1["weights"][k])
               for k in f0["weights"])


@pytest.mark.parametrize("norm", U_NORMS)
def test_unet_step_on_sp2_equals_jax_and_one_process(ranks, norm):
    # dropout's masks on uneven and empty shards, the ups realigned to
    # the skips, batch norm's moments over both ranks' rows: JAX's draws
    # give JAX's one-device step, the port's own the one-process step at
    # the partitioned forward point
    rs = [p[("unet", norm)] for p in ranks["pairs"]]
    want = ranks["unet"][norm]
    assert want["replayed"]
    for run in ("own", "jax"):
        for r in rs[1:]:
            assert r[run]["metrics"] == rs[0][run]["metrics"], run
            for key in ("grads", "weights"):
                assert all(torch.equal(r[run][key][k], rs[0][run][key][k])
                           for k in rs[0][run][key]), (run, key)
    got = rs[0]["jax"]["metrics"]
    assert got.keys() == want["jax"].keys()
    for k, v in want["jax"].items():
        np.testing.assert_allclose(got[k], v, rtol=2e-3, err_msg=k)
    got, one = rs[0]["own"], want["one"]
    assert got["metrics"].keys() == one["metrics"].keys()
    for k, v in one["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-5 * abs(v), k
    assert got["grads"].keys() == one["grads"].keys()
    for net in ("netG", "netD"):
        keys = [k for k in one["grads"] if k.startswith(net + ".")]
        a = torch.cat([got["grads"][k].reshape(-1) for k in keys])
        b = torch.cat([one["grads"][k].reshape(-1) for k in keys])
        assert _rel_norm(a, b) <= 1e-5, net
    for k, v in one["weights"].items():
        np.testing.assert_allclose(got["weights"][k].numpy(), v.numpy(),
                                   atol=5e-4, err_msg=k)


def test_nete_and_edges_step_on_dp2_sp2_equals_jax_and_one_process(ranks):
    # netE on each rank's rows of the real target, its pooling over the
    # ranks' segment sums; the edge channel cut from the whole map; the
    # collisions counted once a data row
    rs = [r["nete"] for r in ranks["ranks"]]
    want = ranks["nete"]
    assert want["replayed"]
    for r in rs:
        assert r["inst"] == (N_BATCH // N_LAYOUT[0], CROP, CROP)
        assert r["metrics"] == rs[0]["metrics"]
        for key in ("grads", "weights"):
            assert all(torch.equal(r[key][k], rs[0][key][k])
                       for k in rs[0][key]), key
    got, one, jx = rs[0], want["one"], want["jax"]
    assert got["metrics"].keys() == one["metrics"].keys() == jx.keys()
    assert got["metrics"]["inst_collisions"] == jx["inst_collisions"] > 0
    for k, v in jx.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=2e-3,
                                   err_msg=k)
        w = one["metrics"][k]
        assert abs(got["metrics"][k] - w) <= 1e-5 * abs(w), k
    assert got["grads"].keys() == one["grads"].keys()
    for net in ("netG", "netE", "netD"):
        keys = [k for k in one["grads"] if k.startswith(net + ".")]
        a = torch.cat([got["grads"][k].reshape(-1) for k in keys])
        b = torch.cat([one["grads"][k].reshape(-1) for k in keys])
        assert _rel_norm(a, b) <= 1e-5, net
    for k, v in one["weights"].items():
        np.testing.assert_allclose(got["weights"][k].numpy(), v.numpy(),
                                   atol=5e-4, err_msg=k)


if __name__ == "__main__":
    if sys.argv[4] == "fit":
        fit_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    else:
        worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
