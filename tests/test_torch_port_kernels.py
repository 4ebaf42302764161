"""The port's kernels B1 (instance norm + act) and B2 (output tail): their
plain PyTorch versions held to the JAX package's Pallas kernels, run as
the JAX tests run them on the CPU (interpret mode), on the same numpy
inputs. The CUDA kernels themselves are held to these plain versions on
the card by chip_smoke.py; here the Python around them (launch plan,
shared-memory layout, argument checks) is tested."""

import gc
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.kernels.instance_norm import (
    instance_norm_act_pallas,
    instance_norm_act_reference as jax_in_reference,
)
from ir2rgb_tpu.kernels.tail_fused import tail_fused as jax_tail_fused
from ir2rgb_tpu.nn.s2d_space import to_s2d

from ir2rgb_tpu_torch.kernels import fused_instance_norm_act, tail_fused

pin = importlib.import_module("ir2rgb_tpu_torch.kernels.instance_norm")
ptail = importlib.import_module("ir2rgb_tpu_torch.kernels.tail_fused")

# jitted: the B2 tests at C 32 and 64 share one compile of the Pallas
# kernel in interpret mode per width (an eager call traces and compiles it
# anew each time)
_jax_tail = jax.jit(jax_tail_fused, static_argnames=("tile", "interpret"))

ACTS = ["none", "relu", "leaky_relu", "tanh"]

# the 36 B1 launches of one pix2pixhd_512 frame: (shape, act) -> count
B1_MAIN_PATH = {
    # trunk head + up3, enhancer down1 + the blocks' first convs
    ((1, 256, 256, 64), "relu"): 6,
    ((1, 256, 256, 64), "none"): 3,
    ((1, 128, 128, 128), "relu"): 2,
    ((1, 64, 64, 256), "relu"): 2,
    ((1, 32, 32, 512), "relu"): 2,
    ((1, 16, 16, 1024), "relu"): 10,
    ((1, 16, 16, 1024), "none"): 9,
    # enhancer down0 + up
    ((1, 512, 512, 32), "relu"): 2,
}
# the 5 B3 d2s launches of one frame, one per up: (input shape, C)
D2S_MAIN_PATH = [((1, 16, 16, 2048), 512), ((1, 32, 32, 1024), 256),
                 ((1, 64, 64, 512), 128), ((1, 128, 128, 256), 64),
                 ((1, 256, 256, 128), 32)]


def _x(shape, seed, scale=3.0, shift=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


@pytest.mark.parametrize("input_nc", [3, 6])
def test_main_path_sends_these_shapes_to_the_kernels(monkeypatch, input_nc):
    # a pix2pixhd_512 / temporal_512 forward on the meta device (shapes
    # only, no arithmetic), recording what reaches each kernel wrapper
    from ir2rgb_tpu_torch import kernels
    from ir2rgb_tpu_torch.nn import GenConfig, LocalEnhancer, ops
    seen, tails, d2s_seen = {}, [], []

    def norm(x, act, negative_slope=0.2):
        key = (tuple(x.shape), act)
        seen[key] = seen.get(key, 0) + 1
        return x

    def tail(x, w, b):
        tails.append((tuple(x.shape), tuple(w.shape)))
        return x[..., :3]

    def d2s(y, c):
        d2s_seen.append((tuple(y.shape), c))
        n, h, w, _ = y.shape
        return y.new_empty((n, 2 * h, 2 * w, c))

    monkeypatch.setattr(ops, "fused_instance_norm_act", norm)
    monkeypatch.setattr(kernels, "tail_fused", tail)
    monkeypatch.setattr(ops, "d2s_fn", d2s)
    with torch.device("meta"):
        g = LocalEnhancer(GenConfig(input_nc=input_nc, ngf=32))
        y = g(torch.empty((1, 512, 512, input_nc)))
    assert seen == B1_MAIN_PATH and sum(seen.values()) == 36
    assert tails == [((1, 512, 512, 32), (7, 7, 32, 3))]
    assert d2s_seen == D2S_MAIN_PATH
    assert tuple(y.shape) == (1, 512, 512, 3)


@pytest.fixture(scope="module", autouse=True)
def _first_torch_tanh():
    """PyTorch's CPU tanh (2.13, AVX512) can be off by ~5e-5 on its first
    call in a process once the intra-op pool has run a parallel op (about
    one process in four); every later call is accurate to ~3e-8. Make
    that first call here, so that no comparison below depends on whether
    it comes first in its process."""
    torch.tanh(torch.zeros(8))


@pytest.mark.parametrize("shape", [(1, 16, 16, 128), (2, 8, 16, 256)])
@pytest.mark.parametrize("act", ACTS)
def test_b1_plain_matches_pallas_interpret(shape, act):
    # fp32 both sides; the two differ only in summation order and in the
    # Pallas kernel's E[x^2]-mean^2 variance (2e-5 / 1e-5, as the JAX
    # package's own kernel test)
    x = _x(shape, seed=0)
    y_j = np.asarray(instance_norm_act_pallas(jnp.asarray(x), act,
                                              interpret=True))
    y_p = fused_instance_norm_act(torch.from_numpy(x), act).numpy()
    err = float(np.abs(y_p - y_j).max())
    np.testing.assert_allclose(y_p, y_j, atol=2e-5, rtol=1e-5,
                               err_msg=f"max-abs {err:.3g}")


@pytest.mark.parametrize("shape", [(1, 32, 32, 32), (1, 16, 16, 64)])
@pytest.mark.parametrize("act", ACTS)
def test_b1_plain_matches_jax_reference_narrow(shape, act):
    # the main path's narrowest tensors (C = 32, 64), which the Pallas
    # kernel does not take; fp32 two-pass statistics on both sides
    x = _x(shape, seed=1)
    y_j = np.asarray(jax_in_reference(jnp.asarray(x), act))
    y_p = fused_instance_norm_act(torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(y_p, y_j, atol=2e-5, rtol=1e-5)


def test_b1_plain_bf16():
    # bf16 in and out, fp32 statistics on both sides; where the fp32
    # results differ in their last bits the two may round to neighbouring
    # bf16 values (2^-8 relative), hence atol 1e-2 as tests/test_kernels.py
    x = _x((1, 16, 16, 128), seed=2, scale=1.0, shift=0.0)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    y_j = np.asarray(instance_norm_act_pallas(xj, "relu", interpret=True),
                     np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    y_p = fused_instance_norm_act(xt, "relu")
    assert y_p.dtype == torch.bfloat16
    np.testing.assert_allclose(y_p.float().numpy(), y_j, atol=1e-2)


@pytest.mark.parametrize("shape", [(1, 32, 32, 32), (2, 8, 16, 256)])
def test_b1_stats_match_numpy(shape):
    # mean and rstd (the backward's residuals) against float64 numpy
    x = _x(shape, seed=3, shift=5.0)
    _, mean, rstd = pin.instance_norm_act(torch.from_numpy(x), "relu")
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), x64.mean(axis=(1, 2)),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(),
                               1 / np.sqrt(x64.var(axis=(1, 2)) + 1e-5),
                               rtol=1e-5)
    assert mean.dtype == rstd.dtype == torch.float32


# one pass of the multiscale D on a 512x512 pair (scale 0, then scale 1)
B1_D_SHAPES = [(1, 129, 129, 128), (1, 65, 65, 256), (1, 66, 66, 512),
               (1, 65, 65, 128), (1, 33, 33, 256), (1, 34, 34, 512)]
# the (shape, direction) cases that take the L2 route on an H100 (PERF.md
# names the same): where no slab of >= 32 bytes a pixel fits the shared
# memory of a cluster; in fp32, also where the tile plans that fit need
# more clusters than the card holds at once
B1_L2_ROUTE = {((1, 512, 512, 32), "fwd"), ((1, 512, 512, 32), "bwd"),
               ((1, 256, 256, 64), "bwd")}
B1_L2_ROUTE_FP32 = B1_L2_ROUTE | {((1, 256, 256, 64), "fwd"),
                                  ((1, 128, 128, 128), "bwd"),
                                  ((1, 129, 129, 128), "bwd")}


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted({s for s, _ in B1_MAIN_PATH})
                         + B1_D_SHAPES)
def test_b1_plan_covers_every_pixel_and_channel(shape, dtype, bwd):
    n, h, w, c = shape
    hw, item = h * w, torch.empty((), dtype=dtype).element_size()
    p = pin._plan(n, hw, c, item, bwd, _h100_like_clusters(bwd))
    # every (n, c, pixel) tiled exactly once: block (g, r) of image n owns
    # channels [g * channels, ...) and pixels [r * share, ...)
    seen = np.zeros((c, hw), np.int32)
    for g in range(p.groups):
        for r in range(p.k):
            seen[g * p.channels:(g + 1) * p.channels,
                 r * p.share:(r + 1) * p.share] += 1
    assert seen.min() == seen.max() == 1
    assert (p.k - 1) * p.share < hw  # no block without pixels
    # clusters of K <= 16 blocks, a grid of whole clusters
    assert p.k in (1, 2, 4, 8, 16) and (n * p.groups * p.k) % p.k == 0
    assert p.channels == 4 * p.cg and 32 % p.cg == 0
    assert p.channels * item <= 64
    # dynamic shared memory as the kernel lays it out, within the limit
    streams = 2 if bwd else 1
    tile = p.share * p.channels * item * streams
    warps = 8 if p.route == "smem" else 16
    assert p.smem_bytes == (tile if p.route == "smem" else 0) \
        + warps * p.channels * streams * 4 + p.channels * 16
    assert p.smem_bytes <= 232_448
    # the tile route holds groups of >= 32 bytes; the L2 route only where
    # none fits
    l2 = B1_L2_ROUTE_FP32 if dtype == torch.float32 else B1_L2_ROUTE
    want = "l2" if (shape, "bwd" if bwd else "fwd") in l2 else "smem"
    assert p.route == want
    assert p.route == "l2" or p.channels * item >= 32


def test_b1_plan_takes_only_clusters_the_card_can_run():
    # a card that holds no cluster above 8 blocks: (1,256,256,64) bf16
    # forward's 32-byte slab then fits no tile; a card that holds none
    # refuses every plan
    p = pin._plan(1, 256 * 256, 64, 2, False,
                  clusters=lambda p: 0 if p.k > 8 else 7)
    assert p.k <= 8 and p.route == "l2"
    with pytest.raises(ValueError):
        pin._plan(1, 256 * 256, 64, 2, False, clusters=lambda p: 0)


def _h100_like_clusters(bwd):
    """The count of a plan's clusters an H100 holds at once, modelled: a
    cluster lies in one GPC (132 SMs as six of 18, one of 16, one of 8),
    and an SM holds as many blocks as its 228 KB of shared memory takes
    (1 KB reserved each), at most 1 on the L2 route's 512 threads and 2
    (backward) or 3 (forward) on the tile route's 256, for registers.
    It gives the card's 7 clusters of 16 and 15 of 8 at 1 block an SM, and
    the plans sweep_b1.py read there at every shape of the path."""
    def clusters(p):
        per_sm = 233_472 // (p.smem_bytes + 1024)
        cap = 1 if p.route == "l2" else 2 if bwd else 3
        return sum(sms * min(per_sm, cap) // p.k
                   for sms in [18] * 6 + [16, 8])
    return clusters


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted({s for s, _ in B1_MAIN_PATH})
                         + B1_D_SHAPES)
def test_b1_plan_runs_in_one_wave(shape, dtype, bwd):
    # every cluster of the launch fits on the card at once: a second wave
    # would wait for the first's slowest cluster. In fp32 the tile plans
    # of (1,256,256,64) forward (8 clusters of 16) and of the
    # (1,128,128,128) and (1,129,129,128) backward do not, and the L2
    # route's do
    n, h, w, c = shape
    item = torch.empty((), dtype=dtype).element_size()
    clusters = _h100_like_clusters(bwd)
    p = pin._plan(n, h * w, c, item, bwd, clusters)
    assert n * p.groups <= clusters(p)
    want = {((1, 256, 256, 64), False): ("l2", 16, 16),
            ((1, 128, 128, 128), True): ("l2", 16, 8),
            ((1, 129, 129, 128), True): ("l2", 16, 8)}
    if dtype == torch.float32 and (shape, bwd) in want:
        assert (p.route, p.channels, p.k) == want[(shape, bwd)]


def test_b1_phase_probe_stamps_every_phase_of_both_kernels():
    # phases_b1 instruments a copy of the source by its lines: each of the
    # five stamps must land once in the forward and once in the backward
    from ir2rgb_tpu_torch import phases_b1
    src = phases_b1.instrumented_source()
    assert [src.count(f"b1_stamp({i});") for i in range(5)] == [2] * 5
    assert "ir2rgb_b1_stamps" in src


def test_b2_phase_probe_stamps_every_phase_of_the_tensor_core_kernel():
    # phases_b2 instruments a copy of the source by its lines: each of the
    # four stamps lands once, inside tail_tc_kernel, the last one after a
    # barrier at the kernel's end
    from ir2rgb_tpu_torch import phases_b2
    src = phases_b2.instrumented_source()
    assert [src.count(f"b2_stamp({i});") for i in range(4)] == [1] * 4
    body = src[src.index("tail_tc_kernel("):src.index("int launch_tc(")]
    assert all(f"b2_stamp({i});" in body for i in range(4))
    assert body.rstrip().endswith("__syncthreads();\n  b2_stamp(3);\n}\n\n"
                                  "template <int KS, int TH>".rstrip())
    assert "ir2rgb_b2_stamps" in src


def _threads(p):
    """Threads per block of plan ``p``'s kernel: 256 on the tile route,
    512 on the L2 route (``Route`` in csrc/instance_norm.cu)."""
    return 256 if p.route == "smem" else 512


def _col_sums(a, p):
    """The kernel's column sums of one block, in float32 and its order.

    ``a``: (iterations, rows, cg, 4) words of pixel row + i * rows
    (zeros past the share). Each thread adds its words in order, each
    warp butterflies (xor 16 ... cg, own value first), and the warps'
    totals are added in warp order. Returns (cg * 4,)."""
    threads = _threads(p)
    s = np.zeros(a.shape[1:], np.float32)
    for i in range(a.shape[0]):
        s = s + a[i]
    t = s.reshape(threads, 4)  # thread t = row * cg + col
    idx = np.arange(threads)
    off = 16
    while off >= p.cg:
        t = t + t[idx ^ off]
        off //= 2
    tot = np.zeros((p.cg, 4), np.float32)
    for warp in range(threads // 32):
        tot = tot + t[warp * 32:warp * 32 + p.cg]
    return tot.reshape(-1)


def _block_words(x, p, g, r):
    """Block (g, r)'s words of image x (hw, c) as (iterations, rows, cg,
    4), zero past the block's pixels, with the mask of its pixels and
    their count."""
    rows = _threads(p) // p.cg
    blk = x[r * p.share:(r + 1) * p.share,
            g * p.channels:(g + 1) * p.channels]
    its = -(-p.share // rows)
    a = np.zeros((its * rows, p.channels), np.float32)
    a[:len(blk)] = blk
    mask = (np.arange(its * rows) < len(blk)).reshape(its, rows, 1, 1)
    return a.reshape(its, rows, p.cg, 4), mask, len(blk)


@pytest.mark.parametrize("shape", [(1, 256, 256, 64), (1, 512, 512, 32)])
def test_b1_reduction_order_matches_float64_at_a_large_mean(shape):
    # the kernel's order under its fp32 plan on an H100: per block a
    # two-pass (mean, M2), then Chan's merge over the cluster's ranks in
    # order, float32 throughout. At mean 100 and std 3 it holds float64
    # statistics to 1e-6 (mean) and 2e-6 (variance) relative (it reads
    # ~1.2e-7 and ~1.6e-7), where a float32 E[x^2] - mean^2 misses by
    # ~2e-2
    n, h, w, c = shape
    hw = h * w
    x = _x((hw, c), seed=11, scale=3.0, shift=100.0)
    p = pin._plan(n, hw, c, 4, False, _h100_like_clusters(False))
    mean = np.zeros(c, np.float32)
    var = np.zeros(c, np.float32)
    for g in range(p.groups):
        tot = np.zeros(p.channels, np.float32)
        mu = np.zeros(p.channels, np.float32)
        m2 = np.zeros(p.channels, np.float32)
        for r in range(p.k):
            a, valid, cnt = _block_words(x, p, g, r)
            mb = _col_sums(a, p) * (np.float32(1) / np.float32(cnt))
            d = np.where(valid, a - mb.reshape(p.cg, 4), np.float32(0))
            mb2 = _col_sums(d * d, p)
            # Chan's merge, as chan_merge
            nb = np.float32(cnt)
            t = tot + nb
            wb = nb / t
            dd = mb - mu
            mu = mu + dd * wb
            m2 = m2 + (mb2 + dd * dd * tot * wb)
            tot = t
        sl = slice(g * p.channels, (g + 1) * p.channels)
        mean[sl], var[sl] = mu, m2 / np.float32(hw)
    x64 = x.astype(np.float64)
    want_mean, want_var = x64.mean(0), x64.var(0)
    mean_err = np.abs(mean - want_mean).max() / np.abs(want_mean).max()
    var_err = (np.abs(var - want_var) / want_var).max()
    assert mean_err < 1e-6, f"mean rel err {mean_err:.3g}"
    assert var_err < 2e-6, f"var rel err {var_err:.3g}"
    # the Pallas kernel's float32 E[x^2] - mean^2 misses that bar
    x32 = x.astype(np.float32)
    naive = (x32 * x32).mean(0, dtype=np.float32) - \
        x32.mean(0, dtype=np.float32) ** 2
    assert (np.abs(naive - want_var) / want_var).max() > 2e-6


@pytest.mark.parametrize("shape", [(1, 256, 256, 64), (1, 512, 512, 32)])
def test_b1_backward_reduction_order_matches_plain_backward(shape):
    # the backward's sums of g' and g' * xh in the kernel's order under
    # its fp32 plan (per block, then the ranks in order), and dx from
    # them, against the plain backward: 1e-6 of max|dx| (it reads ~7e-8)
    n, h, w, c = shape
    hw = h * w
    x = _x((hw, c), seed=12, scale=3.0, shift=100.0)
    gr = np.random.RandomState(13).randn(hw, c).astype(np.float32)
    x64 = x.astype(np.float64)
    mean = x64.mean(0).astype(np.float32)
    rstd = (1 / np.sqrt(x64.var(0) + 1e-5)).astype(np.float32)
    xh = (x - mean) * rstd
    gp = gr * (xh > 0)  # relu
    p = pin._plan(n, hw, c, 4, True, _h100_like_clusters(True))
    gm = np.zeros(c, np.float32)
    gx = np.zeros(c, np.float32)
    for g in range(p.groups):
        a_sum = np.zeros(p.channels, np.float32)
        b_sum = np.zeros(p.channels, np.float32)
        for r in range(p.k):
            a = _block_words(gp, p, g, r)[0]
            b = _block_words(gp * xh, p, g, r)[0]
            a_sum = a_sum + _col_sums(a, p)
            b_sum = b_sum + _col_sums(b, p)
        sl = slice(g * p.channels, (g + 1) * p.channels)
        inv = np.float32(1) / np.float32(hw)
        gm[sl], gx[sl] = a_sum * inv, b_sum * inv
    dx = rstd * (gp - gm - xh * gx)
    want = pin.instance_norm_act_backward_reference(
        torch.from_numpy(x).view(1, h, w, c), torch.from_numpy(mean)[None],
        torch.from_numpy(rstd)[None], torch.from_numpy(gr).view(1, h, w, c),
        "relu").numpy().reshape(hw, c)
    err = np.abs(dx - want).max() / np.abs(want).max()
    assert err < 1e-6, f"max|dx - plain| / max|dx| {err:.3g}"


# ---------------------------------------------------------------------------
# B1 split: the statistics kernel's plan and its two-level merge
# ---------------------------------------------------------------------------

sweep_b1 = importlib.import_module("ir2rgb_tpu_torch.sweep_b1")


def test_b1_stats_shapes_are_the_partitioned_frames_shard_shapes():
    # sweep_b1 --stats and the plan tests below cover every shape
    # chip_smoke.py's spatial phase gives the statistics kernel
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert sorted(sweep_b1.STATS_SHAPES) == sorted(
        {s for s, _ in cs.B1_SPLIT_SHAPES})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sweep_b1.STATS_SHAPES)
def test_b1_stats_plan_covers_every_pixel_once(shape, dtype):
    # the plan on an H100: 132 SMs, two blocks of the kernel on each
    # (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the card); the
    # kernel launches no cluster, so no cluster count enters it
    n, h, w, c = shape
    hw, item = h * w, torch.empty((), dtype=dtype).element_size()
    p = pin._stats_plan(n, hw, c, item, sms=132, resident=2)
    # chunk k owns pixels [k * chunk, min((k + 1) * chunk, hw)): together
    # every pixel exactly once, and the last chunk holds at least one
    ends = [min((k + 1) * p.chunk, hw) for k in range(p.chunks)]
    starts = [k * p.chunk for k in range(p.chunks)]
    assert starts[0] == 0 and ends[-1] == hw and starts[1:] == ends[:-1]
    assert all(s < e for s, e in zip(starts, ends))
    # every channel in one group of cg words: the widest of at most 64
    # bytes a pixel that divides C
    assert p.groups * p.channels == c and p.channels == 4 * p.cg
    assert 32 % p.cg == 0 and p.channels * item <= 64
    assert p.channels * item >= 32 or p.channels == c
    # shared memory as the kernel lays it out (col_sum's float a warp and
    # channel, a float a thread), within the 227 KB opt-in
    assert p.smem_bytes == (8 * p.channels + 256) * 4 <= 232_448
    blocks = n * p.groups * p.chunks
    if hw * p.channels <= 32768:  # a slab one block reads alone
        assert p.chunks == 1
        return
    # two levels: one wave of blocks, each thread of the last block
    # merging one round of at most 16 partials, each thread of a block at
    # least one round of 8 loads; from 16 MB up, a block an SM or more
    rows = pin._stats_rows(p.channels, item)
    assert p.chunks > 1 and blocks <= 264
    assert -(-p.chunks // (256 // p.channels)) <= 16
    assert p.chunk >= 8 * rows
    if n * hw * c * item >= 16 << 20:
        assert blocks >= 128


@pytest.mark.parametrize("channels,itemsize,rows", [
    (4, 2, 256), (8, 2, 256), (16, 2, 128), (32, 2, 64), (4, 4, 256),
    (16, 4, 64)])
def test_b1_stats_threads_read_16_bytes_of_a_pixel(channels, itemsize, rows):
    # a thread loads 16 bytes of a pixel's group (8 bf16 or 4 fp32
    # channels; 8 bytes for a bf16 group of 4), as the kernel's lane
    # choice: the 256 threads of a block read `rows` pixels side by side
    assert pin._stats_rows(channels, itemsize) == rows


@pytest.mark.parametrize("channels,itemsize,load", [
    (4, 2, 8), (8, 2, 16), (32, 2, 16), (4, 4, 16), (16, 4, 16)])
def test_b1_stats_refuses_a_tensor_off_its_loads(channels, itemsize, load):
    # the wrapper's check before a launch: a pointer off the kernel's
    # load width (16 bytes, where _check_nhwc asks 8 of bf16) raises a
    # ValueError that names the width, and one on it passes
    p = pin._make_stats_plan(64, channels, itemsize, channels // 4, 64)
    pin._check_stats_aligned(4096 + load, p, itemsize)
    for off in range(4, load, 4):
        with pytest.raises(ValueError, match=f"{load}-byte aligned"):
            pin._check_stats_aligned(4096 + off, p, itemsize)


def _stats_plan_at(shape, chunk):
    """The fp32 statistics plan of ``shape`` with chunks of ``chunk``
    pixels, in the widest group the kernel takes."""
    n, h, w, c = shape
    cg = pin._choices(h * w, c, 4)[0][0]
    return pin._make_stats_plan(h * w, c, 4, cg, chunk)


# (shape, pixels a chunk, mean; std 1): an odd H x W whose last chunk is
# short at mean 1e3 and -1e3, whole chunks at mean 0, and one level
STATS_CHUNK_CASES = [((1, 33, 65, 16), 97, 1e3), ((2, 17, 19, 32), 40, 0.0),
                     ((1, 31, 31, 64), 33, -1e3), ((1, 32, 64, 16), 2048, 5.0)]


@pytest.mark.parametrize("shape,chunk,mean", STATS_CHUNK_CASES)
def test_b1_stats_chunked_reference_matches_float64(shape, chunk, mean):
    # the plan's chunks and the kernel's merge order (runs of consecutive
    # chunks, then the runs), in fp32, against float64 two-pass
    # statistics: 1e-6 relative (they read ~1e-7). The image's first
    # pixel is taken off before the chunks' means: without that shift,
    # Chan's merge of fp32 means at 1e3 misses by ~1e-5
    n, h, w, c = shape
    hw = h * w
    p = _stats_plan_at(shape, chunk)
    assert p.chunks == -(-hw // chunk)
    x = _x(shape, seed=31, scale=1.0, shift=mean)
    got_mean, got_m2 = pin.instance_norm_stats_chunked_reference(
        torch.from_numpy(x), p)
    x64 = x.astype(np.float64).reshape(n, hw, c)
    mean64 = x64.mean(1)
    m2_64 = ((x64 - mean64[:, None]) ** 2).sum(1)
    scale = np.maximum(np.abs(mean64), np.sqrt(m2_64 / hw))
    assert (np.abs(got_mean.numpy() - mean64) / scale).max() < 1e-6
    assert (np.abs(got_m2.numpy() - m2_64) / m2_64).max() < 1e-6
    assert got_mean.dtype == got_m2.dtype == torch.float32


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("shape,chunk", [(s, k) for s, k, _ in
                                         STATS_CHUNK_CASES[:3]])
def test_b1_stats_chunked_reference_normalises_as_jax(shape, chunk, act):
    # the chunked statistics, applied, against JAX's
    # instance_norm_act_reference (its own mean and var) on the same
    # numpy input, at the B1 tests' scale and mean (at mean 1e3 JAX's own
    # fp32 mean is 6e-5 from float64 in y; the test above holds that case
    # to float64)
    n, h, w, c = shape
    x = _x(shape, seed=32)
    mean_t, m2 = pin.instance_norm_stats_chunked_reference(
        torch.from_numpy(x), _stats_plan_at(shape, chunk))
    rstd = torch.rsqrt(m2 / (h * w) + pin.INSTANCE_NORM_EPS)
    got = pin.instance_norm_apply_reference(torch.from_numpy(x), mean_t,
                                            rstd, act)
    want = np.asarray(jax_in_reference(jnp.asarray(x), act))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def _tail_inputs(hs, c, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(1, 2 * hs, 2 * hs, c).astype(np.float32)
    w = (r.randn(7, 7, c, 3) * 0.1).astype(np.float32)
    b = r.randn(3).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("hs,c", [(32, 32), (32, 64)])
def test_b2_plain_matches_pallas_interpret(hs, c):
    # the Pallas kernel reads the s2d representation and writes the image;
    # the port computes the same image from image space. fp32 both sides,
    # summation order differs (2e-5, as the JAX package's own kernel test)
    x, w, b = _tail_inputs(hs, c)
    y_j = np.asarray(_jax_tail(to_s2d(jnp.asarray(x)), jnp.asarray(w),
                               jnp.asarray(b), tile=16, interpret=True))
    y_p = tail_fused(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b)).numpy()
    assert y_p.shape == (1, 2 * hs, 2 * hs, 3)
    np.testing.assert_allclose(y_p, y_j, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_shared_memory_layout(c, dtype):
    if dtype == torch.float32:
        # CUDA-core route: an odd stride of 16-byte words puts neighbouring
        # pixels in distinct banks; window and weights fit one block
        pix_stride, smem = ptail._smem_layout(c)
        assert pix_stride % 2 == 1 and pix_stride >= c // 4
        assert smem == 16 * (22 * 22 * pix_stride + 49 * c)
        assert smem <= ptail._SMEM_LIMIT
        return
    # tensor-core route: the 8 row addresses of an ldmatrix phase are 8
    # neighbouring pixels, so an odd pixel stride (in 16-byte words) puts
    # them in the 8 distinct 16-byte bank groups of a 128-byte row
    th, words, smem = ptail.tc_layout(c)
    assert words % 2 == 1 and words >= c // 8
    assert sorted({(p * words) % 8 for p in range(8)}) == list(range(8))
    # the (th + 6) x 38 window, then 7 warps' fp32 partials (12 B a pixel)
    assert smem == 16 * (th + 6) * 38 * words + 7 * th * 32 * 12
    # two blocks an SM, the taller tile where it fits
    assert 2 * (smem + 1024) <= 233472
    assert th == (8 if c == 64 else 16)


def _tc_emulation(x, wk, b):
    """The tensor-core route's arithmetic in float32 from the packed
    fragments: for each kw, products of 16 channels (one k-step) summed in
    fp32, accumulated in the kernel's order (kh pair p = 0..3 as the
    window rows arrive, k-steps within), the even taps (kh = 2p) and odd
    taps (kh = 2p + 1) apart and then added; the seven kw partials summed
    in kw order; bias, tanh. Returns fp32 (before the bf16 store)."""
    n, h, wd, c = x.shape
    nks = c // 16
    frag = wk.float().view(7, 4, nks, 8, 4, 4)  # [kw][p][ks][g][t][j]
    bm = torch.zeros(7, 4, nks, 16, 8)          # [kw][p][ks][k][n]
    for t in range(4):
        for j, k in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
            bm[:, :, :, k, :] = frag[:, :, :, :, t, j]
    xp = torch.nn.functional.pad(x.float().permute(0, 3, 1, 2), (3,) * 4,
                                 mode="reflect").permute(0, 2, 3, 1)
    y = None
    for kw in range(7):
        even = torch.zeros(n, h, wd, 4)
        odd = torch.zeros(n, h, wd, 4)
        for p in range(4):
            for ks in range(nks):
                ch = slice(16 * ks, 16 * ks + 16)
                even = even + xp[:, 2 * p:2 * p + h, kw:kw + wd, ch] @ \
                    bm[kw, p, ks, :, :4]
                odd = odd + xp[:, 2 * p + 1:2 * p + 1 + h, kw:kw + wd, ch] @ \
                    bm[kw, p, ks, :, 4:] if p < 3 else odd
        y = even + odd if y is None else y + (even + odd)
    return torch.tanh(y[..., :3] + b)


@pytest.mark.parametrize("c", [16, 32, 64])
def test_b2_tensor_core_arithmetic_matches_plain_and_jax(c):
    # bf16 operands (x and w rounded to bf16 first), fp32 accumulation in
    # the kernel's order, from the packed weights the wrapper builds. The
    # plain version and JAX take the same bf16 values in fp32; they differ
    # only in summation order: atol 2e-5, as the JAX package's own test.
    # JAX: the Pallas kernel in interpret mode at C 32 and 64 (the widths
    # it takes), the generator's composed tail (reflect pad, conv, tanh;
    # ir2rgb_tpu/nn/generators.py:586-590) at C 16.
    from ir2rgb_tpu.nn import ops as jops
    x, w, b = _tail_inputs(32, c, seed=c)  # 64x64: the Pallas minimum
    x = torch.from_numpy(x).bfloat16().float()
    w = torch.from_numpy(w).bfloat16().float()
    b = torch.from_numpy(b)
    wk, b32 = ptail.packed(w, b, torch.bfloat16)
    y_e = _tc_emulation(x, wk, b32)
    y_p = ptail.tail_fused_reference(x, w, b)
    np.testing.assert_allclose(y_e.numpy(), y_p.numpy(), atol=2e-5, rtol=0)
    xj, wj, bj = (jnp.asarray(t.numpy()) for t in (x, w, b))
    if c == 16:
        y_j = jnp.tanh(jops.conv_apply({"w": wj, "b": bj},
                                       jops.reflect_pad(xj, 3)))
    else:
        y_j = _jax_tail(to_s2d(xj), wj, bj, tile=16, interpret=True)
    np.testing.assert_allclose(y_e.numpy(), np.asarray(y_j), atol=2e-5,
                               rtol=0)
    # in bf16, as the kernel stores it: within one rounding of the plain
    # version's bf16 output
    y_b = ptail.tail_fused_reference(x.bfloat16(), w, b).float()
    assert float((y_e.bfloat16().float() - y_b).abs().max()) <= 2 ** -8


@pytest.mark.parametrize("c", [16, 32, 64])
def test_b2_fragment_packing_layout(c):
    # each packed bf16 value against the HWIO weight at its index: lane
    # l = 4g + t of (kw, pair p, k-step ks) holds rows 2t, 2t+1, 2t+8,
    # 2t+9 of column g; column n is output n % 4 of tap kh = 2p + n // 4
    w = torch.from_numpy(np.random.RandomState(c).randn(7, 7, c, 3)
                         .astype(np.float32)).bfloat16()
    wk = ptail.pack_fragments(w)
    assert wk.shape == (7, 4, c // 16, 32, 4) and wk.dtype == torch.bfloat16
    assert wk.is_contiguous()
    got, want = wk.float().numpy(), np.zeros(wk.shape, np.float32)
    wn = w.float().numpy()
    for kw in range(7):
        for p in range(4):
            for ks in range(c // 16):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    kh, o = 2 * p + g // 4, g % 4
                    for j, k in enumerate((2 * t, 2 * t + 1, 2 * t + 8,
                                           2 * t + 9)):
                        if kh < 7 and o < 3:
                            want[kw, p, ks, lane, j] = wn[kh, kw,
                                                          16 * ks + k, o]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [8, 24, 48, 128])
def test_b2_route_refuses_bf16_widths_the_kernel_does_not_take(c):
    x = torch.zeros((1, 32, 32, c), device="meta", dtype=torch.bfloat16)
    w = torch.zeros((7, 7, c, 3), device="meta")
    b = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="C in"):
        ptail.route(x, w, b)
    with pytest.raises(ValueError, match="C in"):
        ptail.tail_fused(x, w, b)


def test_b2_route_by_dtype_and_width():
    def r(c, dtype):
        return ptail.route(torch.zeros((2, 72, 40, c), device="meta",
                                       dtype=dtype),
                           torch.zeros((7, 7, c, 3), device="meta"),
                           torch.zeros(3, device="meta"))
    assert [r(c, torch.bfloat16) for c in (16, 32, 64)] == ["tensor_core"] * 3
    assert [r(c, torch.float32) for c in (16, 32, 64)] == ["cuda_core"] * 3
    with pytest.raises(TypeError):
        r(32, torch.float16)
    with pytest.raises(ValueError):
        ptail.route(torch.zeros((1, 3, 40, 32), device="meta"),
                    torch.zeros((7, 7, 32, 3), device="meta"),
                    torch.zeros(3, device="meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_packed_weights_are_kept_until_the_weight_changes(dtype):
    # as the serving generator passes them: the conv's weight as an HWIO
    # view, its bias, under inference mode
    conv = torch.nn.Conv2d(32, 3, 7)
    with torch.inference_mode():
        def get():
            return ptail.packed(conv.weight.permute(2, 3, 1, 0), conv.bias,
                                dtype)
        first = get()
        assert get() is first
        assert ptail.packed(conv.weight.permute(2, 3, 1, 0), conv.bias,
                            torch.float32 if dtype == torch.bfloat16
                            else torch.bfloat16) is not first
    assert not first[0].is_inference() and not first[1].is_inference()
    assert not first[0].requires_grad and not first[1].requires_grad
    assert first[1].dtype == torch.float32
    with torch.no_grad():
        conv.weight.add_(1.0)  # in place: the version counter moves
    with torch.inference_mode():
        second = get()
        assert second is not first and get() is second
    w_hwio = conv.weight.detach().permute(2, 3, 1, 0)
    want = (ptail.pack_fragments(w_hwio.bfloat16())
            if dtype == torch.bfloat16
            else torch.nn.functional.pad(w_hwio.reshape(-1, 3), (0, 1)))
    assert torch.equal(second[0], want)
    with torch.no_grad():
        conv.bias.mul_(2.0)
    with torch.inference_mode():
        third = get()
    assert third is not second and torch.equal(third[1], conv.bias.detach())
    # the entry goes with the weight: nothing kept refers back to it
    kept = len(ptail._kept)
    del conv, get
    gc.collect()
    assert len(ptail._kept) == kept - 1


def test_plain_versions_do_not_count_as_launches():
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    x = torch.from_numpy(_x((1, 8, 8, 32), seed=4))
    fused_instance_norm_act(x, "relu")
    tail_fused(x, torch.zeros((7, 7, 32, 3)), torch.zeros(3))
    pin.instance_norm_apply(x, *pin.instance_norm_stats(x))
    _, mean, rstd = pin.instance_norm_act_reference(x)
    s1, s2 = pin.instance_norm_bwd_stats(x, mean, rstd, x)
    pin.instance_norm_bwd_apply(x, mean, rstd, x, s1, s2, 64.0)
    assert launch_counts() == {"instance_norm_act": 0,
                               "instance_norm_act_bwd": 0,
                               "instance_norm_stats": 0,
                               "instance_norm_apply": 0,
                               "instance_norm_bwd_stats": 0,
                               "instance_norm_bwd_apply": 0, "tail_fused": 0,
                               "d2s": 0, "s2d": 0}


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    x = torch.zeros((1, 8, 8, 32), device="meta")
    with pytest.raises(ValueError):
        pin.instance_norm_act(x, "relu")
    with pytest.raises(ValueError):
        ptail.tail_fused(x, torch.zeros((7, 7, 32, 3), device="meta"),
                         torch.zeros(3, device="meta"))
    # the kernel entry points refuse CPU tensors rather than compute
    with pytest.raises(ValueError):
        pin.instance_norm_act_cuda(torch.zeros((1, 8, 8, 32)), "relu")
    with pytest.raises(ValueError):
        ptail.tail_fused_cuda(torch.zeros((1, 8, 8, 32)),
                              torch.zeros((7, 7, 32, 3)), torch.zeros(3))


# ---------------------------------------------------------------------------
# B1 backward: the plain version against the JAX custom VJP
# ---------------------------------------------------------------------------

def _b1_bwd_inputs(shape, seed):
    x = _x(shape, seed=seed)
    g = np.random.RandomState(seed + 100).randn(*shape).astype(np.float32)
    _, mean, rstd = pin.instance_norm_act_reference(torch.from_numpy(x))
    return x, g, mean.numpy(), rstd.numpy()


@pytest.mark.parametrize("act", ACTS)
def test_b1_backward_plain_matches_jax_fused_bwd(act):
    # _fused_bwd called directly on the same (x, mean, rstd) and g; fp32
    # both sides, summation order differs: atol 1e-5
    from ir2rgb_tpu.kernels.instance_norm import _fused_bwd
    x, g, mean, rstd = _b1_bwd_inputs((2, 8, 16, 64), seed=5)
    (dx_j,) = _fused_bwd(act, 1e-5, 0.2, (jnp.asarray(x), jnp.asarray(mean),
                                          jnp.asarray(rstd)), jnp.asarray(g))
    dx_p = pin.instance_norm_act_backward_reference(
        torch.from_numpy(x), torch.from_numpy(mean), torch.from_numpy(rstd),
        torch.from_numpy(g), act)
    np.testing.assert_allclose(dx_p.numpy(), np.asarray(dx_j), atol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_b1_backward_matches_jax_grad_of_reference(act):
    # against autodiff of the JAX forward reference: the VJP is the exact
    # gradient of the forward, up to fp32 rounding (atol 1e-5)
    import jax
    x, g, _, _ = _b1_bwd_inputs((1, 16, 16, 32), seed=6)
    dx_j = jax.grad(lambda v: jnp.sum(jax_in_reference(v, act)
                                      * jnp.asarray(g)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fused_instance_norm_act(xt, act)
    (dx_p,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_allclose(dx_p.numpy(), np.asarray(dx_j), atol=1e-5)


def test_b1_autograd_function_saves_forward_stats_and_counts_nothing_on_cpu():
    # the Function's backward is the plain backward on (x, mean, rstd) of
    # its forward; on the CPU neither direction counts a launch
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    x, g, mean, rstd = _b1_bwd_inputs((1, 8, 8, 64), seed=7)
    reset_launch_counts()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = pin.InstanceNormAct.apply(xt, "leaky_relu", 1e-5, 0.2)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    want = pin.instance_norm_act_backward_reference(
        torch.from_numpy(x), torch.from_numpy(mean), torch.from_numpy(rstd),
        torch.from_numpy(g), "leaky_relu")
    assert torch.equal(dx, want)
    assert sum(launch_counts().values()) == 0


def test_b1_backward_bf16_keeps_dtype():
    x, g, mean, rstd = _b1_bwd_inputs((1, 8, 8, 64), seed=8)
    dx = pin.instance_norm_act_backward_reference(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(mean),
        torch.from_numpy(rstd), torch.from_numpy(g).bfloat16(), "relu")
    assert dx.dtype == torch.bfloat16
    want = pin.instance_norm_act_backward_reference(
        torch.from_numpy(x).bfloat16().float(), torch.from_numpy(mean),
        torch.from_numpy(rstd), torch.from_numpy(g).bfloat16().float(),
        "relu")
    np.testing.assert_allclose(dx.float().numpy(), want.numpy(),
                               atol=2e-2, rtol=1e-2)


# ---------------------------------------------------------------------------
# B3: depth-to-space / space-to-depth
# ---------------------------------------------------------------------------

pd2s = importlib.import_module("ir2rgb_tpu_torch.kernels.d2s")


@pytest.mark.parametrize("c", [3, 32, 64])
def test_d2s_plain_matches_pallas_interpret_exactly(c):
    from ir2rgb_tpu.kernels.d2s import d2s_pallas, d2s_reference
    y = np.random.RandomState(c).rand(1, 4, 8, 4 * c).astype(np.float32)
    want = np.asarray(d2s_pallas(jnp.asarray(y), c, True))
    np.testing.assert_array_equal(want, np.asarray(d2s_reference(
        jnp.asarray(y), c)))
    got = pd2s.d2s(torch.from_numpy(y), c)
    assert got.shape == (1, 8, 16, c)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c", [3, 32, 64])
def test_s2d_plain_matches_pallas_interpret_exactly(c):
    from ir2rgb_tpu.kernels.d2s import s2d_pallas, s2d_reference
    x = np.random.RandomState(c + 1).rand(1, 8, 16, c).astype(np.float32)
    want = np.asarray(s2d_pallas(jnp.asarray(x), True))
    np.testing.assert_array_equal(want, np.asarray(s2d_reference(
        jnp.asarray(x))))
    got = pd2s.s2d(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    # the round trip is the identity
    assert torch.equal(pd2s.d2s(got, c), torch.from_numpy(x))


@pytest.mark.parametrize("c", [3, 32])
def test_d2s_autograd_backward_is_s2d(c):
    r = np.random.RandomState(9)
    y = torch.from_numpy(r.rand(2, 4, 6, 4 * c).astype(np.float32))
    g = torch.from_numpy(r.rand(2, 8, 12, c).astype(np.float32))
    y.requires_grad_(True)
    (dy,) = torch.autograd.grad(pd2s.d2s_fn(y, c), y, g)
    assert torch.equal(dy, pd2s.s2d(g))
    # and the gradient of the plain permutation agrees
    (dy_ref,) = torch.autograd.grad(pd2s.d2s_reference(y, c), y, g)
    assert torch.equal(dy, dy_ref)


def test_d2s_is_not_pixel_shuffle():
    # torch.pixel_shuffle orders channels c*4 + dh*2 + dw; B3 reads
    # (dh*2+dw)*C + c, the subpixel deconv's order
    y = torch.arange(2 * 2 * 8, dtype=torch.float32).reshape(1, 2, 2, 8)
    ps = torch.pixel_shuffle(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert not torch.equal(pd2s.d2s(y, 2), ps)


def test_d2s_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    with pytest.raises(ValueError):
        pd2s.d2s(torch.zeros((1, 4, 4, 128), device="meta"), 32)
    with pytest.raises(ValueError):
        pd2s.s2d_cuda(torch.zeros((1, 8, 8, 32)))
    with pytest.raises(ValueError):
        pin.instance_norm_act_bwd_cuda(
            torch.zeros((1, 8, 8, 32)), torch.zeros((1, 32)),
            torch.ones((1, 32)), torch.zeros((1, 8, 8, 32)), "relu")


# ---------------------------------------------------------------------------
# The subpixel transposed conv (nn/ops.py::deconv) that puts B3 on the path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ci,co,hw", [(8, 4, 6), (16, 3, 5), (32, 32, 8)])
def test_subpixel_deconv_matches_conv_transpose_and_jax(ci, co, hw):
    # fp32 on both sides; the subpixel form sums the same products in
    # another order: atol 1e-5
    from ir2rgb_tpu.nn.ops import deconv_apply
    from ir2rgb_tpu_torch.checkpoint.from_jax import deconv_w
    from ir2rgb_tpu_torch.nn import ops
    r = np.random.RandomState(ci + co)
    x = r.randn(2, hw, hw + 1, ci).astype(np.float32)
    w_j = (r.randn(3, 3, ci, co) * 0.2).astype(np.float32)  # flipped HWIO
    b = r.randn(co).astype(np.float32)
    w_t = torch.from_numpy(deconv_w(w_j))  # torch IOHW
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    y = ops.deconv(xt, w_t, bt)
    assert y.shape == (2, 2 * hw, 2 * (hw + 1), co) and y.is_contiguous()
    y_dil = ops.deconv(xt, w_t, bt, lowering="dilated")
    y_j = np.asarray(deconv_apply({"w": jnp.asarray(w_j), "b": jnp.asarray(b)},
                                  jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), y_dil.numpy(), atol=1e-5)
    np.testing.assert_allclose(y.numpy(), y_j, atol=1e-5)


def test_subpixel_deconv_gradients_match_conv_transpose():
    from ir2rgb_tpu_torch.nn import ops
    r = np.random.RandomState(3)
    x = torch.from_numpy(r.randn(1, 5, 5, 8).astype(np.float32))
    w = torch.from_numpy((r.randn(8, 4, 3, 3) * 0.2).astype(np.float32))
    b = torch.from_numpy(r.randn(4).astype(np.float32))
    g = torch.from_numpy(r.randn(1, 10, 10, 4).astype(np.float32))
    grads = []
    for lowering in ("subpixel", "dilated"):
        ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
        grads.append(torch.autograd.grad(
            ops.deconv(*ins, lowering=lowering), ins, g))
    for a, c in zip(*grads):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5)


def test_deconv_module_keeps_its_weight_only_while_the_weight_is_unchanged():
    from ir2rgb_tpu_torch.nn import Deconv
    torch.manual_seed(0)
    up = Deconv(8, 4)
    x = torch.randn(1, 4, 4, 8)
    with torch.inference_mode():
        y0 = up(x)
        kept = up._wk[3]
        assert up(x).equal(y0) and up._wk[3] is kept
    with torch.no_grad():
        up.weight.mul_(2.0)  # in place: the version counter moves
    with torch.inference_mode():
        y1 = up(x)
    assert up._wk[3] is not kept
    np.testing.assert_allclose(y1.numpy(),
                               (2 * (y0 - up.bias) + up.bias).detach().numpy(),
                               atol=1e-5)


def test_subpixel_gather_is_a_permutation():
    # each weight tap lands once and each empty slot reads its own zero,
    # so the gather's backward never adds twice into one address
    from ir2rgb_tpu_torch.nn import ops
    idx = ops._subpixel_index(8, 4, 3, 1, torch.device("cpu"))
    assert torch.equal(idx.sort().values, torch.arange(16 * 8 * 4))


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::tail_tc_kernel<2, 16>(__nv_bfloat16 "
    "const*, uint2 const*, float const*, __nv_bfloat16*, int, int)",
    "_ZN46_GLOBAL__N__39f2cccf_13_tail_fused_cu_f1deaeed14tail_tc_kernel"
    "ILi4ELi8EEEvPK13__nv_bfloat16PK5uint2PKfPS1_ii",
    "void (anonymous namespace)::tail_kernel(float const*, float4 const*, "
    "float const*, float*, int, int, int, int)"])
def test_profile_stream_counts_both_b2_routes_as_the_output_tail(name):
    from ir2rgb_tpu_torch.profile_stream import kind_of
    assert kind_of(name) == "B2 tail"
