"""The port's kernels B1 (instance norm + act) and B2 (output tail): their
plain PyTorch versions held to the JAX package's Pallas kernels, run as
the JAX tests run them on the CPU (interpret mode), on the same numpy
inputs. The CUDA kernels themselves are held to these plain versions on
the card by chip_smoke.py; here the Python around them (launch plan,
shared-memory layout, argument checks) is tested."""

import importlib

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


def _x(shape, seed, scale=3.0, shift=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


@pytest.mark.parametrize("input_nc", [3, 6])
def test_main_path_sends_these_shapes_to_the_kernels(monkeypatch, input_nc):
    # a pix2pixhd_512 / temporal_512 forward on the meta device (shapes
    # only, no arithmetic), recording what reaches each kernel wrapper
    from ir2rgb_tpu_torch import kernels
    from ir2rgb_tpu_torch.nn import GenConfig, LocalEnhancer, ops
    seen, tails = {}, []

    def norm(x, act, negative_slope=0.2):
        key = (tuple(x.shape), act)
        seen[key] = seen.get(key, 0) + 1
        return x

    def tail(x, w, b):
        tails.append((tuple(x.shape), tuple(w.shape)))
        return x[..., :3]

    monkeypatch.setattr(ops, "fused_instance_norm_act", norm)
    monkeypatch.setattr(kernels, "tail_fused", tail)
    with torch.device("meta"):
        g = LocalEnhancer(GenConfig(input_nc=input_nc, ngf=32))
        y = g(torch.empty((1, 512, 512, input_nc)))
    assert seen == B1_MAIN_PATH and sum(seen.values()) == 36
    assert tails == [((1, 512, 512, 32), (7, 7, 32, 3))]
    assert tuple(y.shape) == (1, 512, 512, 3)


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
    np.testing.assert_allclose(y_p, y_j, atol=2e-5, rtol=1e-5)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted({s for s, _ in B1_MAIN_PATH}))
def test_b1_plan_covers_every_pixel_and_channel(shape, dtype):
    n, h, w, c = shape
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    n_chunks, chunk, ct, n_ctiles = pin._plan(n, h * w, c, vec)
    assert (n_chunks - 1) * chunk < h * w <= n_chunks * chunk
    assert ct & (ct - 1) == 0 and ct <= 32 and 256 % ct == 0
    assert (n_ctiles - 1) * ct < c // vec <= n_ctiles * ct
    # about the target number of blocks, never a chunk without pixels
    assert n * n_ctiles * n_chunks < pin._TARGET_BLOCKS + n * n_ctiles


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
    y_j = np.asarray(jax_tail_fused(to_s2d(jnp.asarray(x)), jnp.asarray(w),
                                    jnp.asarray(b), tile=16, interpret=True))
    y_p = tail_fused(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b)).numpy()
    assert y_p.shape == (1, 2 * hs, 2 * hs, 3)
    np.testing.assert_allclose(y_p, y_j, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_shared_memory_layout(c, dtype):
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    pix_stride, smem = ptail._smem_layout(c, vec)
    # an odd stride of 16-byte words puts neighbouring pixels in distinct
    # banks; the window and the weights fit in one block's shared memory
    assert pix_stride % 2 == 1 and pix_stride >= c // vec
    assert smem <= ptail._SMEM_LIMIT


def test_plain_versions_do_not_count_as_launches():
    from ir2rgb_tpu_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    x = torch.from_numpy(_x((1, 8, 8, 32), seed=4))
    fused_instance_norm_act(x, "relu")
    tail_fused(x, torch.zeros((7, 7, 32, 3)), torch.zeros(3))
    assert launch_counts() == {"instance_norm_act": 0, "tail_fused": 0}


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
