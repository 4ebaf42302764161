"""The port's metrics (psnr, ssim, flicker) held to the JAX package's on the
CPU: HWC and NHWC, [-1, 1] frames (peak 2) and uint8 frames (peak 255).
Tolerances: 1e-4 dB on PSNR, 1e-5 absolute on SSIM and flicker."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.infer import metrics as jm

from ir2rgb_tpu_torch.infer import metrics as pm


def _pair(shape, kind, seed):
    r = np.random.RandomState(seed)
    if kind == "u8":
        a = r.randint(0, 256, shape).astype(np.float32)
        b = np.clip(a + r.randint(-40, 41, shape), 0, 255).astype(np.float32)
        return a, b, 255.0
    a = r.uniform(-1, 1, shape).astype(np.float32)
    b = np.clip(a + r.normal(0, 0.2, shape), -1, 1).astype(np.float32)
    return a, b, 2.0


@pytest.mark.parametrize("kind", ["unit", "u8"])
@pytest.mark.parametrize("shape", [(24, 20, 3), (2, 32, 28, 3),
                                   (1, 16, 16, 1)])
def test_psnr_and_ssim_match_jax(shape, kind):
    a, b, peak = _pair(shape, kind, seed=sum(shape))
    got_p = float(pm.psnr(torch.from_numpy(a), torch.from_numpy(b), peak))
    want_p = float(jm.psnr(jnp.asarray(a), jnp.asarray(b), peak))
    assert abs(got_p - want_p) <= 1e-4, (got_p, want_p)
    got_s = float(pm.ssim(torch.from_numpy(a), torch.from_numpy(b), peak))
    want_s = float(jm.ssim(jnp.asarray(a), jnp.asarray(b), peak=peak))
    assert abs(got_s - want_s) <= 1e-5, (got_s, want_s)
    # numpy in, as the evaluate CLI calls them
    assert abs(float(pm.psnr(a, b, peak)) - want_p) <= 1e-4


def test_identical_frames_and_zero_mse():
    a, _, _ = _pair((16, 16, 3), "unit", seed=3)
    t = torch.from_numpy(a)
    assert float(pm.ssim(t, t)) == pytest.approx(1.0, abs=1e-5)
    # the mse floor of 1e-12: the same finite value as JAX's
    assert abs(float(pm.psnr(t, t)) - float(jm.psnr(a, a))) <= 1e-4


@pytest.mark.parametrize("shape", [(5, 12, 10, 3), (4, 2, 8, 8, 3)])
def test_flicker_matches_jax(shape):
    f = np.random.RandomState(7).uniform(-1, 1, shape).astype(np.float32)
    got = float(pm.flicker(torch.from_numpy(f)))
    want = float(jm.flicker(jnp.asarray(f)))
    assert abs(got - want) <= 1e-5, (got, want)


def test_metrics_return_fp32_scalars_from_bf16():
    a, b, _ = _pair((16, 16, 3), "unit", seed=4)
    ab = torch.from_numpy(a).to(torch.bfloat16)
    for v in (pm.psnr(ab, torch.from_numpy(b)), pm.ssim(ab, ab),
              pm.flicker(torch.stack([ab, ab]))):
        assert v.dtype == torch.float32 and v.dim() == 0
