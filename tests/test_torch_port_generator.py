"""The port's LocalEnhancer held to the JAX package's local_enhancer_apply
on the same weights (converted by generator_state_dict_from_jax) and the
same numpy input, in fp32 on the CPU; and its state_dict keys held to the
reference family's (tests/torch_refs.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.nn.generators import GenConfig as JaxGenConfig
from ir2rgb_tpu.nn.generators import local_enhancer_apply, local_enhancer_init

from ir2rgb_tpu_torch.checkpoint import generator_state_dict_from_jax
from ir2rgb_tpu_torch.nn import GenConfig, LocalEnhancer

import torch_refs

SMALL = dict(ngf=8, n_downsample_global=2, n_blocks_global=2,
             n_blocks_local=1)
# pix2pixhd_512's generator: ngf 32 (trunk ngf 64), 4 downs, 9 + 3 blocks
FULL = dict(ngf=32, n_downsample_global=4, n_blocks_global=9,
            n_blocks_local=3)
# jitted: one compile per program instead of one per eager op
_jax_init = jax.jit(local_enhancer_init, static_argnums=1)
_jax_apply = jax.jit(local_enhancer_apply, static_argnums=2)


def psnr(a, b, peak=2.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(peak * peak / mse) if mse > 0 else np.inf


def _port(cfg: GenConfig, sd) -> LocalEnhancer:
    with torch.device("meta"):
        g = LocalEnhancer(cfg)
    g.load_state_dict(sd, assign=True)
    return g.eval()


def _pair(widths, input_nc, size, n_local=1, seed=0):
    kw = dict(net_g="local", input_nc=input_nc, n_local_enhancers=n_local,
              **widths)
    jcfg = JaxGenConfig(**kw)
    params = _jax_init(jax.random.PRNGKey(seed), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    x = np.random.RandomState(seed).uniform(
        -1, 1, (1, size, size, input_nc)).astype(np.float32)
    y_j = np.asarray(_jax_apply(params, jnp.asarray(x), jcfg))
    del params
    cfg = GenConfig(**kw)
    g = _port(cfg, generator_state_dict_from_jax(params_np, cfg))
    with torch.no_grad():
        y_p = g(torch.from_numpy(x)).numpy()
    return y_p, y_j


@pytest.mark.parametrize("n_local", [1, 2])
def test_small_local_enhancer_matches_jax(n_local):
    # fp32 throughout; the JAX side runs its f32 convs at HIGHEST precision,
    # so the gap is summation order only: atol 1e-4 and >= 40 dB, the
    # repo's parity bar
    y_p, y_j = _pair(SMALL, 3, 64, n_local=n_local)
    assert y_p.shape == y_j.shape == (1, 64, 64, 3)
    assert psnr(y_p, y_j) >= 40.0
    np.testing.assert_allclose(y_p, y_j, atol=1e-4)


@pytest.mark.parametrize("input_nc", [3, 6])
def test_full_width_pix2pixhd_512_matches_jax_at_256px(input_nc):
    # the full pix2pixhd_512 widths (input_nc 6 is temporal_512's); at
    # 256 px JAX takes its production s2d lowering, an exact rewrite, so
    # the bar is the same: atol 1e-4, >= 40 dB
    y_p, y_j = _pair(FULL, input_nc, 256)
    assert y_p.shape == y_j.shape == (1, 256, 256, 3)
    assert psnr(y_p, y_j) >= 40.0
    np.testing.assert_allclose(y_p, y_j, atol=1e-4)


def test_reference_state_dict_loads_directly():
    # a reference-family LocalEnhancer's state_dict loads with strict key
    # matching; both are plain fp32 torch on the same input, so the only
    # gap is the port's fp32 instance-norm arithmetic (atol 1e-5)
    torch.manual_seed(0)
    ref = torch_refs.LocalEnhancer(input_nc=3, **SMALL).eval()
    cfg = GenConfig(input_nc=3, **SMALL)
    g = _port(cfg, ref.state_dict())
    assert list(g.state_dict()) == list(ref.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (1, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        y_ref = ref(x).permute(0, 2, 3, 1).numpy()
        y_p = g(x.permute(0, 2, 3, 1).contiguous()).numpy()
    np.testing.assert_allclose(y_p, y_ref, atol=1e-5)


def test_resnet_generator_with_tail_loads_reference_and_matches():
    # the ResNet stack with its c7s1 tail (which goes through B2's plain
    # version): reference keys load strictly, fp32 torch both sides
    from ir2rgb_tpu_torch.nn import ResnetGenerator
    torch.manual_seed(1)
    ref = torch_refs.ResnetGenerator(ngf=8, n_blocks=2).eval()
    with torch.device("meta"):
        g = ResnetGenerator(ngf=8, n_blocks=2)
    g.load_state_dict(ref.state_dict(), assign=True)
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (1, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        y_ref = ref(x).permute(0, 2, 3, 1).numpy()
        y_p = g(x.permute(0, 2, 3, 1).contiguous()).numpy()
    np.testing.assert_allclose(y_p, y_ref, atol=1e-5)


def test_from_jax_rejects_mismatched_params():
    kw = dict(net_g="local", input_nc=3, **SMALL)
    params = jax.tree.map(np.asarray, _jax_init(
        jax.random.PRNGKey(0), JaxGenConfig(**kw)))
    with pytest.raises(ValueError):
        generator_state_dict_from_jax(params, GenConfig(**dict(kw, ngf=16)))


def test_bad_input_size_names_its_cause():
    cfg = GenConfig(input_nc=3, **SMALL)
    with torch.device("meta"):
        g = LocalEnhancer(cfg)
        with pytest.raises(ValueError, match="divisible by 8"):
            g(torch.empty((1, 36, 36, 3)))
