"""WGAN-GP in the port, held to the JAX package on the CPU, fp32:

- kernel B1 differentiated twice (``InstanceNormActBackward``) against
  ``jax.grad`` of a scalar of ``jax.grad`` of
  ``instance_norm_act_reference`` (XLA's second derivative), every
  activation, rtol 1e-4; and against plain float64 autograd of the same
  formula, where the statistics' dependence on x shows: a backward that
  takes mean and rstd as constants misses it by up to ~3.7 at
  (1, 6, 6, 4) (the values reach ~3.3);
- ``gradient_penalty`` against JAX's on the same D weights, pairs and
  mixing weights: the n-layer, multiscale and pixel discriminators, the
  value at rtol 1e-5 and D's parameter gradients under ``_mixed_bar`` at
  1e-4, but the conv biases an instance norm follows, whose true
  gradient is 0: there both sides' rounding noise stays under 1e-4 of
  the largest gradient norm;
- one wgangp train step against JAX's ``loss_and_metrics`` at one pinned
  forward point (``tests/test_torch_port_train_temporal.py``'s machinery,
  the pins holding inside the penalty's D pass too), with JAX's mixing
  weights: every metric at rtol 1e-5, every G and D gradient under
  ``_mixed_bar`` at 1e-4 (D's pre-norm biases as above)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.kernels.instance_norm import (
    instance_norm_act_reference as jax_norm,
)
from ir2rgb_tpu.losses.gan import gradient_penalty as jax_gp
from ir2rgb_tpu.nn.discriminators import DiscConfig as JDiscConfig
from ir2rgb_tpu.nn.discriminators import define_d as jax_define_d

from ir2rgb_tpu_torch.checkpoint import discriminator_state_dict_from_jax
from ir2rgb_tpu_torch.kernels import instance_norm as b1
from ir2rgb_tpu_torch.losses import gan
from ir2rgb_tpu_torch.nn import DiscConfig, define_d

from test_torch_port_train_temporal import KEY, cached_steps, state_dicts
from test_torch_port_train_zoo import _mixed_bar, _params


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs six test processes on the machine's cores, and oversubscribed
    thread pools slowed this module's steps by up to two orders of
    magnitude there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _second_derivative_port(x, w1, w2, act):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = b1.instance_norm_act_fn(xt, act)
    (g,) = torch.autograd.grad((y * torch.from_numpy(w1)).sum(), xt,
                               create_graph=True)
    (h,) = torch.autograd.grad((g * torch.from_numpy(w2)).sum(), xt)
    return h.numpy()


@pytest.mark.parametrize("shape,act", [
    ((1, 6, 6, 4), "none"), ((2, 5, 7, 8), "relu"),
    ((1, 6, 6, 4), "leaky_relu"), ((2, 9, 4, 12), "leaky_relu"),
    ((1, 7, 5, 8), "tanh")])
def test_b1_second_derivative_matches_jax(shape, act):
    r = np.random.RandomState(sum(shape))
    x, w1, w2 = (r.randn(*shape).astype(np.float32) for _ in range(3))
    x = x * 2 + 0.5

    def first(xj):
        return jax.grad(lambda v: jnp.sum(jnp.asarray(w1) * jax_norm(v, act)))(
            xj)

    # jitted: one compile of the double backward, not one per eager op
    want = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(
        jnp.asarray(w2) * first(v))))(jnp.asarray(x)))
    got = _second_derivative_port(x, w1, w2, act)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_cpu_route_keeps_the_statistics_dependence():
    # float64 autograd of the formula, mean and rstd functions of x; the
    # port's route computes in fp32, so it agrees to fp32 rounding
    r = np.random.RandomState(0)
    x, w1, w2 = (r.randn(1, 6, 6, 4) for _ in range(3))
    xt = torch.from_numpy(x).requires_grad_(True)
    mean = xt.mean(dim=(1, 2), keepdim=True)
    var = (xt - mean).square().mean(dim=(1, 2), keepdim=True)
    y = b1.apply_act((xt - mean) * torch.rsqrt(var + b1.INSTANCE_NORM_EPS),
                     "leaky_relu")
    (g,) = torch.autograd.grad((y * torch.from_numpy(w1)).sum(), xt,
                               create_graph=True)
    (want,) = torch.autograd.grad((g * torch.from_numpy(w2)).sum(), xt)
    got = _second_derivative_port(x, w1, w2, "leaky_relu")
    want = want.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# gradient_penalty against JAX's
# ---------------------------------------------------------------------------

DISCS = {"n_layers": dict(net_d="n_layers", num_d=1),
         "multiscale": dict(net_d="multiscale", num_d=2),
         "pixel": dict(net_d="pixel", num_d=1)}


@pytest.mark.parametrize("name", sorted(DISCS))
def test_gradient_penalty_matches_jax(name):
    kw = dict(input_nc=6, ndf=8, n_layers=3, **DISCS[name])
    jcfg, pcfg = JDiscConfig(**kw), DiscConfig(**kw)
    d_init, d_apply = jax_define_d(jcfg)
    params = _params(d_init, 5)
    d = define_d(pcfg)
    d.load_state_dict(discriminator_state_dict_from_jax(params, pcfg))
    r = np.random.RandomState(6)
    real, fake = (r.uniform(-1, 1, (2, 48, 48, 6)).astype(np.float32)
                  for _ in range(2))
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.uniform(key, (2, 1, 1, 1), jnp.float32))

    def penalty(p):
        return jax_gp(lambda x: d_apply(p, x), jnp.asarray(real),
                      jnp.asarray(fake), key, lambda_gp=10.0)

    # jitted: one compile of JAX's penalty and its gradient, not one per
    # eager op of the double backward
    want, want_grads = jax.jit(jax.value_and_grad(penalty))(params)
    got = gan.gradient_penalty(d, torch.from_numpy(real),
                               torch.from_numpy(fake), lambda_gp=10.0,
                               eps=torch.from_numpy(eps))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    got.backward()
    want_sd = discriminator_state_dict_from_jax(
        jax.tree.map(np.asarray, want_grads), pcfg)
    got_sd = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
              for k, p in d.named_parameters()}
    # a conv bias an instance norm follows cannot move D's output, so the
    # penalty's true gradient there is 0; both sides compute rounding
    # noise of a second derivative, which reaches ~1e-5 of the largest
    # gradient norm M (JAX's own: 7e-4 at M = 87 on the pixel D) and
    # moves with the CPU's thread count
    assert _noise_floor_and_bar(d, got_sd, want_sd)


def _pre_norm_biases(d):
    """The keys of the conv biases an instance norm follows in ``d``."""
    if d.cfg.net_d == "pixel":
        return {"net.2.bias"}
    layers = (d.layers() if d.cfg.net_d == "n_layers" else
              [s for i in range(d.cfg.num_d) for s in d.layers(i)])
    names = {id(m): n for n, m in d.named_modules()}
    return {names[id(s[0])] + ".bias" for s in layers if len(s) == 3}


def test_gradient_penalty_draws_eps_from_the_generator():
    # one weight a sample, uniform in [0, 1), from the model's generator
    eps = gan.draw_eps(3, torch.Generator().manual_seed(0))
    assert tuple(eps.shape) == (3, 1, 1, 1) and eps.dtype == torch.float32
    assert bool(((eps >= 0) & (eps < 1)).all())
    assert torch.equal(eps, gan.draw_eps(3, torch.Generator().manual_seed(0)))


# ---------------------------------------------------------------------------
# A wgangp train step against JAX's
# ---------------------------------------------------------------------------

STEPS = {
    "wgangp": dict(
        preset="pix2pixhd_512", t=None, batch=1,
        model=dict(ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=2,
                   n_blocks_local=1),
        loss=dict(no_vgg_loss=True, gan_mode="wgangp")),
}


@pytest.fixture(scope="module")
def steps():
    # the port's mixing weights are JAX's: loss_and_metrics draws them
    # from fold_in(k_pool, 1) (model.py:376-378)
    k_pool = jax.random.split(jax.random.PRNGKey(KEY))[1]

    def draw(n, generator):
        return torch.from_numpy(np.asarray(jax.random.uniform(
            jax.random.fold_in(k_pool, 1), (n, 1, 1, 1), jnp.float32)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gan, "draw_eps", draw)
        get = cached_steps(STEPS)
        yield get


def test_wgangp_step_metrics_match_jax(steps):
    _, port, jax_side = steps("wgangp")
    np.testing.assert_allclose(port["fakes"][0], jax_side["own"][0],
                               atol=1e-5)
    want = {k: np.asarray(v) for k, v in jax_side["metrics"].items()}
    got = {k: v.detach().numpy() for k, v in port["metrics"].items()}
    assert set(got) == set(want) and "D_GP" in got
    assert float(got["D_GP"]) > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_wgangp_step_every_gradient_matches_jax(steps):
    # D's gradient holds the penalty's second derivative through B1
    _, port, jax_side = steps("wgangp")
    pm = port["pm"]
    want_g, want_d = state_dicts(pm, jax_side["grads"])
    got_g = {k: p.grad for k, p in pm.netG.named_parameters()}
    got_d = {k: p.grad for k, p in pm.netD.named_parameters()}
    assert all(v is not None for v in (*got_g.values(), *got_d.values()))
    assert _mixed_bar(got_g, {k: want_g[k] for k in got_g}, 1e-4) == {}
    # D's conv biases before a norm: rounding noise of a true 0 on both
    # sides, as in test_gradient_penalty_matches_jax
    assert _noise_floor_and_bar(pm.netD, got_d, want_d)


def _noise_floor_and_bar(d, got, want):
    """D's gradients ``got`` against ``want``: the conv biases an
    instance norm follows (a true gradient of 0) each under 1e-4 of the
    largest gradient norm on both sides, the rest under ``_mixed_bar``
    at 1e-4."""
    zero = _pre_norm_biases(d)
    big = max(float(v.norm()) for v in want.values())
    for k in zero:
        assert max(float(got[k].norm()),
                   float(want[k].norm())) <= 1e-4 * big, k
    rest = {k: v for k, v in got.items() if k not in zero}
    assert _mixed_bar(rest, {k: want[k] for k in rest}, 1e-4) == {}
    return True
