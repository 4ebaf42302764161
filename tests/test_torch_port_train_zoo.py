"""One train step of the zoo's other generators held to the JAX package's
on the CPU: ``resnet9_256`` (ResNet-9, the 70x70 PatchGAN with feature
matching, L1) and ``pix2pix_unet256`` (U-Net-256, the flat PatchGAN, L1),
at narrow width (ngf = ndf = 8), fp32, on the same weights and batch.
The metrics and every G and D gradient are compared at one forward
point, the JAX fake pinned to the port's, as in
``tests/test_torch_port_train.py``: the networks are piecewise linear,
and rounding that differs between the two frameworks flips units across
their kinks.

``resnet9_256`` runs without its perceptual loss here. Its random VGG19
at 64 px is the most kinked part of the step: moving the input by 1e-7
moves the port's own ResNet-9 gradients by 1.6e-3 of their norm with the
VGG loss and by 2e-6 without it, so no bar below that could hold with
it. The VGG and its loss are held to JAX in
``tests/test_torch_port_train.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.config import PRESETS as JAX_PRESETS
from ir2rgb_tpu.train import create_model as jax_create_model
from ir2rgb_tpu.train.image_pool import init_pool

from ir2rgb_tpu_torch.checkpoint import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from ir2rgb_tpu_torch.config import PRESETS
from ir2rgb_tpu_torch.train import create_model

# preset -> frame size (the U-Net needs 2^8)
SIZES = {"resnet9_256": 64, "pix2pix_unet256": 256}


def _narrow(cfg, size):
    return cfg.replace(model=dataclasses.replace(cfg.model, ngf=8, ndf=8),
                       data=dataclasses.replace(cfg.data, crop_size=size),
                       loss=dataclasses.replace(cfg.loss, no_vgg_loss=True))


def _params(init, seed):
    """numpy parameters in ``init``'s tree (``jax.eval_shape``: nothing
    compiled), kernels N(0, 0.02), biases N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def leaf(path, v):
        s = 0.02 if path[-1].key == "w" else 0.1
        return (rng.randn(*v.shape) * s).astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(init, jax.random.PRNGKey(0)))


def _pinned(model, fake_pin):
    """The JAX model with its generator output pinned to ``fake_pin``
    (``out + stop_gradient(fake_pin - out)``): JAX's own gradient at the
    port's forward point."""
    pinned = dataclasses.replace(model)

    def generate(g_params, a, prev=None, train=False, rng=None, feat=None,
                 edges=None):
        out = model.generate(g_params, a, prev, train, rng, feat, edges)
        return out + jax.lax.stop_gradient(fake_pin.astype(out.dtype) - out)

    pinned.generate = generate
    return pinned


def _mixed_bar(got, want, rel):
    """Tensors whose ‖Δ‖₂ exceeds rel·‖g_jax‖₂ + 1e-6·M (M the largest
    ‖g_jax‖₂ of the network: the conv biases an instance norm follows
    have a true gradient of zero, and both sides compute rounding
    noise)."""
    norms = {k: float(np.linalg.norm(v.numpy())) for k, v in want.items()}
    big = max(norms.values())
    return {k: (float(np.linalg.norm(got[k].numpy() - v.numpy())), norms[k])
            for k, v in want.items()
            if np.linalg.norm(got[k].numpy() - v.numpy())
            > rel * norms[k] + 1e-6 * big}


@pytest.mark.parametrize("name", sorted(SIZES))
def test_train_step_metrics_and_gradients_match_jax(name):
    size = SIZES[name]
    jm = jax_create_model(_narrow(JAX_PRESETS[name], size),
                          steps_per_epoch=1)
    pm = create_model(_narrow(PRESETS[name], size), device="cpu",
                      steps_per_epoch=1)
    g_params, d_params = _params(jm.g_init, 0), _params(jm.d_init, 1)
    pm.netG.load_state_dict(generator_state_dict_from_jax(g_params,
                                                          pm.gen_cfg))
    pm.netD.load_state_dict(discriminator_state_dict_from_jax(d_params,
                                                              pm.disc_cfg))
    r = np.random.RandomState(2)
    batch = {k: r.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
             for k in "ab"}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pool, key = init_pool(0, (size, size, 3)), jax.random.PRNGKey(1)

    @jax.jit
    def grads(params, fake_pin):
        def loss_fn(p):
            return _pinned(jm, fake_pin).loss_and_metrics(
                p[0], p[1], jbatch, key, pool)
        g, _ = jax.grad(loss_fn, has_aux=True)(params)
        _, (metrics, _) = jm.loss_and_metrics(params[0], params[1], jbatch,
                                              key, pool)
        fake = jm.generate(params[0], jbatch["a"], train=True)
        return g, {k: v for k, v in metrics.items()
                   if not k.startswith("_")}, fake

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        fake = pm.netG(tbatch["a"], train=True).numpy()
    (g_grads, d_grads), want_metrics, fake_j = grads((g_params, d_params),
                                                     fake)
    # the pin moves JAX's fake by fp32 rounding only
    np.testing.assert_allclose(fake, np.asarray(fake_j), atol=1e-5)
    metrics = pm.compute_grads(tbatch)
    want_keys = {"G_GAN", "G_L1", "D_real", "D_fake"}
    if name == "resnet9_256":
        want_keys.add("G_GAN_Feat")
    assert set(metrics) == set(want_metrics) == want_keys
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    want_g = generator_state_dict_from_jax(jax.tree.map(np.asarray, g_grads),
                                           pm.gen_cfg)
    want_d = discriminator_state_dict_from_jax(
        jax.tree.map(np.asarray, d_grads), pm.disc_cfg)
    got_g = {k: p.grad for k, p in pm.netG.named_parameters()}
    got_d = {k: p.grad for k, p in pm.netD.named_parameters()}
    assert set(got_g) <= set(want_g) and set(got_d) <= set(want_d)
    assert _mixed_bar(got_g, {k: want_g[k] for k in got_g}, 1e-4) == {}
    assert _mixed_bar(got_d, {k: want_d[k] for k in got_d}, 1e-4) == {}
    # a step moves every G weight: only net_g="local" has a coarse-to-fine
    # freeze
    assert pm.fix_steps == 0
    g0 = {k: v.clone() for k, v in pm.netG.state_dict().items()}
    pm.train_step(tbatch)
    assert all(not torch.equal(v, g0[k]) for k, v in
               pm.netG.state_dict().items() if k.endswith("weight"))
