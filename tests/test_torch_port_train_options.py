"""The train step's options, held to the JAX package on the CPU, fp32:

- the image pool (``train/image_pool.py``) against ``query_pool`` on the
  decisions JAX draws from its keys, over more queries than it holds;
- frame steps against JAX's ``loss_and_metrics`` at one pinned forward
  point (the machinery of ``tests/test_torch_port_train_temporal.py``),
  every metric at rtol 1e-5 and every G and D gradient under
  ``_mixed_bar`` at 1e-4: the label one-hot with the instance-edge
  channel (local enhancer, without its VGG loss: the random VGG's ReLUs
  are the one part of the step left unpinned, and at 64 px they moved
  G's gradients by 8e-4), dropout with the pool (ResNet-6, batch 2),
  and the U-Net's dropout (``unet_128``, 128 px). Dropout masks and pool
  decisions are JAX's own, fed to the port in call order;
- a temporal window draws each frame's own dropout masks;
- every option of the train step (the pixel D, WGAN-GP, grad-accum, EMA,
  bf16 Adam moments, a 50-frame pool) builds, serves through
  ``create_model`` + ``generate`` and trains; grad-accum against the
  full batch and JAX's accumulated step, its indivisible batch, its pool,
  a temporal window; EMA against JAX's; the bf16-moment Adam against
  ``optax.scale_by_adam``; remat against the plain step with dropout,
  bit for bit; the pixel-D step against JAX's;
- every preset's train step at narrow width on the CPU;
- each preset's kernel launches per train step on the meta device
  against ``chip_smoke.py``'s ``TRAIN`` table."""

import dataclasses
import importlib.util
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.train.image_pool import init_pool as jax_init_pool
from ir2rgb_tpu.train.image_pool import query_pool as jax_query_pool

from ir2rgb_tpu_torch.config import PRESETS
from ir2rgb_tpu_torch.train import create_model, image_pool

from test_torch_port_train_temporal import cached_steps, state_dicts
from test_torch_port_train_zoo import _mixed_bar

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _first_torch_tanh():
    """PyTorch's CPU tanh can be off by ~5e-5 on its first call in a
    process (``tests/test_torch_port_kernels.py`` says when); make that
    call here, before any fake is compared."""
    torch.tanh(torch.zeros(8))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tiny CPU tensors: the suite
    runs six test processes on the machine's cores, and oversubscribed
    thread pools slowed small steps by up to two orders of magnitude
    there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The image pool
# ---------------------------------------------------------------------------

def test_pool_matches_query_pool():
    # pool of 3, batches of 2, 5 queries: it fills on the second, then
    # swaps (or not) per JAX's coin and slot for each item
    size, shape = 3, (4, 5, 3)
    r = np.random.RandomState(0)
    jpool = jax_init_pool(size, shape)
    pool = image_pool.init_pool(size, shape)
    swaps = 0
    for q in range(5):
        fakes = r.uniform(-1, 1, (2,) + shape).astype(np.float32)
        key = jax.random.PRNGKey(10 + q)
        want, jpool = jax_query_pool(jpool, jnp.asarray(fakes), key)
        swap, idx = [], []
        for k in jax.random.split(key, 2):
            k_swap, k_idx = jax.random.split(k)
            idx.append(int(jax.random.randint(k_idx, (), 0, size)))
            swap.append(bool(jax.random.bernoulli(k_swap)))
        got, pool = image_pool.query_pool(pool, torch.from_numpy(fakes),
                                          swap=torch.tensor(swap),
                                          idx=torch.tensor(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(pool.buffer.numpy(),
                                      np.asarray(jpool.buffer))
        assert int(pool.count) == int(jpool.count) == min(2 * q + 2, size)
        swaps += sum(swap) if q >= 2 else 0
    assert swaps > 0  # the full pool did swap


def test_pool_draws_from_the_generator_and_checks_frames():
    pool = image_pool.init_pool(2, (4, 4, 3))
    fakes = torch.ones((3, 4, 4, 3))
    out, pool = image_pool.query_pool(pool, fakes,
                                      torch.Generator().manual_seed(0))
    assert torch.equal(out, fakes) and int(pool.count) == 2
    with pytest.raises(ValueError):
        image_pool.query_pool(pool, torch.ones((1, 8, 8, 3)),
                              torch.Generator())
    with pytest.raises(ValueError):
        image_pool.init_pool(0, (4, 4, 3))


# ---------------------------------------------------------------------------
# Frame steps against JAX at one pinned forward point
# ---------------------------------------------------------------------------

NARROW_LOCAL = dict(ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=2,
                    n_blocks_local=1)
STEPS = {
    "labels_edges": dict(
        preset="pix2pixhd_512", t=None, batch=1,
        model=dict(NARROW_LOCAL, label_nc=5, use_instance_edges=True),
        loss=dict(no_vgg_loss=True)),
    "dropout_pool": dict(
        preset="resnet9_256", t=None, batch=2,
        model=dict(ngf=8, ndf=8, net_g="resnet_6blocks", use_dropout=True),
        loss=dict(no_vgg_loss=True, pool_size=1)),
    "unet_dropout": dict(
        preset="pix2pix_unet256", t=None, batch=1, size=128,
        model=dict(ngf=8, ndf=8, net_g="unet_128", use_dropout=True),
        loss={}),
    # JAX's pixel-D step (tests/test_train_step.py:337)
    "pixel_d": dict(
        preset="pix2pix_unet256", t=None, batch=1,
        model=dict(ngf=8, ndf=8, net_g="resnet_6blocks", net_d="pixel"),
        loss={}),
    # the full batch grad-accum's micro-batches add up to
    "accum_full": dict(
        preset="resnet9_256", t=None, batch=2,
        model=dict(ngf=8, ndf=8, net_g="resnet_6blocks"),
        loss=dict(no_vgg_loss=True)),
}
@pytest.fixture(scope="module")
def steps():
    return cached_steps(STEPS)


@pytest.fixture(params=sorted(STEPS))
def step(request, steps):
    return steps(request.param)


def test_step_metrics_match_jax(step):
    name, port, jax_side = step
    # the pin moves JAX's fake by fp32 rounding only
    np.testing.assert_allclose(port["fakes"][0], jax_side["own"][0],
                               atol=1e-5)
    want = {k: np.asarray(v) for k, v in jax_side["metrics"].items()}
    got = {k: v.detach().numpy() for k, v in port["metrics"].items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    if name == "labels_edges":
        # G and D both see label_nc one-hot channels and the edge channel
        pm = port["pm"]
        assert pm.gen_cfg.input_nc == pm.disc_cfg.input_nc - 3 == 6


def test_step_every_gradient_matches_jax(step):
    name, port, jax_side = step
    pm = port["pm"]
    want_g, want_d = state_dicts(pm, jax_side["grads"])
    got_g = {k: p.grad for k, p in pm.netG.named_parameters()}
    got_d = {k: p.grad for k, p in pm.netD.named_parameters()}
    assert all(v is not None for v in (*got_g.values(), *got_d.values()))
    assert _mixed_bar(got_g, {k: want_g[k] for k in got_g}, 1e-4) == {}
    if name == "pixel_d":
        # the pixel D's conv bias before its norm cannot move the logits:
        # its true gradient is 0, and each side's is the rounding noise of
        # a sum over every pixel of the frame (JAX's 3.7e-6): held under
        # 1e-5 of the largest gradient norm, the rest under the bar
        big = max(float(v.norm()) for v in want_d.values())
        assert max(float(got_d["net.2.bias"].norm()),
                   float(want_d["net.2.bias"].norm())) <= 1e-5 * big
        got_d.pop("net.2.bias")
    assert _mixed_bar(got_d, {k: want_d[k] for k in got_d}, 1e-4) == {}
    if name == "dropout_pool":
        # a batch of 2 through a pool of 1: it filled, then JAX's draw
        # decided the second item
        assert int(pm.pool.count) == int(jax_side["pool"].count) == 1
        np.testing.assert_allclose(pm.pool.buffer.numpy(),
                                   np.asarray(jax_side["pool"].buffer),
                                   atol=1e-6)


def _narrow(name, size=64, **model):
    cfg = PRESETS[name]
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8,
                                  n_downsample_global=2, n_blocks_global=1,
                                  n_blocks_local=1, **model),
        data=dataclasses.replace(cfg.data, crop_size=size, n_frames_total=2))


def test_edges_without_inst_maps_raise():
    cfg = _narrow("pix2pixhd_512", use_instance_edges=True)
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, no_vgg_loss=True))
    pm = create_model(cfg, device="cpu")
    batch = {k: torch.zeros((1, 64, 64, 3)) for k in "ab"}
    with pytest.raises(ValueError, match="inst"):
        pm.train_step(batch)
    batch["inst"] = torch.zeros((1, 64, 64), dtype=torch.int32)
    assert all(np.isfinite(float(v)) for v in pm.train_step(batch).values())


@pytest.mark.parametrize("use_dropout", [False, True])
def test_temporal_frames_draw_their_own_dropout(use_dropout):
    # identical frames, no previous-frame input (n_frames_g 1): the frames'
    # G losses are equal without dropout and all differ with it
    cfg = _narrow("temporal_256", net_g="resnet_6blocks", n_frames_g=1,
                  use_dropout=use_dropout)
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, no_vgg_loss=True))
    pm = create_model(cfg, device="cpu")
    r = np.random.RandomState(0)
    frame = {k: r.uniform(-1, 1, (2, 1, 64, 64, 3)).astype(np.float32)
             for k in "ab"}
    batch = {k: torch.from_numpy(np.repeat(v, 3, axis=1))
             for k, v in frame.items()}
    with torch.no_grad():
        losses = pm.loss_and_metrics(batch)[2]["_frame_loss_g"].numpy()
    if use_dropout:
        assert len(np.unique(losses)) == 3, losses
    else:
        np.testing.assert_allclose(losses, losses[0], rtol=1e-6)


# ---------------------------------------------------------------------------
# What trains, what serves
# ---------------------------------------------------------------------------

SERVED_ONLY = [("model", "net_d", "pixel"), ("loss", "gan_mode", "wgangp"),
               ("train", "grad_accum", 2), ("train", "ema_decay", 0.999),
               ("train", "adam_mu_dtype", "bf16")]


@pytest.mark.parametrize("section,field,value",
                         SERVED_ONLY + [("loss", "pool_size", 50)])
def test_training_options_build_and_serve(section, field, value):
    # every config the JAX package builds builds here, serves and trains
    cfg = _narrow("pix2pixhd_512")
    cfg = cfg.replace(**{section: dataclasses.replace(
        getattr(cfg, section), **{field: value})})
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="VGG perceptual loss")
        pm = create_model(cfg, device="cpu")
    assert pm.netD is not None
    a = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32))
    y = pm.generate(a)
    assert tuple(y.shape) == (2, 64, 64, 3) and bool(torch.isfinite(y).all())
    batch = {"a": a, "b": a.flip(1)}
    # each trains now (SERVED_ONLY: the options that served only before
    # this port's A8); a batch of 2, which grad_accum 2 divides
    m = pm.train_step(batch)
    assert pm.step == 1
    assert all(np.isfinite(float(v)) for v in m.values())
    if field == "pool_size":
        assert int(pm.pool.count) == 2


# ---------------------------------------------------------------------------
# grad-accum, EMA, bf16 Adam moments, remat
# ---------------------------------------------------------------------------

def _with(pm, **train):
    """A port model of ``pm``'s config with ``train`` fields changed and
    ``pm``'s weights."""
    cfg = pm.cfg.replace(train=dataclasses.replace(pm.cfg.train, **train))
    twin = create_model(cfg, device="cpu", steps_per_epoch=1)
    for name, net in (*twin.g_nets().items(), *twin.d_nets().items()):
        net.load_state_dict(getattr(pm, name).state_dict())
    return twin


def test_grad_accum_matches_full_batch(steps):
    # accum 2 on JAX's pinned batch of 2: the mean of the two micro-batch
    # gradients, taken at the same parameters, is the full batch's (every
    # loss a batch mean, instance norm per sample): JAX's full-batch
    # gradient at the port's forward point, under the same bar
    _, port, jax_side = steps("accum_full")
    acc = _with(port["pm"], grad_accum=2)
    metrics = acc.compute_grads({k: torch.from_numpy(v)
                                 for k, v in port["batch"].items()})
    want = {k: np.asarray(v) for k, v in jax_side["metrics"].items()}
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5, err_msg=k)
    want_g, want_d = state_dicts(acc, jax_side["grads"])
    got_g = {k: p.grad for k, p in acc.netG.named_parameters()}
    got_d = {k: p.grad for k, p in acc.netD.named_parameters()}
    assert _mixed_bar(got_g, {k: want_g[k] for k in got_g}, 1e-4) == {}
    assert _mixed_bar(got_d, {k: want_d[k] for k in got_d}, 1e-4) == {}


def _tiny(**changes):
    """JAX's tiny_cfg (tests/test_train_step.py:18) in the port."""
    from ir2rgb_tpu_torch.config import (
        Config,
        DataConfig,
        LossConfig,
        ModelConfig,
        TrainConfig,
    )
    model = dict(model="pix2pix", net_g="resnet_6blocks", net_d="n_layers",
                 ngf=8, ndf=8)
    model.update(changes.pop("model", {}))
    return Config(model=ModelConfig(**model),
                  data=DataConfig(crop_size=32, **changes.pop("data", {})),
                  loss=LossConfig(no_vgg_loss=True, **changes.pop("loss", {})),
                  train=TrainConfig(niter=1, niter_decay=1,
                                    **changes.pop("train", {})))


def _pairs(n, size=32, lead=()):
    r = np.random.RandomState(n)
    return {k: torch.from_numpy(r.uniform(-1, 1, (n,) + lead
                                          + (size, size, 3))
                                .astype(np.float32)) for k in "ab"}


def test_grad_accum_indivisible_raises():
    pm = create_model(_tiny(train=dict(grad_accum=2)), device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        pm.train_step(_pairs(3))
    assert pm.step == 0


def test_grad_accum_pool_sees_every_micro_batch():
    # the pool threads through the micro-batches: all 4 fakes entered it
    pm = create_model(_tiny(loss=dict(pool_size=8),
                            train=dict(grad_accum=2)), device="cpu")
    pm.train_step(_pairs(4))
    assert int(pm.pool.count) == 4


def test_grad_accum_temporal_smoke():
    cfg = _tiny(model=dict(model="temporal", n_frames_g=2),
                data=dict(dataset_mode="temporal", n_frames_total=3),
                train=dict(grad_accum=2))
    pm = create_model(cfg, device="cpu")
    metrics = pm.train_step(_pairs(2, lead=(3,)))
    assert np.isfinite(float(metrics["G_GAN"])) and pm.step == 1


def test_ema_tracks_generator():
    # decay 0: no shadow (the checkpoint's layout unchanged); decay 0.5:
    # the shadow starts at G's parameters, in distinct buffers, and after
    # a step is JAX's d·e + (1 − d)·p (model.py:537-541) at JAX's own
    # test's tolerance
    assert create_model(_tiny(), device="cpu").ema is None
    assert "ema_g" not in create_model(_tiny(), device="cpu").state_dict()
    pm = create_model(_tiny(train=dict(ema_decay=0.5)), device="cpu")
    p0 = {k: p.detach().clone() for k, p in pm.netG.named_parameters()}
    for k, p in pm.netG.named_parameters():
        assert torch.equal(pm.ema["netG"][k], p)
        assert pm.ema["netG"][k].data_ptr() != p.data_ptr()
    pm.train_step(_pairs(2))
    p1 = {k: p.detach().numpy() for k, p in pm.netG.named_parameters()}
    want = jax.tree.map(lambda e, p: 0.5 * e + (1.0 - 0.5) * p,
                        {k: jnp.asarray(v.numpy()) for k, v in p0.items()},
                        {k: jnp.asarray(v) for k, v in p1.items()})
    for k, v in want.items():
        np.testing.assert_allclose(pm.ema["netG"][k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert max(float((pm.ema["netG"][k] - torch.from_numpy(p1[k]))
                     .abs().max()) for k in p1) > 0
    # the checkpoint carries it as netG's state_dict, and restores it
    state = pm.state_dict()
    assert set(state["ema_g"]) == set(pm.netG.state_dict())
    twin = create_model(_tiny(train=dict(ema_decay=0.5)), device="cpu")
    twin.load_state_dict(state)
    for k, v in pm.ema["netG"].items():
        assert torch.equal(twin.ema["netG"][k], v)


def test_adam_mu_dtype_bf16_matches_optax():
    # optax.scale_by_adam(mu_dtype=bf16) on the same numpy parameters and
    # gradients over 3 steps, then the lr: the stored mu bit for bit, nu
    # and the parameters within rtol 1e-6
    import optax

    from ir2rgb_tpu_torch.train.optim import AdamBf16Mu
    r = np.random.RandomState(0)
    shapes = [(8, 3, 3, 3), (8,), (5, 7)]
    params = [r.randn(*s).astype(np.float32) * 0.1 for s in shapes]
    grads = [[r.randn(*s).astype(np.float32) * 10.0 ** -r.randint(0, 4)
              for s in shapes] for _ in range(3)]
    lr, b1, b2 = 2e-4, 0.5, 0.999
    tx = optax.scale_by_adam(b1=b1, b2=b2, eps=1e-8, mu_dtype=jnp.bfloat16)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = AdamBf16Mu(tp, lr=lr, betas=(b1, b2), eps=1e-8)
    for step in range(3):
        upd, state = tx.update([jnp.asarray(g) for g in grads[step]], state)
        jp = [p - lr * u for p, u in zip(jp, upd)]
        for p, g in zip(tp, grads[step]):
            p.grad = torch.from_numpy(g)
        opt.step()
        for i, p in enumerate(tp):
            st = opt.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                st["exp_avg"].float().numpy(),
                np.asarray(state.mu[i]).astype(np.float32))
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                       np.asarray(state.nu[i]), rtol=1e-6)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[i]),
                                       rtol=1e-6, atol=1e-9)


def test_adam_mu_dtype_bf16_in_the_model():
    # --train.adam_mu_dtype bf16: G's and D's first moments are bf16, the
    # second fp32; a checkpoint round trip keeps them so; the unfreeze's
    # reset composes (JAX's test_adam_mu_dtype_bf16)
    from ir2rgb_tpu_torch.train.optim import AdamBf16Mu
    cfg = _tiny(train=dict(adam_mu_dtype="bf16"))
    pm = create_model(cfg, device="cpu", steps_per_epoch=1)
    assert isinstance(pm.opt_g, AdamBf16Mu) and isinstance(pm.opt_d,
                                                           AdamBf16Mu)
    metrics = pm.train_step(_pairs(2))
    assert np.isfinite(float(metrics["G_GAN"]))
    for opt in (pm.opt_g, pm.opt_d):
        assert opt.state and all(
            st["exp_avg"].dtype == torch.bfloat16
            and st["exp_avg_sq"].dtype == torch.float32
            for st in opt.state.values())
    twin = create_model(cfg, device="cpu", steps_per_epoch=1)
    twin.load_state_dict(pm.state_dict())
    for a, b in zip(pm.opt_g.state.values(), twin.opt_g.state.values()):
        assert b["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(a["exp_avg"], b["exp_avg"])
    local = _narrow("pix2pixhd_512")
    local = local.replace(
        loss=dataclasses.replace(local.loss, no_vgg_loss=True),
        train=dataclasses.replace(local.train, adam_mu_dtype="bf16",
                                  niter_fix_global=1))
    pm = create_model(local, device="cpu", steps_per_epoch=1)
    pm.train_step(_pairs(1, 64))
    pm.train_step(_pairs(1, 64))  # the unfreeze: G's state restarts
    assert all(st["step"] == 1 for st in pm.opt_g.state.values())
    assert all(st["step"] == 2 for st in pm.opt_d.state.values())


@pytest.mark.parametrize("use_dropout", [False, True])
@pytest.mark.parametrize("net_g", ["local", "resnet_6blocks"])
def test_remat_matches_plain(net_g, use_dropout):
    # JAX's test_remat_matches_plain (tests/test_variants.py:83), with
    # dropout too: the same weights and generator seed, the residual
    # blocks (the trunk's and the enhancer's, or ResNet-6's) recomputed
    # in the backward on the mask drawn before them: losses and every
    # gradient bit for bit
    name = "pix2pixhd_512" if net_g == "local" else "resnet9_256"
    models = []
    for remat in (False, True):
        cfg = _narrow(name, net_g=net_g, use_dropout=use_dropout,
                      remat=remat)
        cfg = cfg.replace(loss=dataclasses.replace(cfg.loss,
                                                   no_vgg_loss=True),
                          train=dataclasses.replace(cfg.train,
                                                    niter_fix_global=0))
        pm = create_model(cfg, device="cpu")
        models.append((pm, pm.compute_grads(_pairs(2, 64))))
    (plain, m0), (remat, m1) = models
    assert remat.gen_cfg.remat and not plain.gen_cfg.remat
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for (k, p), q in zip(plain.netG.named_parameters(),
                         remat.netG.parameters()):
        assert torch.equal(p.grad, q.grad), k
    for (k, p), q in zip(plain.netD.named_parameters(),
                         remat.netD.parameters()):
        assert torch.equal(p.grad, q.grad), k


# the smallest frame of each preset's narrow generator (the U-Net 2^8)
NARROW_SIZE = {"pix2pix_unet256": 256}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_every_preset_trains_at_narrow_width(name):
    # one step on the CPU (a temporal preset: a 2-frame window); the
    # losses are finite and every G weight a step may move moved (the
    # coarse-to-fine presets' trunk is frozen on step 0)
    size = NARROW_SIZE.get(name, 64)
    cfg = _narrow(name, size)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="VGG perceptual loss")
        pm = create_model(cfg, device="cpu", steps_per_epoch=1)
    r = np.random.RandomState(0)
    lead = (1, 2) if cfg.model.model == "temporal" else (1,)
    batch = {k: torch.from_numpy(r.uniform(-1, 1, lead + (size, size, 3))
                                 .astype(np.float32)) for k in "ab"}
    before = {k: v.clone() for k, v in pm.netG.state_dict().items()}
    metrics = pm.train_step(batch)
    assert metrics and all(np.isfinite(float(v)) for v in metrics.values())
    assert not any(k.startswith("_") for k in metrics)
    frozen = pm.fix_steps > 0
    for k, v in pm.netG.state_dict().items():
        if k.endswith("weight") and not (frozen and k.startswith("model.")):
            assert not torch.equal(v, before[k]), k
        elif frozen and k.startswith("model."):
            assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# Kernel launches of one train step, on the meta device
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _meta_step_launches(monkeypatch, name, frozen, model=None, loss=None,
                        train=None):
    """What one full-size bf16 train step of ``name`` (batch 1, its crop
    size, a temporal preset's whole window; ``model`` / ``loss`` /
    ``train``: config fields changed) sends to each kernel: B1 forward
    and backward (shape, act) -> count, d2s (phase shape, C) -> count,
    s2d (image shape) -> count. Shapes only, on the meta device. The B1
    stand-in's backward is itself a Function whose backward reaches x, as
    B1's (WGAN-GP's outer backward runs through it)."""
    from ir2rgb_tpu_torch.kernels import d2s as b3
    from ir2rgb_tpu_torch.losses import gan
    from ir2rgb_tpu_torch.nn import Vgg19, define_d, define_g, ops
    from ir2rgb_tpu_torch.train import GanModel, network_configs
    from ir2rgb_tpu_torch.train.cycle import (
        CycleGanModel,
        cycle_network_configs,
    )
    fwd, bwd, d2s, s2d = {}, {}, {}, {}

    def add(table, key):
        table[key] = table.get(key, 0) + 1

    class NormBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, g, key):
            add(bwd, key)
            return g.clone()

        @staticmethod
        def backward(ctx, gg):
            return gg.clone(), gg.clone(), None

    class Norm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, act):
            ctx.key = (tuple(x.shape), act)
            ctx.save_for_backward(x)
            add(fwd, ctx.key)
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            return NormBackward.apply(x, g, ctx.key), None

    def norm(x, act="relu", negative_slope=0.2):
        if torch.is_grad_enabled() and x.requires_grad:
            return Norm.apply(x, act)
        add(fwd, (tuple(x.shape), act))
        return x.clone()

    class Interleave(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y, c):
            add(d2s, (tuple(y.shape), c))
            return b3.d2s_reference(y, c)

        @staticmethod
        def backward(ctx, g):
            add(s2d, tuple(g.shape))
            return b3.s2d_reference(g), None

    def interleave(y, c):
        if torch.is_grad_enabled() and y.requires_grad:
            return Interleave.apply(y, c)
        add(d2s, (tuple(y.shape), c))
        return b3.d2s_reference(y, c)

    monkeypatch.setattr(ops, "fused_instance_norm_act", norm)
    monkeypatch.setattr(ops, "d2s_fn", interleave)
    monkeypatch.setattr(gan, "draw_eps",
                        lambda n, generator: torch.full((n, 1, 1, 1), 0.5))
    cfg = PRESETS[name]
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="bf16",
                                  **(model or {})),
        loss=dataclasses.replace(cfg.loss, **(loss or {})),
        train=dataclasses.replace(cfg.train, **(train or {})))
    dev = torch.device("meta")
    with torch.device("meta"):
        if cfg.model.model == "cycle_gan":
            g_a, g_b, d_a, d_b = cycle_network_configs(cfg)
            model = CycleGanModel(
                cfg=cfg, gen_cfg=g_a, netG=define_g(g_a), device=dev,
                disc_cfg=d_a, netD=define_d(d_a), gen_cfg_b=g_b,
                disc_cfg_b=d_b, netG_B=define_g(g_b), netD_B=define_d(d_b))
        else:
            gen_cfg, disc_cfg = network_configs(cfg)
            model = GanModel(cfg=cfg, gen_cfg=gen_cfg,
                             netG=define_g(gen_cfg), device=dev,
                             disc_cfg=disc_cfg, netD=define_d(disc_cfg),
                             vgg=None if cfg.loss.no_vgg_loss else Vgg19())
        if model.vgg is not None:
            model.vgg.requires_grad_(False)
        size = cfg.data.crop_size
        lead = ((1, cfg.data.n_frames_total) if cfg.model.model == "temporal"
                else (1,))
        batch = {k: torch.empty(lead + (size, size, 3)) for k in "ab"}
        loss_g, loss_d, _ = model.loss_and_metrics(batch,
                                                   freeze_trunk=frozen)
        (loss_g + loss_d).backward()
    return fwd, bwd, d2s, s2d


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_train_step_sends_chip_smokes_shapes_to_the_kernels(monkeypatch,
                                                             name):
    # chip_smoke.py checks and times the kernels at these shapes, and
    # counts these launches on every step it trains
    table = _chip_smoke().TRAIN[name]
    for frozen in (False, True) if "frozen" in table else (False,):
        want = table["frozen" if frozen else "unfrozen"]
        fwd, bwd, d2s, s2d = _meta_step_launches(monkeypatch, name, frozen)
        assert fwd == want["b1"], (name, frozen)
        assert bwd == want["b1_bwd"], (name, frozen)
        assert d2s == want["d2s"], (name, frozen)
        assert s2d == want["s2d"], (name, frozen)


# chip_smoke.py's train_options tables: (its key, the preset, the config
# changes of the step it counts)
OPTION_TABLES = [
    ("gp pix2pixhd_512", "pix2pixhd_512", dict(loss=dict(gan_mode="wgangp"))),
    ("gp pixel pix2pix_unet256", "pix2pix_unet256",
     dict(model=dict(net_d="pixel"), loss=dict(gan_mode="wgangp"))),
    ("pixel pix2pixhd_512", "pix2pixhd_512", dict(model=dict(net_d="pixel"))),
    ("remat pix2pixhd_1024", "pix2pixhd_1024",
     dict(model=dict(remat=True, use_dropout=True))),
    ("remat pix2pixhd_2048", "pix2pixhd_2048",
     dict(model=dict(remat=True, use_dropout=True))),
]


@pytest.mark.parametrize("key,name,changes", OPTION_TABLES,
                         ids=[k for k, _, _ in OPTION_TABLES])
def test_option_steps_send_chip_smokes_shapes_to_the_kernels(
        monkeypatch, key, name, changes):
    # WGAN-GP's extra D pass, its B1 backward inside the penalty and the
    # B1 backward its second derivative reaches; the pixel D's one norm;
    # remat's blocks recomputed in the backward
    cs = _chip_smoke()
    if key.startswith("remat"):
        want = cs.REMAT[name]
    else:
        want = cs.TRAIN_OPTIONS[key]["unfrozen"]
    fwd, bwd, d2s, s2d = _meta_step_launches(monkeypatch, name, False,
                                             **changes)
    assert fwd == want["b1"] and bwd == want["b1_bwd"], key
    assert d2s == want["d2s"] and s2d == want["s2d"], key


@pytest.mark.parametrize("name", [
    "void fft2d_r2c_32x32<float, false, 0u, false>(float2*, float const*)",
    "void fft2d_c2r_32x32<float, false, false, 0u, false, false>(float*)",
    "std::enable_if<!(false), void>::type internal::gemvx::kernel<int>",
    "void gemv2N_kernel<int, int, float2, float2, float2, float2, 128>"])
def test_profilers_count_ffts_and_gemvs_as_convs(name):
    # cuDNN's fp32 FFT convolutions on an H100 (profile_train.py): the
    # FFTs and the cuBLAS gemv between them are the conv's
    from ir2rgb_tpu_torch.profile_stream import kind_of
    assert kind_of(name) == "conv"
