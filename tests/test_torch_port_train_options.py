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
- what trains, what serves: the options still unported at the train
  step (the pixel D, WGAN-GP, grad-accum, EMA, bf16 Adam moments) build
  and serve through ``create_model`` + ``generate`` and raise at
  ``train_step``; a 50-frame pool builds, serves and trains;
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
    # every config the JAX package builds builds here, and serves
    cfg = _narrow("pix2pixhd_512")
    cfg = cfg.replace(**{section: dataclasses.replace(
        getattr(cfg, section), **{field: value})})
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="VGG perceptual loss")
        pm = create_model(cfg, device="cpu")
    assert (pm.netD is None) == (value == "pixel")
    a = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (1, 64, 64, 3)).astype(np.float32))
    y = pm.generate(a)
    assert tuple(y.shape) == (1, 64, 64, 3) and bool(torch.isfinite(y).all())
    batch = {"a": a, "b": a.flip(1)}
    if (section, field, value) in SERVED_ONLY:
        with pytest.raises(NotImplementedError):
            pm.train_step(batch)
        assert pm.step == 0
    else:
        m = pm.train_step(batch)
        assert all(np.isfinite(float(v)) for v in m.values())
        assert int(pm.pool.count) == 1


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


def _meta_step_launches(monkeypatch, name, frozen):
    """What one full-size bf16 train step of ``name`` (batch 1, its crop
    size, a temporal preset's whole window) sends to each kernel: B1
    forward and backward (shape, act) -> count, d2s (phase shape, C) ->
    count, s2d (image shape) -> count. Shapes only, on the meta device."""
    from ir2rgb_tpu_torch.kernels import d2s as b3
    from ir2rgb_tpu_torch.nn import Vgg19, define_d, define_g, ops
    from ir2rgb_tpu_torch.train import GanModel, network_configs
    fwd, bwd, d2s, s2d = {}, {}, {}, {}

    def add(table, key):
        table[key] = table.get(key, 0) + 1

    class Norm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, act):
            ctx.key = (tuple(x.shape), act)
            add(fwd, ctx.key)
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            add(bwd, ctx.key)
            return g, None

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
    cfg = PRESETS[name]
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bf16"))
    gen_cfg, disc_cfg = network_configs(cfg)
    with torch.device("meta"):
        model = GanModel(cfg=cfg, gen_cfg=gen_cfg, netG=define_g(gen_cfg),
                         device=torch.device("meta"), disc_cfg=disc_cfg,
                         netD=define_d(disc_cfg),
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
