"""The port's train step and the modules it adds, held to the JAX package
on the CPU on the same weights and the same numpy inputs: the
discriminators, the VGG19 trunk, the losses, the lr schedule, and one
whole pix2pixHD train step (metrics, every gradient, the stop-gradient
walls, the coarse-to-fine freeze and Adam reset). fp32 throughout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.config import Config as JConfig
from ir2rgb_tpu.config import DataConfig as JDataConfig
from ir2rgb_tpu.config import LossConfig as JLossConfig
from ir2rgb_tpu.config import ModelConfig as JModelConfig
from ir2rgb_tpu.config import TrainConfig as JTrainConfig
from ir2rgb_tpu.losses import gan as jgan
from ir2rgb_tpu.losses import reconstruction as jrec
from ir2rgb_tpu.nn.discriminators import DiscConfig as JDiscConfig
from ir2rgb_tpu.nn.discriminators import (
    multiscale_disc_apply,
    multiscale_disc_init,
    n_layer_disc_apply,
    n_layer_disc_init,
)
from ir2rgb_tpu.nn.vgg import vgg19_features, vgg19_init
from ir2rgb_tpu.train import create_model as jax_create_model
from ir2rgb_tpu.train.schedule import lr_schedule as jax_lr_schedule

from ir2rgb_tpu_torch.checkpoint import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    vgg_state_dict_from_jax,
)
from ir2rgb_tpu_torch.config import (
    Config,
    DataConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from ir2rgb_tpu_torch.losses import gan as pgan
from ir2rgb_tpu_torch.losses import reconstruction as prec
from ir2rgb_tpu_torch.nn import DiscConfig, Vgg19, define_d, load_vgg19_npz
from ir2rgb_tpu_torch.train import create_model
from ir2rgb_tpu_torch.train.schedule import lr_schedule

import torch_refs

SIZE = 64
ARCH = dict(net_g="local", net_d="multiscale", ngf=8, ndf=8,
            n_downsample_global=2, n_blocks_global=2, n_blocks_local=1,
            num_d=2, n_layers_d=3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair_image(seed, c=6, size=SIZE):
    return np.random.RandomState(seed).uniform(
        -1, 1, (1, size, size, c)).astype(np.float32)


# ---------------------------------------------------------------------------
# Discriminators
# ---------------------------------------------------------------------------

def _disc_pair(net_d, seed=0):
    jcfg = JDiscConfig(net_d=net_d, input_nc=6, ndf=8, n_layers=3, num_d=2)
    cfg = DiscConfig(net_d=net_d, input_nc=6, ndf=8, n_layers=3, num_d=2)
    key = jax.random.PRNGKey(seed)
    params = (multiscale_disc_init(key, jcfg) if net_d == "multiscale"
              else n_layer_disc_init(key, jcfg))
    with torch.device("meta"):
        d = define_d(cfg)
    d.load_state_dict(discriminator_state_dict_from_jax(_np(params), cfg),
                      assign=True)
    return jcfg, params, d


@pytest.mark.parametrize("net_d", ["multiscale", "n_layers"])
def test_discriminator_matches_jax_every_tap(net_d):
    # fp32 both sides, HIGHEST-precision JAX convs: atol 1e-4 on every
    # tap and the logits; scales finest first on both sides
    jcfg, params, d = _disc_pair(net_d)
    x = _pair_image(1)
    # jitted: one compile of JAX's D, not one per eager op
    outs_j = (jax.jit(multiscale_disc_apply, static_argnums=2)(
        params, jnp.asarray(x), jcfg) if net_d == "multiscale"
        else [jax.jit(n_layer_disc_apply, static_argnums=2)(
            params, jnp.asarray(x), jcfg)])
    with torch.no_grad():
        outs_p = d(torch.from_numpy(x))
    assert len(outs_p) == len(outs_j)
    for sp, sj in zip(outs_p, outs_j):
        assert len(sp) == len(sj) == 5
        for tp, tj in zip(sp, sj):
            assert tuple(tp.shape) == tuple(tj.shape)
            np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=1e-4)
        assert sp[-1].dtype == torch.float32


def test_reference_multiscale_state_dict_loads_directly():
    # the reference module's keys load strictly; it runs its full
    # resolution through scale{num_d-1}, and so does the port. Both are
    # plain fp32 torch: the gap is the norm arithmetic (atol 1e-5)
    torch.manual_seed(0)
    ref = torch_refs.MultiscaleDiscriminator(input_nc=6, ndf=8).eval()
    with torch.device("meta"):
        d = define_d(DiscConfig(net_d="multiscale", input_nc=6, ndf=8))
    assert list(d.state_dict()) == list(ref.state_dict())
    d.load_state_dict(ref.state_dict(), assign=True)
    x = torch.from_numpy(_pair_image(2, size=48))
    with torch.no_grad():
        outs_ref = ref(x.permute(0, 3, 1, 2))
        outs_p = d(x)
    for sp, sr in zip(outs_p, outs_ref):
        for tp, tr in zip(sp, sr):
            np.testing.assert_allclose(tp.numpy(),
                                       tr.permute(0, 2, 3, 1).numpy(),
                                       atol=1e-5)


def test_discriminator_from_jax_rejects_mismatched_params():
    _, params, _ = _disc_pair("multiscale")
    with pytest.raises(ValueError):
        discriminator_state_dict_from_jax(
            _np(params), DiscConfig(net_d="multiscale", input_nc=6, ndf=16))


# ---------------------------------------------------------------------------
# VGG19
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vgg():
    return vgg19_init().params  # the JAX random fallback, PRNGKey(0)


def _port_vgg(params):
    vgg = Vgg19()
    vgg.load_state_dict(vgg_state_dict_from_jax(_np(params)))
    return vgg


def test_vgg19_matches_jax_at_64px(jax_vgg):
    # image-space JAX trunk at 64 px, fp32 HIGHEST both sides: atol 1e-4
    x = _pair_image(3, c=3)
    feats_j = vgg19_features(jax_vgg, jnp.asarray(x))
    with torch.no_grad():
        feats_p = _port_vgg(jax_vgg)(torch.from_numpy(x))
    assert len(feats_p) == 5
    for fp_, fj in zip(feats_p, feats_j):
        assert tuple(fp_.shape) == tuple(fj.shape)
        np.testing.assert_allclose(fp_.numpy(), np.asarray(fj), atol=1e-4)


def test_vgg19_npz_loader_reads_the_jax_format(tmp_path, jax_vgg):
    # the .npz layout of the JAX package's `cli/convert.py vgg19`
    path = tmp_path / "vgg19.npz"
    np.savez(path, **{f"{k}_{n}": np.asarray(v[n]) for k, v in jax_vgg.items()
                      for n in ("w", "b")})
    got = load_vgg19_npz(str(path)).state_dict()
    want = vgg_state_dict_from_jax(_np(jax_vgg))
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k])


def test_vgg19_keys_are_torchvisions():
    with torch.device("meta"):
        keys = list(Vgg19().state_dict())
    convs = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28]
    assert keys == [f"features.{i}.{n}" for i in convs
                    for n in ("weight", "bias")]


# ---------------------------------------------------------------------------
# Losses and schedule
# ---------------------------------------------------------------------------

def _disc_out(seed):
    r = np.random.RandomState(seed)
    return [[r.randn(1, 9 - 2 * s, 9 - 2 * s, 4).astype(np.float32)
             for _ in range(3)] + [r.randn(1, 5 - s, 5 - s, 1)
                                   .astype(np.float32)] for s in range(2)]


def _tj(out):
    return [[jnp.asarray(t) for t in s] for s in out]


def _tp(out):
    return [[torch.from_numpy(t) for t in s] for s in out]


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "hinge", "wgangp"])
def test_gan_losses_match_jax(mode):
    # fp32 means of the same maps: rel 1e-5
    fake, real = _disc_out(0), _disc_out(1)
    np.testing.assert_allclose(
        float(pgan.gan_loss_g(_tp(fake), mode)),
        float(jgan.gan_loss_g(_tj(fake), mode)), rtol=1e-5)
    got = pgan.gan_loss_d_parts(_tp(real), _tp(fake), mode)
    want = jgan.gan_loss_d_parts(_tj(real), _tj(fake), mode)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_reconstruction_losses_match_jax(jax_vgg):
    fake, real = _disc_out(2), _disc_out(3)
    np.testing.assert_allclose(
        float(prec.feature_matching_loss(_tp(fake), _tp(real), 3)),
        float(jrec.feature_matching_loss(_tj(fake), _tj(real), 3)),
        rtol=1e-5)
    a, b = _pair_image(4, c=3), _pair_image(5, c=3)
    np.testing.assert_allclose(
        float(prec.l1_loss(torch.from_numpy(a), torch.from_numpy(b))),
        float(jrec.l1_loss(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    with torch.no_grad():
        got = prec.vgg_loss(_port_vgg(jax_vgg), torch.from_numpy(a),
                            torch.from_numpy(b))
    want = jrec.vgg_loss(jax_vgg, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_gradient_penalty_is_not_ported_yet():
    # gradient_penalty is ported (the name predates it): on a linear critic
    # D(x) = 2·sum(x), as JAX's test_gradient_penalty_analytic, every
    # per-sample input gradient norm is 2·sqrt(N), so the penalty is
    # λ(2·sqrt(N) − 1)² whatever ε, here JAX's draw
    b, h, w, c = 2, 4, 4, 3
    r = np.random.RandomState(0)
    real, fake = (r.rand(b, h, w, c).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(0)
    want = jgan.gradient_penalty(lambda x: [[2.0 * x]], jnp.asarray(real),
                                 jnp.asarray(fake), key, lambda_gp=10.0)
    eps = np.asarray(jax.random.uniform(key, (b, 1, 1, 1), jnp.float32))
    got = pgan.gradient_penalty(lambda x: [[2.0 * x]],
                                torch.from_numpy(real),
                                torch.from_numpy(fake), lambda_gp=10.0,
                                eps=torch.from_numpy(eps))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(got) == pytest.approx(10.0 * (2.0 * np.sqrt(h * w * c)
                                               - 1.0) ** 2, rel=1e-5)


@pytest.mark.parametrize("policy", ["linear", "step", "cosine"])
def test_lr_schedule_matches_jax(policy):
    args = (policy, 2e-4, 3, 4, 5, 2)
    pj, pp = jax_lr_schedule(*args), lr_schedule(*args)
    # JAX evaluates the schedule in float32 (cos near its zero): rtol 1e-5
    for step in range(0, 60, 3):
        np.testing.assert_allclose(pp(step), float(pj(jnp.int32(step))),
                                   rtol=1e-5, atol=1e-12)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _configs(niter_fix_global=1):
    jcfg = JConfig(model=JModelConfig(model="pix2pixhd", **ARCH),
                   data=JDataConfig(crop_size=SIZE, batch_size=1),
                   loss=JLossConfig(lambda_l1=0.0),
                   train=JTrainConfig(niter_fix_global=niter_fix_global))
    pcfg = Config(model=ModelConfig(model="pix2pixhd", **ARCH),
                  data=DataConfig(crop_size=SIZE, batch_size=1),
                  loss=LossConfig(lambda_l1=0.0),
                  train=TrainConfig(niter_fix_global=niter_fix_global))
    return jcfg, pcfg


def _pinned(model, fake_pin):
    """A copy of the JAX model whose generator output has the value
    ``fake_pin`` and JAX's own generator gradient (a straight-through
    pin: ``out + stop_gradient(fake_pin - out)``).

    Why: the perceptual loss runs a ReLU VGG, which is piecewise linear.
    The port's fp32 generator output differs from JAX's by rounding
    (~1e-6), and a change that small flips a few VGG units across their
    kinks, which moves dL/dfake, and so every G gradient, by ~0.5% on
    either framework alone. Pinning the fake to the port's value puts both
    sides at one forward point; everything else (the losses, both
    backwards, the freeze, Adam and its reset) is JAX's own code."""
    pinned = dataclasses.replace(model)

    def generate(g_params, a, prev=None, train=False, rng=None, feat=None,
                 edges=None):
        out = model.generate(g_params, a, prev, train, rng, feat, edges)
        return out + jax.lax.stop_gradient(fake_pin.astype(out.dtype) - out)

    pinned.generate = generate
    return pinned


@pytest.fixture(scope="module")
def jax_side():
    """One JAX model, initial state and batch, and two jitted functions
    (each compiled once for the module): ``grads(state, fake_pin)`` ->
    (pinned raw grads, free-running metrics, JAX's own fake) and
    ``step(state, fake_pin)`` -> the state after JAX's ``train_step``
    with the pinned fake."""
    jcfg, _ = _configs()
    with pytest.warns(UserWarning, match="RANDOM"):
        model = jax_create_model(jcfg, steps_per_epoch=1)
    batch = {"a": jnp.asarray(_pair_image(10, c=3)),
             "b": jnp.asarray(_pair_image(11, c=3))}
    state = model.init_state(jax.random.PRNGKey(0), batch)
    key = jax.random.PRNGKey(1)

    @jax.jit
    def grads(state, fake_pin):
        def loss_fn(params):
            return _pinned(model, fake_pin).loss_and_metrics(
                params[0], params[1], batch, key, state.pool)
        g, _ = jax.grad(loss_fn, has_aux=True)(
            (state.g_params, state.d_params))
        _, (metrics, _) = model.loss_and_metrics(
            state.g_params, state.d_params, batch, key, state.pool)
        fake = model.generate(state.g_params, batch["a"], train=True)
        return g, {k: v for k, v in metrics.items()
                   if not k.startswith("_")}, fake

    @jax.jit
    def step(state, fake_pin):
        return _pinned(model, fake_pin).train_step(state, batch)[0]

    return dict(model=model, batch=_np(batch), state=state, grads=grads,
                step=step)


def _port_model(jax_side):
    _, pcfg = _configs()
    with pytest.warns(UserWarning, match="RANDOM"):
        model = create_model(pcfg, device="cpu", steps_per_epoch=1)
    st = jax_side["state"]
    model.netG.load_state_dict(
        generator_state_dict_from_jax(_np(st.g_params), model.gen_cfg))
    model.netD.load_state_dict(
        discriminator_state_dict_from_jax(_np(st.d_params), model.disc_cfg))
    model.vgg.load_state_dict(
        vgg_state_dict_from_jax(_np(jax_side["model"].vgg_params)))
    batch = {k: torch.from_numpy(v.copy())
             for k, v in jax_side["batch"].items()}
    return model, batch


def _port_fake(model, batch):
    with torch.no_grad():
        return model.netG(batch["a"], train=True).numpy()


def _mixed_bar(got, want, rel):
    """Per tensor ‖Δ‖₂ <= rel·‖g_jax‖₂ + 1e-6·M, M the largest ‖g_jax‖₂
    of the network. The second term covers the conv biases that an
    instance norm follows: their true gradient is zero and both sides
    compute rounding noise."""
    norms = {k: float(np.linalg.norm(v.numpy())) for k, v in want.items()}
    big = max(norms.values())
    bad = {}
    for k, v in want.items():
        delta = float(np.linalg.norm(got[k].numpy() - v.numpy()))
        if delta > rel * norms[k] + 1e-6 * big:
            bad[k] = (delta, norms[k])
    return bad


def test_train_step_metrics_and_every_gradient_match_jax(jax_side):
    model, batch = _port_model(jax_side)
    fake = _port_fake(model, batch)
    (g_grads, d_grads), want_metrics, fake_j = jax_side["grads"](
        jax_side["state"], fake)
    # the pin moves JAX's fake by fp32 rounding only
    np.testing.assert_allclose(fake, np.asarray(fake_j), atol=1e-5)
    metrics = model.compute_grads(batch)
    assert set(metrics) == set(want_metrics) == {
        "G_GAN", "G_GAN_Feat", "G_VGG", "D_real", "D_fake"}
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    want_g = generator_state_dict_from_jax(_np(g_grads), model.gen_cfg)
    want_d = discriminator_state_dict_from_jax(_np(d_grads), model.disc_cfg)
    got_g = {k: p.grad for k, p in model.netG.named_parameters()}
    got_d = {k: p.grad for k, p in model.netD.named_parameters()}
    assert _mixed_bar(got_g, want_g, 1e-4) == {}
    assert _mixed_bar(got_d, want_d, 1e-4) == {}


def test_d_gets_no_gradient_from_g_loss_and_g_none_from_d_loss(jax_side):
    model, batch = _port_model(jax_side)
    loss_g, loss_d, _ = model.loss_and_metrics(batch)
    d_params = list(model.netD.parameters())
    g_params = list(model.netG.parameters())
    assert all(g is None for g in torch.autograd.grad(
        loss_g, d_params, retain_graph=True, allow_unused=True))
    assert all(g is None for g in torch.autograd.grad(
        loss_d, g_params, retain_graph=True, allow_unused=True))
    # and each does reach its own network
    assert all(g is not None for g in torch.autograd.grad(
        loss_d, d_params, retain_graph=True, allow_unused=True))
    assert all(g is not None for g in torch.autograd.grad(
        loss_g, g_params, allow_unused=True))


TAIL_BIAS = f"model1_2.{ARCH['n_blocks_local'] + 4}.bias"


def _bias_before_norm(key):
    """The conv biases an instance norm follows: every G bias but the
    tail's, and D's normed layers 1..n_layers."""
    if not key.endswith(".bias"):
        return False
    if key.startswith("scale"):
        j = int(key.split("_layer")[1].split(".")[0])
        return 1 <= j <= ARCH["n_layers_d"]
    return key != TAIL_BIAS


def _adam_mismatches(got, want, lr):
    """Elements off by more than atol 1e-6, over the tensors compared.
    Adam's update is lr·m̂/(sqrt(v̂)+eps) per element, which amplifies a
    gradient's rounding where the gradient itself is near eps (on the
    first step, g/(|g|+eps)): such an element may move by up to ~lr more
    on one side. Every element must stay within 4·lr."""
    off = n = 0
    for k, v in want.items():
        d = np.abs(got[k].numpy() - v.numpy())
        assert d.max() <= 4 * lr, k
        off += int((d > 1e-6).sum())
        n += d.size
    return off, n


def test_fix_steps_boundary_freezes_then_resets_like_jax(jax_side):
    # steps_per_epoch 1, niter_fix_global 1: step 0 is frozen, step 1
    # clears G's Adam state. Three steps on both sides (JAX's with the
    # port's fake pinned, see _pinned). After each step every parameter
    # matches JAX at atol 1e-6, but for the biases an instance norm
    # follows, where Adam turns rounding noise into updates of up to
    # +-lr, and for at most 1e-5 of the other elements (_adam_mismatches)
    model, batch = _port_model(jax_side)
    assert model.fix_steps == 1
    lr = model.schedule(0)
    trunk0 = {k: v.clone() for k, v in model.netG.state_dict().items()
              if k.startswith("model.")}
    jstate = jax_side["state"]
    jtrunk0 = _np(jstate.g_params["global"])
    for i in range(3):
        jstate = jax_side["step"](jstate, _port_fake(model, batch))
        model.train_step(batch)
        assert model.step == int(jstate.step) == i + 1
        if i == 0:
            for k, v in trunk0.items():
                assert torch.equal(model.netG.state_dict()[k], v), k
            assert jax.tree.all(jax.tree.map(
                np.array_equal, jtrunk0, _np(jstate.g_params["global"])))
        want = dict(generator_state_dict_from_jax(
            _np(jstate.g_params), model.gen_cfg))
        want.update(discriminator_state_dict_from_jax(
            _np(jstate.d_params), model.disc_cfg))
        got = dict(model.netG.state_dict())
        got.update(model.netD.state_dict())
        off, n = _adam_mismatches(
            got, {k: v for k, v in want.items() if not _bias_before_norm(k)},
            lr)
        assert off <= 1e-5 * n, f"step {i}: {off} of {n} elements off"
    # the trunk moved once unfrozen
    assert not torch.equal(model.netG.state_dict()["model.1.weight"],
                           trunk0["model.1.weight"])


def test_bias_before_norm_names_the_right_keys(jax_side):
    model, _ = _port_model(jax_side)
    keys = [k for k in (*model.netG.state_dict(), *model.netD.state_dict())
            if _bias_before_norm(k)]
    assert TAIL_BIAS in model.netG.state_dict()
    assert TAIL_BIAS not in keys  # the tail: tanh, no norm
    assert "model1_2.1.bias" in keys and "model.1.bias" in keys
    assert "scale0_layer0.0.bias" not in keys
    assert "scale1_layer4.0.bias" not in keys
    assert "scale1_layer3.0.bias" in keys


@pytest.mark.parametrize("section,field,value", [
    ("loss", "gan_mode", "wgangp"), ("train", "grad_accum", 2),
    ("train", "ema_decay", 0.999), ("train", "adam_mu_dtype", "bf16"),
    ("model", "net_d", "pixel")])
def test_unported_training_options_raise(section, field, value):
    # every option is ported now (the name predates it): the step trains,
    # and shows the option (each is held to JAX in
    # tests/test_torch_port_gp.py and tests/test_torch_port_train_options.py)
    _, pcfg = _configs(niter_fix_global=0)
    sections = {"loss": dataclasses.replace(pcfg.loss, no_vgg_loss=True)}
    sections[section] = dataclasses.replace(
        sections.get(section, getattr(pcfg, section)), **{field: value})
    model = create_model(pcfg.replace(**sections), device="cpu",
                         steps_per_epoch=1)
    r = np.random.RandomState(3)
    batch = {k: torch.from_numpy(r.uniform(-1, 1, (2, SIZE, SIZE, 3))
                                 .astype(np.float32)) for k in "ab"}
    g0 = {k: v.clone() for k, v in model.netG.named_parameters()}
    metrics = model.train_step(batch)
    assert model.step == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert ("D_GP" in metrics) == (value == "wgangp")
    moved = [not torch.equal(p, g0[k]) for k, p in
             model.netG.named_parameters() if k.endswith("weight")]
    assert all(moved)
    if field == "ema_decay":
        shadow = model.ema["netG"]
        for k, p in model.netG.named_parameters():
            want = value * g0[k] + (1 - value) * p.detach()
            torch.testing.assert_close(shadow[k], want, rtol=1e-6,
                                       atol=1e-9)
    if field == "adam_mu_dtype":
        assert all(st["exp_avg"].dtype == torch.bfloat16
                   for st in model.opt_g.state.values())
    if field == "net_d":
        assert type(model.netD).__name__ == "PixelDiscriminator"


def test_serving_copy_follows_training_updates():
    # bf16 serving runs a bf16 copy of the fp32 master weights; a train
    # step changes them, and the next generate sees the change
    _, pcfg = _configs()
    pcfg = pcfg.replace(model=dataclasses.replace(pcfg.model,
                                                  compute_dtype="bf16"),
                        loss=dataclasses.replace(pcfg.loss,
                                                 no_vgg_loss=True))
    model = create_model(pcfg, device="cpu", steps_per_epoch=1)
    assert all(p.dtype == torch.float32 for p in model.netG.parameters())
    a = torch.from_numpy(_pair_image(12, c=3))
    g0 = model.serving_generator()
    assert next(g0.parameters()).dtype == torch.bfloat16
    y0 = model.generate(a)
    assert model.serving_generator() is g0
    model.train_step({"a": a, "b": torch.from_numpy(_pair_image(13, c=3))})
    assert model.serving_generator() is not g0
    assert y0.dtype == torch.bfloat16
    assert not torch.equal(model.generate(a), y0)


def test_training_after_serving_in_one_process():
    # index tensors cached while serving (inference mode) must not be
    # inference tensors, or the next train step cannot save them
    from ir2rgb_tpu_torch.nn import ops
    ops._reflect_index.cache_clear()
    ops._subpixel_index.cache_clear()
    _, pcfg = _configs()
    pcfg = pcfg.replace(loss=dataclasses.replace(pcfg.loss,
                                                 no_vgg_loss=True))
    model = create_model(pcfg, device="cpu", steps_per_epoch=1)
    a = torch.from_numpy(_pair_image(14, c=3))
    model.generate(a)
    m = model.train_step({"a": a, "b": torch.from_numpy(_pair_image(15, c=3))})
    assert all(np.isfinite(float(v)) for v in m.values())
