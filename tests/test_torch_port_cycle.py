"""CycleGAN in the port (``train/cycle.py``), held to the JAX package's
``train/cycle.py`` on the CPU, fp32 (the model tests of
``tests/test_cyclegan.py``):

- one step at one pinned forward point (the machinery of
  ``tests/test_torch_port_train_temporal.py``: every norm's input, every
  ReLU / LeakyReLU decision, every D output and every generator output of
  the four, or six, generator passes pinned to the port's values, in
  call order), JAX's pool decisions (fake_b's pool, then fake_a's): every
  metric at rtol 1e-5 of JAX's, every gradient of the four networks
  under ``_mixed_bar`` at 1e-4, the pools after the step; and the
  metrics against the family's formulas recomputed from the port's own
  networks;
- the stop-gradient walls: the G-side loss reaches neither D, the D side
  neither G, and each loss reaches its two networks;
- JAX's refusals (identity with mismatched channels, labels, instance
  inputs, wgangp) and the identity-free model's directions;
- grad-accum and EMA composed on the two-generator model;
- ``Trainer.fit`` and a resume; the training CLI on unaligned folders
  and ``cli.infer`` serving G_A with the reconstruction column.

ngf / ndf 8 at 32-48 px: JAX compiles one step here."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.config import PRESETS as JAX_PRESETS
from ir2rgb_tpu.train import create_model as jax_create_model
from ir2rgb_tpu.train.image_pool import init_pool as jax_init_pool

from ir2rgb_tpu_torch.checkpoint import (
    cycle_discriminators_from_jax,
    cycle_generators_from_jax,
)
from ir2rgb_tpu_torch.config import PRESETS
from ir2rgb_tpu_torch.nn import ops
from ir2rgb_tpu_torch.train import CycleGanModel, create_model, image_pool

from test_torch_port_train_temporal import _exact, _JaxKinkPins
from test_torch_port_train_zoo import _mixed_bar, _params

SIZE, BATCH, POOL = 32, 2, 1
KEY = 7


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


def _cfg(presets, **loss):
    cfg = presets["cyclegan_256"]
    return cfg.replace(
        model=dataclasses.replace(cfg.model, net_g="resnet_6blocks", ngf=8,
                                  ndf=8),
        data=dataclasses.replace(cfg.data, crop_size=SIZE,
                                 batch_size=BATCH),
        loss=dataclasses.replace(cfg.loss, pool_size=POOL, **loss))


def _batch(seed=0, n=BATCH, size=SIZE):
    r = np.random.RandomState(seed)
    return {k: r.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
            for k in "ab"}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _load_jax(pm, g_params, d_params):
    for name, sd in cycle_generators_from_jax(g_params, pm.gen_cfg,
                                              pm.gen_cfg_b).items():
        getattr(pm, name).load_state_dict(sd)
    for name, sd in cycle_discriminators_from_jax(d_params, pm.disc_cfg,
                                                  pm.disc_cfg_b).items():
        getattr(pm, name).load_state_dict(sd)


def _pool_draws(rng):
    """JAX's (swap, idx) per item for the two queries, in its order:
    fake_b's pool (key k_pb), then fake_a's (k_pa)."""
    _, _, k_pa, k_pb = jax.random.split(rng, 4)
    draws = []
    for kp in (k_pb, k_pa):
        swap, idx = [], []
        for k in jax.random.split(kp, BATCH):
            k_swap, k_idx = jax.random.split(k)
            idx.append(int(jax.random.randint(k_idx, (), 0, POOL)))
            swap.append(bool(jax.random.bernoulli(k_swap)))
        draws.append((swap, idx))
    return draws


@pytest.fixture(scope="module")
def step():
    """The port's step on JAX's weights with its records (the norms' and
    activations' inputs and outputs, D outputs, G outputs, in call
    order), and JAX's pinned step."""
    jm = jax_create_model(_cfg(JAX_PRESETS), steps_per_epoch=1)
    pm = create_model(_cfg(PRESETS), device="cpu", steps_per_epoch=1)
    g_params, d_params = _params(jm.g_init, 0), _params(jm.d_init, 1)
    _load_jax(pm, g_params, d_params)
    batch = _batch()
    rng = jax.random.PRNGKey(KEY)
    queue = _pool_draws(rng)
    norms, taps, fakes = [], [], []
    saved_norm, saved_act = ops.fused_instance_norm_act, ops.apply_act

    def numpy(t):
        return t.detach().numpy().copy()

    def norm(x, act="relu", negative_slope=0.2):
        y = saved_norm(x, act, negative_slope)
        norms.append((numpy(x), numpy(y)))
        return y

    def apply_act(x, act, negative_slope=0.2):
        y = saved_act(x, act, negative_slope)
        if act in ("relu", "leaky_relu"):
            norms.append((numpy(x), numpy(y)))
        return y

    def draw(n, pool_size, generator):
        swap, idx = queue.pop(0)
        return torch.tensor(swap), torch.tensor(idx)

    hooks = [net.register_forward_hook(
        lambda mod, args, out: fakes.append(numpy(out)))
        for net in (pm.netG, pm.netG_B)]
    hooks += [net.register_forward_hook(
        lambda mod, args, out: taps.append([[numpy(t) for t in scale]
                                            for scale in out]))
        for net in (pm.netD, pm.netD_B)]
    saved = (image_pool.draw_decisions, ops.fused_instance_norm_act,
             ops.apply_act)
    image_pool.draw_decisions, ops.fused_instance_norm_act, ops.apply_act = (
        draw, norm, apply_act)
    try:
        loss_g, loss_d, metrics = pm.loss_and_metrics(_torch(batch))
    finally:
        (image_pool.draw_decisions, ops.fused_instance_norm_act,
         ops.apply_act) = saved
        for h in hooks:
            h.remove()
    assert not queue
    (loss_g + loss_d).backward()

    kinks = _JaxKinkPins([dict(norms=norms, taps=taps)])
    pins = [jnp.asarray(f) for f in fakes]
    pinned = dataclasses.replace(jm)
    order = []

    def pin_g(apply):
        def run(p, x, train=False, rng=None):
            out = apply(p, x, train=train, rng=rng)
            order.append(len(order))
            return _exact(out, pins[order[-1]])
        return run

    pinned.g_apply, pinned.gb_apply = pin_g(jm.g_apply), pin_g(jm.gb_apply)
    pinned.d_apply = lambda p, x: kinks.d_output(jm.d_apply(p, x))
    pinned.db_apply = lambda p, x: kinks.d_output(jm.db_apply(p, x))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    pool = {k: jax_init_pool(POOL, (SIZE, SIZE, 3))
            for k in ("fake_a", "fake_b")}

    def total(params):
        order.clear()
        kinks.start(jnp.ones((1,)))
        return pinned.loss_and_metrics(params[0], params[1], jbatch, rng,
                                       pool)

    with kinks.patched():
        grads, (jmetrics, jpool) = jax.jit(jax.grad(total, has_aux=True))(
            (g_params, d_params))
    assert kinks.read_all() and len(order) == len(pins) == 6
    return dict(pm=pm, jm=jm, metrics=metrics, batch=batch, grads=grads,
                jmetrics=jmetrics, jpool=jpool, fakes=fakes)


def test_cycle_metrics_match_jax(step):
    got = {k: v.detach().numpy() for k, v in step["metrics"].items()}
    want = {k: np.asarray(v) for k, v in step["jmetrics"].items()}
    assert set(got) == set(want) == {
        "G_A", "G_B", "Cyc_A", "Cyc_B", "Idt_A", "Idt_B", "D_A", "D_B",
        "_loss_g", "_loss_d"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_cycle_every_gradient_matches_jax(step):
    pm = step["pm"]
    g, d = (jax.tree.map(np.asarray, t) for t in step["grads"])
    want = {**cycle_generators_from_jax(g, pm.gen_cfg, pm.gen_cfg_b),
            **cycle_discriminators_from_jax(d, pm.disc_cfg, pm.disc_cfg_b)}
    for name in ("netG", "netG_B", "netD", "netD_B"):
        got = {k: p.grad for k, p in getattr(pm, name).named_parameters()}
        assert all(v is not None for v in got.values()), name
        assert _mixed_bar(got, {k: want[name][k] for k in got},
                          1e-4) == {}, name


def test_cycle_pools_match_jax(step):
    # a batch of 2 into each 1-image pool, queried fake_b's first: filled,
    # then JAX's draw decided the second item
    for k in ("fake_a", "fake_b"):
        pool, jpool = step["pm"].pool[k], step["jpool"][k]
        assert int(pool.count) == int(jpool.count) == 1
        np.testing.assert_allclose(pool.buffer.numpy(),
                                   np.asarray(jpool.buffer), atol=1e-6)


def test_cycle_losses_match_family_formulas():
    # JAX's test_cycle_losses_match_family_formulas on the port's own
    # networks (no pool): the generator outputs the step made (fake_b,
    # fake_a, rec_a, rec_b, idt_a, idt_b, in order) through the port's Ds
    cfg = _cfg(PRESETS)
    pm = create_model(cfg.replace(loss=dataclasses.replace(
        cfg.loss, pool_size=0)), device="cpu")
    fakes = []
    hooks = [net.register_forward_hook(
        lambda mod, args, out: fakes.append(out.detach()))
        for net in (pm.netG, pm.netG_B)]
    batch = _torch(_batch(4))
    with torch.no_grad():
        got = pm.loss_and_metrics(batch)[2]
    for h in hooks:
        h.remove()
    fake_b, fake_a, rec_a, rec_b, idt_a, idt_b = fakes
    a, b = batch["a"], batch["b"]

    def lsgan(d, x, target):
        return ((d(x)[0][-1].float() - target) ** 2).mean()

    def l1(x, y):
        return (x.float() - y.float()).abs().mean()

    with torch.no_grad():
        expect = {
            "G_A": lsgan(pm.netD, fake_b, 1.0),
            "G_B": lsgan(pm.netD_B, fake_a, 1.0),
            "Cyc_A": 10.0 * l1(rec_a, a), "Cyc_B": 10.0 * l1(rec_b, b),
            "Idt_A": 10.0 * 0.5 * l1(idt_a, b),
            "Idt_B": 10.0 * 0.5 * l1(idt_b, a),
            "D_A": 0.5 * (lsgan(pm.netD, b, 1.0)
                          + lsgan(pm.netD, fake_b, 0.0)),
            "D_B": 0.5 * (lsgan(pm.netD_B, a, 1.0)
                          + lsgan(pm.netD_B, fake_a, 0.0))}
    for k, v in expect.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(
        float(got["_loss_g"] + got["_loss_d"]),
        float(sum(expect.values())), rtol=1e-5)


def test_cycle_sg_walls():
    # JAX's test_cycle_sg_walls: the G-side loss gives the Ds no
    # gradient, the D side the Gs none, and each loss reaches its nets
    cfg = _cfg(PRESETS)
    pm = create_model(cfg.replace(loss=dataclasses.replace(
        cfg.loss, pool_size=0)), device="cpu")
    gs = [*pm.netG.parameters(), *pm.netG_B.parameters()]
    ds = [*pm.netD.parameters(), *pm.netD_B.parameters()]
    loss_g, loss_d, _ = pm.loss_and_metrics(_torch(_batch(1)))
    n_g = len([*pm.netG.parameters()])
    n_d = len([*pm.netD.parameters()])
    for loss, reached, walled, n in ((loss_g, gs, ds, n_g),
                                     (loss_d, ds, gs, n_d)):
        grads = torch.autograd.grad(loss, reached + walled,
                                    retain_graph=True, allow_unused=True)
        assert all(g is None or float(g.abs().max()) == 0
                   for g in grads[len(reached):])
        mine = grads[:len(reached)]
        assert all(g is not None for g in mine)
        # each of the two networks the loss is for
        for part in (mine[:n], mine[n:]):
            assert any(float(g.abs().max()) > 0 for g in part)


@pytest.mark.parametrize("change,match", [
    (dict(model=dict(input_nc=1)), "lambda_identity"),
    (dict(model=dict(label_nc=4)), "label_nc"),
    (dict(model=dict(use_instance_edges=True)), "use_instance_edges"),
    (dict(loss=dict(gan_mode="wgangp")), "wgangp")])
def test_cycle_refuses_what_jax_refuses(change, match):
    cfg = _cfg(PRESETS)
    cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                         for k, v in change.items()})
    with pytest.raises(ValueError, match=match):
        create_model(cfg, device="cpu")


def test_cycle_without_identity_serves_both_directions():
    # lambda_identity 0 lifts the channel constraint: 1-channel A, no
    # Idt metrics, G_A maps 1 -> 3 channels and G_B 3 -> 1
    cfg = _cfg(PRESETS, lambda_identity=0.0)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, input_nc=1))
    pm = create_model(cfg, device="cpu")
    r = np.random.RandomState(0)
    batch = {"a": torch.from_numpy(r.uniform(-1, 1, (2, SIZE, SIZE, 1))
                                   .astype(np.float32)),
             "b": torch.from_numpy(r.uniform(-1, 1, (2, SIZE, SIZE, 3))
                                   .astype(np.float32))}
    metrics = pm.train_step(batch)
    assert "Idt_A" not in metrics and np.isfinite(float(metrics["Cyc_A"]))
    assert pm.generate(batch["a"]).shape[-1] == 3
    assert pm.generate(batch["b"], direction="BtoA").shape[-1] == 1
    with pytest.raises(ValueError, match="direction"):
        pm.generate(batch["a"], direction="AtoA")


def test_cycle_grad_accum_and_ema_compose():
    # JAX's test_cycle_grad_accum_and_ema_compose: the micro-batches run
    # through both domains' pools, and the EMA shadows both generators
    cfg = _cfg(PRESETS)
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, pool_size=8),
                      train=dataclasses.replace(cfg.train, grad_accum=2,
                                                ema_decay=0.5),
                      data=dataclasses.replace(cfg.data, batch_size=4))
    pm = create_model(cfg, device="cpu")
    assert isinstance(pm, CycleGanModel) and sorted(pm.ema) == ["netG",
                                                                "netG_B"]
    p0 = {n: {k: p.detach().clone() for k, p in net.named_parameters()}
          for n, net in pm.g_nets().items()}
    metrics = pm.train_step(_torch(_batch(2, n=4)))
    assert np.isfinite(float(metrics["Cyc_A"]))
    assert int(pm.pool["fake_a"].count) == int(pm.pool["fake_b"].count) == 4
    for n, net in pm.g_nets().items():
        for k, p in net.named_parameters():
            torch.testing.assert_close(pm.ema[n][k],
                                       0.5 * p0[n][k] + 0.5 * p.detach(),
                                       rtol=1e-5, atol=1e-6)
    state = pm.state_dict()
    assert {"netG", "netG_B", "netD", "netD_B", "ema_g",
            "ema_g_B"} <= set(state)
    assert sorted(state["pool"]) == ["fake_a", "fake_b"]


def test_cycle_trainer_fit_and_resume(tmp_path):
    # JAX's test_cycle_trainer_fit_and_resume on one device: fit 3 steps
    # (both pools, the EMA of both generators, through checkpoints), then
    # continue_train picks the state back up bit for bit and trains on
    from ir2rgb_tpu_torch.train import Trainer

    def mk_cfg(**train):
        cfg = _cfg(PRESETS)
        fields = dict(name="cyc_trainer", checkpoints_dir=str(tmp_path),
                      niter=1, niter_decay=0, print_freq=2,
                      save_latest_freq=100, ema_decay=0.5)
        fields.update(train)
        return cfg.replace(
            data=dataclasses.replace(cfg.data, batch_size=4),
            loss=dataclasses.replace(cfg.loss, pool_size=4),
            train=dataclasses.replace(cfg.train, **fields))

    batches = [_torch(_batch(3, n=4))] * 10
    cfg = mk_cfg()
    trainer = Trainer(create_model(cfg, device="cpu", steps_per_epoch=3),
                      cfg)
    trainer.init_or_restore()
    trainer.fit(iter(batches))
    assert trainer.model.step == 3
    cfg2 = mk_cfg(continue_train=True, niter=2)
    model2 = create_model(cfg2, device="cpu", steps_per_epoch=3, seed=1)
    trainer2 = Trainer(model2, cfg2)
    trainer2.init_or_restore()
    assert model2.step == 3 and int(model2.pool["fake_a"].count) > 0
    for n in ("netG", "netG_B"):
        for k, v in trainer.model.ema[n].items():
            assert torch.equal(model2.ema[n][k], v), (n, k)
    for k, v in trainer.model.netD_B.state_dict().items():
        assert torch.equal(model2.netD_B.state_dict()[k], v), k
    trainer2.fit(iter(batches))
    assert model2.step == 6


def _write_unaligned(root, na=4, nb=3, size=40):
    from PIL import Image
    for side, n, base in (("trainA", na, 0), ("trainB", nb, 100)):
        os.makedirs(os.path.join(root, side), exist_ok=True)
        for i in range(n):
            Image.fromarray(np.full((size, size, 3), base + i, np.uint8)).save(
                os.path.join(root, side, f"{side[-1].lower()}{i:03d}.png"))


def test_cycle_cli_e2e(tmp_path, capsys):
    # JAX's test_cycle_cli_e2e: cli.train on unaligned folders, then
    # cli.infer serving G_A on domain A with the reconstruction column
    from ir2rgb_tpu_torch.cli import infer, train
    root = str(tmp_path / "data")
    _write_unaligned(root)
    ckpts = str(tmp_path / "ckpts")
    common = ["--device", "cpu", "--preset", "cyclegan_256",
              "--model.net_g", "resnet_6blocks", "--model.ngf", "4",
              "--model.ndf", "4", "--data.load_size", "40",
              "--data.crop_size", "32", "--train.name", "cyc",
              "--train.checkpoints_dir", ckpts]
    assert train.main(common + [
        "--loss.pool_size", "4", "--data.dataroot", root,
        "--data.batch_size", "2", "--data.num_workers", "0",
        "--train.niter", "1", "--train.niter_decay", "0",
        "--train.print_freq", "1"]) == 0
    assert "Cyc_A" in capsys.readouterr().out
    results = str(tmp_path / "results")
    assert infer.main(common + [
        "--data.dataset_mode", "single",
        "--data.dataroot", os.path.join(root, "trainA"),
        "--infer.results_dir", results]) == 0
    pngs = [f for _, _, fs in os.walk(os.path.join(results, "cyc",
                                                   "test_latest"))
            for f in fs if f.endswith(".png")]
    assert any("reconstructed" in f for f in pngs), pngs
    assert any("generated" in f for f in pngs), pngs
