"""netE, the pix2pixHD feature encoder, in the port
(``ir2rgb_tpu_torch/nn/encoders.py``, ``infer/features.py``,
``cli/precompute_feats.py`` and the model's feature input), held to the
JAX package on the CPU on the same numpy inputs and weights:

- the encoder's forward, raw and pooled per instance (ids up to 2^24),
  its weights converted by ``encoder_state_dict_from_jax``: atol 1e-5;
- the id hash and the collision count, bit for bit; the pooled table's
  counts exactly, its means at rtol 1e-5 (and against a numpy mean);
- one train step with instance maps (32 px, nef 4, two downs): every
  metric at rtol 1e-5, ``inst_collisions`` equal, every G, E and D
  gradient under PERF.md §2's train bar (‖Δ‖ ≤ 1e-3·‖g‖ + 1e-6·max‖g‖)
  at JAX's fake pinned to the port's; E's parameters moved by the step,
  and by a step of the coarse-to-fine freeze, which leaves E live;
- ``kmeans`` (a numpy copy) equal to JAX's, ``sample_feature_map`` at
  JAX's drawn indices equal to JAX's;
- ``push_device(feat=)``, and the temporal stream's refusal;
- ``cli.precompute_feats`` and ``cli.infer`` with
  ``--infer.cluster_path`` and with ``--infer.use_encoded_image`` on a
  32 px folder with instance maps, against the port's own functions.

One intra-op thread."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ir2rgb_tpu.config import PRESETS as JAX_PRESETS
from ir2rgb_tpu.infer import features as jfeat
from ir2rgb_tpu.nn import EncoderConfig as JEncoderConfig
from ir2rgb_tpu.nn import encoder_apply, encoder_init
from ir2rgb_tpu.nn import encoders as jenc
from ir2rgb_tpu.train import create_model as jax_create_model
from ir2rgb_tpu.train.image_pool import init_pool

from ir2rgb_tpu_torch.checkpoint import (
    CheckpointManager,
    discriminator_state_dict_from_jax,
    encoder_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from ir2rgb_tpu_torch.config import PRESETS, parse_cli
from ir2rgb_tpu_torch.infer import features as pfeat
from ir2rgb_tpu_torch.nn import EncoderConfig, define_e
from ir2rgb_tpu_torch.nn import encoders as penc
from ir2rgb_tpu_torch.train import create_model

from test_torch_port_train_zoo import _mixed_bar, _params, _pinned

SIZE = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small CPU tensors (the suite
    runs several test processes on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _voronoi(rng, n, size, cells=6, high=1 << 24):
    """(n, size, size) int32 instance maps: each pixel takes the id of
    its nearest of ``cells`` random sites, ids random below ``high``."""
    yy, xx = np.mgrid[:size, :size]
    out = np.empty((n, size, size), np.int32)
    for i in range(n):
        sites = rng.randint(0, size, (cells, 2))
        ids = rng.randint(0, high, cells)
        d = ((yy[None] - sites[:, 0, None, None]) ** 2
             + (xx[None] - sites[:, 1, None, None]) ** 2)
        out[i] = ids[d.argmin(0)]
    return out


def _enc_params(cfg, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda v: (rng.randn(*v.shape) * 0.1).astype(np.float32),
        jax.eval_shape(lambda k: encoder_init(k, cfg), jax.random.PRNGKey(0)))


@pytest.mark.parametrize("pooled", [False, True])
def test_encoder_matches_jax(pooled):
    jcfg = JEncoderConfig(nef=4, n_downsample_e=2)
    params = _enc_params(jcfg, 0)
    r = np.random.RandomState(1)
    x = r.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    inst = _voronoi(r, 2, SIZE) if pooled else None
    want = np.asarray(encoder_apply(
        params, jnp.asarray(x), None if inst is None else jnp.asarray(inst),
        jcfg))
    cfg = EncoderConfig(nef=4, n_downsample_e=2)
    enc = define_e(cfg)
    enc.load_state_dict(encoder_state_dict_from_jax(params, cfg))
    with torch.no_grad():
        got = enc(torch.from_numpy(x), None if inst is None
                  else torch.from_numpy(inst)).numpy()
    assert got.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="key mismatch|shape mismatch"):
        encoder_state_dict_from_jax(params, dataclasses.replace(cfg, nef=8))


def test_pooling_matches_jax_with_ids_up_to_2_24():
    r = np.random.RandomState(2)
    feat = r.randn(2, 16, 24, 3).astype(np.float32)
    inst = _voronoi(r, 2, 16, cells=9)[:, :, :16]
    inst = np.concatenate([inst, _voronoi(r, 2, 16, cells=5)[:, :, :8]
                           + (1 << 24) - 64], axis=2)
    tf, ti = torch.from_numpy(feat), torch.from_numpy(inst)
    means, cnts, ids = penc.instance_feature_table(tf, ti, 1024)
    jm, jc, ji = jenc.instance_feature_table(jnp.asarray(feat),
                                             jnp.asarray(inst), 1024)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(cnts.numpy(), np.asarray(jc))
    np.testing.assert_allclose(means.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-6)
    got = penc.instance_wise_avg_pool(tf, ti, 1024).numpy()
    np.testing.assert_allclose(got, np.asarray(jenc.instance_wise_avg_pool(
        jnp.asarray(feat), jnp.asarray(inst), 1024)), rtol=1e-5, atol=1e-6)
    assert int(penc.instance_collision_count(ti, 1024)) == 0
    ref = np.empty_like(feat)  # the reference's per-instance mean
    for b in range(2):
        for i in np.unique(inst[b]):
            m = inst[b] == i
            ref[b][m] = feat[b][m].mean(axis=0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_hash_and_collisions_match_jax_bit_for_bit():
    r = np.random.RandomState(3)
    raw = r.randint(0, 1 << 24, (3, 40, 40)).astype(np.int32)
    raw[0, 0, :4] = [0, (1 << 24) - 1, 2 ** 31 - 1, -5]  # int32 extremes
    for n in (1024, 1000):
        np.testing.assert_array_equal(
            penc.hash_instance_ids(torch.from_numpy(raw), n).numpy(),
            np.asarray(jenc.hash_instance_ids(jnp.asarray(raw), n)))
        # ~4800 distinct ids in n segments must collide (pigeonhole)
        got = int(penc.instance_collision_count(torch.from_numpy(raw), n))
        assert got > 0 and got == int(jenc.instance_collision_count(
            jnp.asarray(raw), n))


def _feat_cfg(presets, **train):
    cfg = presets["pix2pixhd_512"]
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, ngf=4, ndf=8, num_d=2, n_downsample_global=2,
            n_blocks_global=1, n_blocks_local=1, use_instance_feat=True,
            feat_num=3, nef=4, n_downsample_e=2),
        data=dataclasses.replace(cfg.data, crop_size=SIZE, batch_size=2),
        loss=dataclasses.replace(cfg.loss, no_vgg_loss=True,
                                 lambda_l1=10.0),
        train=dataclasses.replace(cfg.train, **train))


def _batch(seed=0):
    r = np.random.RandomState(seed)
    return {"a": r.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
            "b": r.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
            "inst": _voronoi(r, 2, SIZE, cells=5)}


def test_train_step_with_instance_features_matches_jax():
    jm = jax_create_model(_feat_cfg(JAX_PRESETS), steps_per_epoch=10)
    pm = create_model(_feat_cfg(PRESETS), device="cpu", steps_per_epoch=10)
    assert pm.gen_cfg.input_nc == 6 and pm.disc_cfg.input_nc == 6
    g_params, d_params = _params(jm.g_init, 0), _params(jm.d_init, 1)
    pm.netG.load_state_dict(generator_state_dict_from_jax(g_params,
                                                          pm.gen_cfg))
    pm.netE.load_state_dict(encoder_state_dict_from_jax(g_params["netE"],
                                                        pm.enc_cfg))
    pm.netD.load_state_dict(discriminator_state_dict_from_jax(d_params,
                                                              pm.disc_cfg))
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pool, key = init_pool(0, (SIZE, SIZE, 3)), jax.random.PRNGKey(1)

    @jax.jit
    def grads(params, fake_pin):
        def loss_fn(p):
            return _pinned(jm, fake_pin).loss_and_metrics(
                p[0], p[1], jbatch, key, pool)
        g, (metrics, _) = jax.grad(loss_fn, has_aux=True)(params)
        return g, {k: v for k, v in metrics.items()
                   if not k.startswith("_")}

    with torch.no_grad():
        feat = pm.netE(tbatch["b"], tbatch["inst"])
        fake = pm._fake(tbatch["a"], feat=feat).numpy()
    (g_grads, d_grads), want_metrics = grads((g_params, d_params), fake)
    metrics = pm.compute_grads(tbatch)
    assert set(metrics) == set(want_metrics) and "inst_collisions" in metrics
    assert float(metrics["inst_collisions"]) == float(
        want_metrics["inst_collisions"])
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    g_np = jax.tree.map(np.asarray, g_grads)
    wants = {"netG": generator_state_dict_from_jax(g_np, pm.gen_cfg),
             "netE": encoder_state_dict_from_jax(g_np["netE"], pm.enc_cfg),
             "netD": discriminator_state_dict_from_jax(
                 jax.tree.map(np.asarray, d_grads), pm.disc_cfg)}
    for name, net in (*pm.g_nets().items(), *pm.d_nets().items()):
        got = {k: p.grad for k, p in net.named_parameters()}
        assert _mixed_bar(got, {k: wants[name][k] for k in got}, 1e-3) \
            == {}, name
    e0 = {k: v.clone() for k, v in pm.netE.state_dict().items()}
    pm.train_step(tbatch)
    assert all(not torch.equal(v, e0[k]) for k, v in
               pm.netE.state_dict().items() if k.endswith("weight"))
    # the checkpoint carries netE, and an EMA shadow key of its own
    assert {"netG", "netE", "netD"} <= set(pm.state_dict())
    assert pm.ema_key("netE") == "ema_e"


def test_freeze_gate_keeps_netE_live():
    pm = create_model(_feat_cfg(PRESETS, niter_fix_global=1), device="cpu",
                      steps_per_epoch=100)
    assert pm.fix_steps == 100
    before = {n: {k: v.clone() for k, v in net.state_dict().items()}
              for n, net in pm.g_nets().items()}
    pm.train_step({k: torch.from_numpy(v) for k, v in _batch(1).items()})

    def moved(name, prefix=""):
        return any(not torch.equal(v, before[name][k]) for k, v in
                   pm.g_nets()[name].state_dict().items()
                   if k.startswith(prefix))
    assert not moved("netG", "model.")   # the frozen trunk
    assert moved("netG", "model1_")      # the enhancer
    assert moved("netE")                 # E stays in G's optimizer


def test_kmeans_and_sample_feature_map_match_jax():
    r = np.random.RandomState(5)
    x = np.concatenate([r.randn(30, 3) * 0.1 + c for c in (-1, 0, 1)]
                       ).astype(np.float32)
    centers = pfeat.kmeans(x, 4, seed=3)
    np.testing.assert_array_equal(centers, jfeat.kmeans(x, 4, seed=3))
    inst = _voronoi(r, 2, 24, cells=7)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jfeat.sample_feature_map(
        jnp.asarray(inst), jnp.asarray(centers), key, 256))
    choice = np.asarray(jax.random.randint(key, (2, 256), 0, len(centers)))
    got = pfeat.feature_map(torch.from_numpy(inst), torch.from_numpy(centers),
                            torch.from_numpy(choice), 256).numpy()
    np.testing.assert_array_equal(got, want)
    # the port's own draws: every instance one centroid, all its pixels
    drawn = pfeat.sample_feature_map(torch.from_numpy(inst),
                                     torch.from_numpy(centers),
                                     torch.Generator().manual_seed(0), 256)
    for b in range(2):
        for i in np.unique(inst[b]):
            rows = drawn[b].numpy()[inst[b] == i]
            assert (rows == rows[0]).all()
            assert any(np.array_equal(rows[0], c) for c in centers)


def test_push_device_takes_the_feature_map():
    from ir2rgb_tpu_torch.infer import StreamingGenerator
    pm = create_model(_feat_cfg(PRESETS), device="cpu", seed=3)
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    feat = pm.encode_features(batch["b"], batch["inst"])
    stream = StreamingGenerator(pm, (SIZE, SIZE), batch=2)
    got = stream.push_device(batch["a"], feat=feat)
    assert torch.equal(got, pm.generate(batch["a"], feat=feat))
    zeros = pm.generate(batch["a"])
    assert torch.equal(zeros, pm.generate(batch["a"],
                                          feat=torch.zeros_like(feat)))
    assert not torch.equal(got, zeros)
    tcfg = PRESETS["temporal_256"]
    temporal = create_model(tcfg.replace(model=dataclasses.replace(
        tcfg.model, ngf=4, ndf=4, net_g="resnet_6blocks")), device="cpu")
    with pytest.raises(ValueError, match="single-frame"):
        StreamingGenerator(temporal, (SIZE, SIZE)).push_device(
            batch["a"][:1], feat=feat[:1])


def _folder(root, n=3, size=40):
    r = np.random.RandomState(6)
    for sub in ("A", "B", "Inst"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        for sub in ("A", "B"):
            Image.fromarray(r.randint(0, 256, (size, size, 3), np.uint8)
                            ).save(os.path.join(root, sub, f"{i:03d}.png"))
        ids = _voronoi(r, 1, size, cells=4, high=200)[0].astype(np.uint8)
        Image.fromarray(ids).save(os.path.join(root, "Inst", f"{i:03d}.png"))


def test_precompute_and_infer_cli_with_features(tmp_path, capsys):
    from ir2rgb_tpu_torch.cli import infer as pinfer
    from ir2rgb_tpu_torch.cli import precompute_feats
    from ir2rgb_tpu_torch.data import DataLoader, preprocess_pair_batch
    root = str(tmp_path / "data")
    _folder(root)
    argv = ["--model.model", "pix2pixhd", "--model.net_g", "global",
            "--model.ngf", "4", "--model.ndf", "4",
            "--model.n_downsample_global", "2", "--model.n_blocks_global",
            "1", "--model.use_instance_feat", "true", "--model.nef", "4",
            "--model.n_downsample_e", "2", "--loss.no_vgg_loss", "true",
            "--data.dataroot", root, "--data.load_size", "32",
            "--data.crop_size", "32", "--data.preprocess", "resize_and_crop",
            "--train.name", "feat", "--train.checkpoints_dir",
            str(tmp_path / "ckpts"), "--infer.n_clusters", "3"]
    cfg = parse_cli(argv)
    model = create_model(cfg, device="cpu", seed=4)
    mgr = CheckpointManager(os.path.join(cfg.run_dir(), "ckpt"))
    mgr.save(1, model.state_dict())
    mgr.wait()
    out = str(tmp_path / "feats.npz")
    assert precompute_feats.main(argv + ["--device", "cpu", "--out", out]
                                 ) == 0
    assert "-> 3 centers ->" in capsys.readouterr().out
    loader = DataLoader(cfg, phase=cfg.data.phase, shuffle=False)
    want = pfeat.kmeans(pfeat.collect_dataset_features(model,
                                                       loader.epoch()), 3)
    centers = pfeat.load_clusters(out)
    np.testing.assert_array_equal(centers, want)

    # test-time galleries: each frame against the model's own forward
    test_cfg = parse_cli(argv + ["--data.phase", "test"])
    frames = list(DataLoader(test_cfg.replace(data=dataclasses.replace(
        test_cfg.data, serial_batches=True, no_flip=True, batch_size=1)),
        phase="test", shuffle=False).epoch())

    def gallery(extra, name):
        res = tmp_path / name
        assert pinfer.main(argv + ["--device", "cpu", "--infer.results_dir",
                                   str(res)] + extra) == 0
        assert "frames: 3" in capsys.readouterr().out
        d = res / "feat" / "test_latest" / "images"
        return [np.asarray(Image.open(d / f"{i:03d}_generated.png"))
                for i in range(3)]

    by_cluster = gallery(["--infer.cluster_path", out], "clustered")
    by_image = gallery(["--infer.use_encoded_image", "true"], "encoded")
    plain = gallery([], "zeros")
    for i, host in enumerate(frames):
        batch = preprocess_pair_batch(
            *(torch.from_numpy(host[k]) for k in "ab"), None, crop_size=32,
            train=False, inst=torch.from_numpy(host["inst"]))
        a, b, inst = batch["a"], batch["b"], batch["inst"]
        styled = {"cluster": pfeat.sample_feature_map(
            inst, torch.from_numpy(centers), torch.Generator().manual_seed(i),
            model.enc_cfg.num_instances),
            "image": model.encode_features(b, inst)}
        for got, feat in ((by_cluster[i], styled["cluster"]),
                          (by_image[i], styled["image"])):
            y = model.generate(a, feat=feat)
            want = ((torch.clamp(y, -1, 1) + 1.0) * 127.5).to(torch.uint8)
            np.testing.assert_array_equal(got, want[0].numpy())
        assert not np.array_equal(by_image[i], plain[i])


@pytest.mark.parametrize("size", [512, 256])
def test_encoder_sends_chip_smokes_shapes(monkeypatch, size):
    """netE of ``pix2pixhd_512`` with ``use_instance_feat`` (nef 16, four
    downs) at full size on the meta device: what reaches B1 and B3's
    d2s, against ``chip_smoke.py``'s ``nete_forward`` (the netE rows of
    its ``NETE`` train-step tables)."""
    from collections import Counter
    from ir2rgb_tpu_torch.train.model import encoder_config
    from test_torch_port_serve_zoo import _chip_smoke, kernel_inputs
    cfg = PRESETS["pix2pixhd_512"]
    enc_cfg = encoder_config(cfg.replace(model=dataclasses.replace(
        cfg.model, use_instance_feat=True)))
    assert (enc_cfg.nef, enc_cfg.n_downsample_e) == (16, 4)

    def forward():
        with torch.device("meta"):
            return define_e(enc_cfg)(torch.empty((1, size, size, 3)))
    b1, _, d2s, y = kernel_inputs(monkeypatch, forward)
    assert tuple(y.shape) == (1, size, size, 3)
    want_b1, want_d2s = _chip_smoke().nete_forward(size)
    d2s = Counter(d2s)
    assert b1 == dict(want_b1) and d2s == dict(want_d2s)
