"""Serving the zoo through the port's entry points, held to the JAX
package on the CPU: the presets, ``create_model`` + ``generate`` for each,
the label one-hot and the instance-edge channel through ``generate``,
``instance_edges``, ``translate_clip``, ``label2im`` and label frames on
the uint8 wire; and, on the meta device, the kernel launches of one
frame of every preset against the tables ``chip_smoke.py`` checks on the
card. fp32; atol 1e-4 unless stated."""

import dataclasses
import importlib.util
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.config import PRESETS as JAX_PRESETS
from ir2rgb_tpu.config import Config as JConfig
from ir2rgb_tpu.config import LossConfig as JLossConfig
from ir2rgb_tpu.config import ModelConfig as JModelConfig
from ir2rgb_tpu.infer import stream as jstream
from ir2rgb_tpu.nn.encoders import instance_edges as jax_instance_edges
from ir2rgb_tpu.train import create_model as jax_create_model

from ir2rgb_tpu_torch.checkpoint import generator_state_dict_from_jax
from ir2rgb_tpu_torch.config import PRESETS, Config, LossConfig, ModelConfig
from ir2rgb_tpu_torch.infer import StreamingGenerator, label2im, translate_clip
from ir2rgb_tpu_torch.nn import define_g, instance_edges
from ir2rgb_tpu_torch.train import create_model, network_configs

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def test_presets_are_the_jax_packages_but_cyclegan():
    # every preset of the JAX package, cyclegan_256 (train/cycle.py)
    # included since the CycleGAN model is ported
    assert set(PRESETS) == set(JAX_PRESETS)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_fields_equal_jax(name):
    # every field the port keeps, section by section, has JAX's value
    got, want = PRESETS[name], JAX_PRESETS[name]
    for section in ("model", "data", "loss", "train", "infer"):
        g, w = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(w, f.name), (section, f.name)


# the smallest frame each preset's generator takes whose every reflect
# pad has two rows to reflect (the U-Net needs 2^8)
SMALL_FRAME = {"pix2pix_unet256": 256, "pix2pixhd_2048": 128}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_every_preset_builds_and_generates_on_the_cpu(name):
    # full width, the seeded reference init; a small frame
    cfg = PRESETS[name]
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="VGG perceptual loss")
        model = create_model(cfg, device="cpu")
    size = SMALL_FRAME.get(name, 64)
    a = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (1, size, size, cfg.model.input_nc)).astype(np.float32))
    y = model.generate(a)
    assert tuple(y.shape) == (1, size, size, 3) and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) <= 1.0


# ---------------------------------------------------------------------------
# Kernel launches of one served frame, on the meta device
# ---------------------------------------------------------------------------

# (B1, B2, B3 d2s) launches of one frame, counted from the generators'
# layers: one B1 an instance norm, one B2 a ResNet tail, one d2s an up
LAUNCHES = {"resnet9_256": (23, 1, 2), "temporal_256": (23, 1, 2),
            "cyclegan_256": (23, 1, 2),
            "pix2pixhd_global_512": (27, 1, 4),
            "pix2pixhd_512": (36, 1, 5), "temporal_512": (36, 1, 5),
            "pix2pixhd_1024": (36, 1, 5), "temporal_1024": (36, 1, 5),
            "pix2pixhd_2048": (45, 1, 6), "pix2pix_unet256": (13, 0, 8)}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_frame_sends_chip_smokes_shapes_to_the_kernels(monkeypatch, name):
    # a full-size frame on the meta device (shapes only), recording what
    # reaches each kernel wrapper; chip_smoke.py counts the same launches
    # on the card and times its kernels at these shapes
    from ir2rgb_tpu_torch import kernels
    from ir2rgb_tpu_torch.nn import ops
    b1, tails, d2s = {}, [], []

    def norm(x, act, negative_slope=0.2):
        key = (tuple(x.shape), act)
        b1[key] = b1.get(key, 0) + 1
        return x

    def tail(x, w, b):
        tails.append(tuple(x.shape))
        return x[..., :3]

    def interleave(y, c):
        d2s.append((tuple(y.shape), c))
        n, h, w, _ = y.shape
        return y.new_empty((n, 2 * h, 2 * w, c))

    monkeypatch.setattr(ops, "fused_instance_norm_act", norm)
    monkeypatch.setattr(kernels, "tail_fused", tail)
    monkeypatch.setattr(ops, "d2s_fn", interleave)
    gen_cfg, _ = network_configs(PRESETS[name])
    size = PRESETS[name].data.crop_size
    with torch.device("meta"):
        y = define_g(gen_cfg)(torch.empty((1, size, size,
                                           gen_cfg.input_nc)))
    assert tuple(y.shape) == (1, size, size, 3)
    table = _chip_smoke().SERVE[name]
    assert b1 == table["b1"] and tails == table["tail"]
    assert d2s == table["d2s"]
    assert (sum(b1.values()), len(tails), len(d2s)) == LAUNCHES[name]


# ---------------------------------------------------------------------------
# Label and edge inputs
# ---------------------------------------------------------------------------

LABEL_NC = 5
NARROW = dict(ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=1,
              n_blocks_local=1)


def _jax_params(init, seed=0):
    """numpy parameters in ``init``'s tree (``jax.eval_shape``: nothing
    compiled), kernels N(0, 0.02), biases N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def leaf(path, v):
        s = 0.02 if path[-1].key == "w" else 0.1
        return (rng.randn(*v.shape) * s).astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(init, jax.random.PRNGKey(0)))


def _models(model_kw, seed=0):
    """A JAX model, its numpy G params, and the port's model on the CPU
    with those weights; no VGG."""
    jcfg = JConfig(model=JModelConfig(**model_kw),
                   loss=JLossConfig(no_vgg_loss=True))
    jm = jax_create_model(jcfg)
    params = _jax_params(jm.g_init, seed)
    pm = create_model(Config(model=ModelConfig(**model_kw),
                             loss=LossConfig(no_vgg_loss=True)),
                      device="cpu")
    pm.netG.load_state_dict(generator_state_dict_from_jax(params,
                                                          pm.gen_cfg))
    return jm, params, pm


def _ids(shape, seed, hi=LABEL_NC + 2):
    """Class-id maps with ids past label_nc and halves (rounded to even)."""
    r = np.random.RandomState(seed)
    return (r.randint(0, 2 * hi, shape) / 2.0).astype(np.float32)


def _inst(shape, seed):
    """Instance-id maps: a few rectangles of distinct ids."""
    r = np.random.RandomState(seed)
    inst = np.zeros(shape, np.int32)
    for k in range(1, 6):
        y0, x0 = r.randint(0, shape[1] - 4), r.randint(0, shape[2] - 4)
        inst[:, y0:y0 + r.randint(2, 12), x0:x0 + r.randint(2, 12)] = k
    return inst


def test_instance_edges_bit_for_bit():
    inst = _inst((2, 24, 20), 0)
    want = np.asarray(jax_instance_edges(jnp.asarray(inst)))
    got = instance_edges(torch.from_numpy(inst)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 24, 20, 1)
    np.testing.assert_array_equal(got, want)


def test_encode_label_matches_jax():
    jm, _, pm = _models(dict(model="pix2pixhd", net_g="resnet_6blocks",
                             label_nc=LABEL_NC, **NARROW))
    a = _ids((2, 8, 8, 1), 1)
    want = np.asarray(jm.encode_label(jnp.asarray(a)))
    got = pm.encode_label(torch.from_numpy(a)).numpy()
    assert got.shape == (2, 8, 8, LABEL_NC)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == 0).any()  # ids >= label_nc: all-zero rows


@pytest.mark.parametrize("net_g,edges", [("resnet_6blocks", True),
                                         ("local", True),
                                         ("resnet_6blocks", None)])
def test_label_and_edge_input_through_generate_matches_jax(net_g, edges):
    # one-hot of the ids, then the edge channel (zeros when not given), in
    # JAX's channel order, through G
    jm, params, pm = _models(dict(model="pix2pixhd", net_g=net_g,
                                  label_nc=LABEL_NC,
                                  use_instance_edges=True, **NARROW))
    assert pm.gen_cfg.input_nc == pm.disc_cfg.input_nc - 3 == LABEL_NC + 1
    a = _ids((1, 32, 32, 1), 2)
    e = (np.asarray(jax_instance_edges(jnp.asarray(_inst((1, 32, 32), 3))))
         if edges else None)
    want = np.asarray(jax.jit(lambda p, a, e: jm.generate(p, a, edges=e))(
        params, jnp.asarray(a), None if e is None else jnp.asarray(e)))
    got = pm.generate(torch.from_numpy(a), edges=None if e is None
                      else torch.from_numpy(e.copy())).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_label_frames_stream_as_raw_ids():
    # uint8 id frames on the wire are ids, not [-1, 1] levels; and the
    # single-frame step takes an edge map (JAX's step_extra)
    kw = dict(model="pix2pixhd", net_g="resnet_6blocks", label_nc=LABEL_NC,
              use_instance_edges=True, **NARROW)
    jm, params, pm = _models(kw)
    frames = [np.random.RandomState(s).randint(
        0, LABEL_NC + 2, (32, 32, 1)).astype(np.uint8) for s in range(3)]
    js = jstream.StreamingGenerator(jm, params, (32, 32))
    ps = StreamingGenerator(pm, (32, 32))
    # fp32 both sides: the uint8 wire may differ by one level where a
    # float lands next to a quantisation boundary (normalised ids would
    # land far from JAX's frames)
    for f, got in zip(frames, ps.stream(frames)):
        want = js.push(f)
        assert got.dtype == np.uint8 and got.shape == (32, 32, 3)
        assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() \
            <= 1
    e = np.asarray(jax_instance_edges(jnp.asarray(_inst((1, 32, 32), 4))))
    a = frames[0][None].astype(np.float32)
    want = np.asarray(js.push_device(jnp.asarray(a), edges=jnp.asarray(e)))
    got = ps.push_device(torch.from_numpy(a),
                         edges=torch.from_numpy(e.copy()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_edges_are_not_a_temporal_input():
    pm = create_model(Config(model=ModelConfig(
        model="temporal", net_g="resnet_6blocks", **NARROW),
        loss=LossConfig(no_vgg_loss=True)), device="cpu")
    with pytest.raises(ValueError):
        StreamingGenerator(pm, (16, 16)).push_device(
            torch.zeros(1, 16, 16, 3), edges=torch.zeros(1, 16, 16, 1))
    with pytest.raises(ValueError):
        create_model(Config(model=ModelConfig(
            model="temporal", net_g="resnet_6blocks", label_nc=4)),
            device="cpu")


@pytest.mark.parametrize("field,value", [("label_nc", LABEL_NC),
                                         ("use_instance_edges", True),
                                         ("use_dropout", True)])
def test_label_edge_and_dropout_models_train_and_serve(field, value):
    # label and edge inputs and dropout serve and train (held to JAX in
    # tests/test_torch_port_train_options.py)
    kw = dict(model="pix2pix", net_g="resnet_6blocks", **NARROW)
    kw[field] = value
    pm = create_model(Config(model=ModelConfig(**kw),
                             loss=LossConfig(no_vgg_loss=True)), device="cpu")
    nc = 1 if field == "label_nc" else 3
    batch = {"a": torch.from_numpy(_ids((1, 16, 16, 1), 0)) if nc == 1
             else torch.zeros((1, 16, 16, 3)),
             "b": torch.zeros((1, 16, 16, 3)),
             "inst": torch.from_numpy(_inst((1, 16, 16), 1))}
    metrics = pm.train_step(batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert pm.step == 1
    assert pm.generate(batch["a"]).shape == (1, 16, 16, 3)


# ---------------------------------------------------------------------------
# Whole clips and label galleries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["temporal", "pix2pixhd"])
def test_translate_clip_matches_jax(model):
    # the temporal model carries its last frames (fp32) through the clip
    jm, params, pm = _models(dict(model=model, net_g="resnet_6blocks",
                                  **NARROW))
    seq = np.random.RandomState(5).uniform(
        -1, 1, (3, 1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jstream.translate_clip(jm, params, jnp.asarray(seq)))
    got = translate_clip(pm, torch.from_numpy(seq)).numpy()
    assert got.shape == want.shape == (3, 1, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 12, 10, 1), (12, 10), (2, 6, 5)])
def test_label2im_bit_for_bit(shape):
    ids = _ids(shape, 6, hi=30) - 2.0  # negatives and ids past label_nc
    want = jstream.label2im(jnp.asarray(ids), 21)
    got = label2im(torch.from_numpy(ids), 21)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(label2im(ids, 21), want)
