"""The port's streaming inference held to the JAX package's on the CPU:
the uint8 wire functions bit for bit, and StreamingGenerator (temporal
carry and single-frame) frame by frame on the same weights and frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.config import Config as JaxConfig
from ir2rgb_tpu.config import LossConfig
from ir2rgb_tpu.config import ModelConfig as JaxModelConfig
from ir2rgb_tpu.infer import stream as jstream
from ir2rgb_tpu.train import create_model as jax_create_model

from ir2rgb_tpu_torch.checkpoint import generator_state_dict_from_jax
from ir2rgb_tpu_torch.config import Config, ModelConfig
from ir2rgb_tpu_torch.infer import stream as pstream
from ir2rgb_tpu_torch.train import create_model

SIZE = 64
ARCH = dict(net_g="local", ngf=8, n_downsample_global=2, n_blocks_global=2,
            n_blocks_local=1)


def test_dev_normalize_bit_identical_on_all_uint8():
    a = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    want = np.asarray(jstream._dev_normalize(jnp.asarray(a)))
    got = pstream._dev_normalize(torch.from_numpy(a)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got, a.astype(np.float32) / 127.5 - 1.0)


def test_dev_quantize_bit_identical():
    r = np.random.RandomState(0)
    f = np.concatenate([r.uniform(-1.2, 1.2, 4096),
                        (np.arange(256) / 127.5 - 1.0),  # exact levels
                        [-1.0, 1.0, 0.0, -0.0, 2.0, -2.0]]).astype(np.float32)
    want = np.asarray(jstream._dev_quantize(jnp.asarray(f)))
    got = pstream._dev_quantize(torch.from_numpy(f)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("label", [False, True])
def test_host_to_wire_u8_matches(label):
    r = np.random.RandomState(1)
    a = (r.uniform(-3, 300, (8, 8, 3)) if label
         else r.uniform(-1.5, 1.5, (8, 8, 3))).astype(np.float32)
    np.testing.assert_array_equal(pstream.host_to_wire_u8(a, label),
                                  jstream.host_to_wire_u8(a, label))


def test_tensor2im_matches():
    f = np.random.RandomState(2).uniform(-1.2, 1.2,
                                         (1, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(pstream.tensor2im(torch.from_numpy(f)),
                                  jstream.tensor2im(jnp.asarray(f)))
    assert pstream.tensor2im(torch.zeros((3, 4, 4, 3))).shape == (3, 4, 4, 3)


def _models(model_kind):
    jcfg = JaxConfig(model=JaxModelConfig(model=model_kind, net_d="n_layers",
                                          ndf=8, n_frames_g=2, **ARCH),
                     loss=LossConfig(no_vgg_loss=True))
    jmodel = jax_create_model(jcfg, steps_per_epoch=10)
    g_params = jmodel.g_init(jax.random.PRNGKey(0))
    pmodel = create_model(Config(model=ModelConfig(model=model_kind,
                                                   n_frames_g=2, **ARCH)),
                          device="cpu")
    sd = generator_state_dict_from_jax(jax.tree.map(np.asarray, g_params),
                                       pmodel.gen_cfg)
    pmodel.netG.load_state_dict(sd)
    return jmodel, g_params, pmodel


@pytest.mark.parametrize("model_kind", ["temporal", "pix2pixhd"])
def test_streaming_generator_matches_jax(model_kind):
    # fp32 on both sides: device floats to atol 1e-4 (summation order
    # only); the uint8 wire may differ by one level where a float lands
    # next to a quantisation boundary
    jmodel, g_params, pmodel = _models(model_kind)
    r = np.random.RandomState(3)
    frames = [(r.rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
              for _ in range(4)]
    floats = [f[None].astype(np.float32) / 127.5 - 1.0 for f in frames]

    js = jstream.StreamingGenerator(jmodel, g_params, (SIZE, SIZE))
    ps = pstream.StreamingGenerator(pmodel, (SIZE, SIZE))
    for f in floats:
        y_j = np.asarray(js.push_device(jnp.asarray(f)))
        y_p = ps.push_device(torch.from_numpy(f)).numpy()
        np.testing.assert_allclose(y_p, y_j, atol=1e-4)
    if model_kind == "temporal":
        assert ps.carry.shape == (1, SIZE, SIZE, 3)

    js = jstream.StreamingGenerator(jmodel, g_params, (SIZE, SIZE))
    ps = pstream.StreamingGenerator(pmodel, (SIZE, SIZE))
    for u_j, u_p in zip(js.stream(frames), ps.stream(frames)):
        assert u_p.dtype == np.uint8 and u_p.shape == (SIZE, SIZE, 3)
        assert np.abs(u_p.astype(np.int16) - u_j.astype(np.int16)).max() <= 1


def test_pipelined_stream_matches_push_and_reset_clears_history():
    _, _, pmodel = _models("temporal")
    r = np.random.RandomState(4)
    frames = [(r.rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
              for _ in range(3)]
    s1 = pstream.StreamingGenerator(pmodel, (SIZE, SIZE))
    seq = [s1.push(f) for f in frames]
    s2 = pstream.StreamingGenerator(pmodel, (SIZE, SIZE))
    for a, b in zip(seq, s2.stream(frames)):
        np.testing.assert_array_equal(a, b)
    s2.reset()
    np.testing.assert_array_equal(s2.push(frames[0]), seq[0])
    # the carry is live: frame 1 after frame 0 differs from frame 1 alone
    s2.reset()
    assert np.abs(s2.push(frames[1]).astype(np.int16)
                  - seq[1].astype(np.int16)).max() > 0
