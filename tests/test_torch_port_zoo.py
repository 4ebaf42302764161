"""The port's generator zoo and the ops it adds, held to the JAX package on
the CPU on the same weights (JAX parameters converted by
``generator_state_dict_from_jax`` / ``discriminator_state_dict_from_jax``)
and the same numpy inputs, fp32: every ``net_g`` (ResNet-6/9, U-Net-128/256,
global, local with two enhancers) at narrow width, ResNet-9 and U-Net-256
at full width at 256 px, the batch and none norms, the resize-conv
upsampler, the flat PatchGAN; the k4 subpixel transposed conv, the pads,
resizes, batch norm and init types; the reference family's state_dict
keys; B1's launch plan at the new shapes. The bar is the repo's: atol 1e-4
and >= 40 dB unless stated."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ir2rgb_tpu.nn import ops as jops
from ir2rgb_tpu.nn.discriminators import DiscConfig as JDiscConfig
from ir2rgb_tpu.nn.discriminators import define_d as jax_define_d
from ir2rgb_tpu.nn.generators import GenConfig as JGenConfig
from ir2rgb_tpu.nn.generators import define_g as jax_define_g

from ir2rgb_tpu_torch.checkpoint import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from ir2rgb_tpu_torch.checkpoint.from_jax import conv_w, deconv_w
from ir2rgb_tpu_torch.nn import (
    DiscConfig,
    GenConfig,
    UnetGenerator,
    define_d,
    define_g,
    ops,
)

import torch_refs
from test_torch_port_kernels import _h100_like_clusters

pin = importlib.import_module("ir2rgb_tpu_torch.kernels.instance_norm")


def psnr(a, b, peak=2.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(peak * peak / mse) if mse > 0 else np.inf


def _params(init, seed):
    """numpy parameters in the tree ``init`` builds (read with
    ``jax.eval_shape``, which compiles nothing): conv and deconv kernels
    N(0, 0.02), biases and batch-norm betas N(0, 0.1), gammas
    1 + N(0, 0.1). The JAX init leaves biases and betas 0, which would
    test nothing of them."""
    rng = np.random.RandomState(seed)
    scale = {"w": 0.02, "b": 0.1, "beta": 0.1, "gamma": 0.1}

    def leaf(path, v):
        name = path[-1].key
        a = rng.randn(*v.shape) * scale[name] + (name == "gamma")
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(init, jax.random.PRNGKey(0)))


def _gen_pair(kw, size, batch=1, seed=0):
    """(port output, JAX output) of the generator ``kw`` names, on one
    numpy input and one set of weights."""
    jcfg = JGenConfig(**kw)
    init, apply = jax_define_g(jcfg)
    params = _params(init, seed)
    x = np.random.RandomState(seed + 1).uniform(
        -1, 1, (batch, size, size, kw.get("input_nc", 3))).astype(np.float32)
    y_j = np.asarray(jax.jit(apply)(params, jnp.asarray(x)))
    cfg = GenConfig(**kw)
    with torch.device("meta"):
        g = define_g(cfg)
    g.load_state_dict(generator_state_dict_from_jax(params, cfg), assign=True)
    with torch.no_grad():
        y_p = g.eval()(torch.from_numpy(x)).numpy()
    return y_p, y_j


NARROW = {
    "resnet_6blocks": (dict(ngf=8), 64),
    "resnet_9blocks": (dict(ngf=8), 64),
    "unet_128": (dict(ngf=8), 128),
    "unet_256": (dict(ngf=8), 256),
    "global": (dict(ngf=8, n_downsample_global=3, n_blocks_global=2), 64),
    "local": (dict(ngf=8, n_downsample_global=2, n_blocks_global=2,
                   n_blocks_local=1, n_local_enhancers=2), 64),
}
# (net_g, norm, upsample): every family at instance norm; batch (on a
# batch of 2, where it differs from instance norm) and none; resize-conv
CASES = ([(n, "instance", "deconv") for n in NARROW]
         + [(n, norm, "deconv") for norm in ("batch", "none")
            for n in ("resnet_6blocks", "unet_128", "global", "local")]
         + [(n, norm, "resize_conv") for n, norm in (
             ("resnet_6blocks", "instance"), ("global", "batch"),
             ("local", "none"))])


@pytest.mark.parametrize("net_g,norm,upsample", CASES)
def test_generator_matches_jax(net_g, norm, upsample):
    widths, size = NARROW[net_g]
    kw = dict(net_g=net_g, norm=norm, upsample=upsample, **widths)
    y_p, y_j = _gen_pair(kw, size, batch=2 if norm == "batch" else 1)
    assert y_p.shape == y_j.shape and y_p.shape[1:] == (size, size, 3)
    assert psnr(y_p, y_j) >= 40.0
    np.testing.assert_allclose(y_p, y_j, atol=1e-4)


@pytest.mark.parametrize("net_g", ["resnet_9blocks", "unet_256"])
def test_full_width_generator_matches_jax_at_256px(net_g):
    # resnet9_256's and pix2pix_unet256's generators (ngf 64); at 256 px
    # JAX runs its ResNet on the s2d rewrite, an exact rewrite
    y_p, y_j = _gen_pair(dict(net_g=net_g, ngf=64), 256)
    assert y_p.shape == y_j.shape == (1, 256, 256, 3)
    assert psnr(y_p, y_j) >= 40.0
    np.testing.assert_allclose(y_p, y_j, atol=1e-4)


def _port_keys(cfg):
    with torch.device("meta"):
        return list(define_g(cfg).state_dict())


@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("net_g,n_blocks", [("resnet_6blocks", 6),
                                            ("resnet_9blocks", 9)])
def test_resnet_keys_are_the_references(net_g, n_blocks, norm):
    # with batch norm the port, like the JAX package and the family's
    # ResnetBlock, has no bias on the residual blocks' convs; the compact
    # reference in torch_refs.py keeps one there (its ResnetBlock ignores
    # the bias rule): every other key is the reference's, in its order
    ref = list(torch_refs.ResnetGenerator(ngf=8, n_blocks=n_blocks,
                                          norm=norm).state_dict())
    if norm == "batch":
        ref = [k for k in ref if not (".conv_block." in k
                                      and k.endswith(".bias")
                                      and "running" not in k
                                      and k.split(".")[-2] in ("1", "5"))]
    assert _port_keys(GenConfig(net_g=net_g, ngf=8, norm=norm)) == ref


@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("net_g,num_downs", [("unet_128", 7),
                                             ("unet_256", 8)])
def test_unet_keys_are_the_references(net_g, num_downs, norm):
    ref = torch_refs.UnetGenerator(num_downs=num_downs, ngf=8, norm=norm)
    assert _port_keys(GenConfig(net_g=net_g, ngf=8, norm=norm)) == list(
        ref.state_dict())


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_reference_unet_loads_and_matches(norm):
    # the reference module's weights load strictly; plain fp32 torch on
    # both sides, the reference's batch norm on batch statistics (train
    # mode): the gap is the norm arithmetic (atol 1e-5)
    torch.manual_seed(0)
    ref = torch_refs.UnetGenerator(num_downs=7, ngf=8, norm=norm).train()
    cfg = GenConfig(net_g="unet_128", ngf=8, norm=norm)
    with torch.device("meta"):
        g = define_g(cfg)
    g.load_state_dict(ref.state_dict(), assign=True)
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (2, 3, 128, 128)).astype(np.float32))
    with torch.no_grad():
        y_ref = ref(x.clone()).permute(0, 2, 3, 1).numpy()
        y_p = g(x.permute(0, 2, 3, 1).contiguous()).numpy()
    np.testing.assert_allclose(y_p, y_ref, atol=1e-5)


def test_unet_levels_walk_the_nested_blocks():
    with torch.device("meta"):
        g = define_g(GenConfig(net_g="unet_256", ngf=8))
    levels = list(g.levels())
    assert isinstance(g, UnetGenerator) and len(levels) == 8
    assert [p for p, _ in levels[:3]] == ["model", "model.model.1",
                                          "model.model.1.model.3"]
    assert levels[0][1].outermost and levels[-1][1].innermost


# ---------------------------------------------------------------------------
# The discriminator's flat layout and its norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net_d,norm,interm", [
    ("n_layers", "instance", False), ("multiscale", "instance", False),
    ("n_layers", "batch", False), ("multiscale", "batch", True),
    ("n_layers", "none", True)])
def test_discriminator_matches_jax(net_d, norm, interm):
    kw = dict(net_d=net_d, input_nc=6, ndf=8, n_layers=3, num_d=2,
              norm=norm, get_interm_feat=interm)
    init, apply = jax_define_d(JDiscConfig(**kw))
    params = _params(init, 0)
    x = np.random.RandomState(1).uniform(
        -1, 1, (2, 64, 64, 6)).astype(np.float32)
    outs_j = apply(params, jnp.asarray(x))
    cfg = DiscConfig(**kw)
    with torch.device("meta"):
        d = define_d(cfg)
    d.load_state_dict(discriminator_state_dict_from_jax(params, cfg),
                      assign=True)
    with torch.no_grad():
        outs_p = d(torch.from_numpy(x))
    assert len(outs_p) == len(outs_j) == (2 if net_d == "multiscale" else 1)
    for sp, sj in zip(outs_p, outs_j):
        assert len(sp) == len(sj) == (5 if interm else 1)
        for tp, tj in zip(sp, sj):
            np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=1e-4)
        assert sp[-1].dtype == torch.float32


@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("net_d", ["n_layers", "multiscale"])
def test_flat_discriminator_is_the_references(net_d, norm):
    # the reference's get_interm_feat=False keys (``model.*`` and
    # ``layer{i}.*``) load strictly, and the outputs match (fp32 torch
    # both sides, batch norm on batch statistics: atol 1e-5)
    torch.manual_seed(0)
    if net_d == "n_layers":
        ref = torch_refs.NLayerDiscriminator(ndf=8, norm=norm,
                                             get_interm_feat=False)
    else:
        ref = torch_refs.MultiscaleDiscriminator(ndf=8, norm=norm,
                                                 get_interm_feat=False)
    with torch.device("meta"):
        d = define_d(DiscConfig(net_d=net_d, ndf=8, norm=norm,
                                get_interm_feat=False))
    assert list(d.state_dict()) == list(ref.state_dict())
    d.load_state_dict(ref.state_dict(), assign=True)
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (2, 48, 48, 6)).astype(np.float32))
    with torch.no_grad():
        outs_ref = ref.train()(x.permute(0, 3, 1, 2))
        outs_p = d(x)
    if net_d == "n_layers":
        outs_ref = [outs_ref]
    for sp, sr in zip(outs_p, outs_ref):
        np.testing.assert_allclose(sp[-1].numpy(),
                                   sr[-1].permute(0, 2, 3, 1).numpy(),
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

# (k, pad, output_padding): the U-Net's k4 p1 op0, the ResNet's k3 p1
# op1, geometries trimmed per dimension, and k4 p1 op1, which the plan
# does not admit (2h + 1 rows) and the dilated conv takes, as in JAX
DECONVS = [(4, 1, 0), (3, 1, 1), (3, 1, 0), (4, 2, 0), (5, 2, 1), (2, 0, 0),
           (4, 1, 1)]


@pytest.mark.parametrize("k,pad,op", DECONVS)
def test_deconv_matches_conv_transpose_and_jax(k, pad, op):
    rng = np.random.RandomState(k * 10 + pad + op)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    w_j = rng.randn(k, k, 6, 4).astype(np.float32)  # flipped HWIO
    b = rng.randn(4).astype(np.float32)
    w = torch.from_numpy(deconv_w(w_j))
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    y = ops.deconv(xt, w, bt, padding=pad, output_padding=op)
    want = F.conv_transpose2d(xt.permute(0, 3, 1, 2), w, bt, stride=2,
                              padding=pad, output_padding=op)
    np.testing.assert_allclose(y.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               atol=1e-5)
    y_j = jops.deconv_apply({"w": jnp.asarray(w_j), "b": jnp.asarray(b)},
                            jnp.asarray(x), stride=2, k=k, pad=pad,
                            output_padding=op)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5)
    assert ops.subpixel_admits(k, pad, op) == (k + op - 2 * pad <= 2)


def test_k4_subpixel_weight_is_a_dense_3x3():
    # the U-Net's up: a 3x3 conv to 4·cout phase channels (each tap of
    # the 4x4 kernel in exactly one phase, the rest zeros)
    w = torch.randn(6, 5, 4, 4)
    wk = ops.subpixel_weight(w, 1)
    assert tuple(wk.shape) == (20, 6, 3, 3)
    assert int((wk != 0).sum()) == w.numel()
    assert torch.equal(torch.sort(wk[wk != 0]).values,
                       torch.sort(w.reshape(-1)).values)


@pytest.mark.parametrize("pad", [1, 3])
def test_replicate_pad_matches_jax(pad):
    x = np.random.RandomState(pad).randn(2, 6, 5, 3).astype(np.float32)
    got = ops.replicate_pad(torch.from_numpy(x), pad).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jops.replicate_pad(jnp.asarray(x), pad)))


@pytest.mark.parametrize("scale", [2, 3])
def test_resize_nearest_matches_jax(scale):
    x = np.random.RandomState(scale).randn(2, 5, 4, 3).astype(np.float32)
    got = ops.resize_nearest(torch.from_numpy(x), scale).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jops.resize_nearest(jnp.asarray(x), scale)))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out_hw", [(29, 37), (11, 7), (1, 16)])
def test_resize_bilinear_matches_jax(out_hw, align_corners):
    # up, down (the triangle kernel widened, antialiased) and a single
    # row; fp32 both sides
    x = np.random.RandomState(4).randn(2, 16, 20, 3).astype(np.float32)
    got = ops.resize_bilinear(torch.from_numpy(x), out_hw,
                              align_corners).numpy()
    want = np.asarray(jops.resize_bilinear(jnp.asarray(x), out_hw,
                                           align_corners))
    assert got.shape == want.shape == (2,) + out_hw + (3,)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("running", [False, True])
def test_batch_norm_matches_jax(running):
    rng = np.random.RandomState(5)
    x = (rng.randn(3, 6, 5, 8) * 2 + 1).astype(np.float32)
    p = {k: rng.randn(8).astype(np.float32) for k in
         ("gamma", "beta", "running_mean")}
    p["running_var"] = rng.uniform(0.5, 2, 8).astype(np.float32)
    want = np.asarray(jops.batch_norm({k: jnp.asarray(v) for k, v in
                                       p.items()}, jnp.asarray(x),
                                      use_running_stats=running))
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = ops.batch_norm(torch.from_numpy(x), t["gamma"], t["beta"],
                         running_mean=t["running_mean"],
                         running_var=t["running_var"],
                         use_running_stats=running).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_batch_norm_layer_keeps_its_running_stats():
    # the generators never call BatchNorm2d.forward: no running stat moves
    with torch.device("meta"):
        g = define_g(GenConfig(net_g="resnet_6blocks", ngf=8, norm="batch"))
    g = g.to_empty(device="cpu")
    from ir2rgb_tpu_torch.nn.generators import init_weights
    init_weights(g, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in g.state_dict().items()
              if "running" in k or "tracked" in k}
    g(torch.rand(2, 32, 32, 3), train=True).sum().backward()
    after = g.state_dict()
    assert before and all(torch.equal(v, after[k]) for k, v in before.items())


def test_dropout_keeps_half_and_scales():
    x = torch.ones(200_000)
    y = ops.dropout(x, 0.5, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    y2 = ops.dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)


def _init_pair(init_type):
    """The port's re-drawn conv (64 -> 128, k3) and deconv (128 -> 32, k4)
    weights, and JAX's of the same layers in torch layout."""
    net = torch.nn.Sequential(torch.nn.Conv2d(64, 128, 3),
                              torch.nn.ConvTranspose2d(128, 32, 4))
    ops.apply_init_type(net, init_type, torch.Generator().manual_seed(0))
    tree = {"conv": {"w": jnp.zeros((3, 3, 64, 128))},
            "up": {"w": jnp.zeros((4, 4, 128, 32))}}
    jt = jops.apply_init_type(tree, jax.random.PRNGKey(0), init_type,
                              deconv_parents=("up",))
    want = [conv_w(np.asarray(jt["conv"]["w"])),
            deconv_w(np.asarray(jt["up"]["w"]))]
    return [net[0].weight.detach().numpy(),
            net[1].weight.detach().numpy()], want


@pytest.mark.parametrize("init_type,stds", [
    # torch's fans off the stored weight: conv fan_in 64·9, fan_out
    # 128·9; deconv (IOHW) fan_in 32·16, fan_out 128·16
    ("xavier", (0.02 * (2 / (576 + 1152)) ** 0.5,
                0.02 * (2 / (512 + 2048)) ** 0.5)),
    ("kaiming", ((2 / 576) ** 0.5, (2 / 512) ** 0.5))])
def test_init_type_std_per_fan_matches_jax(init_type, stds):
    got, want = _init_pair(init_type)
    for g, w, std in zip(got, want, stds):
        assert abs(g.std() / std - 1) < 0.03
        assert abs(g.std() / w.std() - 1) < 0.04
        assert abs(g.mean()) < 0.02 * std


def test_init_type_orthogonal_matches_jax():
    # rows (dim 0: the conv's cout, the deconv's cin) orthonormal times
    # the gain 0.02, on both sides
    got, want = _init_pair("orthogonal")
    for g, w in zip(got, want):
        for m in (g, w):
            mat = m.reshape(m.shape[0], -1).astype(np.float64) / 0.02
            np.testing.assert_allclose(mat @ mat.T, np.eye(m.shape[0]),
                                       atol=1e-5)


def test_init_type_normal_and_unknown():
    net = torch.nn.Conv2d(4, 4, 3)
    w0 = net.weight.detach().clone()
    ops.apply_init_type(net, "normal", torch.Generator())
    assert torch.equal(net.weight, w0)
    with pytest.raises(ValueError):
        ops.apply_init_type(net, "uniform", torch.Generator())


# ---------------------------------------------------------------------------
# B1's plan at the shapes the new generators send it
# ---------------------------------------------------------------------------

# every B1 shape of the new presets' frames (resnet9_256, global_512, the
# 1024 and 2048 enhancers, the U-Net's slabs down to 2x2) -> the plan the
# H100 took there, (group channels, K, route) in bf16 and in fp32
# (chip_smoke.py on an H100 80GB HBM3 at 700 W)
B1_NEW_PLANS = {
    (1, 64, 64, 256): ((32, 8, "smem"), (16, 4, "smem")),
    (1, 512, 512, 64): ((16, 16, "l2"), (16, 16, "l2")),
    (1, 256, 256, 128): ((32, 16, "l2"), (16, 8, "l2")),
    (1, 128, 128, 256): ((32, 8, "smem"), (16, 16, "smem")),
    (1, 64, 64, 512): ((32, 4, "smem"), (16, 2, "smem")),
    (1, 32, 32, 1024): ((32, 2, "smem"), (16, 1, "smem")),
    (1, 1024, 1024, 32): ((8, 16, "l2"), (8, 16, "l2")),
    (1, 2048, 2048, 16): ((4, 16, "l2"), (4, 16, "l2")),
    (1, 128, 128, 64): ((16, 16, "smem"), (16, 16, "smem")),
    (1, 64, 64, 128): ((32, 16, "smem"), (16, 8, "smem")),
    (1, 32, 32, 256): ((32, 8, "smem"), (16, 4, "smem")),
    (1, 16, 16, 512): ((32, 4, "smem"), (16, 2, "smem")),
    (1, 8, 8, 512): ((32, 4, "smem"), (16, 2, "smem")),
    (1, 4, 4, 512): ((32, 4, "smem"), (16, 2, "smem")),
    (1, 2, 2, 512): ((32, 4, "smem"), (16, 2, "smem")),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", sorted(B1_NEW_PLANS))
def test_b1_plan_at_new_shapes(shape, dtype):
    # the forward plan under the modelled H100 is the card's, covers every
    # (channel, pixel) once with no empty block, fits the shared memory
    # and runs in one wave; at the U-Net's tiny slabs (4 to 64 pixels)
    # that is one small cluster per channel group
    n, h, w, c = shape
    hw, item = h * w, torch.empty((), dtype=dtype).element_size()
    clusters = _h100_like_clusters(False)
    p = pin._plan(n, hw, c, item, False, clusters)
    want = B1_NEW_PLANS[shape][dtype == torch.float32]
    assert (p.channels, p.k, p.route) == want
    assert p.groups * p.channels == c and p.channels * item <= 64
    assert (p.k - 1) * p.share < hw <= p.k * p.share
    assert p.smem_bytes <= 232_448 and n * p.groups <= clusters(p)
