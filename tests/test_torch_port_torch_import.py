"""The port's reference ``.pth`` import (checkpoint/torch_import.py) held
to the JAX package's: the same reference checkpoints (tests/torch_refs.py)
go through JAX's import_generator / import_discriminator and the port's,
and both networks run one seeded input; fp32 outputs agree within atol
1e-4. A truncated checkpoint raises on both sides; convert_vgg19_pth
writes the JAX converter's npz."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.checkpoint import torch_import as jti
from ir2rgb_tpu.nn import DiscConfig as JDiscConfig
from ir2rgb_tpu.nn import GenConfig as JGenConfig
from ir2rgb_tpu.nn import define_d as jdefine_d
from ir2rgb_tpu.nn import define_g as jdefine_g
from ir2rgb_tpu.nn.generators import resnet_generator_apply

from ir2rgb_tpu_torch.checkpoint import torch_import as pti
from ir2rgb_tpu_torch.nn.discriminators import DiscConfig, define_d
from ir2rgb_tpu_torch.nn.generators import GenConfig, ResnetGenerator, define_g

import torch_refs

ATOL = 1e-4


def _np_sd(model):
    return collections.OrderedDict((k, v.detach().numpy())
                                   for k, v in model.state_dict().items())


def _seeded(t: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Reference weights drawn from a numpy seed (biases and batch-norm
    betas nonzero too, so that a dropped or misplaced one shows)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for k, v in t.state_dict().items():
            if v.is_floating_point() and "running" not in k:
                scale = 0.2 if v.dim() > 1 else 0.1
                base = 1.0 if (v.dim() == 1 and k.endswith(".weight")) else 0
                v.copy_(torch.from_numpy(
                    (base + scale * rng.standard_normal(v.shape))
                    .astype(np.float32)))
    return t


def _input(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _port_g(cfg, sd, n_blocks=None):
    if n_blocks is None:
        g = define_g(cfg)
    else:
        g = ResnetGenerator(cfg.input_nc, cfg.output_nc, cfg.ngf, n_blocks,
                            2, cfg.norm, compute_dtype=torch.float32)
    g.load_state_dict(sd)
    return g


GENERATORS = {
    # name: (reference module, port / JAX config kwargs, size, n_blocks)
    "resnet_instance": (lambda: torch_refs.ResnetGenerator(
        ngf=8, n_blocks=3, norm="instance"),
        dict(net_g="resnet_9blocks", ngf=8, norm="instance"), 32, 3),
    # the compact block keeps a conv bias under batch norm: dropped by
    # the port (the norm's batch mean cancels it), applied by JAX
    "resnet_batch": (lambda: torch_refs.ResnetGenerator(
        ngf=8, n_blocks=3, norm="batch"),
        dict(net_g="resnet_9blocks", ngf=8, norm="batch"), 32, 3),
    "global": (lambda: torch_refs.ResnetGenerator(
        ngf=4, n_blocks=2, n_downsampling=3, norm="instance"),
        dict(net_g="global", ngf=4, n_downsample_global=3,
             n_blocks_global=2), 64, None),
    "local": (lambda: torch_refs.LocalEnhancer(
        ngf=4, n_downsample_global=2, n_blocks_global=2, n_blocks_local=1),
        dict(net_g="local", ngf=4, n_downsample_global=2, n_blocks_global=2,
             n_blocks_local=1, n_local_enhancers=1), 64, None),
    "local_two_levels": (lambda: torch_refs.LocalEnhancer(
        ngf=4, n_downsample_global=2, n_blocks_global=1, n_blocks_local=1,
        n_local_enhancers=2),
        dict(net_g="local", ngf=4, n_downsample_global=2, n_blocks_global=1,
             n_blocks_local=1, n_local_enhancers=2), 64, None),
    "unet_128": (lambda: torch_refs.UnetGenerator(num_downs=7, ngf=4),
                 dict(net_g="unet_128", ngf=4), 128, None),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_import_matches_jax(name, tmp_path):
    make, kw, size, n_blocks = GENERATORS[name]
    t = _seeded(make(), seed=len(name))
    pth = str(tmp_path / "G.pth")
    torch.save(t.state_dict(), pth)
    x = _input((1, size, size, 3), seed=1)

    jcfg = JGenConfig(**kw)
    jparams = jti.import_generator(_np_sd(t), jcfg,
                                   **({} if n_blocks is None
                                      else {"n_blocks": n_blocks}))
    if n_blocks is None:
        y_j = jdefine_g(jcfg)[1](jparams, jnp.asarray(x))
    else:
        y_j = resnet_generator_apply(jparams, jnp.asarray(x), jcfg,
                                     n_blocks=n_blocks)

    pcfg = GenConfig(**kw)
    sd = pti.import_generator(pth, pcfg, n_blocks=n_blocks)
    g = _port_g(pcfg, sd, n_blocks)
    with torch.no_grad():
        y_p = g(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_p, np.asarray(y_j), atol=ATOL)
    # and the reference module itself (batch norm: batch statistics)
    with torch.no_grad():
        y_t = t.train(kw.get("norm") == "batch")(
            torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(y_p, y_t.transpose(0, 2, 3, 1), atol=ATOL)


@pytest.mark.parametrize("net_d,num_d", [("n_layers", 1), ("multiscale", 2),
                                         ("multiscale", 3)])
def test_discriminator_import_matches_jax(net_d, num_d):
    if net_d == "n_layers":
        t = torch_refs.NLayerDiscriminator(input_nc=6, ndf=8)
    else:
        t = torch_refs.MultiscaleDiscriminator(input_nc=6, ndf=8,
                                               num_d=num_d)
    t = _seeded(t, seed=num_d)
    kw = dict(net_d=net_d, input_nc=6, ndf=8, num_d=num_d)
    x = _input((1, 64, 64, 6), seed=2)
    jparams = jti.import_discriminator(_np_sd(t), JDiscConfig(**kw))
    out_j = jdefine_d(JDiscConfig(**kw))[1](jparams, jnp.asarray(x))
    d = define_d(DiscConfig(**kw))
    d.load_state_dict(pti.import_discriminator(t.state_dict(),
                                               DiscConfig(**kw)))
    with torch.no_grad():
        out_p = d(torch.from_numpy(x))
    assert len(out_p) == len(out_j)
    for scale_p, scale_j in zip(out_p, out_j):
        assert len(scale_p) == len(scale_j)
        for fp, fj in zip(scale_p, scale_j):
            np.testing.assert_allclose(fp.numpy(), np.asarray(fj),
                                       atol=ATOL)


def test_flat_multiscale_checkpoint_fills_interm_feat_module():
    """A checkpoint without intermediate features (``layer{i}`` keys) fills
    the port's ``scale{i}_layer{j}`` module, scale for scale."""
    flat = _seeded(torch_refs.MultiscaleDiscriminator(
        input_nc=6, ndf=8, num_d=2, get_interm_feat=False), seed=5)
    interm = torch_refs.MultiscaleDiscriminator(input_nc=6, ndf=8, num_d=2)
    sd = pti.import_discriminator(flat.state_dict(),
                                  DiscConfig(net_d="multiscale", input_nc=6,
                                             ndf=8, num_d=2))
    flat_convs = [v for k, v in flat.state_dict().items()]
    assert list(sd) == list(interm.state_dict())
    for a, b in zip(sd.values(), flat_convs):
        assert torch.equal(a, b)


def test_truncated_checkpoint_raises_on_both_sides(tmp_path):
    t = torch_refs.ResnetGenerator(ngf=8, n_blocks=3)
    sd = collections.OrderedDict(list(t.state_dict().items())[:-4])
    pth = str(tmp_path / "truncated.pth")
    torch.save(sd, pth)
    with pytest.raises(ValueError, match="conv count mismatch"):
        jti.import_generator(jti.load_state_dict(pth),
                             JGenConfig(net_g="resnet_9blocks", ngf=8),
                             n_blocks=3)
    with pytest.raises(ValueError, match="conv count mismatch"):
        pti.import_generator(pth, GenConfig(net_g="resnet_9blocks", ngf=8),
                             n_blocks=3)


def test_mismatches_name_both_sides():
    t = torch_refs.ResnetGenerator(ngf=8, n_blocks=3, norm="batch")
    with pytest.raises(ValueError, match="norm count mismatch"):
        pti.import_generator(t.state_dict(),
                             GenConfig(net_g="resnet_9blocks", ngf=8),
                             n_blocks=3)
    wide = torch_refs.ResnetGenerator(ngf=16, n_blocks=3)
    with pytest.raises(ValueError, match=r"checkpoint model\.1\.weight "
                       r"\(16, 3, 7, 7\) for module model\.1\.weight "
                       r"\(8, 3, 7, 7\)"):
        pti.import_generator(wide.state_dict(),
                             GenConfig(net_g="resnet_9blocks", ngf=8),
                             n_blocks=3)


def test_clean_port_state_dict_round_trips():
    """A port module's own state_dict (reference keys) imports as itself."""
    cfg = GenConfig(net_g="local", ngf=4, n_downsample_global=2,
                    n_blocks_global=1, n_blocks_local=1, norm="batch")
    g = _seeded(define_g(cfg), seed=9)
    sd = pti.import_generator(g.state_dict(), cfg)
    assert list(sd) == list(g.state_dict())
    for k, v in g.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_convert_vgg19_pth_matches_jax(tmp_path):
    """A torchvision-layout vgg19 state_dict (16 convs in ``features``,
    then the classifier) converts to the same npz on both sides."""
    rng = np.random.RandomState(3)
    chans = [3, 8, 8, 16, 16, 16, 16, 16, 16, 32, 32, 32, 32, 32, 32, 32, 32]
    sd = collections.OrderedDict()
    idx = 0
    for i in range(16):
        sd[f"features.{idx}.weight"] = torch.from_numpy(rng.standard_normal(
            (chans[i + 1], chans[i], 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.standard_normal(chans[i + 1]).astype(np.float32))
        idx += 3 if i in (1, 3, 7, 11) else 2
    sd["classifier.0.weight"] = torch.zeros(4, 32)
    sd["classifier.0.bias"] = torch.zeros(4)
    pth = str(tmp_path / "vgg19.pth")
    torch.save(sd, pth)
    jti.convert_vgg19_pth(pth, str(tmp_path / "jax.npz"))
    pti.convert_vgg19_pth(pth, str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert len(a.files) == 26
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
