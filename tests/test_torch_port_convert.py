"""The port's reverse migration (checkpoint/torch_export.py), its
conversion CLI (cli/convert.py) and the reference-flag table
(config/compat.py), on the CPU: the counterparts of
tests/test_torch_export.py and of the JAX CLI's subcommands.

- Exact round trip: a reference state_dict (tests/torch_refs.py) imported
  by the port and exported into itself as the template gives it back bit
  for bit (a conv bias a batch norm follows, which the port leaves out,
  comes back as 0).
- Deploy back: the port's own weights filled into a reference template
  load strict into the reference module, whose fp32 output equals the
  port generator's within atol 1e-4.
- ``g`` / ``d`` write a port checkpoint, ``export-g`` / ``export-d`` read
  a port run (``--net`` for a cycle_gan run), ``vgg19`` writes the JAX
  converter's npz.
- ``from_reference_flags`` and ``parse_opt_txt`` return what the JAX
  package's return on the same inputs."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from ir2rgb_tpu.checkpoint import torch_import as jti
from ir2rgb_tpu.config import Config as JConfig
from ir2rgb_tpu.config import compat as jcompat

from ir2rgb_tpu_torch.checkpoint import (
    CheckpointManager,
    export_discriminator,
    export_generator,
    import_discriminator,
    import_generator,
    restore_train_state,
    save_torch_state_dict,
)
from ir2rgb_tpu_torch.cli.convert import main as convert_main
from ir2rgb_tpu_torch.config import Config, DataConfig, LossConfig, \
    ModelConfig, PRESETS, save_config
from ir2rgb_tpu_torch.config import compat as pcompat
from ir2rgb_tpu_torch.nn.discriminators import DiscConfig
from ir2rgb_tpu_torch.nn.generators import GenConfig, define_g
from ir2rgb_tpu_torch.train import create_model

import torch_refs

ATOL = 1e-4


def _seeded(t: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Weights drawn from a numpy seed, biases and batch-norm parameters
    nonzero too, so that a dropped or misplaced entry shows."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for k, v in t.state_dict().items():
            if v.is_floating_point():
                base = 1.0 if "running_var" in k or (
                    v.dim() == 1 and k.endswith(".weight")) else 0.0
                v.copy_(torch.from_numpy((base + 0.1 * rng.standard_normal(
                    v.shape)).astype(np.float32)).abs_()
                    if "running_var" in k else torch.from_numpy(
                        (base + 0.1 * rng.standard_normal(v.shape))
                        .astype(np.float32)))
    return t


def _np_sd(module):
    return collections.OrderedDict((k, v.detach().numpy().copy())
                                   for k, v in module.state_dict().items())


def _assert_sd_equal(exported, original, zeroed=()):
    assert list(exported) == list(original)
    for k in original:
        want = np.zeros_like(original[k]) if k in zeroed else original[k]
        np.testing.assert_array_equal(exported[k], want,
                                      err_msg=f"round trip at {k}")


# ---------------------------------------------------------------------------
# Exact round trip: import -> export reproduces the reference state_dict
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_resnet_roundtrip(norm):
    """The compact reference block keeps a conv bias under batch norm;
    the port leaves it out (the batch mean cancels it) and the export
    writes 0 there, which computes the same."""
    t = _seeded(torch_refs.ResnetGenerator(ngf=8, n_blocks=3, norm=norm), 1)
    cfg = GenConfig(net_g="resnet_9blocks", ngf=8, norm=norm)
    sd = _np_sd(t)
    port = import_generator(t.state_dict(), cfg, n_blocks=3)
    zeroed = [k for k in sd if k.endswith(".bias") and k not in port
              and sd[k].ndim == 1 and k.rsplit(".", 1)[0] + ".weight" in sd
              and sd[k.rsplit(".", 1)[0] + ".weight"].ndim == 4]
    assert bool(zeroed) == (norm == "batch")
    _assert_sd_equal(export_generator(port, cfg, sd), sd, zeroed)


def test_unet_roundtrip():
    t = _seeded(torch_refs.UnetGenerator(num_downs=8, ngf=4), 2)
    cfg = GenConfig(net_g="unet_256", ngf=4)
    sd = _np_sd(t)
    _assert_sd_equal(export_generator(import_generator(t.state_dict(), cfg),
                                      cfg, sd), sd)


def test_local_enhancer_roundtrip():
    t = _seeded(torch_refs.LocalEnhancer(ngf=4, n_downsample_global=2,
                                         n_blocks_global=2,
                                         n_blocks_local=2), 3)
    cfg = GenConfig(net_g="local", ngf=4, n_downsample_global=2,
                    n_blocks_global=2, n_blocks_local=2,
                    n_local_enhancers=1)
    sd = _np_sd(t)
    _assert_sd_equal(export_generator(import_generator(t.state_dict(), cfg),
                                      cfg, sd), sd)


@pytest.mark.parametrize("interm", [True, False], ids=["scale", "layer"])
def test_multiscale_d_roundtrip(interm):
    t = _seeded(torch_refs.MultiscaleDiscriminator(
        input_nc=6, ndf=8, num_d=2, get_interm_feat=interm), 4)
    cfg = DiscConfig(net_d="multiscale", ndf=8, num_d=2, input_nc=6,
                     get_interm_feat=interm)
    sd = _np_sd(t)
    _assert_sd_equal(export_discriminator(
        import_discriminator(t.state_dict(), cfg), cfg, sd), sd)


# ---------------------------------------------------------------------------
# Deploy back: the port's weights run in the reference module
# ---------------------------------------------------------------------------

def _port_output(g, x):
    with torch.no_grad():
        return g(x.permute(0, 2, 3, 1).contiguous()).permute(0, 3, 1, 2)


@pytest.mark.parametrize("arch", ["resnet", "local"])
def test_port_weights_deploy_into_torch(arch):
    if arch == "resnet":
        cfg = GenConfig(net_g="resnet_6blocks", ngf=8, norm="instance",
                        compute_dtype=torch.float32)
        t = torch_refs.ResnetGenerator(ngf=8, n_blocks=6, norm="instance")
        size = 32
    else:
        cfg = GenConfig(net_g="local", ngf=4, n_downsample_global=2,
                        n_blocks_global=2, n_blocks_local=2,
                        n_local_enhancers=1, compute_dtype=torch.float32)
        t = torch_refs.LocalEnhancer(ngf=4, n_downsample_global=2,
                                     n_blocks_global=2, n_blocks_local=2)
        size = 64
    g = _seeded(define_g(cfg), 5)
    out_sd = export_generator(g.state_dict(), cfg, _np_sd(t))
    missing, unexpected = t.load_state_dict(
        {k: torch.from_numpy(v) for k, v in out_sd.items()}, strict=True)
    assert not missing and not unexpected
    t.eval()
    x = torch.from_numpy(np.random.RandomState(6).standard_normal(
        (1, 3, size, size)).astype(np.float32))
    with torch.no_grad():
        want = t(x).numpy()
    np.testing.assert_allclose(_port_output(g, x).numpy(), want, atol=ATOL)


def test_export_shape_mismatch_is_loud():
    """A template of another width fails at the offending entry."""
    cfg = GenConfig(net_g="resnet_6blocks", ngf=8, norm="instance")
    g = define_g(cfg)
    t16 = torch_refs.ResnetGenerator(ngf=16, n_blocks=6, norm="instance")
    with pytest.raises(ValueError, match="shape mismatch"):
        export_generator(g.state_dict(), cfg, _np_sd(t16))


def test_export_norm_type_mismatch_is_loud():
    """Instance-norm weights into a batch-norm template fail: the silent
    path would drop conv biases and write initial statistics."""
    cfg = GenConfig(net_g="resnet_6blocks", ngf=8, norm="instance")
    g = define_g(cfg)
    t_bn = torch_refs.ResnetGenerator(ngf=8, n_blocks=6, norm="batch")
    with pytest.raises(ValueError, match="norm count mismatch"):
        export_generator(g.state_dict(), cfg, _np_sd(t_bn))


def test_export_save_and_torch_load(tmp_path):
    """save_torch_state_dict writes a plain .pth that torch.load(
    weights_only=True) + load_state_dict(strict) accept."""
    cfg = GenConfig(net_g="resnet_6blocks", ngf=8, norm="instance")
    g = define_g(cfg)
    t = torch_refs.ResnetGenerator(ngf=8, n_blocks=6, norm="instance")
    path = str(tmp_path / "exported_net_G.pth")
    save_torch_state_dict(export_generator(g.state_dict(), cfg, _np_sd(t)),
                          path)
    t.load_state_dict(torch.load(path, map_location="cpu",
                                 weights_only=True), strict=True)


# ---------------------------------------------------------------------------
# The conversion CLI
# ---------------------------------------------------------------------------

def test_convert_cli_imports_g_and_d(tmp_path, capsys):
    """``g`` / ``d`` import a reference .pth of the preset's architecture
    into a port checkpoint at step 0, as import_generator /
    import_discriminator read it."""
    t = _seeded(torch_refs.ResnetGenerator(ngf=64, n_blocks=9), 7)
    d = _seeded(torch_refs.NLayerDiscriminator(input_nc=6, ndf=64), 8)
    torch.save(t.state_dict(), str(tmp_path / "G.pth"))
    torch.save(d.state_dict(), str(tmp_path / "D.pth"))
    for cmd, net, src in (("g", "netG", t), ("d", "netD", d)):
        out = str(tmp_path / cmd)
        assert convert_main([cmd, "--pth", str(tmp_path / f"{cmd.upper()}"
                                                ".pth"),
                             "--preset", "resnet9_256", "--out", out]) == 0
        got = restore_train_state(out, 0)[net]
        for k, v in src.state_dict().items():
            assert torch.equal(got[k], v), k
    assert "imported" in capsys.readouterr().out


def _small_run(tmp_path, cfg, name="run"):
    """A port run directory: config.json and a checkpoint of ``cfg``'s
    seeded networks at step 3, labelled epoch 1."""
    run = tmp_path / name
    model = create_model(cfg, device="cpu", seed=9)
    for net in (*model.g_nets().values(), *model.d_nets().values()):
        _seeded(net, 10)
    run.mkdir()
    save_config(cfg, str(run / "config.json"))
    mgr = CheckpointManager(str(run / "ckpt"))
    mgr.save(3, model.state_dict())
    mgr.record_epoch(1, 3)
    mgr.wait()
    return str(run), model


def test_convert_cli_export_g_and_d(tmp_path):
    """``export-g`` / ``export-d`` fill reference templates from a port run
    at an epoch label, read off its config.json."""
    cfg = Config(model=ModelConfig(model="pix2pix", net_g="resnet_6blocks",
                                   net_d="n_layers", ngf=8, ndf=8),
                 data=DataConfig(crop_size=32),
                 loss=LossConfig(no_vgg_loss=True))
    run, model = _small_run(tmp_path, cfg)
    templates = {"g": torch_refs.ResnetGenerator(ngf=8, n_blocks=6),
                 "d": torch_refs.NLayerDiscriminator(input_nc=6, ndf=8)}
    for side, net in (("g", model.netG), ("d", model.netD)):
        tpl = str(tmp_path / f"tpl_{side}.pth")
        torch.save(templates[side].state_dict(), tpl)
        out = str(tmp_path / f"{side}.pth")
        assert convert_main([f"export-{side}", "--run", run, "--epoch", "1",
                             "--template", tpl, "--out", out]) == 0
        ref = templates[side]
        ref.load_state_dict(torch.load(out, weights_only=True), strict=True)
        for k, v in net.state_dict().items():
            assert torch.equal(ref.state_dict()[k], v), k


def test_convert_cli_cycle_gan_nets(tmp_path):
    """A cycle_gan run holds two nets a side: ``--net G_B`` / ``D_B`` pick
    the reverse ones; another name is a usage error."""
    cfg = PRESETS["cyclegan_256"]
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, ngf=8, ndf=8,
                                                net_g="resnet_6blocks"),
                      data=dataclasses.replace(cfg.data, crop_size=32))
    run, model = _small_run(tmp_path, cfg)
    tpl = str(tmp_path / "tpl.pth")
    torch.save(torch_refs.ResnetGenerator(ngf=8, n_blocks=6).state_dict(),
               tpl)
    out = str(tmp_path / "g_b.pth")
    assert convert_main(["export-g", "--run", run, "--template", tpl,
                         "--net", "G_B", "--out", out]) == 0
    got = torch.load(out, weights_only=True)
    for k, v in model.netG_B.state_dict().items():
        assert torch.equal(got[k], v), k
    dtpl = str(tmp_path / "dtpl.pth")
    torch.save(torch_refs.NLayerDiscriminator(
        input_nc=3, ndf=8, norm=cfg.model.norm, padw=1,
        get_interm_feat=model.disc_cfg_b.get_interm_feat).state_dict(), dtpl)
    out = str(tmp_path / "d_b.pth")
    assert convert_main(["export-d", "--run", run, "--template", dtpl,
                         "--net", "D_B", "--out", out]) == 0
    got = torch.load(out, weights_only=True)
    for k, v in model.netD_B.state_dict().items():
        assert torch.equal(got[k], v), k
    with pytest.raises(SystemExit):
        convert_main(["export-g", "--run", run, "--template", tpl, "--net",
                      "D_A", "--out", out])


def test_convert_cli_vgg19_matches_jax(tmp_path):
    """``vgg19`` writes the npz of the JAX converter."""
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
    pth = str(tmp_path / "vgg19.pth")
    torch.save(sd, pth)
    assert convert_main(["vgg19", "--pth", pth, "--out",
                         str(tmp_path / "port.npz")]) == 0
    jti.convert_vgg19_pth(pth, str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 26
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# config/compat.py against the JAX package's
# ---------------------------------------------------------------------------

REFERENCE_FLAGS = {
    "name": "exp", "model": "pix2pixHD", "netG": "local", "ngf": "32",
    "ndf": 64, "norm": "instance", "input_nc": 3, "label_nc": 0,
    "n_downsample_global": 4, "n_blocks_global": 9, "n_blocks_local": 3,
    "n_local_enhancers": 1, "batchSize": 2, "loadSize": 572,
    "fineSize": 512, "resize_or_crop": "scale_width_and_crop",
    "no_dropout": True, "no_instance": True, "instance_feat": False,
    "niter": 100, "niter_decay": 100, "niter_fix_global": 10, "lr": 2e-4,
    "beta1": 0.5, "no_lsgan": False, "lambda_feat": 10.0,
    "no_vgg_loss": False, "which_epoch": 30, "max_dataset_size": "inf",
    "how_many": "inf", "gpu_ids": "0", "display_winsize": 512,
    "pool_size": 0, "which_direction": "AtoB",
}


@pytest.mark.parametrize("flags", [
    REFERENCE_FLAGS,
    dict(model="cycle_gan", lambda_A=10.0, lambda_B=7.0,
         lambda_identity=0.5, no_lsgan=True, num_test=50),
    dict(model="pix2pix", lambda_A=100.0, netG="unet_256"),
], ids=["pix2pixhd", "cycle_gan", "pix2pix"])
def test_from_reference_flags_matches_jax(flags):
    """The same reference flags give the same fields, section by section
    (the JAX package's fields that the port's config also has)."""
    got = dataclasses.asdict(pcompat.from_reference_flags(flags))
    want = dataclasses.asdict(jcompat.from_reference_flags(flags))
    for section, fields in got.items():
        for k, v in fields.items():
            if k in want[section]:
                assert v == want[section][k], (section, k)
    assert pcompat.REFERENCE_FLAG_TABLE.keys() == \
        jcompat.REFERENCE_FLAG_TABLE.keys()
    assert pcompat._NETG_ALIASES == jcompat._NETG_ALIASES
    assert isinstance(pcompat.from_reference_flags(flags), Config)
    assert isinstance(jcompat.from_reference_flags(flags), JConfig)


def test_parse_opt_txt_matches_jax(tmp_path):
    path = tmp_path / "opt.txt"
    path.write_text("------------ Options -------------\n"
                    "batchSize: 4\nbeta1: 0.5\ncheckpoints_dir: ./ckpts\n"
                    "continue_train: False\nfineSize: 256\n"
                    "lr: 0.0002  [default: 0.001]\nname: run1\n"
                    "netG: global\nno_flip: True\n"
                    "-------------- End ----------------\n")
    got = pcompat.parse_opt_txt(str(path))
    assert got == jcompat.parse_opt_txt(str(path))
    assert got["batchSize"] == 4 and got["lr"] == 0.0002
    assert got["no_flip"] is True and got["netG"] == "global"
