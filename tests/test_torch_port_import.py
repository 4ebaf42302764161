"""The port stands alone: ir2rgb_tpu_torch and chip_smoke.py import no JAX
and nothing of ir2rgb_tpu, and its entry points run on the CUDA device
unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "ir2rgb_tpu_torch"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ir2rgb_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'ir2rgb_tpu_torch.parallel.spatial' in names, names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ir2rgb_tpu' or m.startswith('ir2rgb_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15  # every module was imported


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ir2rgb_tpu")


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ir2rgb_tpu_import_in_source(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path}: {bad}"


def test_create_model_defaults_to_the_card():
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.train import create_model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is legal here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model(PRESETS["pix2pixhd_512"])


def test_create_model_on_cpu_when_asked():
    import dataclasses
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.train import create_model
    cfg = PRESETS["temporal_512"]
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, n_blocks_global=1, n_downsample_global=2))
    m = create_model(cfg, device="cpu")
    assert m.device.type == "cpu" and m.gen_cfg.input_nc == 6
    assert all(p.device.type == "cpu" for p in m.netG.parameters())


@pytest.mark.parametrize("field,value", [("use_instance_feat", True),
                                         ("model", "cycle_gan")])
def test_unported_inputs_raise(field, value):
    import dataclasses
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.train import create_model
    cfg = PRESETS["pix2pixhd_512"]
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **{field: value}))
    if value == "cycle_gan":
        # ported now (the test's name predates it): the unpaired model,
        # its two generators on the CPU as asked
        from ir2rgb_tpu_torch.train import CycleGanModel
        m = create_model(cfg, device="cpu")
        assert isinstance(m, CycleGanModel)
        assert all(p.device.type == "cpu" for p in m.netG_B.parameters())
        return
    # netE is ported now: it builds on the CPU as asked, G's input widens
    # by feat_num, and only what JAX refuses (temporal + feat) raises
    m = create_model(cfg, device="cpu")
    assert m.gen_cfg.input_nc == 3 + cfg.model.feat_num
    assert set(m.g_nets()) == {"netG", "netE"}
    assert all(p.device.type == "cpu" for p in m.netE.parameters())
    temporal = PRESETS["temporal_512"]
    with pytest.raises(ValueError, match="instance features"):
        create_model(temporal.replace(model=dataclasses.replace(
            temporal.model, **{field: value})), device="cpu")
