"""The port's inspection CLI (cli/info.py) on the CPU: every test of
tests/test_info.py on the port's run directories, artifacts, torch
checkpoints and videos, the JAX package's artifacts too (read from the
zip and meta.json only), and the same answers as the JAX package's
``inspect_path`` where both read the same file."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.cli.info import inspect_path as jax_inspect_path
from ir2rgb_tpu.config import Config as JConfig
from ir2rgb_tpu.config import DataConfig as JDataConfig
from ir2rgb_tpu.config import LossConfig as JLossConfig
from ir2rgb_tpu.config import ModelConfig as JModelConfig
from ir2rgb_tpu.infer import export as jexport
from ir2rgb_tpu.train import create_model as jax_create_model

from ir2rgb_tpu_torch.checkpoint import CheckpointManager
from ir2rgb_tpu_torch.cli.info import inspect_path, main
from ir2rgb_tpu_torch.config import Config, DataConfig, LossConfig, \
    ModelConfig, save_config
from ir2rgb_tpu_torch.infer.export import (
    export_multistream_artifact,
    export_serving_artifact,
)
from ir2rgb_tpu_torch.obs.video import MJPEGAviWriter
from ir2rgb_tpu_torch.train import create_model

import torch_refs

SMALL = dict(net_g="resnet_6blocks", net_d="n_layers", ngf=8, ndf=8)


def _same_as_jax(port: dict, jax_info: dict) -> None:
    """The port's answer is JAX's on the same file (the path aside)."""
    port, jax_info = dict(port), dict(jax_info)
    port.pop("path"), jax_info.pop("path")
    for k, v in jax_info.items():
        assert port[k] == v, k


def test_inspect_video(tmp_path):
    p = str(tmp_path / "c.avi")
    with MJPEGAviWriter(p, fps=25) as w:
        for _ in range(5):
            w.add(np.zeros((32, 48, 3), np.uint8))
    info = inspect_path(p)
    assert info["kind"] == "video"
    assert info["frames"] == 5 and info["fps"] == 25.0
    assert info["frame_hw"] == [32, 48]
    assert info["duration_s"] == 0.2
    _same_as_jax(info, jax_inspect_path(p))


def test_inspect_torch_checkpoint(tmp_path):
    t = torch_refs.ResnetGenerator(ngf=8, n_blocks=6, norm="instance")
    p = str(tmp_path / "G.pth")
    torch.save(t.state_dict(), p)
    info = inspect_path(p)
    assert info["kind"] == "torch_checkpoint"
    assert info["conv_layers"] > 10
    assert info["parameters"] == sum(v.numel()
                                     for v in t.state_dict().values())
    _same_as_jax(info, jax_inspect_path(p))


def test_inspect_artifacts(tmp_path):
    """The port's single- and multi-stream artifacts, and a JAX one:
    kind, geometry, batch or slots, weights and program format."""
    model = create_model(Config(model=ModelConfig(model="pix2pix", **SMALL),
                                data=DataConfig(crop_size=32),
                                loss=LossConfig(no_vgg_loss=True)),
                         device="cpu")
    single = str(tmp_path / "s.ir2rgb")
    multi = str(tmp_path / "m.ir2rgb")
    export_serving_artifact(model, (32, 32), single)
    export_multistream_artifact(model, (32, 32), multi, n_slots=2)
    si = inspect_path(single)
    assert si["artifact_kind"] == "single-stream" and si["batch"] == 1
    assert si["frame_hw"] == [32, 32]
    assert si["params"] == len(model.netG.state_dict())
    assert si["program_format"] == "torch.export"
    assert si["platforms"] == ["cuda", "cpu"]
    mi = inspect_path(multi)
    assert mi["artifact_kind"] == "multistream" and mi["slots"] == 2
    assert mi["format_version"] == 2
    for path in (single, multi):  # JAX's reader agrees on the port's
        _same_as_jax(inspect_path(path), jax_inspect_path(path))

    jmodel = jax_create_model(JConfig(
        model=JModelConfig(model="pix2pix", **SMALL),
        data=JDataConfig(crop_size=32), loss=JLossConfig(no_vgg_loss=True)),
        steps_per_epoch=1)
    rng = np.random.RandomState(0)
    g = jax.tree.map(
        lambda s: jnp.asarray(rng.randn(*s.shape).astype(np.float32) * 0.05),
        jax.eval_shape(jmodel.g_init, jax.random.PRNGKey(0)))
    jpath = str(tmp_path / "j.ir2rgb")
    jexport.export_serving_artifact(jmodel, g, (32, 32), jpath,
                                    platforms=("cpu",))
    ji = inspect_path(jpath)
    assert ji["artifact_kind"] == "single-stream"
    assert ji["program_format"] == "jax.export"
    assert ji["platforms"] == ["cpu"]
    _same_as_jax(ji, jax_inspect_path(jpath))


def test_inspect_run_dir_and_cli(tmp_path, capsys):
    """A port run directory (config.json, the checkpoint manager's steps
    and epoch labels, the loss log) through the CLI's --json output and
    its human-readable one."""
    cfg = Config(model=ModelConfig(model="pix2pix", **SMALL),
                 data=DataConfig(crop_size=32, dataroot="/data/x"),
                 loss=LossConfig(no_vgg_loss=True))
    run = tmp_path / "inforun"
    run.mkdir()
    save_config(cfg, str(run / "config.json"))
    mgr = CheckpointManager(str(run / "ckpt"))
    for step in (2, 4):
        mgr.save(step, {"step": step, "w": torch.zeros(3)})
    mgr.record_epoch(1, 4)
    mgr.wait()
    (run / "loss_log.txt").write_text("(epoch: 1, iters: 2) G_GAN: 1.0\n"
                                      "(epoch: 1, iters: 4) G_GAN: 0.9\n")
    assert main(["--json", str(run)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["kind"] == "run_dir"
    assert info["model"]["net_g"] == "resnet_6blocks"
    assert info["data"]["crop_size"] == 32
    assert info["checkpoint_steps"] == [2, 4]
    assert info["epoch_labels"] == {"1": 4}
    assert info["loss_log_lines"] == 2
    assert info["last_loss_line"].endswith("G_GAN: 0.9")
    assert main([str(run)]) == 0
    text = capsys.readouterr().out
    assert text.startswith(f"run_dir: {run}")
    assert "  model:\n    model: pix2pix" in text
    assert "  checkpoint_steps: [2, 4]" in text


def test_inspect_usage_error():
    with pytest.raises(SystemExit, match="usage"):
        main([])


def test_inspect_unknown_kind(tmp_path):
    p = str(tmp_path / "x.txt")
    with open(p, "w") as fh:
        fh.write("hi")
    with pytest.raises(SystemExit, match="don't know how"):
        inspect_path(p)


def test_inspect_plain_directory_rejected(tmp_path):
    d = str(tmp_path / "notarun")
    os.makedirs(d)
    with pytest.raises(SystemExit, match="not an ir2rgb run dir"):
        inspect_path(d)


def test_inspect_full_module_pickle_rejected(tmp_path):
    """A whole pickled nn.Module is refused cleanly: unpickling it would
    run code, which an inspection tool must never do."""
    p = str(tmp_path / "model.pth")
    torch.save(torch.nn.Linear(2, 2), p)
    with pytest.raises(SystemExit, match="not a plain state_dict"):
        inspect_path(p)


def test_inspect_non_dict_pickle_rejected(tmp_path):
    p = str(tmp_path / "list.pth")
    torch.save([1, 2, 3], p)
    with pytest.raises(SystemExit, match="not a state_dict"):
        inspect_path(p)
