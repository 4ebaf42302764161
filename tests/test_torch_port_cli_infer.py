"""The port's inference and evaluation CLIs (cli/infer.py, cli/evaluate.py,
cli/common.py::load_generator_params) held to the JAX package's on the
CPU. Both CLIs run in process on the same tiny folder with the same
reference ``.pth`` (``--torch_g``): the gallery's generated PNGs within
1 LSB with at most 0.1% of the values differing (ROADMAP §C: JAX's
jitted normalize is a fused multiply-add), input and target PNGs equal,
and the ``frames: N  PSNR: ... SSIM: ...`` lines within 0.01 dB and 1e-4.
Also: single mode, a label map with instance edges, a temporal model over
two sequences with ``--infer.video`` (the carry and the video restart at
the boundary), ``--infer.which_epoch`` from a port checkpoint,
``--infer.use_ema`` serving a run's EMA shadow, the refusals, and cli.evaluate's JSON against JAX's within 1e-4 with its
all-skipped exit code."""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from ir2rgb_tpu.cli import evaluate as jevaluate
from ir2rgb_tpu.cli import infer as jinfer

from ir2rgb_tpu_torch.checkpoint import CheckpointManager
from ir2rgb_tpu_torch.cli import evaluate as pevaluate
from ir2rgb_tpu_torch.cli import infer as pinfer
from ir2rgb_tpu_torch.config import parse_cli
from ir2rgb_tpu_torch.data import write_synthetic_dataset
from ir2rgb_tpu_torch.obs import read_mjpeg_avi
from ir2rgb_tpu_torch.train import create_model

import torch_refs

MAX_DIFFERING = 1e-3  # share of uint8 values allowed to differ by 1 LSB
ARCH = ["--model.net_g", "resnet_6blocks", "--model.ngf", "8",
        "--model.ndf", "8", "--loss.no_vgg_loss", "true",
        "--data.load_size", "48", "--data.crop_size", "32"]


def _pth(path, input_nc=3, seed=0):
    torch.manual_seed(seed)
    t = torch_refs.ResnetGenerator(input_nc=input_nc, ngf=8, n_blocks=6)
    torch.save(t.state_dict(), path)
    return str(path)


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def _both(tmp_path, capsys, name, extra):
    """Run JAX's and the port's infer CLI with the same flags; return
    (JAX gallery dir, port gallery dir, JAX stdout, port stdout)."""
    outs, dirs = {}, {}
    for side, main, more in (("jax", jinfer.main, []),
                             ("port", pinfer.main, ["--device", "cpu"])):
        res = tmp_path / f"results_{side}"
        argv = ARCH + ["--train.name", name,
                       "--train.checkpoints_dir", str(tmp_path / "ckpts"),
                       "--infer.results_dir", str(res)] + extra + more
        outs[side] = _run(main, argv, capsys)
        dirs[side] = res / name / "test_latest"
    return dirs["jax"], dirs["port"], outs["jax"], outs["port"]


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im)


def _assert_u8_close(p, j):
    assert p.shape == j.shape and p.dtype == j.dtype == np.uint8
    d = np.abs(p.astype(np.int16) - j.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert np.mean(d > 0) <= MAX_DIFFERING, np.mean(d > 0)


def _assert_galleries_match(jdir, pdir):
    names = sorted(os.listdir(jdir / "images"))
    assert names and names == sorted(os.listdir(pdir / "images"))
    for n in names:
        j, p = _png(jdir / "images" / n), _png(pdir / "images" / n)
        if n.endswith("_generated.png"):
            _assert_u8_close(p, j)
        else:
            np.testing.assert_array_equal(p, j, err_msg=n)
    assert (pdir / "index.html").exists()
    return names


def _metrics_line(out):
    m = re.search(r"frames: (\d+)  PSNR: (-?[\d.]+) dB  SSIM: (-?[\d.]+)",
                  out)
    assert m, out
    return int(m.group(1)), float(m.group(2)), float(m.group(3))


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("aligned"))
    write_synthetic_dataset(root, n=3, size=48)
    return root


def test_infer_torch_g_matches_jax_and_evaluate(aligned, tmp_path, capsys):
    pth = _pth(tmp_path / "G.pth")
    jdir, pdir, jout, pout = _both(
        tmp_path, capsys, "parity",
        ["--data.dataroot", aligned, "--infer.how_many", "2",
         "--torch_g", pth])
    names = _assert_galleries_match(jdir, pdir)
    assert len(names) == 6  # 2 frames x (input, generated, target)
    jf, jpsnr, jssim = _metrics_line(jout)
    pf, ppsnr, pssim = _metrics_line(pout)
    assert pf == jf == 2
    assert abs(ppsnr - jpsnr) <= 0.01 + 1e-9
    assert abs(pssim - jssim) <= 1e-4 + 1e-9

    # evaluate: generated vs target folders, both CLIs, the same JSON
    gen, tgt = tmp_path / "gen", tmp_path / "tgt"
    for d, suffix in ((gen, "_generated.png"), (tgt, "_target.png")):
        d.mkdir()
        for n in names:
            if n.endswith(suffix):
                shutil.copy(pdir / "images" / n, d / n)
    results = {}
    for side, main, more in (("jax", jevaluate.main, []),
                             ("port", pevaluate.main, ["--device", "cpu"])):
        js = tmp_path / f"eval_{side}.json"
        _run(main, ["--generated", str(gen), "--target", str(tgt),
                    "--json_out", str(js)] + more, capsys)
        results[side] = json.loads(js.read_text())
    assert set(results["port"]) == set(results["jax"])
    assert results["port"]["frames"] == results["jax"]["frames"] == 2
    for k in ("psnr_mean", "psnr_std", "ssim_mean", "flicker"):
        assert abs(results["port"][k] - results["jax"][k]) <= 1e-4, k
    # infer scores the float frames, evaluate the saved uint8 PNGs
    assert abs(results["port"]["psnr_mean"] - ppsnr) < 0.1


def test_evaluate_all_skipped_and_empty_exit_1(tmp_path, capsys):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    for i in range(2):
        Image.new("RGB", (16, 16), (i, 0, 0)).save(a / f"{i}.png")
        Image.new("RGB", (24, 24), (0, i, 0)).save(b / f"{i}.png")
    for main, more in ((jevaluate.main, []),
                       (pevaluate.main, ["--device", "cpu"])):
        assert main(["--generated", str(a), "--target", str(b)] + more) == 1
        assert "no comparable pairs" in capsys.readouterr().err
        assert main(["--generated", str(tmp_path / "c"), "--target",
                     str(b)] + more) == 1
        assert "no images found" in capsys.readouterr().err


def test_evaluate_mixed_sizes_skip_flicker(tmp_path, capsys):
    a = tmp_path / "a"
    a.mkdir()
    for i, size in enumerate((16, 16, 24)):
        Image.new("RGB", (size, size), (10 * i, 5, 0)).save(a / f"{i}.png")
    results = {}
    for side, main, more in (("jax", jevaluate.main, []),
                             ("port", pevaluate.main, ["--device", "cpu"])):
        js = tmp_path / f"{side}.json"
        assert main(["--generated", str(a), "--target", str(a),
                     "--json_out", str(js)] + more) == 0
        assert "skipping flicker" in capsys.readouterr().err
        results[side] = json.loads(js.read_text())
    assert results["port"]["flicker"] is None
    assert results["port"]["frames"] == results["jax"]["frames"] == 3


def test_single_mode_matches_jax(aligned, tmp_path, capsys):
    pth = _pth(tmp_path / "G.pth", seed=1)
    jdir, pdir, jout, pout = _both(
        tmp_path, capsys, "single",
        ["--data.dataroot", aligned, "--data.dataset_mode", "single",
         "--torch_g", pth])
    names = _assert_galleries_match(jdir, pdir)
    assert len(names) == 6 and not any("target" in n for n in names)
    assert "frames: 3  (single mode: no ground truth" in pout
    assert "frames: 3  (single mode" in jout


def test_label_map_with_instance_edges_matches_jax(tmp_path, capsys):
    label_nc = 4
    root = tmp_path / "labels"
    for sub in ("A", "B", "Inst"):
        (root / sub).mkdir(parents=True)
    rng = np.random.RandomState(2)
    for i in range(2):
        ids = np.kron(rng.randint(0, label_nc, (6, 6)),
                      np.ones((8, 8), np.int64)).astype(np.uint8)
        Image.fromarray(ids).save(root / "A" / f"{i:03d}.png")
        Image.fromarray((ids * 3 + 1).astype(np.uint8)).save(
            root / "Inst" / f"{i:03d}.png")
        Image.fromarray(rng.randint(0, 256, (48, 48, 3), np.uint8)).save(
            root / "B" / f"{i:03d}.png")
    pth = _pth(tmp_path / "G.pth", input_nc=label_nc + 1, seed=2)
    jdir, pdir, jout, pout = _both(
        tmp_path, capsys, "label",
        ["--data.dataroot", str(root), "--model.label_nc", str(label_nc),
         "--model.use_instance_edges", "true", "--model.model", "pix2pixhd",
         "--torch_g", pth])
    _assert_galleries_match(jdir, pdir)
    # the input column is the label palette, not a [-1, 1] image
    inp = _png(pdir / "images" / "000_input.png")
    assert len(np.unique(inp.reshape(-1, 3), axis=0)) <= label_nc
    assert _metrics_line(pout)[0] == _metrics_line(jout)[0] == 2


def test_temporal_two_sequences_and_video_match_jax(tmp_path, capsys):
    root = str(tmp_path / "video")
    write_synthetic_dataset(root, size=48, n_videos=2, frames_per_video=3)
    pth = _pth(tmp_path / "G.pth", input_nc=6, seed=3)
    videos = {}
    outs = {}
    for side in ("jax", "port"):
        videos[side] = str(tmp_path / f"out_{side}.avi")
    jdir = pdir = None
    for side, main, more in (("jax", jinfer.main, []),
                             ("port", pinfer.main, ["--device", "cpu"])):
        res = tmp_path / f"results_{side}"
        argv = ARCH + ["--model.model", "temporal", "--model.n_frames_g",
                       "2", "--data.dataroot", root,
                       "--train.name", "temporal",
                       "--train.checkpoints_dir", str(tmp_path / "ckpts"),
                       "--infer.results_dir", str(res),
                       "--infer.video", videos[side], "--torch_g", pth] + more
        outs[side] = _run(main, argv, capsys)
        if side == "jax":
            jdir = res / "temporal" / "test_latest"
        else:
            pdir = res / "temporal" / "test_latest"
    names = _assert_galleries_match(jdir, pdir)
    assert sum(n.endswith("_generated.png") for n in names) == 6
    assert _metrics_line(outs["port"])[0] == 6
    # one video a sequence: out.avi, then out_vid001.avi
    for side in ("jax", "port"):
        base = videos[side][:-4]
        assert f"video: {base}.avi, {base}_vid001.avi" in outs[side]
    for suffix in (".avi", "_vid001.avi"):
        pf, _ = read_mjpeg_avi(videos["port"][:-4] + suffix)
        jf, _ = read_mjpeg_avi(videos["jax"][:-4] + suffix)
        assert pf.shape == jf.shape == (3, 32, 32, 3)
        assert np.abs(pf.astype(int) - jf.astype(int)).max() <= 8
    # the carry restarts at vid001: its first frame is a fresh stream's
    first = _png(pdir / "images" / "vid001_0000_generated.png")
    from ir2rgb_tpu_torch.checkpoint import import_generator
    from ir2rgb_tpu_torch.infer import StreamingGenerator
    cfg = parse_cli(ARCH + ["--model.model", "temporal",
                            "--model.n_frames_g", "2"])
    model = create_model(cfg, device="cpu")
    model.netG.load_state_dict(import_generator(pth, model.gen_cfg))
    a = _png(os.path.join(root, "A", "vid001", "0000.png"))[8:40, 8:40].copy()
    np.testing.assert_array_equal(StreamingGenerator(model, (32, 32))
                                  .push(a), first)


def test_which_epoch_from_a_port_checkpoint(aligned, tmp_path, capsys):
    """``--infer.which_epoch 1`` serves the epoch's netG from the port's
    CheckpointManager (the same PNGs as that netG given by --torch_g);
    the default serves the latest; --infer.use_ema finds no shadow."""
    argv = ARCH + ["--data.dataroot", aligned, "--train.name", "run",
                   "--train.checkpoints_dir", str(tmp_path / "ckpts"),
                   "--device", "cpu", "--infer.how_many", "1"]
    cfg = parse_cli(ARCH + ["--train.name", "run",
                            "--train.checkpoints_dir",
                            str(tmp_path / "ckpts")])
    mgr = CheckpointManager(os.path.join(cfg.run_dir(), "ckpt"))
    epoch1 = create_model(cfg, device="cpu", seed=11)
    mgr.save(5, epoch1.state_dict())
    mgr.record_epoch(1, 5)
    mgr.save(10, create_model(cfg, device="cpu", seed=12).state_dict())
    mgr.wait()
    torch.save(epoch1.netG.state_dict(), tmp_path / "epoch1.pth")

    def generated(extra, results):
        _run(pinfer.main, argv + ["--infer.results_dir",
                                  str(tmp_path / results)] + extra, capsys)
        d = tmp_path / results / "run"
        (sub,) = os.listdir(d)
        return _png(d / sub / "images" / "0000_generated.png")

    by_epoch = generated(["--infer.which_epoch", "1"], "r1")
    by_pth = generated(["--torch_g", str(tmp_path / "epoch1.pth")], "r2")
    latest = generated([], "r3")
    np.testing.assert_array_equal(by_epoch, by_pth)
    assert not np.array_equal(by_epoch, latest)
    with pytest.raises(SystemExit, match="no EMA weights"):
        pinfer.main(argv + ["--infer.use_ema", "true"])
    with pytest.raises(SystemExit, match="no EMA state"):
        pinfer.main(argv + ["--infer.use_ema", "true", "--torch_g",
                            str(tmp_path / "epoch1.pth")])


def test_use_ema_serves_the_shadow(aligned, tmp_path, capsys):
    """``--infer.use_ema`` on a port checkpoint of a run trained with
    ``--train.ema_decay`` serves the EMA shadow: the same PNGs as
    ``--torch_g`` with the shadow's weights, and not the raw netG's."""
    cfg = parse_cli(ARCH + ["--train.name", "ema",
                            "--train.checkpoints_dir", str(tmp_path / "c"),
                            "--train.ema_decay", "0.5"])
    model = create_model(cfg, device="cpu", steps_per_epoch=1, seed=3)
    r = np.random.RandomState(0)
    batch = {k: torch.from_numpy(r.uniform(-1, 1, (1, 32, 32, 3))
                                 .astype(np.float32)) for k in "ab"}
    for _ in range(2):
        model.train_step(batch)
    mgr = CheckpointManager(os.path.join(cfg.run_dir(), "ckpt"))
    mgr.save(model.step, model.state_dict())
    mgr.wait()
    torch.save(model.ema_state_dict(), tmp_path / "shadow.pth")
    argv = ARCH + ["--data.dataroot", aligned, "--train.name", "ema",
                   "--train.checkpoints_dir", str(tmp_path / "c"),
                   "--device", "cpu", "--infer.how_many", "1"]

    def generated(extra, results):
        _run(pinfer.main, argv + ["--infer.results_dir",
                                  str(tmp_path / results)] + extra, capsys)
        d = tmp_path / results / "ema" / "test_latest" / "images"
        return _png(d / "0000_generated.png")

    by_ema = generated(["--infer.use_ema", "true"], "r1")
    by_pth = generated(["--torch_g", str(tmp_path / "shadow.pth")], "r2")
    raw = generated([], "r3")
    np.testing.assert_array_equal(by_ema, by_pth)
    assert not np.array_equal(by_ema, raw)


@pytest.mark.parametrize("flags,match", [
    (["--infer.use_encoded_image", "true"], "A12"),
    (["--infer.cluster_path", "c.npy"], "A12"),
    (["--infer.quant", "int8"], "A11"),
    # a CycleGAN serves (A13 is ported); quantized, it is refused
    (["--model.model", "cycle_gan", "--infer.quant", "int8"], "A11"),
    (["--infer.use_encoded_image", "true", "--data.dataset_mode", "single"],
     "ground-truth"),
])
def test_unported_options_are_refused(flags, match):
    with pytest.raises(SystemExit, match=match):
        pinfer.main(ARCH + ["--device", "cpu"] + flags)


@pytest.mark.parametrize("dtype,tf32", [("float32", False), ("bf16", True)])
def test_fp32_infer_turns_tf32_off(monkeypatch, dtype, tf32):
    """An fp32 model infers with full-fp32 convolutions and matmuls (the
    JAX package's HIGHEST precision); bf16 leaves the TF32 flags alone."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(SystemExit, match="A12"):
        pinfer.main(ARCH + ["--device", "cpu", "--model.compute_dtype",
                            dtype, "--infer.cluster_path", "c.npy"])
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
