"""The slice as a whole on the CPU: the port's ``cli.train`` and the JAX
package's ``cli.train`` on the same synthetic folder and the same initial
weights (JAX's, converted with ``checkpoint/from_jax.py`` and loaded
through ``--train.load_pretrain``), frames and temporal windows; a
resumed port run against an uninterrupted one, bit for bit; and the
Trainer's checkpoint and logging cadence against JAX's Trainer.

Numbers: ``preprocess none`` and ``no_flip`` make every batch the same on
both sides (no random draw), and ``print_freq 1`` logs every step.

- The first step's metrics agree at rel 1e-4.
- Later steps are held at JAX's own trajectory: the port's losses at
  JAX's parameters after step k-1 (from JAX's checkpoints) on batch k
  agree with JAX's step-k metrics at rel 1e-4. Unpinned, the two
  trajectories part: at 32 px these synthetic frames have flat regions
  that share one pre-activation value, so one ReLU or LeakyReLU unit
  flipped by fp32 rounding moves a whole region. Measured on identical
  batches and parameters equal to 2e-6: D_fake 5.1e-2 apart at the
  fourth step, 1.0e-1 at the fifth. So the unpinned steps are held only
  at rel 0.5: the same batches and schedule, not the same floats.
- The update itself is held on a one-pair folder (one step an epoch)
  through the learning-rate decay: the parameters in each step's
  checkpoint against JAX's, two steps, before any kink can flip; every
  element within 4 lr and all but 1e-4 of them at atol 1e-6.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from ir2rgb_tpu.checkpoint import CheckpointManager as JaxCheckpoints
from ir2rgb_tpu.cli.train import main as jax_main
from ir2rgb_tpu.config import parse_cli as jax_parse_cli
from ir2rgb_tpu.obs.visualizer import Visualizer as JaxVisualizer
from ir2rgb_tpu.train import Trainer as JaxTrainer
from ir2rgb_tpu.train import create_model as jax_create_model

from ir2rgb_tpu_torch.checkpoint import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    save_train_state,
)
from ir2rgb_tpu_torch.cli.train import main
from ir2rgb_tpu_torch.config import parse_cli
from ir2rgb_tpu_torch.data import (
    DataLoader,
    synthetic_pair_batch,
    write_synthetic_dataset,
)
from ir2rgb_tpu_torch.data.transforms import normalize
from ir2rgb_tpu_torch.obs import Visualizer
from ir2rgb_tpu_torch.train import Trainer, create_model

METRICS = ("D_fake", "D_real", "G_GAN", "G_GAN_Feat", "G_L1")
TINY = ["--model.ngf", "4", "--model.ndf", "8", "--loss.no_vgg_loss", "true",
        "--data.load_size", "32", "--data.crop_size", "32",
        "--data.preprocess", "none", "--data.no_flip", "true",
        "--train.num_devices", "1", "--train.print_freq", "1"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_init_as_port(argv, steps_per_epoch, out_dir):
    """JAX's initial G and D (the JAX CLI's key, train.seed) saved as a
    port checkpoint under ``out_dir/ckpt`` for --train.load_pretrain."""
    jcfg = jax_parse_cli(argv)
    batch = {k: jax.numpy.zeros((1, 32, 32, 3)) for k in ("a", "b")}
    if jcfg.data.dataset_mode == "temporal":
        batch = {k: v[:, None].repeat(jcfg.data.n_frames_total, 1)
                 for k, v in batch.items()}
    state = jax_create_model(jcfg, steps_per_epoch=steps_per_epoch
                             ).init_state(jax.random.PRNGKey(
                                 jcfg.train.seed), batch)
    model = create_model(parse_cli(argv), device="cpu")
    save_train_state(os.path.join(out_dir, "ckpt"), 0, {
        "netG": generator_state_dict_from_jax(_np(state.g_params),
                                              model.gen_cfg),
        "netD": discriminator_state_dict_from_jax(_np(state.d_params),
                                                  model.disc_cfg)})
    return model


def _run_both(tmp_path, argv, steps_per_epoch):
    """The JAX CLI and the port's (from JAX's initial weights) into
    ``tmp_path/{jax,port}/run``."""
    init = str(tmp_path / "init")
    model = _jax_init_as_port(argv, steps_per_epoch, init)
    runs = {}
    for side, run in (("jax", jax_main), ("port", main)):
        extra = ["--train.name", "run", "--train.checkpoints_dir",
                 str(tmp_path / side)]
        if side == "port":
            extra += ["--train.load_pretrain", init, "--device", "cpu"]
        assert run(argv + extra) == 0
        runs[side] = str(tmp_path / side / "run")
    return runs, model


def _listing(run):
    """The run directory's files; a checkpoint counts as its step (a
    port file '3.pt', an Orbax directory '3')."""
    files = set()
    for root, dirs, names in os.walk(run):
        rel = os.path.relpath(root, run)
        if rel == "ckpt":
            files |= {f"ckpt/{n.split('.')[0]}" for n in dirs + names}
            dirs[:] = []
        else:
            files |= {os.path.join(rel, "events*" if rel == "tb" else n)
                      for n in names}
    return sorted(files)


def _records(run):
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _labels(run):
    path = os.path.join(run, "ckpt", "epochs.json")
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)


def _config(run):
    with open(os.path.join(run, "config.json")) as fh:
        cfg = json.load(fh)
    for k in ("checkpoints_dir", "load_pretrain"):
        cfg["train"].pop(k)
    return cfg


def _check_same_run(runs):
    assert _listing(runs["port"]) == _listing(runs["jax"])
    assert _config(runs["port"]) == _config(runs["jax"])
    for f in ("loss_log.txt",):
        got = open(os.path.join(runs["port"], f)).read().splitlines()
        want = open(os.path.join(runs["jax"], f)).read().splitlines()
        assert len(got) == len(want)
    labels = _labels(runs["port"])
    assert _labels(runs["jax"]) == labels
    got, want = _records(runs["port"]), _records(runs["jax"])
    assert [(r["epoch"], r["step"]) for r in got] == \
        [(r["epoch"], r["step"]) for r in want]
    for k in METRICS:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-4,
                                   err_msg=k)
    for g, w in zip(got[1:], want[1:]):
        for k in METRICS:
            np.testing.assert_allclose(g[k], w[k], rtol=0.5,
                                       err_msg=(g["step"], k))
    return labels, got, want


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_aligned")
    data = str(tmp / "data")
    write_synthetic_dataset(data, n=5, size=32)
    argv = ["--model.net_g", "resnet_6blocks", "--data.dataroot", data,
            "--train.niter", "1", "--train.niter_decay", "0",
            "--train.display_freq", "2", "--train.save_latest_freq", "1",
            "--train.save_epoch_freq", "1"] + TINY
    runs, model = _run_both(tmp, argv, 5)
    return argv, runs, model


def test_cli_writes_jaxs_files_steps_and_labels(aligned):
    _, runs, _ = aligned
    labels, got, _ = _check_same_run(runs)
    assert labels == {"1": 5} and [r["step"] for r in got] == [1, 2, 3, 4, 5]
    ckpt = os.path.join(runs["port"], "ckpt")
    assert sorted(os.listdir(ckpt)) == ["1.pt", "2.pt", "3.pt", "4.pt",
                                        "5.pt", "epochs.json"]
    images = os.listdir(os.path.join(runs["port"], "web", "images"))
    # displays at steps 2 and 4 and the final dump at 5
    assert len(images) == 9


def test_cli_steps_match_jax_at_jaxs_parameters(aligned):
    argv, runs, model = aligned
    want = _records(runs["jax"])
    loader = DataLoader(parse_cli(argv))
    jckpt = JaxCheckpoints(os.path.join(runs["jax"], "ckpt"))
    for k, host in enumerate(loader.epoch(), start=1):
        if k == 1:
            continue
        st = jckpt.restore(k - 1)
        model.netG.load_state_dict(generator_state_dict_from_jax(
            _np(st["g_params"]), model.gen_cfg))
        model.netD.load_state_dict(discriminator_state_dict_from_jax(
            _np(st["d_params"]), model.disc_cfg))
        batch = {s: normalize(torch.from_numpy(host[s])) for s in "ab"}
        with torch.no_grad():
            _, _, got = model.loss_and_metrics(batch)
        for name in METRICS:
            np.testing.assert_allclose(float(got[name]), want[k - 1][name],
                                       rtol=1e-4, err_msg=(k, name))
    jckpt.close()


def _biases_before_norm(net, prefix):
    """The conv biases an instance norm follows: their true gradient is
    zero, and Adam turns each side's rounding noise into updates of up
    to +-lr."""
    keys = set()
    for name, mod in net.named_modules():
        kids = list(mod.named_children())
        for (i, conv), (_, nxt) in zip(kids, kids[1:]):
            if getattr(conv, "bias", None) is not None and \
                    getattr(nxt, "what", None) == "instance":
                keys.add(f"{prefix}{name}.{i}.bias".replace("..", "."))
    return keys


def test_cli_updates_match_jax_through_the_lr_decay(tmp_path):
    # one pair, so an epoch is one step (steps_per_epoch = len(loader));
    # niter 0, niter_decay 2: step 1 trains at lr, step 2 at lr/2. Each
    # step's checkpoint holds G and D after the CLI's own Adam update.
    # One update moves an element by ~lr = 2e-4, so a wrong lr, beta or
    # steps_per_epoch moves nearly every element. Held: every element
    # within 4 lr, and at most 1e-4 of the elements off by more than
    # 1e-6, the biases an instance norm follows aside. Adam's first step
    # is lr * g / (|g| + eps): where a gradient cancels to near eps its
    # rounding (which moves with the thread pool's split of a sum) moves
    # the element by a visible part of lr; measured: one element of
    # 76,516, by 6.1e-7 alone and 1.7e-6 under a parallel test run
    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n=1, size=32)
    argv = ["--model.net_g", "resnet_6blocks", "--data.dataroot", data,
            "--train.niter", "0", "--train.niter_decay", "2",
            "--train.display_freq", "2", "--train.save_latest_freq", "1",
            "--train.save_epoch_freq", "2"] + TINY
    runs, model = _run_both(tmp_path, argv, 1)
    lr = parse_cli(argv).train.lr
    noise = _biases_before_norm(model.netG, "G.") | \
        _biases_before_norm(model.netD, "D.")
    assert "G.model.1.bias" in noise and "D.model1.0.bias" in noise
    jckpt = JaxCheckpoints(os.path.join(runs["jax"], "ckpt"))
    assert jckpt.all_steps() == [1, 2]
    for step in (1, 2):
        st = jckpt.restore(step)
        want = {f"G.{k}": torch.as_tensor(v) for k, v in
                generator_state_dict_from_jax(_np(st["g_params"]),
                                              model.gen_cfg).items()}
        want.update({f"D.{k}": torch.as_tensor(v) for k, v in
                     discriminator_state_dict_from_jax(
                         _np(st["d_params"]), model.disc_cfg).items()})
        got = _state(runs["port"], step)
        assert got["step"] == step
        got = {f"{n[3]}.{k}": v for n in ("netG", "netD")
               for k, v in got[n].items()}
        assert got.keys() == want.keys()
        off = n = 0
        for k, v in want.items():
            d = (got[k] - v).abs()
            assert float(d.max()) <= 4 * lr, (step, k)
            if k not in noise:
                off += int((d > 1e-6).sum())
                n += d.numel()
        assert off <= 1e-4 * n, f"step {step}: {off} of {n} elements off"
    jckpt.close()


def test_temporal_cli_matches_jax(tmp_path):
    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_videos=1, frames_per_video=5, size=32)
    argv = ["--preset", "temporal_256", "--data.dataroot", data,
            "--data.n_frames_total", "3", "--train.niter", "1",
            "--train.niter_decay", "0", "--train.display_freq", "2",
            "--train.save_latest_freq", "2"] + TINY
    runs, _ = _run_both(tmp_path, argv, 3)
    labels, got, _ = _check_same_run(runs)
    assert labels == {} and [r["step"] for r in got] == [1, 2, 3]
    assert sorted(os.listdir(os.path.join(runs["port"], "ckpt"))) == \
        ["2.pt", "3.pt"]


# ---------------------------------------------------------------------------
# Resume: bit for bit the uninterrupted run
# ---------------------------------------------------------------------------

def _state(run, step):
    state = torch.load(os.path.join(run, "ckpt", f"{step}.pt"),
                       weights_only=True)
    state.pop("config")  # names the run
    return state


def _equal(x, y):
    if isinstance(x, torch.Tensor):
        return x.dtype == y.dtype and torch.equal(x, y)
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_equal(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(map(_equal, x, y))
    return x == y


@pytest.mark.parametrize("extra", [[], ["--loss.pool_size", "2",
                                        "--model.use_dropout", "true"]],
                         ids=["plain", "pool_dropout"])
def test_resumed_run_ends_bit_identical(tmp_path, extra):
    # serial batches: the relaunched loader's first epoch is the
    # uninterrupted run's second; fp32 on the CPU is deterministic
    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n=3, size=32)
    argv = ["--model.net_g", "resnet_6blocks", "--data.dataroot", data,
            "--data.serial_batches", "true", "--train.niter_decay", "0",
            "--train.checkpoints_dir", str(tmp_path), "--device", "cpu",
            ] + TINY + extra
    assert main(argv + ["--train.name", "whole", "--train.niter", "2"]) == 0
    assert main(argv + ["--train.name", "parts", "--train.niter", "1"]) == 0
    assert main(argv + ["--train.name", "parts", "--train.niter", "2",
                        "--train.continue_train", "true"]) == 0
    whole, parts = _state(str(tmp_path / "whole"), 6), \
        _state(str(tmp_path / "parts"), 6)
    assert whole["step"] == parts["step"] == 6
    if extra:
        assert int(whole["pool"]["count"]) == 2
    assert _equal(parts, whole)
    steps = [r["step"] for r in _records(str(tmp_path / "parts"))]
    assert steps == [1, 2, 3, 4, 5, 6]


# ---------------------------------------------------------------------------
# The Trainer's cadence, against JAX's Trainer
# ---------------------------------------------------------------------------

def _run_files(run):
    steps = sorted(int(f.split(".")[0]) for f in os.listdir(
        os.path.join(run, "ckpt")) if f[0].isdigit())
    lines = open(os.path.join(run, "loss_log.txt")).read().splitlines()
    images = sorted(os.listdir(os.path.join(run, "web", "images")))
    return steps, _labels(run), len(lines), len(_records(run)), images


def test_trainer_cadence_matches_jaxs_trainer(tmp_path):
    # 3 steps an epoch, 9 steps: log lines at 2, 4, 6, 8; images at 4, 8;
    # saves at 4, 8 (save_latest_freq), 6 (epoch 2) and the final 9
    argv = ["--model.net_g", "resnet_6blocks", "--model.ngf", "4",
            "--model.ndf", "8", "--loss.no_vgg_loss", "true",
            "--data.crop_size", "32", "--train.num_devices", "1",
            "--train.niter", "2", "--train.niter_decay", "1",
            "--train.print_freq", "2", "--train.display_freq", "4",
            "--train.save_latest_freq", "4", "--train.save_epoch_freq", "2",
            "--train.name", "cadence"]
    host = synthetic_pair_batch(1, 32)
    cfg = parse_cli(argv + ["--train.checkpoints_dir", str(tmp_path / "p")])
    trainer = Trainer(create_model(cfg, device="cpu", steps_per_epoch=3),
                      cfg, visualizer=Visualizer(cfg.run_dir(), "cadence"))
    batch = {k: normalize(torch.from_numpy(host[k])) for k in "ab"}
    trainer.init_or_restore()
    trainer.fit(batch for _ in range(20))

    jcfg = jax_parse_cli(argv + ["--train.checkpoints_dir",
                                 str(tmp_path / "j")])
    jtrainer = JaxTrainer(jax_create_model(jcfg, steps_per_epoch=3), jcfg,
                          visualizer=JaxVisualizer(jcfg.run_dir(), "cadence"))
    jbatch = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    state = jtrainer.init_or_restore(jax.random.PRNGKey(0), jbatch)
    jtrainer.fit(state, (jbatch for _ in range(20)))
    jtrainer.ckpt.close()

    got = _run_files(cfg.run_dir())
    assert got == _run_files(jcfg.run_dir())
    assert got[:4] == ([4, 6, 8, 9], {"2": 6}, 5, 4)  # 5: the log's header


# ---------------------------------------------------------------------------
# Refusals and the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,match", [
    (["--infer.quant", "int8"], "serving-only"),
    (["--data.dataset_mode", "single"], "no ground-truth"),
    (["--model.model", "cycle_gan", "--data.dataset_mode", "temporal"],
     "not temporal windows"),
])
def test_cli_refuses_what_jax_refuses(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        main(argv + ["--device", "cpu", "--data.dataroot", str(tmp_path)])


@pytest.mark.parametrize("dtype,tf32", [("float32", False), ("bf16", True)])
def test_fp32_train_turns_tf32_off(monkeypatch, tmp_path, dtype, tf32):
    """An fp32 model trains with full-fp32 convolutions and matmuls (the
    JAX package's HIGHEST precision), as cli.infer serves; bf16 leaves the
    TF32 flags as they were."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(FileNotFoundError, match="folder pair"):
        main(["--device", "cpu", "--model.compute_dtype", dtype,
              "--data.dataroot", str(tmp_path)])
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_tf32 is tf32


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is legal here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--data.dataroot", str(tmp_path)])
