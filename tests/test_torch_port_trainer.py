"""The port's Trainer and obs layer on the CPU: every test of
tests/test_trainer_integration.py on the port (fit and resume,
load_pretrain and the global-into-local graft, which_epoch resume and a
fresh run that overwrites, a bf16 pool restored from an fp32 file, the
display's conditioning, a finished run relaunched), the refusals, and the
obs copies against JAX's (TensorBoard records byte for byte,
loss_log.txt, metrics.jsonl and the web page). The cadence against JAX's
Trainer is in test_torch_port_cli_train.py, beside the JAX runs whose
compiled shapes it shares."""

import dataclasses
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from ir2rgb_tpu.obs import tb as jtb
from ir2rgb_tpu.obs.visualizer import Visualizer as JVisualizer

from ir2rgb_tpu_torch.config import (
    Config,
    DataConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from ir2rgb_tpu_torch.data.synthetic import synthetic_pair_batch
from ir2rgb_tpu_torch.data.transforms import normalize
from ir2rgb_tpu_torch.obs import Visualizer
from ir2rgb_tpu_torch.obs import tb as ptb
from ir2rgb_tpu_torch.train import Trainer, create_model

TINY = dict(model="pix2pix", net_g="resnet_6blocks", net_d="n_layers",
            ngf=4, ndf=4)


def _cfg(tmp_path, model=None, **train_kw):
    defaults = dict(name="trainer_it", checkpoints_dir=str(tmp_path),
                    niter=1, niter_decay=0, print_freq=2, display_freq=4,
                    save_latest_freq=100)
    defaults.update(train_kw)
    return Config(model=ModelConfig(**(model or TINY)),
                  data=DataConfig(crop_size=32, batch_size=2),
                  loss=LossConfig(no_vgg_loss=True),
                  train=TrainConfig(**defaults))


def _batch():
    host = synthetic_pair_batch(2, 32)
    return {k: normalize(torch.from_numpy(host[k])) for k in ("a", "b")}


def _batches(n):
    batch = _batch()
    for _ in range(n):
        yield batch


def _trainer(cfg, spe, visualizer=None):
    model = create_model(cfg, device="cpu", steps_per_epoch=spe)
    return Trainer(model, cfg, visualizer=visualizer)


def test_trainer_fit_and_resume(tmp_path):
    cfg = _cfg(tmp_path)
    vis = Visualizer(cfg.run_dir(), cfg.train.name)
    trainer = _trainer(cfg, 3, vis)
    trainer.init_or_restore()
    trainer.fit(_batches(10))  # niter * spe = 3 steps
    assert trainer.model.step == 3
    run = cfg.run_dir()
    assert os.path.exists(os.path.join(run, "config.json"))
    assert "G_GAN" in open(os.path.join(run, "loss_log.txt")).read()
    assert os.path.exists(os.path.join(run, "metrics.jsonl"))
    assert trainer.ckpt.latest_step() == 3
    done = {k: v.clone() for k, v in trainer.model.netG.state_dict().items()}

    cfg2 = _cfg(tmp_path, continue_train=True, niter=2)
    trainer2 = _trainer(cfg2, 3, vis)
    trainer2.init_or_restore()
    assert trainer2.model.step == 3
    assert all(torch.equal(v, done[k])
               for k, v in trainer2.model.netG.state_dict().items())
    trainer2.fit(_batches(10))
    assert trainer2.model.step == 6


def test_trainer_load_pretrain(tmp_path):
    cfg = _cfg(tmp_path / "src")
    trainer = _trainer(cfg, 2)
    trainer.fit(_batches(4))
    cfg2 = _cfg(tmp_path / "dst", load_pretrain=cfg.run_dir())
    trainer2 = _trainer(cfg2, 2)
    trainer2.init_or_restore()
    # warm-started weights, fresh step counter and optimizers
    assert trainer2.model.step == 0 and not trainer2.model.opt_g.state
    for net in ("netG", "netD"):
        src = getattr(trainer.model, net).state_dict()
        for k, v in getattr(trainer2.model, net).state_dict().items():
            assert torch.equal(v, src[k]), (net, k)


def test_which_epoch_resume_and_fresh_run_overwrite(tmp_path):
    cfg = _cfg(tmp_path, niter=3, save_epoch_freq=1)
    trainer = _trainer(cfg, 2)
    trainer.init_or_restore()
    trainer.fit(_batches(10))
    assert trainer.model.step == 6
    assert trainer.ckpt.all_steps() == [2, 4, 6]
    assert trainer.ckpt.step_for_label("2") == 4
    assert trainer.ckpt.step_for_label("latest") == 6
    with pytest.raises(FileNotFoundError):
        trainer.ckpt.step_for_label("9")

    # resume from the named, non-latest epoch 2: the fork drops step 6,
    # and training past it saves it again
    cfg2 = _cfg(tmp_path, niter=3, save_epoch_freq=1, continue_train=True,
                which_epoch="2")
    trainer2 = _trainer(cfg2, 2)
    trainer2.init_or_restore()
    assert trainer2.model.step == 4
    assert trainer2.ckpt.all_steps() == [2, 4]
    trainer2.fit(_batches(10))
    assert trainer2.model.step == 6
    assert trainer2.ckpt.all_steps() == [2, 4, 6]

    # a fresh run into the same directory: old steps cleared
    cfg3 = _cfg(tmp_path, niter=1, save_epoch_freq=1)
    trainer3 = _trainer(cfg3, 2)
    assert trainer3.ckpt.latest_step() is None
    trainer3.init_or_restore()
    trainer3.fit(_batches(5))
    assert trainer3.model.step == 2
    assert trainer3.ckpt.all_steps() == [2]


def test_restore_casts_an_fp32_pool_to_the_compute_dtype(tmp_path):
    def cfg_bf16(**kw):
        c = _cfg(tmp_path, **kw)
        return dataclasses.replace(
            c, model=dataclasses.replace(c.model, compute_dtype="bf16"),
            loss=dataclasses.replace(c.loss, pool_size=4))

    trainer = _trainer(cfg_bf16(), 3)
    state = trainer.model.state_dict()
    assert trainer.model.pool.buffer.dtype == torch.bfloat16
    state["pool"] = {"buffer": state["pool"]["buffer"].float() + 0.5,
                     "count": state["pool"]["count"] + 2}
    state["step"] = 1
    trainer.ckpt.save(1, state)
    trainer.ckpt.wait()

    trainer2 = _trainer(cfg_bf16(continue_train=True), 3)
    trainer2.init_or_restore()
    pool = trainer2.model.pool
    assert trainer2.model.step == 1 and int(pool.count) == 2
    assert pool.buffer.dtype == torch.bfloat16
    assert bool((pool.buffer == 0.5).all())
    trainer2.model.train_step(_batch())
    assert trainer2.model.step == 2


class _Shown:
    def __init__(self):
        self.calls = []

    def display_current_results(self, visuals, epoch, step):
        self.calls.append((visuals, epoch, step))

    def flush(self):
        pass


def test_display_uses_conditioning(tmp_path):
    # the display of an edge model is generated with the batch's instance
    # edges, as training sees them, not the zeros prior
    from ir2rgb_tpu_torch.infer.stream import tensor2im
    model = dict(TINY, net_g="local", model="pix2pixhd", n_downsample_global=2,
                 n_blocks_global=1, n_blocks_local=1, use_instance_edges=True)
    cfg = _cfg(tmp_path, model=model)
    shown = _Shown()
    trainer = _trainer(cfg, 10, shown)
    rng = np.random.RandomState(0)
    batch = {"a": torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32)),
             "b": torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32)),
             "inst": torch.from_numpy(rng.randint(0, 5, (2, 32, 32)))}
    trainer._display(batch, 12)
    visuals, epoch, step = shown.calls[0]
    assert (epoch, step) == (2, 12)
    assert visuals["generated"].shape == (32, 32, 3)
    prior = tensor2im(trainer.model.generate(batch["a"][:1]))
    assert not np.array_equal(visuals["generated"], prior)
    np.testing.assert_array_equal(visuals["target"], tensor2im(batch["b"][:1]))


def test_load_pretrain_global_into_local(tmp_path):
    # the pix2pixHD coarse-to-fine warm start: a global G's trunk grafts
    # into the local enhancer's, whose own branch keeps its fresh init
    glob = dict(TINY, model="pix2pixhd", net_g="global", ngf=8,
                n_downsample_global=2, n_blocks_global=1)
    cfg = _cfg(tmp_path / "src", model=glob)
    trainer = _trainer(cfg, 2)
    trainer.fit(_batches(3))
    local = dict(glob, net_g="local", ngf=4, n_blocks_local=1)
    cfg2 = _cfg(tmp_path / "dst", model=local, load_pretrain=cfg.run_dir(),
                niter_fix_global=1)
    trainer2 = _trainer(cfg2, 2)
    fresh = {k: v.clone() for k, v in trainer2.model.netG.state_dict().items()}
    trainer2.init_or_restore()
    g1 = trainer.model.netG.state_dict()
    g2 = trainer2.model.netG.state_dict()
    trunk = [k for k in g2 if k.startswith("model.")]
    assert trunk and all(torch.equal(g2[k], g1[k]) for k in trunk)
    # the global's output head has no place in the trunk: not copied
    assert any(k.startswith("model.") and k not in g2 for k in g1)
    branch = [k for k in g2 if k.startswith("model1_")]
    assert branch and all(torch.equal(g2[k], fresh[k]) for k in branch)


def test_completed_run_relaunch_is_noop(tmp_path):
    cfg = _cfg(tmp_path, niter=1)
    trainer = _trainer(cfg, 2)
    trainer.fit(_batches(5))
    assert trainer.model.step == 2
    files = sorted(os.listdir(os.path.join(cfg.run_dir(), "ckpt")))

    cfg2 = _cfg(tmp_path, niter=1, continue_train=True)
    trainer2 = _trainer(cfg2, 2)
    trainer2.init_or_restore()
    trainer2.fit(_batches(5))
    assert trainer2.model.step == 2 and trainer2._last_saved is None
    assert sorted(os.listdir(os.path.join(cfg.run_dir(), "ckpt"))) == files


@pytest.mark.parametrize("field,value", [("num_devices", 2),
                                         ("spatial_devices", 2),
                                         ("multihost", True)])
def test_unported_parallel_training_raises_before_any_step(tmp_path, field,
                                                           value):
    cfg = _cfg(tmp_path, **{field: value})
    model = create_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Trainer(model, cfg)
    assert not os.path.exists(cfg.run_dir())


def test_every_visible_card_is_refused_not_one_silently(tmp_path,
                                                      monkeypatch):
    # num_devices 0 means every visible device; with two cards the port
    # would train on one, so it refuses before anything is written
    import types
    cfg = _cfg(tmp_path)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    card_model = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="2 devices"):
        Trainer(card_model, cfg)
    assert not os.path.exists(cfg.run_dir())
    cfg1 = _cfg(tmp_path, num_devices=1)
    assert Trainer(card_model, cfg1).model is card_model


def test_unported_step_options_raise_through_fit(tmp_path):
    # grad-accum is ported (the name predates it): two accumulated steps
    # through fit equal two bare train steps of a twin model, parameter for
    # parameter, and the run checkpoints them
    cfg = _cfg(tmp_path, grad_accum=2)
    trainer = _trainer(cfg, 2)
    twin = _trainer(cfg, 2).model
    trainer.fit(_batches(2))
    for batch in _batches(2):
        twin.train_step(batch)
    assert trainer.model.step == twin.step == 2
    for (k, p), q in zip(trainer.model.netG.named_parameters(),
                         twin.netG.parameters()):
        assert torch.equal(p, q), k
    assert trainer.ckpt.all_steps()


# ---------------------------------------------------------------------------
# obs: the copies against JAX's
# ---------------------------------------------------------------------------

def test_tb_records_are_jaxs_bytes(tmp_path, monkeypatch):
    for mod in (ptb, jtb):
        monkeypatch.setattr(mod.time, "time", lambda: 1234567.25)
    png = bytes(range(256)) * 3
    paths = []
    for mod, sub in ((ptb, "port"), (jtb, "jax")):
        w = mod.TBEventWriter(str(tmp_path / sub))
        w.add_scalar("loss/G_GAN", 0.731, 7)
        w.add_scalars({"loss/D_real": 0.25, "perf/step_time": 1e-3}, -1)
        w.add_image("sample", png, 16, 24, 9)
        w.close()
        paths.append(w.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_visualizer_writes_jaxs_records(tmp_path):
    errors = {"D_fake": 0.25, "G_GAN": 1.5, "G_L1": 65.0625}
    img = (np.arange(8 * 8 * 3) % 256).astype(np.uint8).reshape(8, 8, 3)
    runs = {}
    for cls, sub in ((Visualizer, "port"), (JVisualizer, "jax")):
        vis = cls(str(tmp_path / sub), "exp")
        for step in (2, 4):
            vis.print_current_errors(1, step, errors, 0.125)
            vis.display_current_results({"input": img, "generated": img},
                                        1, step)
        vis.flush()
        run = str(tmp_path / sub)
        runs[sub] = (open(os.path.join(run, "loss_log.txt")).read()
                     .splitlines()[1:],  # the header holds the time
                     [json.loads(x) for x in open(
                         os.path.join(run, "metrics.jsonl"))],
                     open(os.path.join(run, "web", "index.html")).read(),
                     sorted(os.listdir(os.path.join(run, "web", "images"))))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][0] == ("(epoch: 1, iters: 2, time: 0.125) "
                                  "D_fake: 0.250 G_GAN: 1.500 G_L1: 65.062")


def test_profiler_trace_is_written(tmp_path):
    vis = Visualizer(str(tmp_path), "prof")
    vis.start_profiler_trace()
    with vis.profile("span"):
        torch.ones(4).sum()
    path = vis.stop_profiler_trace()
    assert path.startswith(str(tmp_path / "trace"))
    assert "span" in open(path).read()


# ---------------------------------------------------------------------------
# Kernel launches through the Trainer, on the meta device
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _meta_model(cfg):
    from ir2rgb_tpu_torch.nn import Vgg19, define_d, define_g
    from ir2rgb_tpu_torch.train import GanModel, network_configs
    from ir2rgb_tpu_torch.train.cycle import (
        CycleGanModel,
        cycle_network_configs,
    )
    from ir2rgb_tpu_torch.train.schedule import lr_schedule
    if cfg.model.model == "cycle_gan":
        g_a, g_b, d_a, d_b = cycle_network_configs(cfg)
        with torch.device("meta"):
            nets = [define_g(g_a), define_g(g_b), define_d(d_a),
                    define_d(d_b)]
        return CycleGanModel(
            cfg=cfg, gen_cfg=g_a, netG=nets[0], netG_B=nets[1], gen_cfg_b=g_b,
            disc_cfg=d_a, netD=nets[2], netD_B=nets[3], disc_cfg_b=d_b,
            device=torch.device("meta"),
            opt_g=torch.optim.Adam([*nets[0].parameters(),
                                    *nets[1].parameters()]),
            opt_d=torch.optim.Adam([*nets[2].parameters(),
                                    *nets[3].parameters()]),
            schedule=lr_schedule("linear", 2e-4, 1, 1, 1, 50),
            steps_per_epoch=100)
    gen_cfg, disc_cfg = network_configs(cfg)
    with torch.device("meta"):
        g, d = define_g(gen_cfg), define_d(disc_cfg)
        vgg = None if cfg.loss.no_vgg_loss else Vgg19().requires_grad_(False)
    return GanModel(cfg=cfg, gen_cfg=gen_cfg, netG=g, netD=d, vgg=vgg,
                    device=torch.device("meta"), disc_cfg=disc_cfg,
                    opt_g=torch.optim.Adam(g.parameters()),
                    opt_d=torch.optim.Adam(d.parameters()),
                    schedule=lr_schedule("linear", 2e-4, 1, 1, 1, 50),
                    steps_per_epoch=100,
                    fix_steps=100 if cfg.model.net_g == "local" else 0)


@pytest.mark.parametrize("name", sorted(_chip_smoke().TRAIN))
def test_fit_step_and_display_send_chip_smokes_shapes(tmp_path, monkeypatch,
                                                      name):
    # one full-size bf16 Trainer.fit step (frozen where the preset trains
    # coarse to fine) and its display: what reaches each kernel wrapper
    # is the bare step's TRAIN row and the served frame's SERVE row, which
    # chip_smoke.py checks and times the kernels at
    from ir2rgb_tpu_torch import kernels
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.infer import stream
    from ir2rgb_tpu_torch.kernels import d2s as b3
    from ir2rgb_tpu_torch.nn import ops
    counts = {k: {} for k in ("b1", "b1_bwd", "d2s", "s2d", "tail")}

    def add(table, key):
        counts[table][key] = counts[table].get(key, 0) + 1

    class Norm(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, act):
            ctx.key = (tuple(x.shape), act)
            add("b1", ctx.key)
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            add("b1_bwd", ctx.key)
            return g, None

    class Interleave(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y, c):
            add("d2s", (tuple(y.shape), c))
            return b3.d2s_reference(y, c)

        @staticmethod
        def backward(ctx, g):
            add("s2d", tuple(g.shape))
            return b3.s2d_reference(g), None

    def tail(x, w, b):
        add("tail", tuple(x.shape))
        return x[..., :3]

    monkeypatch.setattr(ops, "fused_instance_norm_act",
                        lambda x, act="relu", negative_slope=0.2:
                        Norm.apply(x, act))
    monkeypatch.setattr(ops, "d2s_fn", Interleave.apply)
    monkeypatch.setattr(kernels, "tail_fused", tail)
    monkeypatch.setattr(stream, "tensor2im", lambda t: t)
    cfg = PRESETS[name]
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="bf16"),
        train=dataclasses.replace(cfg.train, checkpoints_dir=str(tmp_path),
                                  display_freq=1))
    shown = _Shown()
    trainer = Trainer(_meta_model(cfg), cfg, visualizer=shown)
    trainer._save = lambda step: None  # no file of meta tensors
    size = cfg.data.crop_size
    lead = (1, cfg.data.n_frames_total) if cfg.model.model == "temporal" \
        else (1,)
    batch = {k: torch.empty(lead + (size, size, 3), device="meta")
             for k in "ab"}
    step = {}

    def train_step(b):
        out = type(trainer.model).train_step(trainer.model, b)
        step.update({k: dict(v) for k, v in counts.items()})
        for v in counts.values():
            v.clear()
        return out

    trainer.model.train_step = train_step
    trainer.fit([batch], total_steps=1)
    assert trainer.model.step == 1 and len(shown.calls) == 1
    table = _chip_smoke().TRAIN[name]
    want = table["frozen" if "frozen" in table else "unfrozen"]
    assert {k: step[k] for k in want} == want and not step["tail"]
    serve = _chip_smoke().SERVE[name]
    assert counts["b1"] == serve["b1"]
    assert list(counts["tail"]) == serve["tail"]
    assert counts["d2s"] == Counter(serve["d2s"])
    assert not counts["b1_bwd"] and not counts["s2d"]
