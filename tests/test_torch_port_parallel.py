"""Data-parallel training of the port (``ir2rgb_tpu_torch/parallel/``) on
the CPU: two gloo ranks against the port's one-process step of the same
global batch, and against the JAX package's 8-device data-parallel step.

- (a) pix2pix ``resnet_6blocks``, ngf / ndf 8, crop 32 from 40, a global
  batch of 4 (two rows a rank), one step of each variant: plain; a full
  pool of 4 with dropout; grad-accum 2; batch norm; WGAN-GP. Every draw
  (crop and flip, dropout masks, pool decisions, the penalty's mixing
  weights) equal bit for bit to the one-process draw's rows, the metrics
  within rtol 1e-5, every gradient under ``_mixed_bar`` at 1e-4
  (``tests/test_torch_port_train.py``), the parameters after the step
  within atol 5e-4 (JAX's bar, ``tests/test_parallel.py:80-85``: Adam's
  first update is about lr·sign(g)), and the two replicas equal bit for
  bit. Rank 1 builds its model from another seed: ``replicate`` makes it
  rank 0's.
- (b) the same machinery on ``tests/test_parallel.py``'s config and JAX's
  weights against ``jax.jit`` of ``train_step`` on conftest's 8 virtual
  devices: JAX's own DP bars.
- (c) CycleGAN (``tests/test_cyclegan.py:300``'s counterpart) with both
  pools.
- (d) ``Trainer.fit`` on two ranks and a resume: rank 1 writes nothing,
  both restore rank 0's files bit for bit.
- (e) ``torchrun`` of ``cli.train --device cpu`` on two ranks.
- (f)-(i) ``shard_batch``'s layout, ``initialize``'s rules, ``num_devices``'
  rules and ``dp_sp_mesh``'s ``ValueError``s (JAX's), and its dp×sp
  layout (JAX's; spatially partitioned serving itself is
  ``tests/test_torch_port_spatial.py``).

The file is also its own worker (``python tests/test_torch_port_parallel.py
PORT RANK WORLD OUT JOB``): each case starts its ranks on a free port, one
torch thread a process, with a 60 s timeout on the group and on the wait,
and kills them on failure. The ranks of (a)-(c) run every case in one
launch."""

import builtins
import contextlib
import os
import pathlib
import signal
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from ir2rgb_tpu_torch.config import (  # noqa: E402
    Config,
    DataConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from ir2rgb_tpu_torch.data import transforms  # noqa: E402
from ir2rgb_tpu_torch.losses import gan  # noqa: E402
from ir2rgb_tpu_torch.nn import ops  # noqa: E402
from ir2rgb_tpu_torch.parallel import (  # noqa: E402
    data_parallel_mesh,
    dp_sp_mesh,
    multihost,
    replicate,
    shard_batch,
)
from ir2rgb_tpu_torch.parallel.mesh import local_rows, sharded  # noqa: E402
from ir2rgb_tpu_torch.train import create_model, image_pool  # noqa: E402
from ir2rgb_tpu_torch.train.image_pool import PoolState  # noqa: E402

TIMEOUT_S = 60
LOAD, CROP, BATCH = 40, 32, 4

BASE = dict(model="pix2pix", net_g="resnet_6blocks", net_d="n_layers",
            ngf=8, ndf=8)
# (a): variant -> (model, loss, train) overrides
VARIANTS = {
    "plain": ({}, {}, {}),
    "pool_dropout": ({"use_dropout": True}, {"pool_size": 4}, {}),
    "accum": ({}, {}, {"grad_accum": 2}),
    "batch_norm": ({"norm": "batch"}, {}, {}),
    "wgangp": ({}, {"gan_mode": "wgangp"}, {}),
}
CYCLE = "cycle"
JAX_CASE = "jax"


def _cfg(name):
    if name == CYCLE:
        return Config(
            model=ModelConfig(model="cycle_gan", net_g="resnet_6blocks",
                              net_d="n_layers", ngf=8, ndf=8,
                              get_interm_feat=False),
            data=DataConfig(dataset_mode="unaligned", crop_size=CROP,
                            batch_size=BATCH),
            loss=LossConfig(no_vgg_loss=True, no_gan_feat_loss=True,
                            lambda_l1=0.0, pool_size=4),
            train=TrainConfig())
    if name == JAX_CASE:  # tests/test_parallel.py:24-31, pool 0
        return Config(model=ModelConfig(**BASE),
                      data=DataConfig(crop_size=32, batch_size=8),
                      loss=LossConfig(no_vgg_loss=True, pool_size=0),
                      train=TrainConfig())
    model, loss, train = VARIANTS[name]
    return Config(model=ModelConfig(**{**BASE, **model}),
                  data=DataConfig(crop_size=CROP, batch_size=BATCH),
                  loss=LossConfig(no_vgg_loss=True, **loss),
                  train=TrainConfig(**train))


def _u8_batch(seed):
    r = np.random.RandomState(seed)
    return {k: torch.from_numpy(r.randint(0, 256, (BATCH, LOAD, LOAD, 3),
                                          dtype=np.uint8)) for k in "ab"}


def _jax_batch():
    from ir2rgb_tpu_torch.data.synthetic import synthetic_pair_batch
    host = synthetic_pair_batch(8, 32)
    return {k: torch.from_numpy(host[k].astype(np.float32) / 127.5 - 1.0)
            for k in ("a", "b")}


def _fill_pool(model):
    """A full pool of seeded frames, so one step swaps."""
    def full(p, seed):
        r = np.random.RandomState(seed)
        buf = torch.from_numpy(r.uniform(-1, 1, tuple(p.buffer.shape))
                               .astype(np.float32)).to(p.buffer.dtype)
        return PoolState(buf, torch.tensor(p.buffer.shape[0]))
    if isinstance(model.pool, dict):
        model.pool = {k: full(p, i + 20)
                      for i, (k, p) in enumerate(sorted(model.pool.items()))}
    elif model.pool is not None:
        model.pool = full(model.pool, 20)


@contextlib.contextmanager
def _recorded():
    """Every draw the step and the transforms make, in order, as the
    caller received it: crop/flip (this process's rows), dropout masks,
    the penalty's weights, the pool's decisions (global in both)."""
    rec = {"crop": [], "dropout": [], "eps": [], "pool": []}
    saved = [(transforms, "_draw"), (ops, "dropout_mask"),
             (gan, "draw_eps"), (image_pool, "draw_decisions")]
    originals = [getattr(m, n) for m, n in saved]

    def wrap(fn, key):
        def run(*a, **kw):
            out = fn(*a, **kw)
            rec[key].append([x.clone() for x in out]
                            if isinstance(out, tuple) else out.clone())
            return out
        return run
    for (m, n), fn, key in zip(saved, originals, rec):
        setattr(m, n, wrap(fn, key))
    try:
        yield rec
    finally:
        for (m, n), fn in zip(saved, originals):
            setattr(m, n, fn)


def _weights(model):
    return {f"{net}.{k}": v.detach().clone()
            for net, mod in (*model.g_nets().items(),
                             *model.d_nets().items())
            for k, v in mod.state_dict().items()}


def _grads(model):
    return {f"{net}.{k}": p.grad.clone()
            for net, mod in (*model.g_nets().items(),
                             *model.d_nets().items())
            for k, p in mod.named_parameters() if p.grad is not None}


def _pools(model):
    pools = model.pool if isinstance(model.pool, dict) else {"": model.pool}
    return {k: (p.buffer.clone(), p.count.clone())
            for k, p in pools.items() if p is not None}


def run_case(name, mesh=None, weights=None):
    """One train step of case ``name`` on this process's rows (all of
    them without ``mesh``); what it drew, computed and left."""
    cfg = _cfg(name)
    rank = 0 if mesh is None else mesh.rank
    model = create_model(cfg, device="cpu", steps_per_epoch=10,
                         seed=7 * rank)
    if weights is not None:
        model.netG.load_state_dict(weights["netG"])
        model.netD.load_state_dict(weights["netD"])
    _fill_pool(model)
    accum = cfg.train.grad_accum
    with _recorded() as rec:
        if mesh is not None:
            replicate(model, mesh)
        if name == JAX_CASE:
            batch = _jax_batch()
            if mesh is not None:
                batch = shard_batch(batch, mesh)
        else:
            u8 = _u8_batch(3)
            if mesh is not None:
                u8 = shard_batch(u8, mesh, accum)
            gen = torch.Generator().manual_seed(5)
            with sharded(mesh, accum):
                batch = transforms.preprocess_pair_batch(
                    u8["a"], u8["b"], gen, CROP, unpaired=name == CYCLE)
        metrics = model.train_step(batch)
    return {"metrics": {k: v.clone() for k, v in metrics.items()},
            "grads": _grads(model), "weights": _weights(model),
            "pools": _pools(model), "draws": rec, "batch": batch}


# ---------------------------------------------------------------------------
# (d) Trainer.fit on two ranks, with a resume
# ---------------------------------------------------------------------------

def _fit_cfg(out, **train):
    return Config(model=ModelConfig(**{**BASE, "ngf": 4, "ndf": 4}),
                  data=DataConfig(crop_size=32, batch_size=2),
                  loss=LossConfig(no_vgg_loss=True, pool_size=2),
                  train=TrainConfig(name="dp_fit", checkpoints_dir=str(out),
                                    niter=1, niter_decay=0, print_freq=1,
                                    save_latest_freq=2, **train))


@contextlib.contextmanager
def _writes_under(root):
    """Every attempt to write under ``root``: open for writing, remove,
    replace, rename, mkdir."""
    root = os.path.abspath(root)
    seen = []
    real_open = open
    patched = {}

    def under(p):
        return os.path.abspath(os.fspath(p)).startswith(root)

    def op(name):
        fn = getattr(os, name)
        patched[name] = fn

        def run(*a, **kw):
            # a mkdir of a directory that exists writes nothing
            if under(a[0]) and not (name == "mkdir"
                                    and os.path.exists(a[0])):
                seen.append((name, os.fspath(a[0])))
            return fn(*a, **kw)
        return run

    def open_(file, mode="r", *a, **kw):
        if isinstance(file, (str, os.PathLike)) and under(file) and any(
                c in mode for c in "wax+"):
            seen.append(("open", os.fspath(file)))
        return real_open(file, mode, *a, **kw)
    for name in ("remove", "replace", "rename", "mkdir"):
        setattr(os, name, op(name))
    builtins.open = open_
    try:
        yield seen
    finally:
        builtins.open = real_open
        for name, fn in patched.items():
            setattr(os, name, fn)


def _state(model):
    """A copy of ``model.state_dict()`` (its tensors are the live ones),
    the config aside."""
    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, dict):
            return {k: copy(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(copy(x) for x in v)
        return v
    st = copy(model.state_dict())
    st.pop("config")
    return st


def _same(x, y):
    if isinstance(x, torch.Tensor):
        return (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                and torch.equal(x, y))
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(map(_same, x, y))
    return x == y


def fit_job(mesh, out):
    from ir2rgb_tpu_torch.train import Trainer
    batch = shard_batch({k: v[:2] for k, v in _jax_batch().items()}, mesh)

    def data(n):
        for _ in range(n):
            yield batch
    cm = _writes_under(out) if mesh.rank else contextlib.nullcontext([])
    with cm as writes:
        cfg = _fit_cfg(out)
        trainer = Trainer(create_model(cfg, device="cpu", steps_per_epoch=4,
                                       seed=7 * mesh.rank), cfg)
        trainer.init_or_restore()
        trainer.fit(data(3), total_steps=3)
        end = _state(trainer.model)
        cfg2 = _fit_cfg(out, continue_train=True)
        resumed = Trainer(create_model(cfg2, device="cpu", steps_per_epoch=4,
                                       seed=11), cfg2)
        resumed.init_or_restore()
        back = _state(resumed.model)
        on_disk = resumed.ckpt.restore(3)
        on_disk.pop("config")
        resumed.fit(data(2), total_steps=4)
        final = _state(resumed.model)
    return {"writes": list(writes), "step": resumed.model.step,
            "restored_is_end": _same(end, back),
            "restored_is_disk": _same(on_disk, back), "final": final,
            "ckpts": sorted(os.listdir(os.path.join(cfg.run_dir(), "ckpt")))}


def worker(port, rank, world, out, job):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=world, process_id=rank,
                         timeout_s=TIMEOUT_S)
    mesh = data_parallel_mesh(world, device="cpu")
    res = {}
    if job == "steps":
        try:
            data_parallel_mesh(world + 1)
        except ValueError as e:
            res["mismatch"] = str(e)
        weights = torch.load(os.path.join(out, "jax_weights.pt"))
        for name in [*VARIANTS, CYCLE, JAX_CASE]:
            res[name] = run_case(name, mesh,
                                 weights if name == JAX_CASE else None)
    else:
        res = fit_job(mesh, os.path.join(out, "runs"))
    torch.save(res, os.path.join(out, f"{job}_rank{rank}.pt"))
    mesh.barrier()
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# The launcher side
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
            "CUDA_VISIBLE_DEVICES": ""}


def _wait_all(procs):
    """Wait for every process (``TIMEOUT_S`` each); kill them all and
    fail on a timeout or a non-zero exit."""
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    assert outs is not None, "a rank hung past its timeout"
    bad = [f"rank {r} exited {p.returncode}:\n{e[-3000:]}"
           for r, (p, (_, e)) in enumerate(zip(procs, outs)) if p.returncode]
    assert not bad, "\n".join(bad)
    return outs


def launch(out, job, world=2):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(r), str(world), str(out),
         job], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
        for r in range(world)]
    _wait_all(procs)
    return [torch.load(os.path.join(out, f"{job}_rank{r}.pt"))
            for r in range(world)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(model):
    """``tests/test_parallel.py``'s initial JAX state (``init_state`` at
    key 0, jitted: ~8 s here against ~25 s op by op) and its weights as
    the port's state_dicts."""
    import jax
    from ir2rgb_tpu_torch.checkpoint import (
        discriminator_state_dict_from_jax,
        generator_state_dict_from_jax,
    )
    batch = {k: v.numpy() for k, v in _jax_batch().items()}
    state = jax.jit(model.init_state)(jax.random.PRNGKey(0), batch)
    pm = create_model(_cfg(JAX_CASE), device="cpu")
    g = jax.tree.map(np.asarray, state.g_params)
    d = jax.tree.map(np.asarray, state.d_params)
    return state, {"netG": generator_state_dict_from_jax(g, pm.gen_cfg),
                   "netD": discriminator_state_dict_from_jax(d,
                                                             pm.disc_cfg)}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The two ranks' results of every step case, the one-process step of
    each, and JAX's 8-device step and gradients (computed while the ranks
    run)."""
    import jax
    from ir2rgb_tpu.config import Config as JConfig
    from ir2rgb_tpu.config import DataConfig as JDataConfig
    from ir2rgb_tpu.config import LossConfig as JLossConfig
    from ir2rgb_tpu.config import ModelConfig as JModelConfig
    from ir2rgb_tpu.config import TrainConfig as JTrainConfig
    from ir2rgb_tpu.parallel import (
        batch_sharding,
        replicate as jreplicate,
        shard_batch as jshard_batch,
    )
    from ir2rgb_tpu.parallel import data_parallel_mesh as jmesh
    from ir2rgb_tpu.train import create_model as jax_create_model

    out = tmp_path_factory.mktemp("dp")
    jcfg = JConfig(model=JModelConfig(**BASE),
                   data=JDataConfig(crop_size=32, batch_size=8),
                   loss=JLossConfig(no_vgg_loss=True, pool_size=0),
                   train=JTrainConfig())
    jm = jax_create_model(jcfg, steps_per_epoch=10)
    state, weights = _jax_state(jm)
    torch.save(weights, out / "jax_weights.pt")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(r), "2", str(out),
         "steps"], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
        for r in range(2)]
    try:
        # JAX's DP step on the 8 virtual devices; its gradient is its
        # Adam's first moment over 1 - beta1 (0.5: exact)
        batch = {k: jax.numpy.asarray(v.numpy())
                 for k, v in _jax_batch().items()}
        mesh = jmesh(8)
        rep, bsh = jreplicate(mesh), batch_sharding(mesh)
        s8, m8 = jax.jit(jm.train_step, in_shardings=(rep, bsh),
                         out_shardings=(rep, rep))(
            jax.device_put(state, rep), jshard_batch(batch, mesh))
        b1 = jcfg.train.beta1
        jax_side = {"metrics": {k: float(v) for k, v in m8.items()},
                    "grads": [jax.tree.map(lambda m: np.asarray(m) / (1 - b1),
                                           opt[0].mu)
                              for opt in (s8.g_opt, s8.d_opt)],
                    "g_params": jax.tree.map(np.asarray, s8.g_params),
                    "d_params": jax.tree.map(np.asarray, s8.d_params)}
        one = {name: run_case(name) for name in [*VARIANTS, CYCLE]}
    finally:
        _wait_all(procs)  # kills the ranks on a timeout
    ranks = [torch.load(out / f"steps_rank{r}.pt") for r in range(2)]
    return dict(ranks=ranks, one=one, jax=jax_side)


def _mixed_bar(got, want, rel):
    """Tensors whose ‖Δ‖₂ exceeds rel·‖want‖₂ + 1e-6·M (M the largest
    ‖want‖₂): ``tests/test_torch_port_train.py``'s bar."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    big = max(norms.values())
    return {k: (float((got[k] - v).norm()), norms[k])
            for k, v in want.items()
            if float((got[k] - v).norm()) > rel * norms[k] + 1e-6 * big}


def _check_draws(name, ranks, one):
    accum = _cfg(name).train.grad_accum
    for key in ("dropout", "eps"):
        assert len(one[key]) == len(ranks[0][key]) == len(ranks[1][key])
        for i, want in enumerate(one[key]):
            got = torch.cat([r[key][i] for r in ranks])
            assert torch.equal(got, want), (key, i)
    assert len(one["pool"]) == len(ranks[0]["pool"])
    for i, want in enumerate(one["pool"]):
        for r in ranks:
            assert all(map(torch.equal, r["pool"][i], want)), ("pool", i)
    assert len(one["crop"]) == len(ranks[0]["crop"]) > 0
    for i, want in enumerate(one["crop"]):
        for rank, r in enumerate(ranks):
            rows = local_rows(BATCH, 2, rank, accum)
            assert all(torch.equal(g, w[rows])
                       for g, w in zip(r["crop"][i], want)), ("crop", i)


@pytest.mark.parametrize("name", [*VARIANTS, CYCLE])
def test_dp_step_matches_one_process_step(dp, name):
    ranks = [r[name] for r in dp["ranks"]]
    one = dp["one"][name]
    if name == "pool_dropout":
        assert one["draws"]["dropout"] and one["draws"]["pool"]
    if name == "wgangp":
        assert one["draws"]["eps"]
    if name == CYCLE:
        assert len(one["draws"]["pool"]) == 2 and len(one["pools"]) == 2
    _check_draws(name, [r["draws"] for r in ranks], one["draws"])
    # the ranks' rows are the one-process batch's, after the transforms
    accum = _cfg(name).train.grad_accum
    for rank, r in enumerate(ranks):
        rows = local_rows(BATCH, 2, rank, accum)
        for k, v in r["batch"].items():
            assert torch.equal(v, one["batch"][k][rows]), k
    # the replicas are one: metrics, gradients, weights, pools
    r0, r1 = ranks
    for key in ("metrics", "grads", "weights"):
        assert r0[key].keys() == r1[key].keys()
        assert all(torch.equal(r0[key][k], r1[key][k]) for k in r0[key]), key
    for k in r0["pools"]:
        assert all(map(torch.equal, r0["pools"][k], r1["pools"][k]))
    # against the one-process step of the global batch
    assert r0["metrics"].keys() == one["metrics"].keys()
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(float(r0["metrics"][k]), float(v),
                                   rtol=1e-5, err_msg=k)
    assert r0["grads"].keys() == one["grads"].keys()
    for net in {k.split(".")[0] for k in one["grads"]}:
        keys = [k for k in one["grads"] if k.split(".")[0] == net]
        assert _mixed_bar({k: r0["grads"][k] for k in keys},
                          {k: one["grads"][k] for k in keys}, 1e-4) == {}
    for k, v in one["weights"].items():
        np.testing.assert_allclose(r0["weights"][k].numpy(), v.numpy(),
                                   atol=5e-4, err_msg=k)
    for k, (buf, count) in one["pools"].items():
        assert torch.equal(r0["pools"][k][1], count)
        np.testing.assert_allclose(r0["pools"][k][0].numpy(), buf.numpy(),
                                   atol=1e-5)


def test_dp_step_matches_jax_dp_step(dp):
    from ir2rgb_tpu_torch.checkpoint import (
        discriminator_state_dict_from_jax,
        generator_state_dict_from_jax,
    )
    r0 = dp["ranks"][0][JAX_CASE]
    jx = dp["jax"]
    assert r0["metrics"].keys() == jx["metrics"].keys()
    for k, v in jx["metrics"].items():
        np.testing.assert_allclose(float(r0["metrics"][k]), v, rtol=2e-3,
                                   err_msg=k)
    pm = create_model(_cfg(JAX_CASE), device="cpu")
    g_grad, d_grad = jx["grads"]
    want = {**{f"netG.{k}": v for k, v in generator_state_dict_from_jax(
        g_grad, pm.gen_cfg).items()},
        **{f"netD.{k}": v for k, v in discriminator_state_dict_from_jax(
            d_grad, pm.disc_cfg).items()}}
    assert set(r0["grads"]) <= set(want)
    for k, v in r0["grads"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    after = {**{f"netG.{k}": v for k, v in generator_state_dict_from_jax(
        jx["g_params"], pm.gen_cfg).items()},
        **{f"netD.{k}": v for k, v in discriminator_state_dict_from_jax(
            jx["d_params"], pm.disc_cfg).items()}}
    for k, v in r0["weights"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(after[k]),
                                   atol=5e-4, err_msg=k)


def test_num_devices_other_than_the_world_size_raises(dp):
    for r in dp["ranks"]:
        assert "num_devices=3" in r["mismatch"]
        assert "torchrun" in r["mismatch"]


def test_trainer_fit_and_resume_on_two_ranks(tmp_path):
    r0, r1 = launch(tmp_path, "fit")
    assert r1["writes"] == []  # rank 0 alone writes
    assert r0["ckpts"] == r1["ckpts"] == ["2.pt", "3.pt", "4.pt"]
    for r in (r0, r1):
        assert r["restored_is_end"] and r["restored_is_disk"]
        assert r["step"] == 4
    assert _same(r0["final"], r1["final"])


def test_torchrun_cli_train_two_ranks(tmp_path):
    from ir2rgb_tpu_torch.cli.train import main as cli_main
    from ir2rgb_tpu_torch.data import write_synthetic_dataset
    data = tmp_path / "data"
    write_synthetic_dataset(str(data), n=2, size=LOAD)
    args = ["--device", "cpu", "--model.net_g", "resnet_6blocks",
            "--model.ngf", "4", "--model.ndf", "8", "--loss.no_vgg_loss",
            "true", "--data.dataroot", str(data), "--data.load_size",
            str(LOAD), "--data.crop_size", "32", "--data.batch_size", "2",
            "--train.checkpoints_dir", str(tmp_path / "runs"),
            "--train.niter", "1", "--train.niter_decay", "0",
            "--train.print_freq", "1"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "ir2rgb_tpu_torch.cli.train",
         *args, "--train.name", "dp", "--train.num_devices", "2",
         "--dist_timeout", str(TIMEOUT_S)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    _wait_all([proc])
    assert cli_main(args + ["--train.name", "one"]) == 0
    run = tmp_path / "runs" / "dp"
    assert (run / "config.json").exists() and (run / "loss_log.txt").exists()
    dp_state = torch.load(run / "ckpt" / "1.pt")
    one_state = torch.load(tmp_path / "runs" / "one" / "ckpt" / "1.pt")
    assert dp_state["step"] == one_state["step"] == 1
    for net in ("netG", "netD"):
        for k, v in one_state[net].items():
            np.testing.assert_allclose(dp_state[net][k].numpy(), v.numpy(),
                                       atol=5e-4, err_msg=f"{net}.{k}")


# ---------------------------------------------------------------------------
# (f)-(i): in process
# ---------------------------------------------------------------------------

def _mesh(world, rank):
    from ir2rgb_tpu_torch.parallel import DataParallelMesh
    return DataParallelMesh(world, rank, rank, torch.device("cpu"))


def test_shard_batch_layout():
    x = torch.arange(8)
    assert [shard_batch(x, _mesh(2, r)).tolist() for r in range(2)] == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    # grad-accum 2: each rank's slice of each micro-batch, in order
    assert [shard_batch(x, _mesh(2, r), accum=2).tolist()
            for r in range(2)] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert [shard_batch(x, _mesh(4, r), accum=2).tolist()
            for r in range(4)] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    # every leaf splits dim 0: windows, instance maps, numpy arrays
    batch = {"seq": torch.arange(4 * 3 * 2 * 2 * 1).reshape(4, 3, 2, 2, 1),
             "inst": np.arange(4 * 2 * 2).reshape(4, 2, 2),
             "pair": (torch.arange(4), [torch.arange(8).reshape(4, 2)])}
    got = shard_batch(batch, _mesh(2, 1))
    assert torch.equal(got["seq"], batch["seq"][2:])
    assert torch.equal(got["inst"], torch.from_numpy(batch["inst"][2:]))
    assert got["pair"][0].tolist() == [2, 3]
    assert got["pair"][1][0].tolist() == [[4, 5], [6, 7]]
    for world, accum in ((3, 1), (2, 3), (8, 1)):
        with pytest.raises(ValueError, match="does not divide"):
            shard_batch(x[:6] if world == 8 else x, _mesh(world, 0), accum)


@pytest.mark.parametrize("mode,accum", [("aligned", 1), ("aligned", 2),
                                        ("unaligned", 1)])
def test_loader_decodes_each_ranks_rows(tmp_path, mode, accum):
    # every rank walks the one-process epoch order (and, unaligned, its B
    # draws) and decodes its own rows of each global batch
    from ir2rgb_tpu_torch.data import DataLoader, write_synthetic_dataset
    root = tmp_path / "data"
    write_synthetic_dataset(str(root), n=8, size=16)
    cfg = Config(data=DataConfig(dataroot=str(root), dataset_mode=mode,
                                 load_size=16, crop_size=16, batch_size=4),
                 train=TrainConfig(grad_accum=accum))

    def batches(shard):
        epoch = DataLoader(cfg, shard=shard).epoch()
        return [next(epoch) for _ in range(2)]
    one = batches(None)
    for rank in range(2):
        rows = local_rows(4, 2, rank, accum).numpy()
        for got, want in zip(batches((2, rank)), one):
            for k in ("a", "b"):
                assert np.array_equal(got[k], want[k][rows]), (rank, k)


def test_initialize_warns_or_raises(monkeypatch):
    import torch.distributed as dist
    for k in multihost.ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(k, raising=False)
    with pytest.warns(UserWarning, match="single-process"):
        multihost.initialize()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        multihost.initialize(require=True)
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(coordinator_address="127.0.0.1:1")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="incomplete"):
        multihost.initialize()
    monkeypatch.delenv("RANK")
    # an explicit cluster whose coordinator never answers: raises
    with pytest.raises(Exception):
        multihost.initialize(coordinator_address=f"127.0.0.1:{_free_port()}",
                             num_processes=2, process_id=1, timeout_s=1)
    assert not dist.is_initialized()


def test_num_devices_rules(monkeypatch):
    m = data_parallel_mesh(0, device="cpu")
    assert (m.world, m.rank, m.group) == (1, 0, None)
    assert data_parallel_mesh(1, device="cpu").world == 1
    with pytest.raises(ValueError, match="nproc_per_node 2"):
        data_parallel_mesh(2, device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        data_parallel_mesh(-1, device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="every visible card"):
        data_parallel_mesh(0, device="cuda")
    assert data_parallel_mesh(1, device="cuda").world == 1


@pytest.mark.parametrize("dp_,sp", [(0, 0), (-1, 1), (0, 16), (4, 4),
                                    (3, 3)])
def test_dp_sp_mesh_value_errors_are_jaxs(dp_, sp):
    import jax
    from ir2rgb_tpu.parallel import dp_sp_mesh as jax_dp_sp_mesh
    devices = jax.devices()[:8]
    with pytest.raises(ValueError) as want:
        jax_dp_sp_mesh(dp_, sp, devices=devices)
    with pytest.raises(ValueError) as got:
        dp_sp_mesh(dp_, sp, devices=list(range(len(devices))))
    assert str(got.value) == str(want.value)


def test_dp_sp_mesh_spatial_is_a16_and_dp_is_the_mesh():
    # A16a: dp_sp_mesh(2, 4) on a group of 8 ranks (a fake one, each rank
    # in turn) is the mesh JAX builds: rank r at JAX's devices[dp, sp],
    # its sp subgroup JAX's row and its dp subgroup JAX's column
    from ir2rgb_tpu.parallel import dp_sp_mesh as jax_dp_sp_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    ids = np.vectorize(lambda d: d.id)(jax_dp_sp_mesh(2, 4).devices)
    for rank in range(8):
        torch.distributed.init_process_group(
            "fake", rank=rank, world_size=8, store=FakeStore())
        try:
            m = dp_sp_mesh(2, 4, device="cpu")
            get = torch.distributed.get_process_group_ranks
            assert (m.world, m.dp, m.sp) == (8, 2, 4)
            assert ids[m.dp_rank, m.sp_rank] == rank
            assert get(m.sp_group) == ids[m.dp_rank].tolist()
            assert get(m.dp_group) == ids[:, m.sp_rank].tolist()
        finally:
            torch.distributed.destroy_process_group()
    assert dp_sp_mesh(1, 1, devices=[0]).world == 1


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
           sys.argv[4], sys.argv[5])
