"""WGAN-GP and CycleGAN on the port's dp×sp train step
(``parallel/spatial.py`` differentiated twice) on the CPU, against the
port's unsharded ops, one process's step and JAX's one-device step.

- In process, the ``sp`` ranks are threads
  (``tests/test_torch_port_spatial_train.py``'s ``on_ranks``): the
  halo's second derivative (a chain conv → tanh → a zero, reflect or edge
  window op → tanh → ``avg_pool(count_include_pad=False)`` → conv over
  uneven rows, a rank without rows at sp 3) and the generator's training
  tail's equal the unsharded ones' to 1e-6; the split B1's second derivative for every act on sp
  2 and 3 (uneven rows, a rank without rows) equals the fused
  ``InstanceNormActBackward``'s and JAX's ``jax.grad`` of ``jax.grad``
  (rtol 1e-4, atol 1e-4·max, ``tests/test_torch_port_gp.py``'s bars);
  ``gradient_penalty`` over the uneven shards of the n-layer, multiscale
  and pixel Ds equals JAX's penalty (rtol 1e-5) and its D gradient (the
  noise-floor bar of ``tests/test_torch_port_gp.py``).
- One spawn of 4 gloo ranks (``python tests/test_torch_port_spatial_gp.py
  PORT RANK OUT``, one torch thread each): JAX's
  ``tests/test_parallel.py:127`` config with ``gan_mode="wgangp"`` on dp
  2 × sp 2 (all four ranks) and on dp 1 × sp 2 (ranks 0 and 1), and the
  CycleGAN config of ``tests/test_torch_port_cycle.py`` on sp 2 (ranks 2
  and 3, beside it), each from JAX's weights with JAX's mixing weights,
  held to JAX's one-device jitted step (metrics rtol 2e-3) and to the
  port's one-process step (metrics rel ≤ 1e-5, each network's gradient
  ‖Δ‖ ≤ 1e-5·‖g‖, the weights after Adam within atol 5e-4, a CycleGAN's
  pools the one-process pools); the pixel D with batch norm under
  WGAN-GP on sp 2 against one process; then ``cli.train --preset
  cyclegan_256 --train.spatial_devices 2`` on dp 2 × sp 2 from unaligned
  folders, rank 0's checkpoint holding the four networks and both pools
  whole, every rank's state equal.
"""

import dataclasses
import functools
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
    sys.path.insert(0, str(ROOT / "tests"))

from ir2rgb_tpu_torch.config import (  # noqa: E402
    Config,
    DataConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from ir2rgb_tpu_torch.kernels import instance_norm as b1  # noqa: E402
from ir2rgb_tpu_torch.losses import gan  # noqa: E402
from ir2rgb_tpu_torch.nn import ops  # noqa: E402
from ir2rgb_tpu_torch.nn.discriminators import DiscConfig, define_d  # noqa: E402
from ir2rgb_tpu_torch.parallel import (  # noqa: E402
    DataParallelMesh,
    dp_sp_mesh,
    multihost,
    replicate,
    shard_batch,
    spatial,
)
from ir2rgb_tpu_torch.train import create_model  # noqa: E402

from test_torch_port_spatial_train import (  # noqa: E402,F401
    _gap,
    _one_thread,
    _rows,
    _seeded,
    _thread_local_partition,
    on_ranks,
)

TIMEOUT_S = 60


# ---------------------------------------------------------------------------
# In process: the ranks are threads
# ---------------------------------------------------------------------------

def _second(fn, x, rows, c1, c2, weights):
    """The chain ``fn`` differentiated twice: (d/dx, d/dweights) of
    <d<fn(x), c1>/dx, c2>, on the whole ``x`` (``rows`` None) or on thread
    ranks, each on its rows of the partition ``rows`` (the rows' x
    gradients joined, the weights' summed)."""
    if rows is None:
        xw = x.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad((fn(xw) * c1).sum(), xw,
                                   create_graph=True)
        return torch.autograd.grad((g * c2).sum(), [xw, *weights])

    def rank(r, part):
        xr = part.tag(_rows(x, rows, r).clone().requires_grad_(True), rows)
        y = fn(xr)
        (g,) = torch.autograd.grad((y * _rows(c1, part.bounds(y), r)).sum(),
                                   xr, create_graph=True)
        return torch.autograd.grad((g * _rows(c2, rows, r)).sum(),
                                   [xr, *weights], allow_unused=True)
    outs = on_ranks(len(rows) - 1, rank)
    return [torch.cat([o[0] for o in outs], dim=1)] + [
        sum(torch.zeros_like(w) if o[1 + i] is None else o[1 + i]
            for o in outs) for i, w in enumerate(weights)]


W1 = (_seeded((6, 4, 4, 4), 51) * 0.25).requires_grad_(True)
WM = (_seeded((6, 6, 3, 3), 52) * 0.15).requires_grad_(True)
WL = (_seeded((2, 6, 4, 4), 53) * 0.1).requires_grad_(True)
# the window op of each edge mode
WINDOW = {"zero": lambda h: ops.conv(h, WM, None, 1, 1),
          "reflect": lambda h: ops.conv(ops.reflect_pad(h, 1), WM),
          "edge": lambda h: ops.conv(ops.replicate_pad(h, 1), WM)}


def _chain(mode):
    """8 rows -> 5 (a 4x4 stride-2 conv) -> 5 (the mode's window op) ->
    3 (the pool) -> 2 (a 4x4 stride-2 conv): uneven shards at sp 2 and 3,
    and at sp 3 a rank without rows of the output."""
    def fn(x):
        h = ops.apply_act(ops.conv(x, W1, None, 2, 2), "tanh")
        h = ops.apply_act(WINDOW[mode](h), "tanh")
        h = ops.avg_pool(h, 3, 2, 1, count_include_pad=False)
        return ops.conv(h, WL, None, 2, 2)
    return fn


@pytest.mark.parametrize("sp", [2, 3])
@pytest.mark.parametrize("mode", spatial.MODES)
def test_halo_second_derivative_equals_the_unsharded_chain(mode, sp):
    x = _seeded((2, 8, 10, 4), 54)
    c1, c2 = _seeded((2, 2, 2, 2), 55), _seeded((2, 8, 10, 4), 56)
    fn, weights = _chain(mode), [W1, WM, WL]
    want = _second(fn, x, None, c1, c2, weights)
    got = _second(fn, x, spatial.bounds(8, sp), c1, c2, weights)
    scale = max(float(t.abs().max()) for t in want)
    assert scale > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert _gap(a, b, scale) <= 1e-6, (mode, sp, i)


@pytest.mark.parametrize("sp", [2, 3])
def test_train_tail_second_derivative_equals_the_unsharded_tail(sp):
    # reflect pad 3 from the halo, the 7x7 conv, tanh (the generator's
    # training tail) on 9 rows split unevenly
    from ir2rgb_tpu_torch.nn.generators import _tail
    conv = torch.nn.Conv2d(6, 3, 7)
    with torch.no_grad():
        conv.weight.copy_(_seeded((3, 6, 7, 7), 60) * 0.06)
        conv.bias.copy_(_seeded((3,), 61))
    x = _seeded((1, 9, 8, 6), 62)
    c1, c2 = _seeded((1, 9, 8, 3), 63), _seeded((1, 9, 8, 6), 64)
    weights = [conv.weight, conv.bias]

    def fn(t):
        return _tail(conv, t, train=True)
    want = _second(fn, x, None, c1, c2, weights)
    got = _second(fn, x, spatial.bounds(9, sp), c1, c2, weights)
    scale = max(float(t.abs().max()) for t in want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _gap(a, b, scale) <= 1e-6, (sp, i)


@functools.lru_cache(maxsize=None)
def _jax_norm_second(rows, act):
    """JAX's jax.grad of jax.grad of ``instance_norm_act_reference`` on
    the inputs of :func:`_norm_inputs` (jitted: one compile)."""
    import jax
    import jax.numpy as jnp
    from ir2rgb_tpu.kernels.instance_norm import (
        instance_norm_act_reference as jax_norm,
    )
    x, w1, w2 = (t.numpy() for t in _norm_inputs(rows))

    def first(v):
        return jax.grad(lambda u: jnp.sum(jnp.asarray(w1) * jax_norm(u, act)))(
            v)
    return np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(
        jnp.asarray(w2) * first(v))))(jnp.asarray(x)))


def _norm_inputs(rows):
    shape = (2, rows, 5, 8)
    return (_seeded(shape, 57) * 2 + 0.5, _seeded(shape, 58),
            _seeded(shape, 59))


@pytest.mark.parametrize("sp,rows", [(2, 7), (3, 7), (3, 2)],
                         ids=["sp2", "sp3", "sp3_empty_rank"])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh", "none"])
def test_split_b1_second_derivative_equals_the_fused_one_and_jax(act, sp,
                                                                 rows):
    x, c1, c2 = _norm_inputs(rows)

    def norm(t):
        return ops.norm_act(t, "instance", act)

    (got,) = _second(norm, x, spatial.bounds(rows, sp), c1, c2, [])
    (fused,) = _second(lambda t: b1.instance_norm_act_fn(t, act), x, None,
                       c1, c2, [])
    want = _jax_norm_second(rows, act)
    for ref in (fused.numpy(), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


DISCS = {"n_layers": dict(net_d="n_layers", num_d=1),
         "multiscale": dict(net_d="multiscale", num_d=2),
         "pixel": dict(net_d="pixel", num_d=1)}


@functools.lru_cache(maxsize=None)
def _penalty_case(name):
    """D's config, JAX's weights (as the port's state_dict), the pairs,
    the mixing weights and JAX's penalty and its D gradient (jitted)."""
    import jax
    import jax.numpy as jnp
    from ir2rgb_tpu.losses.gan import gradient_penalty as jax_gp
    from ir2rgb_tpu.nn.discriminators import DiscConfig as JDiscConfig
    from ir2rgb_tpu.nn.discriminators import define_d as jax_define_d
    from ir2rgb_tpu_torch.checkpoint import discriminator_state_dict_from_jax
    from test_torch_port_train_zoo import _params
    kw = dict(input_nc=6, ndf=8, n_layers=3, **DISCS[name])
    pcfg = DiscConfig(**kw)
    d_init, d_apply = jax_define_d(JDiscConfig(**kw))
    params = _params(d_init, 5)
    r = np.random.RandomState(6)
    real, fake = (r.uniform(-1, 1, (2, 48, 48, 6)).astype(np.float32)
                  for _ in range(2))
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.uniform(key, (2, 1, 1, 1), jnp.float32))
    want, grads = jax.jit(jax.value_and_grad(lambda p: jax_gp(
        lambda x: d_apply(p, x), jnp.asarray(real), jnp.asarray(fake), key,
        lambda_gp=10.0)))(params)
    return (pcfg, discriminator_state_dict_from_jax(params, pcfg), real,
            fake, eps, float(want), discriminator_state_dict_from_jax(
                jax.tree.map(np.asarray, grads), pcfg))


@pytest.mark.parametrize("sp", [2, 3])
@pytest.mark.parametrize("name", sorted(DISCS))
def test_gradient_penalty_over_uneven_shards_equals_jax(name, sp):
    from test_torch_port_gp import _noise_floor_and_bar
    pcfg, sd, real, fake, eps, want, want_sd = _penalty_case(name)
    d = define_d(pcfg)
    d.load_state_dict(sd)
    names, params = zip(*d.named_parameters())
    b = spatial.bounds(48, sp)

    def rank(r, part):
        gp = gan.gradient_penalty(
            d, _rows(torch.from_numpy(real), b, r),
            _rows(torch.from_numpy(fake), b, r), lambda_gp=10.0,
            eps=torch.from_numpy(eps))
        grads = torch.autograd.grad(gp, params, allow_unused=True)
        return float(gp.detach()), grads
    outs = on_ranks(sp, rank)
    np.testing.assert_allclose(sum(o[0] for o in outs), want, rtol=1e-5)
    got = {k: sum(torch.zeros_like(p) if o[1][i] is None else o[1][i]
                  for o in outs)
           for i, (k, p) in enumerate(zip(names, params))}
    assert _noise_floor_and_bar(d, got, want_sd)


# ---------------------------------------------------------------------------
# The ranks: WGAN-GP on dp 2 x sp 2 and dp 1 x sp 2, CycleGAN on sp 2, the
# pixel D with batch norm, and cli.train of a CycleGAN on dp 2 x sp 2
# ---------------------------------------------------------------------------

CROP, BATCH = 32, 2
# JAX's tests/test_parallel.py:24-31 with WGAN-GP (its create_model's pool:
# 0 here)
GP = dict(model="pix2pix", net_g="resnet_6blocks", net_d="n_layers", ngf=8,
          ndf=8)
GP_LAYOUTS = [(2, 2), (1, 2)]  # (dp, sp): all four ranks; ranks 0 and 1
# the pixel D with batch norm (G's norm too), against one process
PIXEL = dict(GP, net_d="pixel", norm="batch")
# tests/test_torch_port_cycle.py's CycleGAN: a 1-frame pool, so the
# step's second item meets a full pool and JAX's swap decision
CYCLE_POOL = 1


def _gp_cfg(model=GP):
    return Config(model=ModelConfig(**model),
                  data=DataConfig(crop_size=CROP, batch_size=BATCH),
                  loss=LossConfig(no_vgg_loss=True, pool_size=0,
                                  gan_mode="wgangp"),
                  train=TrainConfig())


def _cycle_cfg():
    from ir2rgb_tpu_torch.config import PRESETS
    cfg = PRESETS["cyclegan_256"]
    return cfg.replace(
        model=dataclasses.replace(cfg.model, net_g="resnet_6blocks", ngf=8,
                                  ndf=8),
        data=dataclasses.replace(cfg.data, crop_size=CROP,
                                 batch_size=BATCH),
        loss=dataclasses.replace(cfg.loss, pool_size=CYCLE_POOL))


def _batch(seed):
    r = np.random.RandomState(seed)
    return {k: torch.from_numpy(r.uniform(-1, 1, (BATCH, CROP, CROP, 3))
                                .astype(np.float32)) for k in "ab"}


def _nets(model):
    return {**model.g_nets(), **model.d_nets()}


def _grads(model):
    return {f"{net}.{k}": p.grad.clone()
            for net, mod in _nets(model).items()
            for k, p in mod.named_parameters() if p.grad is not None}


def _weights(model):
    return {f"{net}.{k}": v.detach().clone()
            for net, mod in _nets(model).items()
            for k, v in mod.state_dict().items()}


def _pools(model):
    pools = model.pool if isinstance(model.pool, dict) else {}
    return {k: (p.buffer.clone(), int(p.count)) for k, p in pools.items()}


def step_case(cfg, weights, draws, seed, mesh=None):
    """One train step of ``cfg`` from ``weights`` on batch ``seed`` with
    ``draws`` handed in, on this rank's block (the whole batch without
    ``mesh``)."""
    from ir2rgb_tpu_torch.parallel import mesh as pmesh
    from ir2rgb_tpu_torch.train import image_pool
    model = create_model(cfg, device="cpu", steps_per_epoch=10,
                         seed=0 if mesh is None else 5 * mesh.rank)
    for name, net in _nets(model).items():
        net.load_state_dict(weights[name])
    batch = _batch(seed)
    if mesh is not None:
        replicate(model, mesh)
        batch = shard_batch(batch, mesh)
    queue = list(draws["pool"])
    eps = draws["eps"]

    def draw_eps(n, generator):
        return pmesh.draw(lambda m: eps[:m].clone(), n)

    def draw_decisions(n, pool_size, generator):
        swap, idx = queue.pop(0)
        return torch.tensor(swap), torch.tensor(idx)
    saved = gan.draw_eps, image_pool.draw_decisions
    gan.draw_eps, image_pool.draw_decisions = draw_eps, draw_decisions
    try:
        # the ranks and one process run the same CPU convolutions (a test
        # module a worker imports, tests/torch_refs.py, turns oneDNN off)
        with torch.backends.mkldnn.flags(enabled=True):
            metrics = model.train_step(batch)
    finally:
        gan.draw_eps, image_pool.draw_decisions = saved
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _grads(model), "weights": _weights(model),
            "pools": _pools(model)}


def _write_unaligned(root, na=4, nb=3, size=40):
    from PIL import Image
    r = np.random.RandomState(8)
    for side, n in (("trainA", na), ("trainB", nb)):
        os.makedirs(os.path.join(root, side), exist_ok=True)
        for i in range(n):
            Image.fromarray(r.randint(0, 256, (size, size, 3), np.uint8)).save(
                os.path.join(root, side, f"{side[-1].lower()}{i:03d}.png"))


def cli_case(out):
    """``cli.train --preset cyclegan_256 --train.spatial_devices 2`` on
    this world (dp 2 x sp 2) for two steps from unaligned folders; this
    rank's model after it (the model the CLI built, kept by wrapping
    ``create_model``) and rank 0's checkpoint."""
    import ir2rgb_tpu_torch.train as train_pkg
    from ir2rgb_tpu_torch.cli import train
    made, build = [], train_pkg.create_model

    def keep(*a, **kw):
        made.append(build(*a, **kw))
        return made[-1]
    train_pkg.create_model = keep
    try:
        rc = train.main([
            "--device", "cpu", "--preset", "cyclegan_256",
            "--model.net_g", "resnet_6blocks", "--model.ngf", "4",
            "--model.ndf", "4", "--data.load_size", "40",
            "--data.crop_size", str(CROP), "--loss.pool_size", "4",
            "--data.dataroot", os.path.join(out, "unaligned"),
            "--data.batch_size", "2", "--data.num_workers", "0",
            "--train.spatial_devices", "2", "--train.name", "sp_cyc",
            "--train.checkpoints_dir", os.path.join(out, "runs"),
            "--train.niter", "1", "--train.niter_decay", "0",
            "--train.print_freq", "1"])
    finally:
        train_pkg.create_model = build
    (model,) = made
    return {"rc": rc, "step": model.step, "weights": _weights(model),
            "pools": _pools(model)}


def _pair_mesh(pair, rank):
    """dp 1 x sp 2 over a pair of the world's ranks (``pair`` its group,
    ``rank`` this one's place in it)."""
    return DataParallelMesh(2, rank, 0, torch.device("cpu"), pair, sp=2,
                            sp_group=pair)


def worker(port, rank, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=4, process_id=rank,
                         timeout_s=TIMEOUT_S)
    refs = torch.load(os.path.join(out, "refs.pt"))
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    res = {(2, 2): step_case(_gp_cfg(), refs["gp"], refs["gp_draws"], 0,
                             dp_sp_mesh(2, 2, device="cpu"))}
    mesh = _pair_mesh(pairs[rank // 2], rank % 2)
    if rank < 2:
        res[(1, 2)] = step_case(_gp_cfg(), refs["gp"], refs["gp_draws"], 0,
                                mesh)
    else:
        res["cycle"] = step_case(_cycle_cfg(), refs["cycle"],
                                 refs["cycle_draws"], 1, mesh)
        res["pixel"] = step_case(_gp_cfg(PIXEL), refs["pixel"],
                                 refs["gp_draws"], 0, mesh)
    res["cli"] = cli_case(out)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _spawn(out, n):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    return [subprocess.Popen(
        [sys.executable, __file__, str(port), str(r), str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True) for r in range(n)]


def _wait(procs):
    try:
        outs = [p.communicate(timeout=2 * TIMEOUT_S) for p in procs]
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


def _jax_gp_state():
    """JAX's WGAN-GP config, an initial state (weights drawn from numpy
    seeds, ``tests/test_torch_port_spatial_train.py::_drawn``), its
    weights as the port's and the mixing weights its ``train_step``
    draws (``model.py:440``, ``:330``, ``:378``)."""
    import jax
    import jax.numpy as jnp
    from ir2rgb_tpu.config import Config as JConfig
    from ir2rgb_tpu.config import DataConfig as JDataConfig
    from ir2rgb_tpu.config import LossConfig as JLossConfig
    from ir2rgb_tpu.config import ModelConfig as JModelConfig
    from ir2rgb_tpu.train import create_model as jax_create_model
    from ir2rgb_tpu.train.image_pool import init_pool
    from ir2rgb_tpu.train.model import TrainState
    from ir2rgb_tpu_torch.checkpoint import (
        discriminator_state_dict_from_jax,
        generator_state_dict_from_jax,
    )
    from test_torch_port_spatial_train import _drawn
    jm = jax_create_model(JConfig(
        model=JModelConfig(**GP),
        data=JDataConfig(crop_size=CROP, batch_size=BATCH),
        loss=JLossConfig(no_vgg_loss=True, pool_size=0, gan_mode="wgangp")),
        steps_per_epoch=10)
    g, d = _drawn(jm.g_init, 0), _drawn(jm.d_init, 1)
    state = TrainState(g_params=g, d_params=d, g_opt=jm.g_tx.init(g),
                       d_opt=jm.d_tx.init(d), step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(2),
                       pool=init_pool(0, (CROP, CROP, 3)))
    k_pool = jax.random.split(jax.random.split(state.rng)[1])[1]
    eps = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(k_pool, 1), (BATCH, 1, 1, 1), jnp.float32)))
    pm = create_model(_gp_cfg(), device="cpu")
    weights = {"netG": generator_state_dict_from_jax(
        jax.tree.map(np.asarray, g), pm.gen_cfg),
        "netD": discriminator_state_dict_from_jax(
            jax.tree.map(np.asarray, d), pm.disc_cfg)}
    return jm, state, weights, {"eps": eps, "pool": []}


def _jax_cycle_state():
    """JAX's CycleGAN of :func:`_cycle_cfg`, an initial state (numpy-drawn
    weights), its weights as the port's and its pools' decisions
    (``cycle.py:135``: fake_b's pool, then fake_a's)."""
    import jax
    import jax.numpy as jnp
    from ir2rgb_tpu.config import PRESETS as JAX_PRESETS
    from ir2rgb_tpu.train import create_model as jax_create_model
    from ir2rgb_tpu.train.image_pool import init_pool
    from ir2rgb_tpu.train.model import TrainState
    from ir2rgb_tpu_torch.checkpoint import (
        cycle_discriminators_from_jax,
        cycle_generators_from_jax,
    )
    from test_torch_port_spatial_train import _drawn
    cfg = JAX_PRESETS["cyclegan_256"]
    jm = jax_create_model(cfg.replace(
        model=dataclasses.replace(cfg.model, net_g="resnet_6blocks", ngf=8,
                                  ndf=8),
        data=dataclasses.replace(cfg.data, crop_size=CROP,
                                 batch_size=BATCH),
        loss=dataclasses.replace(cfg.loss, pool_size=CYCLE_POOL)),
        steps_per_epoch=10)
    g, d = _drawn(jm.g_init, 4), _drawn(jm.d_init, 5)
    frame = (CROP, CROP, 3)
    state = TrainState(g_params=g, d_params=d, g_opt=jm.g_tx.init(g),
                       d_opt=jm.d_tx.init(d), step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(3),
                       pool={k: init_pool(CYCLE_POOL, frame)
                             for k in ("fake_a", "fake_b")})
    _, _, k_pa, k_pb = jax.random.split(jax.random.split(state.rng)[1], 4)
    pool = []
    for kp in (k_pb, k_pa):
        swap, idx = [], []
        for k in jax.random.split(kp, BATCH):
            k_swap, k_idx = jax.random.split(k)
            idx.append(int(jax.random.randint(k_idx, (), 0, CYCLE_POOL)))
            swap.append(bool(jax.random.bernoulli(k_swap)))
        pool.append((swap, idx))
    pm = create_model(_cycle_cfg(), device="cpu")
    np_ = functools.partial(jax.tree.map, np.asarray)
    weights = {**cycle_generators_from_jax(np_(g), pm.gen_cfg, pm.gen_cfg_b),
               **cycle_discriminators_from_jax(np_(d), pm.disc_cfg,
                                               pm.disc_cfg_b)}
    return jm, state, weights, {"eps": torch.zeros(BATCH, 1, 1, 1),
                                "pool": pool}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' cases, the port's one-process steps and JAX's
    one-device steps (computed while the ranks run)."""
    import jax
    out = tmp_path_factory.mktemp("spatial_gp")
    gp_jm, gp_state, gp_w, gp_draws = _jax_gp_state()
    cy_jm, cy_state, cy_w, cy_draws = _jax_cycle_state()
    pixel = create_model(_gp_cfg(PIXEL), device="cpu", seed=9)
    pixel_w = {k: {n: v.clone() for n, v in net.state_dict().items()}
               for k, net in _nets(pixel).items()}
    torch.save({"gp": gp_w, "gp_draws": gp_draws, "cycle": cy_w,
                "cycle_draws": cy_draws, "pixel": pixel_w},
               out / "refs.pt")
    _write_unaligned(str(out / "unaligned"))
    procs = _spawn(out, 4)
    try:
        res = {"one": step_case(_gp_cfg(), gp_w, gp_draws, 0),
               "one_cycle": step_case(_cycle_cfg(), cy_w, cy_draws, 1),
               "one_pixel": step_case(_gp_cfg(PIXEL), pixel_w, gp_draws, 0)}
        for key, jm, state, seed in (("jax", gp_jm, gp_state, 0),
                                     ("jax_cycle", cy_jm, cy_state, 1)):
            _, m = jax.jit(jm.train_step)(state, {
                k: v.numpy() for k, v in _batch(seed).items()})
            res[key] = {k: float(v) for k, v in m.items()}
    finally:
        _wait(procs)
    res["ranks"] = [torch.load(out / f"rank{r}.pt") for r in range(4)]
    res["checkpoint"] = torch.load(out / "runs" / "sp_cyc" / "ckpt" / "2.pt",
                                   weights_only=False)
    return res


def _rel_norm(got, want):
    return float((got - want).norm()) / max(float(want.norm()), 1e-30)


def _held_to(rs, one, jx, nets):
    """Every rank's step the same replica; rank 0's metrics against JAX's
    (rtol 2e-3, JAX's bar; ``jx`` None: none) and one process's (rel ≤
    1e-5), each network's gradient ‖Δ‖ ≤ 1e-5·‖g‖, the weights after Adam
    within JAX's atol 5e-4 and the pools' frames within 1e-5."""
    for r in rs[1:]:
        assert r["metrics"] == rs[0]["metrics"]
        for key in ("grads", "weights"):
            assert all(torch.equal(r[key][k], rs[0][key][k])
                       for k in rs[0][key]), key
        assert all(torch.equal(v[0], rs[0]["pools"][k][0])
                   for k, v in r["pools"].items())
    r0 = rs[0]
    assert r0["metrics"].keys() == one["metrics"].keys()
    for k, want in one["metrics"].items():
        got = r0["metrics"][k]
        assert abs(got - want) <= 1e-5 * abs(want), k
        if jx is not None:
            np.testing.assert_allclose(got, jx[k], rtol=2e-3, err_msg=k)
    assert jx is None or jx.keys() == one["metrics"].keys()
    assert r0["grads"].keys() == one["grads"].keys()
    for net in nets:
        keys = [k for k in one["grads"] if k.startswith(net + ".")]
        assert keys, net
        got = torch.cat([r0["grads"][k].reshape(-1) for k in keys])
        want = torch.cat([one["grads"][k].reshape(-1) for k in keys])
        assert _rel_norm(got, want) <= 1e-5, net
    for k, v in one["weights"].items():
        np.testing.assert_allclose(r0["weights"][k].numpy(), v.numpy(),
                                   atol=5e-4, err_msg=k)
    # the pools: whole frames, filled as far (their fakes are the
    # partitioned forward's, a rounding from one process's)
    assert r0["pools"].keys() == one["pools"].keys()
    for k, (buf, count) in one["pools"].items():
        assert r0["pools"][k][1] == count, k
        np.testing.assert_allclose(r0["pools"][k][0].numpy(), buf.numpy(),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("layout", GP_LAYOUTS,
                         ids=lambda t: f"dp{t[0]}xsp{t[1]}")
def test_wgangp_step_on_dp_sp_equals_jax_and_one_process(ranks, layout):
    rs = [r[layout] for r in ranks["ranks"] if layout in r]
    assert len(rs) == layout[0] * layout[1]
    assert rs[0]["metrics"]["D_GP"] > 0
    _held_to(rs, ranks["one"], ranks["jax"], ("netG", "netD"))


def test_cyclegan_step_on_sp2_equals_jax_and_one_process(ranks):
    rs = [r["cycle"] for r in ranks["ranks"][2:]]
    one = ranks["one_cycle"]
    # the second item met the full 1-frame pool and JAX's decision
    assert set(one["pools"]) == {"fake_a", "fake_b"}
    _held_to(rs, one, ranks["jax_cycle"], ("netG", "netG_B", "netD",
                                           "netD_B"))


def test_pixel_d_with_batch_norm_wgangp_on_sp2_equals_one_process(ranks):
    rs = [r["pixel"] for r in ranks["ranks"][2:]]
    assert rs[0]["metrics"]["D_GP"] > 0
    _held_to(rs, ranks["one_pixel"], None, ("netG", "netD"))


def test_cyclegan_cli_on_dp2_sp2_checkpoints_every_network_whole(ranks):
    runs = [r["cli"] for r in ranks["ranks"]]
    assert all(r["rc"] == 0 and r["step"] == 2 for r in runs)
    for r in runs[1:]:
        assert all(torch.equal(v, runs[0]["weights"][k])
                   for k, v in r["weights"].items())
        for k, (buf, count) in runs[0]["pools"].items():
            assert r["pools"][k][1] == count and torch.equal(
                r["pools"][k][0], buf)
    ckpt = ranks["checkpoint"]
    assert int(ckpt["step"]) == 2
    for name in ("netG", "netG_B", "netD", "netD_B"):
        for k, v in ckpt[name].items():
            assert torch.equal(v, runs[0]["weights"][f"{name}.{k}"]), k
    # both pools whole frames (4 of them, filled by the two steps' 2 each)
    assert set(ckpt["pool"]) == {"fake_a", "fake_b"}
    for k, p in ckpt["pool"].items():
        assert tuple(p["buffer"].shape) == (4, CROP, CROP, 3)
        assert int(p["count"]) == 4
        assert torch.equal(p["buffer"], runs[0]["pools"][k][0])


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
