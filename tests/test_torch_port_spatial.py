"""Spatially partitioned serving of the port (``parallel/spatial.py``) on
the CPU, against the port's unsharded ops and frames and JAX's sharded
ones.

- In process, no group: every shard-aware op of ``nn/ops.py`` run on each
  rank's rows with the halo rows cut from the whole tensor
  (:class:`CutShards`), for sp 2, 4 and 8 (shards of one row included),
  equals the unsharded op to 1e-6; B1's plain statistics merged over the
  shards, then its plain apply, equal ``instance_norm_act_reference``;
  B2's plain version over a halo equals ``tail_fused_reference``.
- Layout: ``dp_sp_mesh(2, 4)`` on 8 ranks of a fake process group is
  JAX's ``dp_sp_mesh(2, 4)`` (rank order and subgroups), and
  ``shard_batch``'s blocks are JAX's shards on conftest's 8 devices.
- One spawn of 4 gloo ranks (``python tests/test_torch_port_spatial.py
  PORT RANK OUT``, one torch thread each, 60 s timeouts): JAX's
  ``tests/test_parallel.py:99`` local enhancer at crop 32 on sp 4 (the
  trunk's bottom is shards of one row) and ``:165``'s temporal stream for
  3 frames on sp 4, each against the port's unsharded frames (1e-5) and
  JAX's sharded ones (1e-4), the carry's rows per rank; a
  ``MultiStreamServer`` of 4 temporal slots on dp 2 × sp 2 against the
  one-process server; a batch-norm generator's batch of 2 on dp 2 × sp 2
  (the moments over every rank's rows) against one process.
- Errors: pooled serving with a mesh (JAX's ``test_multistream.py:232``),
  and each piece out of this slice names ROADMAP A16b.
"""

import importlib.util
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
    InferConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from ir2rgb_tpu_torch.infer import MultiStreamServer  # noqa: E402
from ir2rgb_tpu_torch.infer import StreamingGenerator  # noqa: E402
from ir2rgb_tpu_torch.kernels import instance_norm as pin  # noqa: E402
from ir2rgb_tpu_torch.kernels.tail_fused import (  # noqa: E402
    tail_fused_reference,
)
from ir2rgb_tpu_torch.nn import ops, quant  # noqa: E402
from ir2rgb_tpu_torch.parallel import (  # noqa: E402
    dp_sp_mesh,
    multihost,
    shard_batch,
    spatial,
)
from ir2rgb_tpu_torch.parallel.mesh import DataParallelMesh  # noqa: E402
from ir2rgb_tpu_torch.train import create_model  # noqa: E402

TIMEOUT_S = 60
CROP, SP, FRAMES, SLOTS = 32, 4, 3, 4
# JAX's tests/test_parallel.py:99 (local enhancer) and :165 (temporal)
LOCAL = dict(model="pix2pixhd", net_g="local", ngf=8, n_downsample_global=2,
             n_blocks_global=2, n_blocks_local=1)
TEMPORAL = dict(model="temporal", net_g="resnet_6blocks", ngf=8,
                n_frames_g=2)
# the server's ticks: the slots with a frame
TICKS = [(0, 1, 2, 3), (0, 2), (0, 1, 2, 3)]
# batch norm's moments over dp x sp: a batch of 2 on dp 2 x sp 2
BATCH_NORM = dict(model="pix2pix", net_g="resnet_6blocks", ngf=8,
                  norm="batch")


# ---------------------------------------------------------------------------
# In process: each op on each rank's rows, halos cut from the whole tensor
# ---------------------------------------------------------------------------

class CutShards(spatial.Shards):
    """Rank ``rank`` of ``sp`` whose halo rows are cut from ``whole``, the
    unsharded input of the op under test."""

    def __init__(self, sp, rank, whole):
        super().__init__(sp, rank)
        self.whole = whole

    def exchange(self, x, plan):
        return self.whole[:, list(plan.foreign[self.rank])]


def _per_rank(fn, x, sp):
    h = x.shape[1] // sp
    outs = []
    for r in range(sp):
        with spatial.partitioned(CutShards(sp, r, x)):
            outs.append(fn(x[:, r * h:(r + 1) * h].contiguous()))
    return outs


def _seeded(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, shape).astype(np.float32))


W3 = _seeded((6, 4, 3, 3), 1)
W7 = _seeded((6, 4, 7, 7), 2)
B = _seeded((6,), 3)
WT = _seeded((4, 6, 3, 3), 4)  # a k3 p1 op1 transposed conv, IOHW
# op -> (fn, stride, rows it adds at each end: pads compare extended rows)
OPS = {
    "conv_k3_s1_p1": (lambda x: ops.conv(x, W3, B, 1, 1), 1, 0),
    "conv_k3_s2_p1": (lambda x: ops.conv(x, W3, B, 2, 1), 2, 0),
    "reflect_pad_1": (lambda x: ops.reflect_pad(x, 1), 1, 1),
    "reflect_pad_3": (lambda x: ops.reflect_pad(x, 3), 1, 3),
    "reflect_pad_3_conv_k7": (
        lambda x: ops.conv(ops.reflect_pad(x, 3), W7, B), 1, 0),
    "edge_pad_2": (lambda x: ops.replicate_pad(x, 2), 1, 2),
    "avg_pool_3_2_1": (lambda x: ops.avg_pool(x, 3, 2, 1), 2, 0),
    "deconv_k3_p1_op1": (lambda x: ops.deconv(x, WT, B[:6]), 1, 0),
    "resize_nearest": (lambda x: ops.resize_nearest(x, 2), 1, 0),
    "resize_bilinear": (
        lambda x: ops.resize_bilinear(x, (2 * _global_rows(x), 20)), 1, 0),
}


def _global_rows(x):
    part = spatial.active()
    return x.shape[1] if part is None else part.global_rows(x.shape[1])


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("op", sorted(OPS))
def test_shard_aware_op_equals_the_unsharded_op(op, sp):
    fn, stride, grow = OPS[op]
    # shards of one row: 8 rows, 16 where a stride-2 op halves them
    x = _seeded((2, 8 * stride, 10, 4), 5)
    want = fn(x)
    outs = _per_rank(fn, x, sp)
    hout = want.shape[1] // sp if not grow else x.shape[1] // sp
    for r, got in enumerate(outs):
        ref = want[:, r * hout:(r + 1) * hout + 2 * grow]
        assert got.shape == ref.shape, (op, r)
        assert float((got - ref).abs().max()) <= 1e-6, (op, r)


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("act", ["relu", "none", "leaky_relu"])
def test_b1_stats_merged_then_applied_equals_the_fused_reference(act, sp):
    x = _seeded((2, 8, 6, 8), 6) * 3 + 0.5
    want, mean_w, rstd_w = pin.instance_norm_act_reference(x, act)
    h = x.shape[1] // sp
    parts = [pin.instance_norm_stats_reference(x[:, r * h:(r + 1) * h])
             for r in range(sp)]
    mean, rstd = spatial.merge_stats(torch.stack([p[0] for p in parts]),
                                     torch.stack([p[1] for p in parts]),
                                     h * x.shape[2], pin.INSTANCE_NORM_EPS)
    assert float((mean - mean_w).abs().max()) <= 1e-6
    assert float((rstd - rstd_w).abs().max() / rstd_w.abs().max()) <= 1e-6
    for r in range(sp):
        got = pin.instance_norm_apply_reference(x[:, r * h:(r + 1) * h],
                                                mean, rstd, act)
        assert float((got - want[:, r * h:(r + 1) * h]).abs().max()) <= 1e-5


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_b2_over_a_halo_equals_the_whole_tail(sp):
    x = _seeded((1, 16, 12, 16), 7)
    w, b = _seeded((7, 7, 16, 3), 8) * 0.1, _seeded((3,), 9)
    want = tail_fused_reference(x, w, b)
    h = x.shape[1] // sp
    outs = _per_rank(lambda t: tail_fused_reference(
        spatial.active().halo(t, 3, 3, "reflect"), w, b)[:, 3:3 + h], x, sp)
    got = torch.cat(outs, dim=1)
    assert float((got - want).abs().max()) <= 1e-6


def test_a_stride_2_op_on_odd_shards_names_the_layer_and_sp():
    # a strided conv splits its output over the ranks, uneven or not
    # (tests/test_torch_port_spatial_train.py); a 2x2 max pool is row-local
    # and a generator's stages must split evenly: both name the layer, sp
    x = _seeded((1, 12, 8, 4), 10)
    with spatial.partitioned(CutShards(4, 1, x)), \
            pytest.raises(ValueError, match=r"max_pool 2x2.*sp = 4"):
        ops.max_pool2x2(x[:, 3:6])
    from ir2rgb_tpu_torch.nn.generators import GenConfig, define_g
    g = define_g(GenConfig(net_g="resnet_6blocks", ngf=4, input_nc=4))
    with spatial.partitioned(CutShards(4, 1, x)), torch.no_grad(), \
            pytest.raises(ValueError, match=r"resnet_6blocks.*sp = 4"):
        g(x[:, 3:6])


# ---------------------------------------------------------------------------
# chip_smoke.py's SPATIAL tables against a partitioned frame on the meta
# device (shapes only)
# ---------------------------------------------------------------------------

class MetaShards(spatial.Shards):
    """A middle rank whose exchanges return empty rows of the right
    shape: a partitioned forward on the meta device."""

    def exchange(self, x, plan):
        return x.new_empty((x.shape[0], len(plan.foreign[self.rank]))
                           + tuple(x.shape[2:]))

    def gather_stats(self, t):
        return t.new_empty((self.sp,) + tuple(t.shape))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# a rank process (the file run as a script) needs none of it
CS = _chip_smoke() if __name__ != "__main__" else None
# every ResNet-family preset on sp 4, and the phase's own shards
PARTITIONED = [] if CS is None else sorted(
    {(p, 4, 1) for p in CS.SERVE if "unet" not in p}
    | set(CS.SPATIAL_TABLES))


@pytest.mark.parametrize("key", PARTITIONED,
                         ids=lambda k: "-".join(map(str, k)))
def test_partitioned_frame_sends_chip_smokes_shapes(monkeypatch, key):
    from ir2rgb_tpu_torch import kernels
    from ir2rgb_tpu_torch.config import PRESETS
    from ir2rgb_tpu_torch.nn import define_g
    from ir2rgb_tpu_torch.train import network_configs
    preset, sp, n = key
    stats, b1, tails, d2s = {}, {}, [], []

    def count(table, k):
        table[k] = table.get(k, 0) + 1

    def norm_stats(x):
        count(stats, tuple(x.shape))
        mean = x.new_empty((x.shape[0], x.shape[3]))
        return mean, mean

    def norm_apply(x, mean, rstd, act, negative_slope=0.2):
        count(b1, (tuple(x.shape), act))
        return x

    def tail(x, w, b):
        tails.append(tuple(x.shape))
        return x[..., :3]

    def interleave(y, c):
        d2s.append((tuple(y.shape), c))
        return y.new_empty((y.shape[0], 2 * y.shape[1], 2 * y.shape[2], c))
    monkeypatch.setattr(ops, "instance_norm_stats", norm_stats)
    monkeypatch.setattr(ops, "instance_norm_apply", norm_apply)
    monkeypatch.setattr(ops, "fused_instance_norm_act", None)
    monkeypatch.setattr(kernels, "tail_fused", tail)
    monkeypatch.setattr(ops, "d2s_fn", interleave)
    gen_cfg, _ = network_configs(PRESETS[preset])
    size = PRESETS[preset].data.crop_size
    with torch.device("meta"), torch.no_grad(), \
            spatial.partitioned(MetaShards(sp, 1)):
        y = define_g(gen_cfg)(torch.empty((n, size // sp, size,
                                           gen_cfg.input_nc)))
    table = CS.shard_table(CS.SERVE[preset], sp, n)
    assert table == CS.SPATIAL_TABLES.get(key, table)
    assert tuple(y.shape) == (n, size // sp, size, 3)
    assert b1 == table["b1"] and tails == table["tail"]
    assert d2s == table["d2s"]
    assert stats == {s: sum(c for (t, _), c in b1.items() if t == s)
                     for s, _ in b1}
    assert CS.spatial_per_frame(preset) == {
        **CS.per_frame(preset), "instance_norm_act": 0,
        "instance_norm_stats": sum(stats.values()),
        "instance_norm_apply": sum(b1.values()), "tail_fused": len(tails),
        "d2s": len(d2s)}


# ---------------------------------------------------------------------------
# Layout: the mesh and shard_batch against JAX's
# ---------------------------------------------------------------------------

def _fake_group(world, rank):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    torch.distributed.init_process_group("fake", rank=rank, world_size=world,
                                         store=FakeStore())


def test_dp_sp_mesh_2x4_is_the_mesh_jax_builds():
    from ir2rgb_tpu.parallel import dp_sp_mesh as jax_dp_sp_mesh
    jmesh = jax_dp_sp_mesh(2, 4)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(8):
        _fake_group(8, rank)
        try:
            m = dp_sp_mesh(2, 4, device="cpu")
            row = [int(i) for i in ids[m.dp_rank]]
            col = [int(i) for i in ids[:, m.sp_rank]]
            assert (m.dp, m.sp, m.world) == (2, 4, 8)
            assert ids[m.dp_rank, m.sp_rank] == rank
            get = torch.distributed.get_process_group_ranks
            assert get(m.sp_group) == row and get(m.dp_group) == col
        finally:
            torch.distributed.destroy_process_group()


def test_shard_batch_blocks_are_jaxs_shards():
    import jax
    from ir2rgb_tpu.parallel import dp_sp_mesh as jax_dp_sp_mesh
    from ir2rgb_tpu.parallel import shard_batch as jax_shard_batch
    r = np.random.default_rng(11)
    batch = {"img": r.standard_normal((2, 8, 8, 3)).astype(np.float32),
             "seq": r.standard_normal((2, 3, 8, 8, 3)).astype(np.float32),
             "inst": r.integers(0, 9, (2, 8, 8)).astype(np.int32),
             "label": np.arange(2, dtype=np.int32)}
    want = jax_shard_batch(batch, jax_dp_sp_mesh(2, 4))
    for rank in range(8):
        m = DataParallelMesh(8, rank, rank, torch.device("cpu"), sp=4)
        got = shard_batch(batch, m)
        for k, arr in want.items():
            [shard] = [s for s in arr.addressable_shards
                       if s.device.id == rank]
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(jax.device_get(
                                              shard.data)), err_msg=k)


def test_dp_sp_mesh_sp_without_a_group_of_dp_times_sp_raises():
    with pytest.raises(ValueError, match="nproc_per_node 8"):
        dp_sp_mesh(2, 4, devices=list(range(8)))
    _fake_group(4, 0)
    try:
        with pytest.raises(ValueError, match="has 4 rank"):
            dp_sp_mesh(1, 2)
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# Errors: pooled serving with a mesh, and what is out of this slice
# ---------------------------------------------------------------------------

def _model(arch, **infer):
    cfg = Config(model=ModelConfig(**arch), data=DataConfig(crop_size=CROP),
                 loss=LossConfig(no_vgg_loss=True),
                 infer=InferConfig(**infer))
    return create_model(cfg, device="cpu")


FAKE_SP2 = DataParallelMesh(2, 0, 0, torch.device("cpu"), sp=2)


def test_pooled_serving_with_a_mesh_raises():
    model = _model(TEMPORAL)
    with pytest.raises(ValueError, match="single-chip"):
        MultiStreamServer(model, (CROP, CROP), n_slots=4, physical_slots=2,
                          mesh=object())


@pytest.mark.parametrize("what", ["train_step", "quant", "netE_features",
                                  "edges", "artifact",
                                  "multistream_artifact", "unet"])
def test_out_of_slice_pieces_name_a16b(what, tmp_path):
    from ir2rgb_tpu_torch.infer.export import load_serving_artifact
    from ir2rgb_tpu_torch.nn.generators import GenConfig, define_g
    from ir2rgb_tpu_torch.train.trainer import Trainer
    x = _seeded((1, 8, 8, 8), 12)
    with pytest.raises(NotImplementedError, match="A16b"):
        if what == "train_step":
            # temporal windows, WGAN-GP and CycleGAN train partitioned;
            # the instance-edge input does not
            cfg = Config(model=ModelConfig(**LOCAL, use_instance_edges=True),
                         loss=LossConfig(no_vgg_loss=True),
                         train=TrainConfig(spatial_devices=2,
                                           checkpoints_dir=str(tmp_path)))
            Trainer(create_model(cfg, device="cpu"), cfg)
        elif what == "quant":
            with torch.no_grad(), quant.using("int8"), \
                    spatial.partitioned(CutShards(2, 0, x)):
                ops.conv(x[:, :4], torch.zeros((8, 8, 3, 3)), padding=1)
        elif what in ("netE_features", "edges"):
            s = StreamingGenerator(_model(LOCAL), (CROP, CROP), mesh=FAKE_SP2)
            extra = torch.zeros((1, CROP, CROP, 1))
            s.push_device(torch.zeros((1, CROP, CROP, 3)),
                          **{"feat" if what == "netE_features" else "edges":
                             extra})
        elif what == "artifact":
            load_serving_artifact(str(tmp_path / "m.ir2rgb"), mesh=FAKE_SP2)
        elif what == "multistream_artifact":
            MultiStreamServer.from_artifact(str(tmp_path / "m.ir2rgb"),
                                            mesh=FAKE_SP2)
        else:
            with torch.no_grad(), spatial.partitioned(CutShards(2, 0, x)):
                define_g(GenConfig(net_g="unet_128", ngf=4, input_nc=8))(
                    x[:, :4])


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _frames(n, seed, c=3):
    r = np.random.default_rng(seed)
    return r.uniform(-1, 1, (n, 1, CROP, CROP, c)).astype(np.float32)


def _u8_ticks():
    r = np.random.default_rng(13)
    return [{s: r.integers(0, 256, (CROP, CROP, 3), dtype=np.uint8)
             for s in slots} for slots in TICKS]


def _u8_frames():
    r = np.random.default_rng(14)
    return [r.integers(0, 256, (CROP, CROP, 3), dtype=np.uint8)
            for _ in range(2)]


def _step_device(srv):
    """Two ``step_device`` ticks of the whole physical batch: (uint8 out,
    carry) after each."""
    r = np.random.default_rng(15)
    out = []
    for _ in range(2):
        frames = torch.from_numpy(r.integers(0, 256, (SLOTS, CROP, CROP, 3),
                                             dtype=np.uint8))
        out.append((srv.step_device(frames).clone(), srv._carry.clone()))
    return out


def _serve_ticks(srv, ticks):
    sids = [srv.open() for _ in range(SLOTS)]
    outs, carries = [], []
    for t in ticks:
        outs.append(srv.step({sids[s]: f for s, f in t.items()}))
        carries.append(srv._carry.clone())
    return outs, carries


def worker(port, rank, out):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=4, process_id=rank,
                         timeout_s=TIMEOUT_S)
    weights = torch.load(os.path.join(out, "weights.pt"))
    res = {}
    m14 = dp_sp_mesh(1, SP, device="cpu")
    try:
        dp_sp_mesh(1, 2)
    except ValueError as e:
        res["mismatch"] = str(e)
    local = _model(LOCAL)
    local.netG.load_state_dict(weights["local"])
    x = torch.from_numpy(_frames(1, 0)[0])
    s = StreamingGenerator(local, (CROP, CROP), mesh=m14)
    res["local"] = s.push_device(x)
    res["local_u8"] = list(s.stream(_u8_frames()))
    temporal = _model(TEMPORAL)
    temporal.netG.load_state_dict(weights["temporal"])
    s = StreamingGenerator(temporal, (CROP, CROP), mesh=m14)
    res["temporal"] = [(s.push_device(torch.from_numpy(f)), s.carry.clone())
                       for f in _frames(FRAMES, 1)]
    m22 = dp_sp_mesh(2, 2, device="cpu")
    srv = MultiStreamServer(temporal, (CROP, CROP), n_slots=SLOTS, mesh=m22)
    res["server"] = _serve_ticks(srv, _u8_ticks())
    res["server_rank"] = (m22.dp_rank, m22.sp_rank)
    srv = MultiStreamServer(temporal, (CROP, CROP), n_slots=SLOTS, mesh=m22)
    res["server_device"] = _step_device(srv)
    res["batch_norm"] = StreamingGenerator(
        _model(BATCH_NORM), (CROP, CROP), batch=2, mesh=m22).push_device(
            torch.from_numpy(_frames(2, 3)[:, 0]))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    m14.barrier()
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_weights(jmodel, seed):
    """JAX generator params of ``jmodel`` drawn as the reference's
    ``weights_init`` draws them (kernels N(0, 0.02), biases 0) from a
    numpy seed, without compiling JAX's init."""
    import jax
    shapes = jax.eval_shape(jmodel.g_init, jax.random.PRNGKey(0))
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (r.normal(0, 0.02, s.shape) if len(s.shape) > 1
                   else np.zeros(s.shape)).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, the port's one-process frames and JAX's
    sharded frames of the same weights (computed while the ranks run)."""
    import jax
    import jax.numpy as jnp
    from ir2rgb_tpu.config import Config as JConfig
    from ir2rgb_tpu.config import DataConfig as JDataConfig
    from ir2rgb_tpu.config import LossConfig as JLossConfig
    from ir2rgb_tpu.config import ModelConfig as JModelConfig
    from ir2rgb_tpu.infer.stream import StreamingGenerator as JStream
    from ir2rgb_tpu.parallel import batch_sharding, replicate
    from ir2rgb_tpu.parallel import dp_sp_mesh as jax_dp_sp_mesh
    from ir2rgb_tpu.train import create_model as jax_create_model
    from ir2rgb_tpu_torch.checkpoint import generator_state_dict_from_jax

    out = tmp_path_factory.mktemp("spatial")
    jm, params, sds = {}, {}, {}
    for i, (name, arch) in enumerate((("local", LOCAL),
                                      ("temporal", TEMPORAL))):
        jm[name] = jax_create_model(JConfig(
            model=JModelConfig(**arch), data=JDataConfig(crop_size=CROP),
            loss=JLossConfig(no_vgg_loss=True)), steps_per_epoch=10)
        params[name] = _jax_weights(jm[name], i)
        sds[name] = generator_state_dict_from_jax(
            params[name], _model(arch).gen_cfg)
    torch.save(sds, out / "weights.pt")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(r), str(out)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True) for r in range(4)]
    try:
        mesh = jax_dp_sp_mesh(1, SP)
        rep, xsh = replicate(mesh), batch_sharding(mesh)
        lm = jm["local"]
        x = _frames(1, 0)[0]
        jax_local = np.asarray(jax.jit(
            lambda p, a: lm.generate(p, a, train=False),
            in_shardings=(rep, xsh), out_shardings=xsh)(
                jax.device_put(params["local"], rep),
                jax.device_put(jnp.asarray(x), xsh)))
        js = JStream(jm["temporal"], params["temporal"], (CROP, CROP),
                     mesh=mesh)
        jax_temporal = [np.asarray(js.push_device(jnp.array(f)))
                        for f in _frames(FRAMES, 1)]
        with torch.no_grad():
            local, temporal = _model(LOCAL), _model(TEMPORAL)
            local.netG.load_state_dict(sds["local"])
            temporal.netG.load_state_dict(sds["temporal"])
            one_local = local.generate(torch.from_numpy(x))
            one_local_u8 = list(StreamingGenerator(
                local, (CROP, CROP)).stream(_u8_frames()))
            s = StreamingGenerator(temporal, (CROP, CROP))
            one_temporal = [(s.push_device(torch.from_numpy(f)),
                             s.carry.clone()) for f in _frames(FRAMES, 1)]
            one_server = _serve_ticks(MultiStreamServer(
                temporal, (CROP, CROP), n_slots=SLOTS), _u8_ticks())
            one_server_device = _step_device(MultiStreamServer(
                temporal, (CROP, CROP), n_slots=SLOTS))
            one_batch_norm = _model(BATCH_NORM).generate(
                torch.from_numpy(_frames(2, 3)[:, 0]))
    finally:
        try:
            outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
    bad = [f"rank {r} exited {p.returncode}:\n{e[-3000:]}"
           for r, (p, (_, e)) in enumerate(zip(procs, outs)) if p.returncode]
    assert not bad, "\n".join(bad)
    return dict(ranks=[torch.load(out / f"rank{r}.pt", weights_only=False)
                       for r in range(4)],
                jax_local=jax_local, jax_temporal=jax_temporal,
                one_local=one_local, one_temporal=one_temporal,
                one_server=one_server, one_batch_norm=one_batch_norm,
                one_local_u8=one_local_u8,
                one_server_device=one_server_device)


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def test_local_enhancer_on_sp4_equals_one_process_and_jax(ranks):
    for r in ranks["ranks"]:
        assert r["local"].shape == (1, CROP, CROP, 3)
        assert _gap(r["local"], ranks["one_local"]) <= 1e-5
        assert _gap(r["local"], ranks["jax_local"]) <= 1e-4
    assert "has 4 rank" in ranks["ranks"][0]["mismatch"]
    # the host wire: uint8 frames through the pipelined stream
    for r in ranks["ranks"]:
        for got, want in zip(r["local_u8"], ranks["one_local_u8"]):
            assert got.shape == (CROP, CROP, 3) and _gap(got, want) <= 1


def test_temporal_stream_on_sp4_equals_one_process_and_jax(ranks):
    h = CROP // SP
    for k, r in enumerate(ranks["ranks"]):
        for (got, carry), (want, want_carry), jax_out in zip(
                r["temporal"], ranks["one_temporal"], ranks["jax_temporal"]):
            assert _gap(got, want) <= 1e-5
            assert _gap(got, jax_out) <= 1e-4
            # each rank keeps its own rows of the carry
            assert carry.shape == (1, h, CROP, 3)
            assert _gap(carry, want_carry[:, k * h:(k + 1) * h]) <= 1e-5


def test_multistream_server_on_dp2_sp2_equals_one_process(ranks):
    outs_one, carries_one = ranks["one_server"]
    for r in ranks["ranks"]:
        outs, carries = r["server"]
        d, s = r["server_rank"]
        for got, want in zip(outs, outs_one):
            assert sorted(got) == sorted(want)
            for sid in want:  # uint8 frames: rounding may move one LSB
                assert _gap(got[sid], want[sid]) <= 1
        h = CROP // 2
        for got, want in zip(carries, carries_one):
            assert _gap(got, want[2 * d:2 * d + 2, s * h:(s + 1) * h]) <= 1e-5
        # the device path: the whole batch in and out on every rank
        for (got, carry), (want, want_carry) in zip(
                r["server_device"], ranks["one_server_device"]):
            assert got.shape == want.shape and _gap(got, want) <= 1
            assert _gap(carry, want_carry[2 * d:2 * d + 2,
                                          s * h:(s + 1) * h]) <= 1e-5


def test_batch_norm_on_dp2_sp2_takes_the_whole_batchs_moments(ranks):
    # two frames, one a data row, each split over its row's two ranks:
    # batch norm's statistics span all four ranks' rows
    for r in ranks["ranks"]:
        assert r["batch_norm"].shape == (2, CROP, CROP, 3)
        assert _gap(r["batch_norm"], ranks["one_batch_norm"]) <= 1e-5


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
