"""The port's MultiStreamServer (infer/multistream.py) held to the JAX
package's on the CPU, on the same generator weights (carried across with
checkpoint/from_jax.py): every scenario of tests/test_multistream.py but
the mesh guard (held in tests/test_torch_port_spatial.py) runs on both
servers, each side also checks its own batched streams against its batch-1
StreamingGenerator (within 1 LSB, as the JAX tests do), and the port's
outputs are held to JAX's: uint8 within 1 LSB with at most 0.1% of the
values differing at all (JAX's jitted tick normalises with one fused
multiply-add, the port divides: ROADMAP §C), and the carries in fp32
within 1e-4.

Added: the pooled dispatch is atomic. A logical tick whose second chunk
raises leaves every carry and pending reset as it was, and the next tick
equals a run in which the failed tick never happened."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.config import Config as JConfig
from ir2rgb_tpu.config import DataConfig as JDataConfig
from ir2rgb_tpu.config import LossConfig as JLossConfig
from ir2rgb_tpu.config import ModelConfig as JModelConfig
from ir2rgb_tpu.infer import MultiStreamServer as JMultiStreamServer
from ir2rgb_tpu.infer import StreamingGenerator as JStreamingGenerator
from ir2rgb_tpu.train import create_model as jax_create_model

from ir2rgb_tpu_torch.checkpoint import generator_state_dict_from_jax
from ir2rgb_tpu_torch.config import Config, DataConfig, LossConfig, ModelConfig
from ir2rgb_tpu_torch.infer import MultiStreamServer, StreamingGenerator
from ir2rgb_tpu_torch.infer import multistream as pms
from ir2rgb_tpu_torch.nn.generators import Deconv
from ir2rgb_tpu_torch.train import create_model

HW = (32, 32)
ARCH = dict(net_g="resnet_6blocks", net_d="n_layers", ngf=8, ndf=8,
            n_frames_g=2)
MAX_DIFFERING = 1e-3  # share of uint8 values allowed to differ by 1 LSB
CARRY_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """{temporal: (JAX model, JAX params, port model)}, one set of
    weights each."""
    out = {}
    for temporal in (True, False):
        kind = "temporal" if temporal else "pix2pix"
        jmodel = jax_create_model(JConfig(
            model=JModelConfig(model=kind, **ARCH),
            data=JDataConfig(crop_size=32),
            loss=JLossConfig(no_vgg_loss=True)), steps_per_epoch=10)
        g = jmodel.g_init(jax.random.PRNGKey(0))
        pmodel = create_model(Config(
            model=ModelConfig(model=kind, **ARCH),
            data=DataConfig(crop_size=32),
            loss=LossConfig(no_vgg_loss=True)), device="cpu")
        pmodel.netG.load_state_dict(generator_state_dict_from_jax(
            jax.tree.map(np.asarray, g), pmodel.gen_cfg))
        out[temporal] = (jmodel, g, pmodel)
    return out


class Side:
    """One package's serving surface over the shared weights."""

    def __init__(self, models, port: bool):
        self.models, self.port = models, port

    def server(self, n_slots, temporal=True, physical_slots=None):
        jmodel, g, pmodel = self.models[temporal]
        if self.port:
            return MultiStreamServer(pmodel, HW, n_slots=n_slots,
                                     physical_slots=physical_slots)
        return JMultiStreamServer(jmodel, g, HW, n_slots=n_slots,
                                  physical_slots=physical_slots)

    def stream(self, temporal=True):
        jmodel, g, pmodel = self.models[temporal]
        if self.port:
            return StreamingGenerator(pmodel, HW)
        return JStreamingGenerator(jmodel, g, HW)


def _frames(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.rand(32, 32, 3) * 255).astype(np.uint8) for _ in range(n)]


def _assert_lsb(a, b):
    """Batched vs batch-1 on one side: within 1 LSB."""
    assert a.dtype == np.uint8 and b.dtype == np.uint8
    assert np.max(np.abs(a.astype(np.int16) - b.astype(np.int16))) <= 1


def _assert_port_matches_jax(p, j):
    assert p.dtype == np.uint8 and j.dtype == np.uint8
    assert p.shape == j.shape
    d = np.abs(p.astype(np.int16) - j.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert np.mean(d > 0) <= MAX_DIFFERING, np.mean(d > 0)


def _carry(srv):
    c = srv._carry
    if c is None:
        return None
    return (c.numpy() if isinstance(c, torch.Tensor)
            else np.asarray(jax.device_get(c)))


def _both(models, scenario):
    """Run ``scenario(side) -> (outputs, servers)`` on the port and on
    JAX; hold every output and each server's final carry to JAX's."""
    p_outs, p_srvs = scenario(Side(models, port=True))
    j_outs, j_srvs = scenario(Side(models, port=False))
    assert len(p_outs) == len(j_outs)
    for p, j in zip(p_outs, j_outs):
        _assert_port_matches_jax(p, j)
    for ps, js in zip(p_srvs, j_srvs):
        pc, jc = _carry(ps), _carry(js)
        assert (pc is None) == (jc is None)
        if pc is not None:
            np.testing.assert_allclose(pc, jc, atol=CARRY_ATOL)
    return p_outs


def test_multistream_matches_independent_streams(models):
    def scenario(side):
        seqs = {0: _frames(1, 3), 1: _frames(2, 3), 2: _frames(3, 3)}
        ref = {}
        for k, frames in seqs.items():
            s = side.stream()
            ref[k] = [s.push(f) for f in frames]
        srv = side.server(4)
        sids = {k: srv.open() for k in seqs}
        outs = []
        for t in range(3):
            o = srv.step({sids[k]: seqs[k][t] for k in seqs})
            for k in seqs:
                _assert_lsb(o[sids[k]], ref[k][t])
                outs.append(o[sids[k]])
        return outs, [srv]
    _both(models, scenario)


def test_skip_tick_holds_carry(models):
    def scenario(side):
        fa, fb = _frames(10, 3), _frames(11, 2)
        s = side.stream()
        ref_b = [s.push(f) for f in fb]
        srv = side.server(2)
        a, b = srv.open(), srv.open()
        o0 = srv.step({a: fa[0], b: fb[0]})
        o1 = srv.step({a: fa[1]})                 # b skips this tick
        o2 = srv.step({a: fa[2], b: fb[1]})
        _assert_lsb(o0[b], ref_b[0])
        _assert_lsb(o2[b], ref_b[1])
        assert set(o1) == {a}
        return [o0[a], o0[b], o1[a], o2[a], o2[b]], [srv]
    _both(models, scenario)


def test_slot_reuse_resets_carry(models):
    def scenario(side):
        f = _frames(20, 2)
        fresh_first = side.stream().push(f[0])
        srv = side.server(1)
        sid = srv.open()
        o = [srv.step({sid: f[0]})[sid], srv.step({sid: f[1]})[sid]]
        srv.close(sid)
        sid2 = srv.open()
        assert sid2 == sid                        # same physical slot
        out = srv.step({sid2: f[0]})[sid2]
        _assert_lsb(out, fresh_first)
        return o + [out], [srv]
    _both(models, scenario)


def test_ticks_pipelined_matches_step(models):
    def scenario(side):
        seq_a, seq_b = _frames(30, 4), _frames(31, 4)
        srv1 = side.server(2)
        a1, b1 = srv1.open(), srv1.open()
        seq_out = [srv1.step({a1: seq_a[t], b1: seq_b[t]})
                   for t in range(4)]
        srv2 = side.server(2)
        a2, b2 = srv2.open(), srv2.open()
        piped = list(srv2.ticks([{a2: seq_a[t], b2: seq_b[t]}
                                 for t in range(4)]))
        assert len(piped) == 4
        outs = []
        for got, want in zip(piped, seq_out):
            np.testing.assert_array_equal(got[a2], want[a1])
            np.testing.assert_array_equal(got[b2], want[b1])
            outs += [got[a2], got[b2]]
        return outs, [srv1, srv2]
    _both(models, scenario)


def test_slot_exhaustion_and_unknown_slot(models):
    for side in (Side(models, True), Side(models, False)):
        srv = side.server(1)
        sid = srv.open()
        with pytest.raises(RuntimeError, match="slots busy"):
            srv.open()
        with pytest.raises(KeyError, match="unattached"):
            srv.step({sid + 1: _frames(0, 1)[0]})
        srv.close(sid)
        assert srv.open() == sid


def test_physical_slot_padding_exact(models):
    """physical_slots > n_slots pads the batch with masked rows that never
    surface and change no output."""
    def scenario(side):
        seqs = {0: _frames(50, 2), 1: _frames(51, 2), 2: _frames(52, 2)}
        ref = {}
        for k, frames in seqs.items():
            s = side.stream()
            ref[k] = [s.push(f) for f in frames]
        srv = side.server(3, physical_slots=8)
        assert srv.physical_slots == 8
        sids = {k: srv.open() for k in seqs}
        with pytest.raises(RuntimeError):
            srv.open()  # the logical capacity is still 3
        outs = []
        for t in range(2):
            o = srv.step({sids[k]: seqs[k][t] for k in seqs})
            assert set(o) == set(sids.values())
            for k in seqs:
                _assert_lsb(o[sids[k]], ref[k][t])
                outs.append(o[sids[k]])
        return outs, [srv]
    _both(models, scenario)
    # the port's default physical batch: the requested slots, capped at
    # KNEE_SLOTS (the JAX package's {1, 2, 8} rounding answers a layout
    # cliff of the TPU compiler and is not copied)
    assert [pms.default_physical_slots(n)
            for n in (1, 2, 3, 7, 8, 9, 16, 17, 40)] == [1, 2, 3, 7, 8, 9,
                                                          16, 16, 16]
    assert pms.KNEE_SLOTS == 16


def test_pooled_chunked_round_robin_matches_streaming(models):
    """physical_slots < n_slots: chained chunk ticks over a carry pool
    give each stream its StreamingGenerator's outputs, through skips and
    a close + reopen."""
    def scenario(side):
        seqs = {k: _frames(60 + k, 3) for k in range(5)}
        ref = {}
        for k, frames in seqs.items():
            s = side.stream()
            ref[k] = [s.push(f) for f in frames]
        srv = side.server(5, physical_slots=2)
        assert srv.physical_slots == 2 and srv._pooled
        sids = {k: srv.open() for k in seqs}
        outs = []
        o = srv.step({sids[k]: seqs[k][0] for k in seqs})  # 3 chunks
        for k in seqs:
            _assert_lsb(o[sids[k]], ref[k][0])
            outs.append(o[sids[k]])
        live = [k for k in seqs if k not in (0, 3)]
        o = srv.step({sids[k]: seqs[k][1] for k in live})
        assert set(o) == {sids[k] for k in live}
        for k in live:
            _assert_lsb(o[sids[k]], ref[k][1])
            outs.append(o[sids[k]])
        o = srv.step({sids[0]: seqs[0][1], sids[3]: seqs[3][1]})
        _assert_lsb(o[sids[0]], ref[0][1])
        _assert_lsb(o[sids[3]], ref[3][1])
        outs += [o[sids[0]], o[sids[3]]]
        srv.close(sids[4])
        nid = srv.open()
        o = srv.step({nid: seqs[4][0]})
        _assert_lsb(o[nid], ref[4][0])
        return outs + [o[nid]], [srv]
    _both(models, scenario)


def test_pooled_non_temporal_chunks(models):
    def scenario(side):
        frames = _frames(70, 5)
        s = side.stream(temporal=False)
        ref = [s.push(f) for f in frames]
        srv = side.server(5, temporal=False, physical_slots=2)
        sids = [srv.open() for _ in range(5)]
        o = srv.step({sids[i]: frames[i] for i in range(5)})
        for i in range(5):
            _assert_lsb(o[sids[i]], ref[i])
        return [o[s] for s in sids], [srv]
    _both(models, scenario)


def test_pooled_pipelined_ticks_match_step(models):
    def scenario(side):
        seqs = {k: _frames(80 + k, 3) for k in range(3)}
        srv1 = side.server(3, physical_slots=2)
        sids1 = {k: srv1.open() for k in seqs}
        seq_out = [srv1.step({sids1[k]: seqs[k][t] for k in seqs})
                   for t in range(3)]
        srv2 = side.server(3, physical_slots=2)
        sids2 = {k: srv2.open() for k in seqs}
        piped = list(srv2.ticks(
            [{sids2[k]: seqs[k][t] for k in seqs} for t in range(3)]))
        assert len(piped) == 3
        outs = []
        for got, want in zip(piped, seq_out):
            for k in seqs:
                np.testing.assert_array_equal(got[sids2[k]],
                                              want[sids1[k]])
                outs.append(got[sids2[k]])
        return outs, [srv1, srv2]
    _both(models, scenario)


def test_non_temporal_batched_serving(models):
    def scenario(side):
        frames = _frames(40, 3)
        s = side.stream(temporal=False)
        ref = [s.push(f) for f in frames]
        srv = side.server(3, temporal=False)
        sids = [srv.open() for _ in range(3)]
        o = srv.step({sids[i]: frames[i] for i in range(3)})
        for i in range(3):
            _assert_lsb(o[sids[i]], ref[i])
        return [o[s] for s in sids], [srv]
    _both(models, scenario)


def test_step_device_leaves_caller_frames_alone(models):
    """step_device may be called again with the same device frames: they
    are not written (the JAX server must not donate them)."""
    def scenario(side):
        srv = side.server(2)
        batch = np.stack(_frames(50, srv.physical_slots))
        if side.port:
            frames_dev = torch.from_numpy(batch)
            keep = frames_dev.clone()
            out1 = srv.step_device(frames_dev).numpy()
            out2 = srv.step_device(frames_dev).numpy()
            assert torch.equal(frames_dev, keep)
        else:
            frames_dev = jnp.asarray(batch)
            out1 = np.asarray(jax.device_get(srv.step_device(frames_dev)))
            out2 = np.asarray(jax.device_get(srv.step_device(frames_dev)))
        assert out1.shape == out2.shape == (2, 32, 32, 3)
        return [out1, out2], [srv]
    _both(models, scenario)


def test_empty_tick_is_free_and_consistent(models):
    """step({}) returns {} without running the generator; ticks() with
    empty ticks interleaved matches sequential step calls."""
    def scenario(side):
        fa = _frames(5, 2)
        srv = side.server(1)
        a = srv.open()
        assert srv.step({}) == {}
        o0 = srv.step({a: fa[0]})
        assert srv.step({}) == {}
        o1 = srv.step({a: fa[1]})
        srv2 = side.server(1)
        a2 = srv2.open()
        outs = list(srv2.ticks(iter([{}, {a2: fa[0]}, {}, {a2: fa[1]}])))
        assert len(outs) == 4
        assert outs[0] == {} and outs[2] == {}
        np.testing.assert_array_equal(outs[1][a2], o0[a])
        np.testing.assert_array_equal(outs[3][a2], o1[a])
        return [o0[a], o1[a]], [srv, srv2]
    _both(models, scenario)


def test_failed_chunk_leaves_the_pooled_tick_uncommitted(models):
    """A pooled logical tick of three chunks whose second chunk raises:
    every carry and every pending reset is what it was before the tick,
    and the next tick equals a run in which the failed tick never
    happened."""
    side = Side(models, port=True)
    seqs = {k: _frames(90 + k, 3) for k in range(5)}

    def prepare():
        srv = side.server(5, physical_slots=2)
        sids = {k: srv.open() for k in seqs}
        srv.step({sids[k]: seqs[k][0] for k in seqs})
        # a reopened slot: its reset is pending across the failed tick
        srv.close(sids[1])
        sids[1] = srv.open()
        return srv, sids

    srv, sids = prepare()
    carry = srv._carry.clone()
    pending = srv._pending_reset.copy()
    assert pending[sids[1]] and pending.sum() == 1
    tick, calls = srv._tick, []

    def failing(*args):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("chunk 2 failed")
        return tick(*args)

    srv._tick = failing
    with pytest.raises(RuntimeError, match="chunk 2 failed"):
        srv.step({sids[k]: seqs[k][1] for k in seqs})
    assert len(calls) == 2
    srv._tick = tick
    assert torch.equal(srv._carry, carry)
    np.testing.assert_array_equal(srv._pending_reset, pending)

    ref, ref_sids = prepare()
    for t in (1, 2):
        got = srv.step({sids[k]: seqs[k][t] for k in seqs})
        want = ref.step({ref_sids[k]: seqs[k][t] for k in seqs})
        for k in seqs:
            np.testing.assert_array_equal(got[sids[k]], want[ref_sids[k]])
        assert torch.equal(srv._carry, ref._carry)
    assert not srv._pending_reset.any()


@pytest.mark.parametrize("surface", ["pooled_server", "stream"])
def test_bf16_serving_keeps_the_rearranged_deconv_weight(surface):
    """bf16 serving: the serving copy is built with inference mode off
    even when the first tick asks for it inside, so every ``Deconv``
    keeps its rearranged weight from one tick to the next."""
    model = create_model(Config(
        model=ModelConfig(model="temporal", compute_dtype="bf16", **ARCH),
        data=DataConfig(crop_size=32),
        loss=LossConfig(no_vgg_loss=True)), device="cpu")
    frames = _frames(7, 2)
    if surface == "pooled_server":
        srv = MultiStreamServer(model, HW, n_slots=3, physical_slots=2)
        sids = [srv.open() for _ in range(3)]

        def tick(f):
            srv.step({s: f for s in sids})
    else:
        stream = StreamingGenerator(model, HW)
        tick = stream.push
    tick(frames[0])
    g = model.serving_generator()
    assert all(not p.is_inference() for p in g.parameters())
    deconvs = [m for m in g.modules() if isinstance(m, Deconv)]
    assert deconvs and all(m._wk is not None for m in deconvs)
    kept = [m._wk[3] for m in deconvs]
    tick(frames[1])
    assert model.serving_generator() is g
    assert all(m._wk[3] is k for m, k in zip(deconvs, kept))
