"""The port's network serving daemon (infer/server.py, cli/serve.py) on the
CPU: the non-artifact tests of tests/test_serve.py against the port's
FrameServer over localhost (the TCP protocol, the batching tick loop,
per-connection carries, the JPEG wire, error paths, flow control, the
batching window), the JAX package's FrameClient talking to the port's
FrameServer (the wire protocol is the same byte for byte), and
``python -m ir2rgb_tpu_torch.cli.serve --device cpu`` end to end. Every
socket wait has its own timeout."""

import os
import pathlib
import selectors
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ir2rgb_tpu.infer.server import FrameClient as JFrameClient

from ir2rgb_tpu_torch.config import Config, DataConfig, LossConfig, ModelConfig
from ir2rgb_tpu_torch.infer import MultiStreamServer, StreamingGenerator
from ir2rgb_tpu_torch.infer.server import (
    _HDR,
    _HELLO,
    FrameClient,
    FrameServer,
    _recv_exact,
)
from ir2rgb_tpu_torch.train import create_model

import torch_refs

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 60.0  # every client socket's own timeout, seconds


def _model(temporal=True):
    cfg = Config(
        model=ModelConfig(model="temporal" if temporal else "pix2pix",
                          net_g="resnet_6blocks", net_d="n_layers",
                          ngf=8, ndf=8, n_frames_g=2),
        data=DataConfig(crop_size=32), loss=LossConfig(no_vgg_loss=True))
    return create_model(cfg, device="cpu", seed=3)


def _frames(seed, n, smooth=False):
    if smooth:  # JPEG-friendly for the wire-codec test
        yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
        return [np.stack([(xx * 4 + 9 * t) % 256, (yy * 4) % 256,
                          (xx + yy + 5 * t) % 256], -1).astype(np.uint8)
                for t in range(n)]
    rng = np.random.RandomState(seed)
    return [(rng.rand(32, 32, 3) * 255).astype(np.uint8) for _ in range(n)]


def _assert_lsb(a, b, tol=1):
    assert np.max(np.abs(a.astype(np.int16) - b.astype(np.int16))) <= tol


def _client(port, **kw):
    return FrameClient("127.0.0.1", port, timeout=TIMEOUT, **kw)


@pytest.fixture(scope="module")
def served():
    """One running FrameServer shared by the in-process tests."""
    model = _model()
    srv = MultiStreamServer(model, (32, 32), n_slots=4)
    fs = FrameServer(srv, port=0, tick_ms=2.0)
    fs.start()
    yield fs, model
    fs.stop()


def _reference(model, frames):
    s = StreamingGenerator(model, (32, 32))
    return [s.push(f) for f in frames]


def test_single_client_matches_streaming_generator(served):
    fs, model = served
    frames = _frames(1, 4)
    ref = _reference(model, frames)
    with _client(fs.port) as c:
        assert c.frame_hw == (32, 32)
        assert (c.in_nc, c.out_nc) == (3, 3)
        for f, r in zip(frames, ref):
            _assert_lsb(c.push(f), r)


def test_jax_client_talks_to_the_port_server(served):
    """The JAX package's FrameClient against the port's FrameServer: the
    hello, raw frames, STAT and BYE! are the same bytes."""
    fs, model = served
    frames = _frames(12, 3)
    ref = _reference(model, frames)
    with JFrameClient("127.0.0.1", fs.port, timeout=TIMEOUT) as c:
        assert c.frame_hw == (32, 32) and (c.in_nc, c.out_nc) == (3, 3)
        assert not c.reply_jpeg
        outs = list(c.stream(frames))
        st = c.stats()
    assert st["slots_total"] == 4 and st["physical_slots"] == 4
    assert len(outs) == 3
    for o, r in zip(outs, ref):
        _assert_lsb(o, r)


def test_two_clients_batched_with_isolated_carries(served):
    """Two concurrent connections: each stream equals its own batch-1
    run while the server batches their frames into shared ticks."""
    fs, model = served
    fa, fb = _frames(2, 3), _frames(3, 3)
    ref = {"a": _reference(model, fa), "b": _reference(model, fb)}
    ca, cb = _client(fs.port), _client(fs.port)
    try:
        for t in range(3):
            ca.send(fa[t])
            cb.send(fb[t])
            _assert_lsb(ca.recv(), ref["a"][t])
            _assert_lsb(cb.recv(), ref["b"][t])
    finally:
        ca.close()
        cb.close()


def test_pipelined_stream(served):
    fs, model = served
    frames = _frames(4, 5)
    ref = _reference(model, frames)
    with _client(fs.port) as c:
        outs = list(c.stream(frames))
    assert len(outs) == len(ref)
    for o, r in zip(outs, ref):
        _assert_lsb(o, r)


def test_reconnect_gets_fresh_carry(served):
    fs, _ = served
    frames = _frames(5, 2)
    with _client(fs.port) as c:
        first = [c.push(f) for f in frames]
    with _client(fs.port) as c:
        again = [c.push(f) for f in frames]
    for a, b in zip(first, again):
        _assert_lsb(a, b)


def test_bad_frame_size_errors(served):
    fs, _ = served
    with _client(fs.port) as c:
        c.send(np.zeros((16, 16, 3), np.uint8))
        with pytest.raises(RuntimeError, match="expected 3072"):
            c.recv()


def test_jpeg_wire_mode():
    """JPEG both ways: the expected reply is the reference's output on
    the decoded input, through the reply-side JPEG round trip."""
    from ir2rgb_tpu_torch.data import native
    model = _model(temporal=False)
    srv = MultiStreamServer(model, (32, 32), n_slots=2)
    fs = FrameServer(srv, port=0, encode="jpeg", quality=95, tick_ms=0)
    fs.start()
    try:
        ref_srv = MultiStreamServer(model, (32, 32), n_slots=1)
        sid = ref_srv.open()

        def roundtrip(img):
            j = np.frombuffer(native.encode_jpeg(img, 95), np.uint8)
            return native.decode_jpeg_mem_batch(
                j, np.array([0]), np.array([len(j)]), 32, 32)[0]

        with _client(fs.port, jpeg=True, quality=95) as c:
            assert c.reply_jpeg
            for f in _frames(0, 2, smooth=True):
                out = c.push(f)
                expected = roundtrip(ref_srv.step({sid: roundtrip(f)})[sid])
                err = out.astype(np.float32) - expected.astype(np.float32)
                psnr = 10 * np.log10(255.0 ** 2
                                     / max(float(np.mean(err ** 2)), 1e-9))
                assert psnr > 35, psnr
    finally:
        fs.stop()


def test_slot_exhaustion_refused():
    srv = MultiStreamServer(_model(temporal=False), (32, 32), n_slots=1)
    fs = FrameServer(srv, port=0, tick_ms=0)
    fs.start()
    try:
        with _client(fs.port) as c1:
            c1.push(_frames(1, 1)[0])
            c2 = _client(fs.port)
            with pytest.raises(RuntimeError, match="slots busy"):
                c2.send(_frames(2, 1)[0])
                c2.recv()
            c2.close()
        deadline = time.time() + 10
        while time.time() < deadline:
            c3 = _client(fs.port)
            try:
                c3.push(_frames(3, 1)[0])
                break
            except RuntimeError:
                time.sleep(0.05)
            finally:
                c3.close()
        else:
            pytest.fail("slot never freed after client close")
    finally:
        fs.stop()


def test_frame_then_instant_disconnect_keeps_server_alive(served):
    fs, model = served
    s = socket.create_connection(("127.0.0.1", fs.port), timeout=TIMEOUT)
    _recv_exact(s, _HELLO.size)
    payload = np.zeros(32 * 32 * 3, np.uint8).tobytes()
    s.sendall(_HDR.pack(b"FRMR", len(payload)) + payload)
    s.close()  # no recv: the close races the tick
    frames = _frames(8, 2)
    ref = _reference(model, frames)
    with _client(fs.port) as c:
        for f, r in zip(frames, ref):
            _assert_lsb(c.push(f), r)


def test_connect_and_reset_does_not_leak_slots():
    srv = MultiStreamServer(_model(temporal=False), (32, 32), n_slots=1)
    fs = FrameServer(srv, port=0, tick_ms=0)
    fs.start()
    try:
        for _ in range(4):  # more abrupt connects than slots
            s = socket.create_connection(("127.0.0.1", fs.port),
                                         timeout=TIMEOUT)
            # RST instead of FIN: SO_LINGER with a zero timeout
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
            s.close()
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                with _client(fs.port) as c:
                    out = c.push(_frames(9, 1)[0])
                assert out.shape == (32, 32, 3)
                break
            except (RuntimeError, ConnectionError):
                time.sleep(0.1)
        else:
            pytest.fail("slot leaked: server refuses clients after "
                        "connect-and-reset peers")
    finally:
        fs.stop()


def test_pop_flag_missing_value_is_usage_error():
    from ir2rgb_tpu_torch.cli.common import pop_flag
    with pytest.raises(SystemExit, match="requires a value"):
        pop_flag(["--model.ngf", "8", "--torch_g"], "--torch_g")


def test_stats_message(served):
    fs, _ = served
    with _client(fs.port) as c:
        c.push(_frames(40, 1)[0])
        st = c.stats()
    assert st["slots_total"] == 4
    assert st["frames_served"] >= 1 and st["ticks_served"] >= 1
    assert st["slots_active"] >= 1


def test_stats_with_frames_in_flight(served):
    """stats() composes with pipelining: every frame's output still
    arrives, in order."""
    fs, _ = served
    fr = _frames(41, 3)
    with _client(fs.port) as c:
        for f in fr:
            c.send(f)
        st = c.stats()  # races the 3 frames in flight by design
        outs = [c.recv() for _ in range(3)]
    assert st["slots_total"] == 4
    with _client(fs.port) as c:
        outs2 = [c.push(f) for f in fr]
    for a, b in zip(outs, outs2):
        _assert_lsb(a, b)


def test_thin_client_imports_no_framework():
    """The protocol client and video IO import without torch (lazy
    package ``__init__``s)."""
    code = (
        "import sys\n"
        "import ir2rgb_tpu_torch.infer.server, ir2rgb_tpu_torch.data.video,"
        " ir2rgb_tpu_torch.obs.video\n"
        "heavy = [m for m in sys.modules if m.startswith('ir2rgb_tpu_torch')"
        " and any(k in m for k in ('loader', 'transforms', 'stream',"
        " 'multistream', 'train', 'nn.', 'checkpoint', 'kernels'))]\n"
        "assert not heavy, heavy\n"
        "assert 'torch' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-1500:]


def test_backpressure_transparent():
    """A client that outruns the tick loop is throttled by flow-control
    credits, never errored or dropped."""
    srv = MultiStreamServer(_model(temporal=False), (32, 32), n_slots=2)
    fs = FrameServer(srv, port=0, tick_ms=0.0, max_pending=2)
    fs.start()
    try:
        fr = _frames(77, 12)
        with _client(fs.port) as c:
            for f in fr:
                c.send(f)           # 12 frames deep, credits allow 2
            st = c.stats()          # STAT carries no credit: no deadlock
            outs = [c.recv() for _ in range(12)]
        assert st["slots_total"] == 2
        with _client(fs.port) as c:
            outs2 = [c.push(f) for f in fr]
        for a, b in zip(outs, outs2):
            _assert_lsb(a, b)
    finally:
        fs.stop()


def test_lone_connection_skips_batching_window():
    """A lone connection skips the batching window (tick_ms is set high,
    so a regression shows as a multi-second stall)."""
    srv = MultiStreamServer(_model(temporal=False), (32, 32), n_slots=2)
    fs = FrameServer(srv, port=0, tick_ms=1500.0)
    fs.start()
    try:
        fr = _frames(31, 4)
        with _client(fs.port) as c:
            c.push(fr[0])
            t0 = time.perf_counter()
            for f in fr[1:]:
                c.push(f)
            assert time.perf_counter() - t0 < 1.5, (
                "lone-connection frames waited the batching window")
    finally:
        fs.stop()


def test_window_exits_when_every_connection_contributed():
    srv = MultiStreamServer(_model(temporal=False), (32, 32), n_slots=2)
    fs = FrameServer(srv, port=0, tick_ms=3000.0)
    fs.start()
    try:
        fr = _frames(32, 2)
        with _client(fs.port) as a, _client(fs.port) as b:
            outs = {}

            def push(name, cli):
                outs[name] = cli.push(fr[0])

            def both():
                ts = [threading.Thread(target=push, args=(n, c))
                      for n, c in (("a", a), ("b", b))]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=TIMEOUT)
                assert not any(t.is_alive() for t in ts)

            both()  # warm-up round
            t1 = time.perf_counter()
            both()
            assert time.perf_counter() - t1 < 2.0, "window did not exit early"
            assert outs["a"].shape == (32, 32, 3)
    finally:
        fs.stop()


def test_frameserver_rejects_bad_max_pending():
    srv = MultiStreamServer(_model(temporal=False), (32, 32), n_slots=1)
    with pytest.raises(ValueError, match="max_pending"):
        FrameServer(srv, port=0, max_pending=0)


def test_lazy_exports_cache_into_module():
    import ir2rgb_tpu_torch.data as d
    vars(d).pop("make_dataset", None)
    assert "make_dataset" not in vars(d)
    first = d.make_dataset
    assert "make_dataset" in vars(d)
    assert d.make_dataset is first
    with pytest.raises(AttributeError, match="no attribute"):
        d.not_an_export


@pytest.mark.parametrize("dtype,tf32", [("float32", False), ("bf16", True)])
def test_serve_cli_fp32_turns_tf32_off(monkeypatch, dtype, tf32):
    """An fp32 model serves with full-fp32 convolutions and matmuls (the
    JAX package's HIGHEST precision); bf16 leaves the TF32 flags alone."""
    from ir2rgb_tpu_torch.cli.serve import main
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(["--device", "cpu", "--model.compute_dtype", dtype,
              "--artifact", "m.ir2rgb", "--torch_g", "g.pth"])
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_tf32 is tf32


def _banner(proc, timeout: float) -> str:
    """The first stdout line of ``proc``, or fail after ``timeout`` s."""
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        if not sel.select(timeout):
            pytest.fail(f"no banner within {timeout} s")
        return proc.stdout.readline()
    finally:
        sel.close()


def test_serve_cli_e2e(tmp_path):
    """``python -m ir2rgb_tpu_torch.cli.serve --device cpu --torch_g``: a
    subprocess on port 0, a client whose replies equal the imported
    generator's StreamingGenerator run, and a clean shutdown."""
    from ir2rgb_tpu_torch.checkpoint import import_generator
    t = torch_refs.ResnetGenerator(ngf=8, n_blocks=6, norm="instance")
    ckpt = str(tmp_path / "latest_net_G.pth")
    torch.save(t.state_dict(), ckpt)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ir2rgb_tpu_torch.cli.serve",
         "--device", "cpu", "--model.model", "pix2pix",
         "--model.net_g", "resnet_6blocks", "--model.ngf", "8",
         "--model.ndf", "8", "--data.crop_size", "32",
         "--infer.serve_port", "0", "--infer.serve_slots", "2",
         "--torch_g", ckpt],
        stdout=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    try:
        line = _banner(proc, 120)
        assert "serving pix2pix/resnet_6blocks at" in line, line
        assert "slots 2 (physical 2)" in line, line
        port = int(line.split(" at ")[1].split()[0].rsplit(":", 1)[1])
        assert port > 0
        model = _model(temporal=False)
        model.netG.load_state_dict(import_generator(ckpt, model.gen_cfg))
        frames = _frames(7, 2)
        ref = _reference(model, frames)
        with _client(port) as c:
            for f, r in zip(frames, ref):
                _assert_lsb(c.push(f), r)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
