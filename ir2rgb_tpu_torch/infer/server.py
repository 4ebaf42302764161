"""Network serving daemon: N TCP clients -> one batched generator tick
(the port of ``ir2rgb_tpu/infer/server.py``; the wire protocol is the
same, byte for byte, so either package's client talks to either
package's server).

A long-lived process that accepts frames over the network. It fronts
:class:`~ir2rgb_tpu_torch.infer.multistream.MultiStreamServer`: every
client connection attaches to one server slot (its own temporal carry on
the device), and a single tick loop batches whatever frames arrived
across all connections into ONE generator tick. What batching gains on
the H100 is measured by ``chip_smoke.py``'s ms/tick ladder (``PERF.md``
§5).

Wire protocol (version 1, little-endian, dependency-free):

- On accept, the server sends a 12-byte hello:
  ``b"I2RS" | u8 version | u8 in_nc | u8 out_nc | u8 flags | u16 h | u16 w``
  (flags bit 0: replies are JPEG). Frames are h x w, in_nc channels.
- Every subsequent message both ways is ``fourcc | u32 length | payload``:
  - client->server  ``FRMR`` raw HWC uint8 (h*w*in_nc bytes) or
    ``FRMJ`` a JPEG (decoded + resized server-side; gray for in_nc=1);
    ``STAT`` (length 0) requests server stats; ``BYE!`` (length 0) for
    a clean close.
  - server->client  ``OUTR`` raw h*w*out_nc uint8 or ``OUTJ`` a JPEG
    (per ``encode=``), in frame order per connection; ``STAT`` + a JSON
    object (ticks/frames served, slot occupancy) answering a stats
    request — answered out of band, so it may overtake frame outputs
    still queued for a tick (FrameClient.stats() parks any OUT*
    messages it reads while waiting); ``ERR!`` + utf-8 message before a
    protocol-error close.

Clients may pipeline frames; per-connection output order matches input
order. One frame per connection joins each tick (FIFO), so a pipelining
client's backlog drains one frame per tick while OTHER connections'
frames still batch into the same tick. Backlog is bounded: the server
holds at most ``max_pending`` frames end-to-end per connection — when a
client outruns the tick loop by more than that, the reader stops
reading its socket and TCP backpressure throttles the sender (no error,
no drop; ``send()`` just blocks until outputs drain).

Threading: one reader + one writer thread per connection, one tick-loop
thread, one accept thread. Only the tick loop touches the
MultiStreamServer (slot open/close included — readers enqueue control
events), so the model side stays single-threaded; the tick enters
``torch.inference_mode()`` itself, in the tick loop's thread (the mode
and the current CUDA stream are thread-local). The batching window
(``tick_ms``) bounds added latency: the loop blocks for the first
pending frame, then waits at most tick_ms for concurrent connections'
frames to join the batch — exiting early the moment every attached
connection has contributed one, and skipping the window entirely when
only one connection is attached. Any other event (an open, a close, a
STAT request) ends the window too.

This module imports no torch: ``FrameClient`` serves thin clients. JPEG
goes through ``data/native.py`` (the C++ library where it loads, else
PIL).
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from collections import deque
from typing import Dict, Iterator, Optional

import numpy as np

_MAGIC = b"I2RS"
_VERSION = 1
_HELLO = struct.Struct("<4sBBBBHH")
_HDR = struct.Struct("<4sI")
_MAX_PAYLOAD = 64 << 20  # 64 MB: > any 8K raw frame; rejects garbage lengths


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _send_msg(sock: socket.socket, fourcc: bytes, payload: bytes) -> None:
    sock.sendall(_HDR.pack(fourcc, len(payload)) + payload)


class FrameServer:
    """Serve a MultiStreamServer over TCP (see module docstring).

    >>> srv = MultiStreamServer(model, (512, 512), n_slots=8)
    >>> fs = FrameServer(srv, port=0)        # 0 = ephemeral
    >>> fs.start()
    >>> ...                                   # clients connect/stream
    >>> fs.stop()
    """

    def __init__(self, srv, host: str = "127.0.0.1", port: int = 7788,
                 encode: str = "raw", quality: int = 90,
                 tick_ms: float = 5.0, max_pending: int = 32):
        if encode not in ("raw", "jpeg"):
            raise ValueError(f"encode must be raw|jpeg, got {encode!r}")
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.srv = srv
        self.host, self.port = host, int(port)
        self.encode = encode
        self.quality = int(quality)
        self.tick_ms = float(tick_ms)
        self.max_pending = int(max_pending)
        self.out_nc = srv.out_nc
        self._listener: Optional[socket.socket] = None
        self._threads: list = []
        self._conns: Dict[int, "_Conn"] = {}  # sid -> connection
        self._events: "queue.Queue" = queue.Queue()  # readers -> tick loop
        self._stop = threading.Event()
        self.ticks_served = 0
        self.frames_served = 0

    @property
    def slots_active(self) -> int:
        """Attached-slot count, safe to read from any thread (a bare
        ``len`` on the slot set is atomic under the GIL — unlike
        ``srv.active_slots``, which iterates the set and may only be
        called from the tick loop)."""
        return len(self.srv._attached)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self._listener = socket.create_server((self.host, self.port))
        self.port = self._listener.getsockname()[1]  # resolve port 0
        self._listener.settimeout(0.2)
        t_acc = threading.Thread(target=self._accept_loop,
                                 name="i2rs-accept", daemon=True)
        t_tick = threading.Thread(target=self._tick_loop,
                                  name="i2rs-tick", daemon=True)
        self._threads = [t_acc, t_tick]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        for conn in list(self._conns.values()):
            conn.shutdown()
        if self._listener is not None:
            self._listener.close()

    def serve_forever(self) -> None:
        """Blocking run (the CLI entry); Ctrl-C stops cleanly. Safe to
        call after an explicit start() (e.g. to resolve an ephemeral
        port first)."""
        if self._listener is None:
            self.start()
        try:
            while not self._stop.is_set():
                self._stop.wait(0.5)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    # -- accept / per-connection IO ---------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(self, sock)
            self._events.put(("open", conn, None))

    def _hello(self) -> bytes:
        h, w = self.srv.frame_hw
        flags = 1 if self.encode == "jpeg" else 0
        return _HELLO.pack(_MAGIC, _VERSION, self.srv.in_nc, self.out_nc,
                           flags, h, w)

    # -- the single model-owning thread -----------------------------------

    def _tick_loop(self) -> None:
        while not self._stop.is_set():
            # a pipelining client may have frames parked in its pending
            # deque from the last tick: don't block on new events then
            backlog = any(c.pending for c in self._conns.values())
            try:
                ev = self._events.get(timeout=0 if backlog else 0.2)
                events = [ev]
            except queue.Empty:
                events = []
            if (events and events[0][0] == "frame" and self.tick_ms > 0
                    and not backlog and len(self._conns) > 1):
                # batching window: let other connections' frames join —
                # but never wait longer than it takes for every attached
                # connection to contribute one (and a lone connection
                # skips the window entirely: there is nobody to batch
                # with, so the wait would be pure added latency)
                deadline = time.perf_counter() + self.tick_ms / 1e3
                have = {events[0][1].sid}
                while len(have) < len(self._conns):
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    try:
                        ev = self._events.get(timeout=left)
                    except queue.Empty:
                        break
                    events.append(ev)
                    if ev[0] == "frame" and ev[1].sid is not None:
                        have.add(ev[1].sid)
                    else:
                        # open/close/stat changes membership mid-window:
                        # step with what we have rather than reasoning
                        # about a moving set
                        break
            while True:
                try:
                    events.append(self._events.get_nowait())
                except queue.Empty:
                    break
            # route events IN ORDER: frames land on their connection's
            # pending deque (per-connection FIFO regardless of how ticks
            # slice the shared queue); a close drops that connection's
            # parked frames along with its slot
            for kind, conn, frame in events:
                if kind == "open":
                    self._handle_open(conn)
                elif kind == "close":
                    self._handle_close(conn)
                elif kind == "stat":
                    self._handle_stat(conn)
                elif kind == "frame" and conn.sid is not None:
                    conn.pending.append(frame)
            # one frame per attached connection per tick
            frames: Dict[int, "_Conn"] = {}
            batch: Dict[int, np.ndarray] = {}
            for sid, conn in self._conns.items():
                if conn.pending:
                    frames[sid] = conn
                    batch[sid] = conn.pending.popleft()
            if not batch:
                continue
            try:
                outs = self.srv.step(batch)
            except Exception as e:  # keep the serving thread alive
                for conn in frames.values():
                    conn.send_error(f"tick failed: {e}")
                    # the frame was consumed without an output message;
                    # hand its flow-control credit back directly
                    conn._credits.release()
                continue
            self.ticks_served += 1
            self.frames_served += len(outs)
            for sid, out in outs.items():
                frames[sid].send_output(out)

    def _handle_open(self, conn: "_Conn") -> None:
        try:
            sid = self.srv.open()
        except RuntimeError as e:
            # no writer thread yet — flush the refusal directly
            try:
                conn.sock.sendall(self._hello())
                _send_msg(conn.sock, b"ERR!", str(e).encode())
            except OSError:
                pass
            conn.shutdown()
            return
        conn.sid = sid
        self._conns[sid] = conn
        if not conn.start(self._hello()):
            # hello never reached the peer and no reader thread exists
            # to emit a close event — release the slot here or it leaks
            self._handle_close(conn)

    def _handle_stat(self, conn: "_Conn") -> None:
        import json
        conn.outbox.put((b"STAT", json.dumps({
            "ticks_served": self.ticks_served,
            "frames_served": self.frames_served,
            "slots_total": self.srv.n_slots,
            "slots_active": len(self.srv.active_slots),
            "physical_slots": self.srv.physical_slots,
            "encode": self.encode,
        }).encode()))

    def _handle_close(self, conn: "_Conn") -> None:
        if conn.sid is not None and conn.sid in self._conns:
            del self._conns[conn.sid]
            self.srv.close(conn.sid)
            conn.sid = None
        conn.shutdown()


class _Conn:
    """One client connection: reader thread parses frames into the
    server's event queue; writer thread drains the outbox."""

    def __init__(self, server: FrameServer, sock: socket.socket):
        self.server = server
        self.sock = sock
        self.sid: Optional[int] = None
        self.outbox: "queue.Queue" = queue.Queue()
        # frames parsed but not yet served, in arrival order; owned by
        # the tick loop (readers hand frames over via the event queue)
        self.pending = deque()
        # flow control: one credit per frame the server may hold for
        # this connection end-to-end (event queue + pending + outbox +
        # socket buffer). The reader stops reading when credits run out,
        # so a runaway pipelining client is throttled by TCP
        # backpressure instead of growing server memory without bound.
        # Credits return when the writer finishes sending the output.
        self._credits = threading.Semaphore(server.max_pending)
        self._dead = threading.Event()
        # serializes the writer thread with synchronous error sends
        # (reader-thread protocol errors must flush BEFORE the close
        # event tears the socket down)
        self._wlock = threading.Lock()

    def start(self, hello: bytes) -> bool:
        """Send the hello and spin up IO threads; False if the peer was
        already gone (caller must release the slot — no reader thread
        exists to emit the close event)."""
        try:
            self.sock.sendall(hello)
        except OSError:
            self._dead.set()
            return False
        threading.Thread(target=self._read_loop, daemon=True,
                         name=f"i2rs-read-{self.sid}").start()
        threading.Thread(target=self._write_loop, daemon=True,
                         name=f"i2rs-write-{self.sid}").start()
        return True

    # reader -> event queue
    def _read_loop(self) -> None:
        srv = self.server.srv
        h, w = srv.frame_hw
        raw_len = h * w * srv.in_nc
        try:
            while not self._dead.is_set():
                fourcc, length = _HDR.unpack(_recv_exact(self.sock, 8))
                if length > _MAX_PAYLOAD:
                    raise ValueError(f"payload length {length} exceeds "
                                     f"{_MAX_PAYLOAD}")
                payload = _recv_exact(self.sock, length) if length else b""
                if fourcc == b"BYE!":
                    break
                if fourcc == b"STAT":
                    # answered by the tick loop — it owns the slot set
                    # (reading _attached here would race _handle_open/
                    # _handle_close on the tick thread); reply goes out
                    # through the outbox like any output
                    self.server._events.put(("stat", self, None))
                    continue
                if fourcc == b"FRMR":
                    if length != raw_len:
                        raise ValueError(
                            f"raw frame is {length} bytes, expected "
                            f"{raw_len} ({h}x{w}x{srv.in_nc})")
                    frame = np.frombuffer(payload, np.uint8).reshape(
                        h, w, srv.in_nc)
                elif fourcc == b"FRMJ":
                    from ir2rgb_tpu_torch.data import native
                    frame = native.decode_jpeg_mem_batch(
                        np.frombuffer(payload, np.uint8),
                        np.array([0]), np.array([length]), h, w,
                        gray=srv.in_nc == 1)[0]
                else:
                    raise ValueError(f"unknown message {fourcc!r}")
                while not self._credits.acquire(timeout=0.2):
                    if self._dead.is_set():
                        return  # finally still emits the close event
                self.server._events.put(("frame", self, frame))
        except (ConnectionError, OSError):
            pass
        except Exception as e:  # protocol error: tell the client why
            self.send_error(str(e))
        finally:
            self.server._events.put(("close", self, None))

    # outbox -> socket
    def _write_loop(self) -> None:
        while not self._dead.is_set():
            try:
                item = self.outbox.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                return
            fourcc, payload = item
            try:
                with self._wlock:
                    _send_msg(self.sock, fourcc, payload)
            except OSError:
                return
            if fourcc in (b"OUTR", b"OUTJ"):
                # the frame's output left the server — return its
                # flow-control credit (STAT replies carry no credit)
                self._credits.release()

    def send_output(self, out: np.ndarray) -> None:
        if self.server.encode == "jpeg":
            from ir2rgb_tpu_torch.data import native
            self.outbox.put(
                (b"OUTJ", native.encode_jpeg(out, self.server.quality)))
        else:
            self.outbox.put((b"OUTR", np.ascontiguousarray(out).tobytes()))

    def send_error(self, msg: str) -> None:
        """Synchronous: flushes before the caller proceeds to teardown."""
        try:
            with self._wlock:
                _send_msg(self.sock, b"ERR!", msg.encode())
        except OSError:
            pass

    def shutdown(self) -> None:
        self._dead.set()
        self.outbox.put(None)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class FrameClient:
    """Minimal protocol client (tests, demos, load generators).

    >>> with FrameClient("127.0.0.1", port) as c:
    ...     rgb = c.push(ir_frame)            # (h, w, 3) uint8
    """

    def __init__(self, host: str, port: int, jpeg: bool = False,
                 quality: int = 90, timeout: float = 120.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        magic, ver, in_nc, out_nc, flags, h, w = _HELLO.unpack(
            _recv_exact(self.sock, _HELLO.size))
        if magic != _MAGIC or ver != _VERSION:
            raise ConnectionError(f"not an ir2rgb-serve endpoint "
                                  f"(magic={magic!r} version={ver})")
        self.in_nc, self.out_nc = in_nc, out_nc
        self.frame_hw = (h, w)
        self.reply_jpeg = bool(flags & 1)
        self.jpeg = jpeg
        self.quality = quality
        # frame outputs that arrived while waiting for a STAT reply
        # (the server may answer STAT before OR after in-flight frames
        # — no cross-kind ordering is promised); recv() drains these
        # first so pipelining + stats() compose safely
        self._parked: deque = deque()

    def send(self, frame: np.ndarray) -> None:
        """Send one frame without waiting for the reply (pipelining)."""
        arr = np.ascontiguousarray(frame, np.uint8)
        if self.jpeg:
            from ir2rgb_tpu_torch.data import native
            _send_msg(self.sock, b"FRMJ",
                      native.encode_jpeg(arr, self.quality))
        else:
            _send_msg(self.sock, b"FRMR", arr.tobytes())

    def recv(self) -> np.ndarray:
        if self._parked:
            fourcc, payload = self._parked.popleft()
        else:
            fourcc, length = _HDR.unpack(_recv_exact(self.sock, 8))
            payload = _recv_exact(self.sock, length)
        if fourcc == b"ERR!":
            raise RuntimeError(f"server error: {payload.decode()}")
        h, w = self.frame_hw
        if fourcc == b"OUTJ":
            import io

            from PIL import Image
            a = np.asarray(Image.open(io.BytesIO(payload)), np.uint8)
            return a[..., None] if a.ndim == 2 else a
        if fourcc != b"OUTR":
            raise RuntimeError(f"unexpected message {fourcc!r}")
        return np.frombuffer(payload, np.uint8).reshape(h, w, self.out_nc)

    def push(self, frame: np.ndarray) -> np.ndarray:
        self.send(frame)
        return self.recv()

    def stats(self) -> dict:
        """Server-side counters (ticks/frames served, slot occupancy).

        Safe with frames in flight: the server answers STAT out of band
        with frame outputs (it may overtake frames still queued for a
        tick), so any OUT* messages read while waiting are parked for
        the next recv() in order."""
        import json
        _send_msg(self.sock, b"STAT", b"")
        while True:
            fourcc, length = _HDR.unpack(_recv_exact(self.sock, 8))
            payload = _recv_exact(self.sock, length)
            if fourcc == b"ERR!":
                raise RuntimeError(f"server error: {payload.decode()}")
            if fourcc == b"STAT":
                return json.loads(payload.decode())
            if fourcc in (b"OUTR", b"OUTJ"):
                self._parked.append((fourcc, payload))
                continue
            raise RuntimeError(f"unexpected message {fourcc!r} while "
                               f"waiting for STAT")

    def stream(self, frames) -> Iterator[np.ndarray]:
        """Depth-1 pipelined request stream (send t+1 before recv t)."""
        it = iter(frames)
        try:
            self.send(next(it))
        except StopIteration:
            return
        for f in it:
            self.send(f)
            yield self.recv()
        yield self.recv()

    def close(self) -> None:
        try:
            _send_msg(self.sock, b"BYE!", b"")
        except OSError:
            pass
        self.sock.close()

    def __enter__(self) -> "FrameClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
