"""Multi-stream batched serving — the port of
``ir2rgb_tpu/infer/multistream.py``.

N independent video streams share one batched generator tick, each with
its own previous-frame carry on the device:

- The tick runs at a fixed physical batch; streams attach to and detach
  from slots between ticks. Per-slot state transitions are masks applied
  on the device (``torch.where``), built on the host as (S,) bools:
    reset[i]      -> the carry is zeroed before the forward (stream start)
    valid[i]      -> the carry advances with the new generated frame
    not valid[i]  -> the carry is held (the stream skipped this tick and
                     resumes later with its temporal context)
- Frames cross host -> device as uint8 and outputs come back uint8; the
  normalize and quantize run on the device (``stream._dev_normalize``,
  ``stream._dev_quantize``).
- ``ticks()`` is a depth-1 pipeline, as ``StreamingGenerator.stream``:
  tick t is dispatched before the host waits for tick t-1's outputs.
- More slots than the physical batch: the logical tick runs as chained
  chunk ticks over a carry pool of ``n_slots + 1`` rows (each chunk
  gathers its rows by slot index; pad rows point at the last, scratch
  row with valid False, so they carry back its own value).
- The pooled dispatch is atomic. Every chunk gathers from the committed
  pool, and the advanced carries are scattered into it in place, and the
  slots' pending resets cleared, only after every chunk of the logical
  tick was dispatched. If a chunk raises, every carry and pending reset
  is as it was before the tick. (The JAX package commits chunk by chunk,
  so there a failed later chunk leaves earlier chunks' streams one frame
  ahead.) A logical tick's chunks touch disjoint slots, so the outputs
  are the JAX package's whenever nothing fails.

A quantized model (``cfg.infer.quant``) serves its tick through
``generate`` in its mode, with the JAX package's semantics: the
activation scale of ``int8`` and ``int8_mixed`` is one amax over the
whole batched tick, pad rows included, so a stream's frame depends on
the other streams of its tick, and a batched frame equals its batch-1
frame only in ``"none"`` and ``int8_w``.

On a dp×sp mesh (``mesh=``, ``parallel.dp_sp_mesh``; JAX's
``multistream.py:151-211``) every rank makes the same server and ticks
with the same frames: the physical rows split over the ``dp`` ranks
(``dp`` must divide them), each frame's rows over ``sp`` (the ops
exchange what they read, ``parallel/spatial.py``), each rank keeps its
block of the carry, and ``step`` / ``step_device`` return every stream's
whole frame on every rank. Chunked serving over a carry pool is
single-card logic and refuses a mesh, as in JAX.

``KNEE_SLOTS`` caps the physical batch by default (``physical_slots``
overrides it). ``chip_smoke.py``'s serve phase measures the batched tick
at S = 1, 2, 4, 8, 16 (``PERF.md`` §5). 16 is the top of that ladder,
not a measured knee: on an NVIDIA H100 80GB HBM3 at 700 W, bf16, the
aggregate frames/s of ``temporal_512`` and ``pix2pixhd_1024`` still rose
from 8 to 16 slots, and one 16-row tick took less time than two chained
8-row ticks; where it stops rising is not measured. The tick runs under
``torch.inference_mode()``, entered in whichever thread calls it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ir2rgb_tpu_torch.infer.wire import (
    _dev_normalize,
    _dev_quantize,
    host_to_wire_u8,
)
from ir2rgb_tpu_torch.parallel import spatial
from ir2rgb_tpu_torch.train.model import GanModel

KNEE_SLOTS = 16


def default_physical_slots(n: int) -> int:
    """The physical batch for ``n`` requested slots: ``n``, capped at
    ``KNEE_SLOTS``; more slots are served by chunked round-robin ticks
    over the carry pool."""
    return min(n, KNEE_SLOTS)


def build_tick(model: GanModel, temporal: bool, carry_c: int,
               generate=None):
    """The batched tick on device tensors: temporal ``tick(frames_u8,
    carry, reset, valid) -> (uint8 out, new carry)``; otherwise
    ``tick(frames_u8, reset, valid) -> uint8 out`` (the masks are no-ops
    for a stateless model). A label model's frames are class ids and are
    not normalised (``generate`` one-hot encodes them). ``generate(x,
    prev=None)`` is the generator's forward, ``model.generate`` by default
    (``infer/export.py`` passes one over the program's weights)."""
    generate = model.generate if generate is None else generate
    norm = ((lambda u8: u8.to(torch.float32))
            if model.cfg.model.label_nc > 0 else _dev_normalize)
    if temporal:
        def tick(frames_u8, carry, reset, valid):
            x = norm(frames_u8)
            carry_in = torch.where(reset[:, None, None, None], 0.0, carry)
            fake = generate(x, prev=carry_in)
            adv = torch.cat([fake.to(torch.float32), carry_in],
                            dim=-1)[..., :carry_c]
            new_carry = torch.where(valid[:, None, None, None], adv,
                                    carry_in)
            return _dev_quantize(fake), new_carry
    else:
        def tick(frames_u8, reset, valid):
            return _dev_quantize(generate(norm(frames_u8)))
    return tick


def build_pool_tick(model: GanModel, carry_c: int):
    """The temporal tick over a carry pool: ``tick(frames_u8, pool,
    slot_idx, reset, valid) -> (uint8 out, new carry rows)``. Row i
    gathers ``pool[slot_idx[i]]``; ``pool`` is not written, the caller
    scatters the new rows back (:func:`commit_pool`). Pad rows name the
    scratch row (index ``n_slots``) with valid False: each carries back
    the scratch row's own value, so duplicate indices scatter identical
    data."""
    base = build_tick(model, True, carry_c)

    def tick(frames_u8, pool, slot_idx, reset, valid):
        return base(frames_u8, pool[slot_idx], reset, valid)
    return tick


def commit_pool(pool: torch.Tensor, staged) -> None:
    """Scatter every staged (slot_idx, new carry rows) into ``pool`` in
    place, with one ``index_put_``."""
    if staged:
        idx, rows = zip(*staged)
        pool.index_put_((torch.cat(idx),), torch.cat(rows))


class MultiStreamServer:
    """Serve up to ``n_slots`` independent streams with one batched tick.

    Usage::

        srv = MultiStreamServer(model, (512, 512), n_slots=8)
        a = srv.open(); b = srv.open()          # attach two streams
        outs = srv.step({a: ir_a, b: ir_b})     # {a: rgb_a, b: rgb_b}
        outs = srv.step({a: ir_a2})             # b skips, carry held
        srv.close(b)                            # slot b free for reuse

    Works for temporal models (a carry a slot) and single-frame models
    (a batched forward). Frames are uint8 HWC (or float [-1, 1]). The
    model's ``netG`` holds the serving weights.
    """

    def __init__(self, model: GanModel, frame_hw: Tuple[int, int],
                 n_slots: int = 8, physical_slots: Optional[int] = None,
                 mesh=None):
        """``physical_slots``: the batch of one tick, by default
        ``default_physical_slots(n_slots)``. Smaller than ``n_slots``, the
        extra slots are served by chunked round-robin ticks over a carry
        pool (one gather a chunk, one scatter a tick); larger, the pad rows
        are masked. ``mesh``: a dp×sp ``DataParallelMesh`` (the module
        docstring); not with a carry pool."""
        cfgm = model.cfg.model
        self.model = model
        self.device = model.device
        self.n_slots = int(n_slots)
        if self.n_slots < 1:
            raise ValueError(f"n_slots={self.n_slots} must be >= 1")
        if physical_slots is None:
            physical_slots = default_physical_slots(self.n_slots)
        if physical_slots < 1:
            raise ValueError(f"physical_slots={physical_slots} must "
                             f"be >= 1")
        self.physical_slots = int(physical_slots)
        self._pooled = self.physical_slots < self.n_slots
        if self._pooled and mesh is not None:
            raise ValueError(
                "physical_slots < n_slots (chunked round-robin) is "
                "single-chip knee logic — a mesh shards slots across "
                "chips instead; give each chip's server <= "
                f"{KNEE_SLOTS} slots")
        self.mesh, self._shards = mesh, None
        if mesh is not None:
            if self.physical_slots % mesh.dp:
                raise ValueError(
                    f"physical_slots={self.physical_slots} does not split "
                    f"over dp = {mesh.dp} ranks")
            self._shards = (spatial.Shards.of(mesh) if mesh.sp > 1
                            else None)
        self.temporal = cfgm.model == "temporal"
        self.carry_c = cfgm.output_nc * model.n_prev
        h, w = frame_hw
        self.frame_hw = (h, w)
        # a label model carries one id channel on the wire (one-hot on
        # the device inside generate)
        self._label = cfgm.label_nc > 0
        self.in_nc = 1 if self._label else cfgm.input_nc
        self.out_nc = cfgm.output_nc
        self._free = list(range(self.n_slots))
        self._attached: set = set()
        self._pending_reset = np.zeros(self.n_slots, np.bool_)
        # not pooled: carry row == slot id (physical >= n_slots). Pooled:
        # an (n_slots + 1)-row pool whose last row is the pad rows'
        # scratch; each chunk gathers its rows.
        self._carry = None
        if self.temporal:
            rows = (self.n_slots + 1 if self._pooled
                    else self.physical_slots)
            shape = (rows, h, w, self.carry_c)
            if mesh is not None:  # this rank's block of the carry
                shape = spatial.local_block(
                    torch.empty(shape, device="meta"), mesh).shape
            self._carry = torch.zeros(shape, dtype=torch.float32,
                                      device=self.device)
            self._tick = (build_pool_tick(model, self.carry_c)
                          if self._pooled
                          else build_tick(model, True, self.carry_c))
        else:
            self._tick = build_tick(model, False, self.carry_c)

    @classmethod
    def from_artifact(cls, path: str, n_slots: Optional[int] = None,
                      clamp: bool = False, device=None,
                      mesh=None) -> "MultiStreamServer":
        """Serve a sealed multi-stream artifact
        (``infer/export.py::export_multistream_artifact``) on ``device``
        (None: the CUDA device): the same slot lifecycle and ``step()``
        surface with no model code behind it (``model`` is None).

        The physical batch is sealed at export and there is no carry pool;
        ``n_slots`` may cap the attachable streams below it (default: all
        of them). A cap above the sealed batch raises, unless ``clamp``
        (the CLI's forgiving mode) clips it to the sealed batch. A sealed
        program serves one card: a ``mesh`` raises (ROADMAP A16b)."""
        from functools import partial
        if mesh is not None:
            raise NotImplementedError(
                "a sealed artifact on a mesh: its program is one card's "
                f"({spatial.A16B})")

        from ir2rgb_tpu_torch.infer.export import load_multistream_artifact
        tick, params, meta = load_multistream_artifact(path, device)
        self = cls.__new__(cls)
        self.model = None  # a sealed program: no model code behind it
        self.device = next(iter(params.values())).device
        self.physical_slots = int(meta["batch"])
        self.n_slots = int(n_slots if n_slots is not None
                           else meta["batch"])
        if self.n_slots < 1:
            raise ValueError(f"n_slots={self.n_slots} must be >= 1")
        if self.n_slots > self.physical_slots:
            if not clamp:
                raise ValueError(
                    f"n_slots={self.n_slots} exceeds the artifact's "
                    f"sealed batch {self.physical_slots}; re-export "
                    f"with more slots")
            self.n_slots = self.physical_slots
        self._pooled = False  # the sealed batch is the physical batch
        self.mesh, self._shards = None, None
        self.temporal = bool(meta["temporal"])
        self.carry_c = int(meta["carry_c"])
        h, w = meta["frame_hw"]
        self.frame_hw = (h, w)
        self._label = meta.get("label_nc", 0) > 0
        self.in_nc = int(meta["input_nc"])
        self.out_nc = int(meta["output_nc"])
        self._free = list(range(self.n_slots))
        self._attached = set()
        self._pending_reset = np.zeros(self.n_slots, np.bool_)
        self._carry = (torch.zeros((self.physical_slots, h, w,
                                    self.carry_c), dtype=torch.float32,
                                   device=self.device)
                       if self.temporal else None)
        self._tick = partial(tick, params)
        return self

    # -- slot lifecycle -------------------------------------------------

    @property
    def active_slots(self) -> Tuple[int, ...]:
        return tuple(sorted(self._attached))

    def open(self) -> int:
        """Attach a new stream; returns its slot id. The slot's carry is
        zeroed on its first tick (fresh temporal context)."""
        if not self._free:
            raise RuntimeError(
                f"all {self.n_slots} slots busy — close() one or build "
                f"the server with more slots")
        sid = self._free.pop(0)
        self._attached.add(sid)
        self._pending_reset[sid] = True
        return sid

    def close(self, sid: int) -> None:
        """Detach a stream; the slot becomes reusable."""
        self._attached.remove(sid)
        self._pending_reset[sid] = False
        self._free.append(sid)

    # -- serving --------------------------------------------------------

    def _wire_u8(self, a) -> np.ndarray:
        a = np.asarray(a)
        if a.dtype != np.uint8:
            a = host_to_wire_u8(a, self._label)
        return a

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _dispatch_chunk(self, frames: Dict[int, np.ndarray], sids):
        """H2D and the tick for <= ``physical_slots`` streams, reading the
        committed carries. Returns (the output on its way to the host, a
        done event or None, row -> sid, the new carry: the whole carry,
        or pooled the (slot_idx, rows) to commit, or None). Does not
        block; pair with :meth:`_fetch`."""
        h, w = self.frame_hw
        p = self.physical_slots
        batch = np.zeros((p, h, w, self.in_nc), np.uint8)
        valid = np.zeros(p, np.bool_)
        reset = np.zeros(p, np.bool_)
        # pooled rows are chunk-local and pad rows gather the scratch
        # row; otherwise the row is the slot id
        idx = np.full(p, self.n_slots, np.int64)
        rowmap = {}
        for i, sid in enumerate(sids):
            row = i if self._pooled else sid
            batch[row] = self._wire_u8(frames[sid])
            valid[row] = True
            reset[row] = self._pending_reset[sid]
            idx[row] = sid
            rowmap[row] = sid
        carry = None
        with torch.inference_mode():
            if self.mesh is not None:
                out, carry = self._mesh_tick(batch, reset, valid)
            elif self.temporal and self._pooled:
                idx_dev = self._dev(idx)
                out, rows = self._tick(self._dev(batch), self._carry,
                                       idx_dev, self._dev(reset),
                                       self._dev(valid))
                carry = (idx_dev, rows)
            elif self.temporal:
                out, carry = self._tick(self._dev(batch), self._carry,
                                        self._dev(reset), self._dev(valid))
            else:
                out = self._tick(self._dev(batch), self._dev(reset),
                                 self._dev(valid))
        if self.device.type != "cuda":
            return out, None, rowmap, carry
        host = out.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, rowmap, carry

    def _mesh_tick(self, frames, reset, valid):
        """The tick of the whole physical batch on a mesh: this rank's
        block of the frames (host or device) and masks ticks under
        ``spatial.serving``; returns (the whole output gathered from every
        rank, this rank's new carry or None)."""
        def mine(t):
            t = spatial.local_block(torch.as_tensor(t), self.mesh)
            return t.contiguous().to(self.device)
        frames, reset, valid = mine(frames), mine(reset), mine(valid)
        carry = None
        with spatial.serving(self.mesh, self._shards):
            if self.temporal:
                out, carry = self._tick(frames, self._carry, reset, valid)
            else:
                out = self._tick(frames, reset, valid)
        return spatial.gather_block(out, self.mesh), carry

    def _dispatch(self, frames: Dict[int, np.ndarray]):
        """Dispatch one logical tick as one or more chunk ticks (chunked
        round-robin when there are more streams than physical rows) and
        commit its carries and consumed resets once all of them were
        dispatched. Returns a list of (host out, done, rowmap); no result
        is fetched, so chunk k+1's host work overlaps chunk k's on the
        device."""
        unknown = set(frames) - self._attached
        if unknown:
            raise KeyError(f"frames for unattached slots {sorted(unknown)}")
        sids = sorted(frames)
        p = self.physical_slots
        parts, staged = [], []
        for i in range(0, len(sids), p):
            host, done, rowmap, carry = self._dispatch_chunk(
                frames, sids[i:i + p])
            parts.append((host, done, rowmap))
            staged.append(carry)
        if self._pooled and self.temporal:
            with torch.inference_mode():
                commit_pool(self._carry, staged)
        elif self.temporal:
            self._carry = staged[0]
        self._pending_reset[sids] = False  # resets consumed
        return parts

    @staticmethod
    def _fetch(parts) -> Dict[int, np.ndarray]:
        outs: Dict[int, np.ndarray] = {}
        for host, done, rowmap in parts:
            if done is not None:
                done.synchronize()
            arr = host.numpy()
            for row, sid in rowmap.items():
                outs[sid] = arr[row]
        return outs

    def step(self, frames: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
        """One synchronous tick: {slot: IR frame} -> {slot: uint8 RGB}.
        Slots without a frame this tick hold their carry. An empty dict
        runs nothing: no frame, no output, every carry held."""
        if not frames:
            return {}
        return self._fetch(self._dispatch(frames))

    def ticks(self, feed: Iterable[Dict[int, np.ndarray]]
              ) -> Iterator[Dict[int, np.ndarray]]:
        """Pipelined serving loop over per-tick frame dicts: yields one
        output dict a tick, the same as sequential :meth:`step` calls;
        the host's work on tick t overlaps the device's on tick t-1.
        Empty ticks yield {} without running the generator."""
        pending: Optional[List] = None
        for frames in feed:
            out = self._dispatch(frames) if frames else None
            if pending is not None:
                yield self._fetch(pending)
            elif out is None:
                # keep the one-tick alignment: an empty tick with nothing
                # pending yields its empty output now
                yield {}
                continue
            pending = out
            if out is None:
                yield {}
        if pending is not None:
            yield self._fetch(pending)

    def step_device(self, frames_dev: torch.Tensor,
                    reset: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Device-in device-out tick of the whole physical batch (no host
        sync), the benchmark path: ``frames_dev`` is (physical_slots, h,
        w, in_nc) uint8 on the model's device and is not written. Pooled,
        physical row i is slot i. On a mesh every rank passes the whole
        batch and gets the whole output."""
        p = self.physical_slots
        dev = self.device
        if reset is None:
            reset = torch.zeros(p, dtype=torch.bool, device=dev)
        if valid is None:
            valid = torch.ones(p, dtype=torch.bool, device=dev)
        with torch.inference_mode():
            if self.mesh is not None:
                out, carry = self._mesh_tick(frames_dev, reset, valid)
                if self.temporal:
                    self._carry = carry
            elif self.temporal and self._pooled:
                idx = torch.arange(p, device=dev)
                out, rows = self._tick(frames_dev, self._carry, idx, reset,
                                       valid)
                commit_pool(self._carry, [(idx, rows)])
            elif self.temporal:
                out, self._carry = self._tick(frames_dev, self._carry,
                                              reset, valid)
            else:
                out = self._tick(frames_dev, reset, valid)
        return out
