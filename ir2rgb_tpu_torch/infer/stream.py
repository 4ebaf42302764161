"""Inference — single-frame apply, batch-1 streaming and whole clips (the
port of ``ir2rgb_tpu/infer/stream.py``).

- The uint8 wire (``infer/wire.py``): frames cross host<->device as
  uint8 and are normalised and quantised on the device, bit-identically
  to the JAX package (``_dev_normalize``, ``_dev_quantize``,
  ``host_to_wire_u8``). A label model's frames are class ids: they go to
  the device as raw ids, not normalised, and ``generate`` one-hot encodes
  them.
- The temporal carry (the last ``n_frames_g - 1`` generated frames, fp32)
  never leaves the device.
- ``stream`` is a depth-1 pipeline: frame t is uploaded and its forward
  queued before the host waits for the output of frame t-1, whose
  device->host copy was queued right behind its forward, so the host's
  handling of t-1 overlaps the device's work on t.

- On a dp×sp mesh (``mesh=``, ``parallel.dp_sp_mesh``), as JAX's
  ``StreamingGenerator(mesh=)`` (``stream.py:84-107``): every rank makes
  the same stream and pushes the same whole frame (and netE feature and
  instance-edge maps). Each takes its block (batch rows over ``dp``,
  image rows over ``sp``), serves it under
  ``parallel.spatial.serving`` (the ops exchange the rows and statistics
  the whole frame's computation reads), keeps its rows of the carry, and
  returns the whole output, gathered from every rank, as JAX's global
  array is whole.

CUDA-graph capture and pinned asynchronous uploads are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ir2rgb_tpu_torch.infer.wire import (  # noqa: F401 (re-exported)
    _dev_normalize,
    _dev_quantize,
    host_to_wire_u8,
)
from ir2rgb_tpu_torch.parallel import spatial
from ir2rgb_tpu_torch.train.model import GanModel


def tensor2im(t: torch.Tensor) -> np.ndarray:
    """[-1,1] NHWC tensor -> uint8 HWC (reference util.tensor2im). A batch
    of B>1 frames stays NHWC uint8 (batch 1 squeezes to HWC)."""
    arr = t.detach().to("cpu", torch.float32).numpy()
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    arr = (np.clip(arr.astype(np.float32), -1, 1) + 1.0) * 127.5
    return arr.astype(np.uint8)


def single_frame_infer(model: GanModel):
    """No-grad G forward: a_frame (B,H,W,C) -> fake (B,H,W,3)."""
    return model.generate


class StreamingGenerator:
    """Stateful streaming translator (batch 1 by default).

    Usage:
        stream = StreamingGenerator(model, (h, w))
        for ir_frame in frames:          # uint8/float host frames
            rgb = stream.push(ir_frame)  # numpy uint8 out

    ``push_device`` takes and returns device tensors (no host sync).
    """

    def __init__(self, model: GanModel, frame_hw: Tuple[int, int],
                 batch: int = 1, mesh=None):
        """``mesh``: a dp×sp ``DataParallelMesh`` (``dp_sp_mesh``), the
        same on every rank: ``batch`` splits over ``dp``, the frame's rows
        over ``sp``, and the carry stays split (:attr:`carry` is this
        rank's rows)."""
        self.model = model
        cfgm = model.cfg.model
        self.temporal = cfgm.model == "temporal"
        # label frames carry class ids: the uint8 wire is not normalised
        self._norm = ((lambda a: a.to(torch.float32)) if cfgm.label_nc > 0
                      else _dev_normalize)
        self.carry_c = cfgm.output_nc * model.n_prev
        self.out_nc = cfgm.output_nc
        self.device = model.device
        self.mesh, self._shards = mesh, None
        h, w = frame_hw
        if mesh is not None:
            # the rank's block of a whole (batch, h, w) frame
            batch, h, _ = spatial.local_block(
                torch.empty((batch, h, w, 0), device="meta"), mesh).shape[:3]
            self._shards = (spatial.Shards.of(mesh) if mesh.sp > 1
                            else None)
        self._carry = (torch.zeros((batch, h, w, self.carry_c),
                                   dtype=torch.float32, device=self.device)
                       if self.temporal else None)

    def reset(self) -> None:
        if self._carry is not None:
            self._carry = torch.zeros_like(self._carry)

    @property
    def carry(self) -> Optional[torch.Tensor]:
        return self._carry

    def push_device(self, a: torch.Tensor,
                    feat: Optional[torch.Tensor] = None,
                    edges: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Device-in device-out step: NHWC ``a`` on the model's device ->
        the generated frame in the compute dtype. ``edges``: the
        (B, H, W, 1) instance-boundary map of a single-frame
        ``use_instance_edges`` model, ``feat`` the (B, H, W, feat_num)
        netE feature map of a ``use_instance_feat`` model (JAX's
        ``step_extra``); a temporal stream refuses both. On a mesh ``a``
        and the maps are whole on every rank, each cut to the rank's
        block, and the output is whole."""
        if (feat is not None or edges is not None) and self.temporal:
            raise ValueError(
                "feature/edge maps are a pix2pixHD (single-frame) "
                "test surface; temporal streaming has no such input")
        if self.mesh is None:
            return self._generate(a, feat, edges)
        with torch.inference_mode():
            a, feat, edges = (None if t is None else spatial.local_block(
                t, self.mesh).contiguous() for t in (a, feat, edges))
            return spatial.gather_block(self._generate(a, feat, edges),
                                        self.mesh)

    def _generate(self, a: torch.Tensor,
                  feat: Optional[torch.Tensor] = None,
                  edges: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The rank's rows of the frame (and of its feature and edge
        maps) -> its rows of the output, the carry advanced."""
        with spatial.serving(self.mesh, self._shards):
            if not self.temporal:
                return self.model.generate(a, feat=feat, edges=edges)
            fake = self.model.generate(a, prev=self._carry)
        with torch.inference_mode():
            self._carry = torch.cat([fake.to(torch.float32), self._carry],
                                    dim=-1)[..., :self.carry_c].contiguous()
        return fake

    def _dispatch(self, a_host: np.ndarray):
        """Upload one host frame and queue its forward and the copy of its
        output to the host; returns (host tensor, done event, is_u8)."""
        a = np.asarray(a_host)
        if a.ndim == 3:
            a = a[None]
        with torch.inference_mode():
            # on a mesh only the rank's block goes to the device
            a = torch.from_numpy(a)
            if self.mesh is not None:
                a = spatial.local_block(a, self.mesh).contiguous()
            if a.dtype == torch.uint8:
                out = _dev_quantize(self._generate(self._norm(
                    a.to(self.device))))
                is_u8 = True
            else:
                out = self._generate(a.to(self.device, torch.float32))
                is_u8 = False
            if out.dtype == torch.bfloat16:
                out = out.to(torch.float32)
            if self.mesh is not None:
                out = spatial.gather_block(out, self.mesh)
        if self.device.type != "cuda":
            return out, None, is_u8
        host = out.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, is_u8

    @staticmethod
    def _fetch(host: torch.Tensor, done, is_u8: bool) -> np.ndarray:
        if done is not None:
            done.synchronize()
        if is_u8:
            arr = host.numpy()
            # squeeze only the singleton batch dim
            return arr[0] if arr.ndim == 4 and arr.shape[0] == 1 else arr
        return tensor2im(host)

    def push(self, a_host: np.ndarray) -> np.ndarray:
        """Host frame in (uint8, or [-1,1] float), uint8 RGB out. Blocks on
        this frame's output; :meth:`stream` pipelines."""
        return self._fetch(*self._dispatch(a_host))

    def stream(self, frames: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Pipelined serving loop: host frames in, uint8 RGB out, one frame
        of latency. Same outputs as sequential :meth:`push` calls."""
        pending = None
        for a_host in frames:
            out = self._dispatch(a_host)            # upload + queue
            if pending is not None:
                yield self._fetch(*pending)         # wait on t-1 only
            pending = out
        if pending is not None:
            yield self._fetch(*pending)


def translate_clip(model: GanModel, a_seq: torch.Tensor) -> torch.Tensor:
    """Whole-clip translation: ``a_seq`` (T, B, H, W, C) on the model's
    device -> (T, B, H, W, output_nc) in the compute dtype. The temporal
    model carries its last generated frames (fp32, on the device) from
    one frame to the next, starting from zeros; any other model runs the
    frames one by one (``stream.py:256-278``)."""
    cfgm = model.cfg.model
    if cfgm.model != "temporal":
        return torch.stack([model.generate(a) for a in a_seq])
    carry_c = cfgm.output_nc * model.n_prev
    carry = torch.zeros(a_seq.shape[1:4] + (carry_c,), dtype=torch.float32,
                        device=a_seq.device)
    fakes = []
    for a in a_seq:
        fake = model.generate(a, prev=carry)
        with torch.inference_mode():
            carry = torch.cat([fake.to(torch.float32), carry],
                              dim=-1)[..., :carry_c]
        fakes.append(fake)
    return torch.stack(fakes)


def _voc_palette(n: int) -> np.ndarray:
    """The VOC bit-interleave colormap the reference's Colorize uses."""
    palette = np.zeros((n, 3), np.uint8)
    for k in range(n):
        r = g = b = 0
        c = k
        for j in range(7):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        palette[k] = (r, g, b)
    return palette


def label2im(t, label_nc: int) -> np.ndarray:
    """Class-id map (tensor or array; (1,) H, W (, 1)) -> palette RGB
    uint8 for galleries (the reference ``util.tensor2label``): ids
    rounded, clipped to [0, label_nc - 1], coloured by the VOC map."""
    arr = (t.detach().to("cpu").numpy() if isinstance(t, torch.Tensor)
           else np.asarray(t))
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    n = max(int(label_nc), 1)
    ids = np.clip(np.round(arr).astype(np.int64), 0, n - 1)
    return _voc_palette(n)[ids]
