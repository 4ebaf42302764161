"""Inference — single-frame apply and batch-1 streaming (the serving half of
``ir2rgb_tpu/infer/stream.py``).

- The uint8 wire: frames cross host<->device as uint8 and are normalised
  and quantised on the device, bit-identically to the JAX package
  (``_dev_normalize``, ``_dev_quantize``, ``host_to_wire_u8``).
- The temporal carry (the last ``n_frames_g - 1`` generated frames, fp32)
  never leaves the device.
- ``stream`` is a depth-1 pipeline: frame t is uploaded and its forward
  queued before the host waits for the output of frame t-1, whose
  device->host copy was queued right behind its forward, so the host's
  handling of t-1 overlaps the device's work on t.

CUDA-graph capture and pinned asynchronous uploads are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ir2rgb_tpu_torch.train.model import GanModel


def _dev_normalize(a_u8: torch.Tensor) -> torch.Tensor:
    """uint8 frame -> [-1,1] float32 on the device. Bit-identical to the
    host-side ``a.astype(np.float32) / 127.5 - 1.0`` (u8->f32 is exact;
    the same IEEE division and subtraction)."""
    return a_u8.to(torch.float32) / 127.5 - 1.0


def _dev_quantize(fake: torch.Tensor) -> torch.Tensor:
    """[-1,1] frame -> uint8 on the device; mirrors tensor2im's
    clip/scale/truncate, so the device->host copy moves 1 byte/px."""
    arr = (torch.clamp(fake.to(torch.float32), -1, 1) + 1.0) * 127.5
    return arr.to(torch.uint8)


def host_to_wire_u8(a: np.ndarray, label: bool) -> np.ndarray:
    """Host-side conversion of a non-uint8 frame to the uint8 wire:

    - image frames: [-1, 1] floats quantise like tensor2im;
    - label frames (label_nc > 0): class ids round/clip to the id byte.
    """
    if label:
        return np.clip(np.round(a.astype(np.float32)), 0,
                       255).astype(np.uint8)
    return ((np.clip(a.astype(np.float32), -1, 1) + 1.0)
            * 127.5).astype(np.uint8)


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
                 batch: int = 1):
        self.model = model
        cfgm = model.cfg.model
        self.temporal = cfgm.model == "temporal"
        self.carry_c = cfgm.output_nc * model.n_prev
        self.out_nc = cfgm.output_nc
        self.device = model.device
        h, w = frame_hw
        self._carry = (torch.zeros((batch, h, w, self.carry_c),
                                   dtype=torch.float32, device=self.device)
                       if self.temporal else None)

    def reset(self) -> None:
        if self._carry is not None:
            self._carry = torch.zeros_like(self._carry)

    @property
    def carry(self) -> Optional[torch.Tensor]:
        return self._carry

    def push_device(self, a: torch.Tensor) -> torch.Tensor:
        """Device-in device-out step: NHWC ``a`` on the model's device ->
        the generated frame in the compute dtype."""
        if not self.temporal:
            return self.model.generate(a)
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
            if a.dtype == np.uint8:
                a_dev = torch.from_numpy(a).to(self.device)
                out = _dev_quantize(self.push_device(_dev_normalize(a_dev)))
                is_u8 = True
            else:
                out = self.push_device(torch.from_numpy(
                    a.astype(np.float32)).to(self.device))
                is_u8 = False
            if out.dtype == torch.bfloat16:
                out = out.to(torch.float32)
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
