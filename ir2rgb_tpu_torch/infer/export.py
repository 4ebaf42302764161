"""Sealed serving artifacts — the port of ``ir2rgb_tpu/infer/export.py``.

The JAX package seals its uint8-wire serving step as StableHLO
(``jax.export``). The port seals the same step with ``torch.export``:
normalize (raw class ids for a label model) -> the generator's serving
forward -> quantize, with the temporal carry threaded through, traced
once into an ``ExportedProgram`` whose graph calls the hand-written
kernels as the ``ir2rgb::`` custom ops (``kernels/``). It is packed with
the weights and the geometry into one ``.ir2rgb`` zip:

- ``program.bin``: the ``torch.export.save`` bytes. The weights are
  program inputs (``step(params, a_u8[, carry])``, ``params`` keyed by
  the generator's reference ``state_dict`` keys, as JAX's
  ``step(params, a_u8, carry)``), so the program holds no copy of them;
- ``meta.json``: the wire geometry, the carry, the weights' keys
  (``param_paths``) and dtypes, ``"program_format": "torch.export"``;
- ``param_<i>.npy``: the weights, stored fp32 and cast back to their
  dtype on load (bf16 round-trips losslessly); 4-D weights are made
  channels-last again, as the port's models keep them.

Properties:

- **Self-contained**: loading needs this module, the uint8 wire
  (``infer/wire.py``), the device rule (``runtime.py``) and the kernel
  ops, no ``nn/``, ``train/`` or ``config/`` module: the program is the traced generator, so a change of
  the model code cannot change a sealed artifact.
- **The live step**: the single-stream step is ``StreamingGenerator``'s
  uint8 step and the multi-stream one ``build_tick``'s, over the serving
  generator (the bf16 copy in bf16) in the model's quantization mode
  (``cfg.infer.quant``), which is baked in. The weight caches of the live
  path (B2's packing, ``Deconv``'s rearranged weight, ``nn/quant.py``'s
  quantized weights) are not read while tracing: the program derives
  those from its ``params`` in every call, as the JAX package's does
  (B2's packing is kept at run time by the op's CUDA implementation,
  keyed on the loaded weight). The index tensors of the pads and of the
  subpixel deconvs depend on shapes only: an eager frame before the trace
  keeps them, and they enter the program as constants. On the CPU a
  loaded artifact's frames equal the live path's bit for bit.
- **One artifact, two devices**: traced once on the model's device; the
  loader moves the program to the device asked for
  (``torch.export.passes.move_to_device_pass``), so one artifact serves
  the card and CPU CI. ``platforms`` (default ``("cuda", "cpu")``) records
  where it may be loaded; ``"tpu"`` is refused.
- An artifact written by the JAX package (StableHLO, no
  ``program_format``) is refused with a ``ValueError``.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from ir2rgb_tpu_torch import kernels  # noqa: F401 (registers the ir2rgb:: ops)
from ir2rgb_tpu_torch.infer.wire import host_to_wire_u8
from ir2rgb_tpu_torch.runtime import resolve_device

# a sealed program is one card's, as the JAX package's artifacts are
ONE_CARD = ("a sealed artifact serves one card: its program holds no "
            "exchange, and the JAX package's loaders take no mesh")

_FORMAT_VERSION = 1
# multi-stream artifacts carry a different program signature (masks and
# per-slot carries); their own version makes a single-stream loader
# refuse them cleanly
_FORMAT_VERSION_MULTI = 2
_KNOWN_VERSIONS = (_FORMAT_VERSION, _FORMAT_VERSION_MULTI)
PROGRAM_FORMAT = "torch.export"
DEFAULT_PLATFORMS = ("cuda", "cpu")


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def _check_exportable(model) -> None:
    cfgm = model.cfg.model
    if model.enc_cfg is not None or cfgm.use_instance_edges:
        # the sealed wire is uint8 frames only; exporting a feature/edge
        # conditioned model would bake the zeros prior in and silently
        # drop style control
        raise ValueError(
            "serving artifacts carry only the uint8 frame input; "
            "use_instance_feat/use_instance_edges models need instance "
            "maps per frame — serve them through cli/infer.py (or "
            "StreamingGenerator.push_device(feat=, edges=)) instead")
    if cfgm.label_nc > 256:
        raise ValueError(
            f"label_nc={cfgm.label_nc} class ids do not fit the uint8 "
            "serving wire; serve through cli/infer.py instead")


def _platforms(platforms: Optional[Sequence[str]]) -> list:
    platforms = list(DEFAULT_PLATFORMS if platforms is None else platforms)
    for p in platforms:
        if p not in DEFAULT_PLATFORMS:
            raise ValueError(
                f"platform {p!r}: a port artifact is a torch.export "
                f"program for {' or '.join(DEFAULT_PLATFORMS)}; a TPU "
                "artifact is the JAX package's (ir2rgb_tpu.cli.export)")
    return platforms


def _serving_forward(model):
    """(generator forward over explicit weights, those weights, the quant
    mode): the serving generator (the bf16 copy in bf16) called with
    ``params`` by ``torch.func.functional_call``, in the model's
    quantization mode, as ``GanModel.generate`` serves it."""
    from ir2rgb_tpu_torch.nn import quant
    net = model.serving_generator()
    mode = quant.resolve(model.cfg.infer.quant)

    def generate_with(params):
        def generate(a, prev=None):
            with quant.using(mode):
                return torch.func.functional_call(
                    net, params, (model._generator_input(a, prev),))
        return generate
    params = {k: v.detach() for k, v in net.state_dict().items()}
    return generate_with, params, mode


def _single_step(model, generate_with, temporal: bool, carry_c: int):
    """The uint8-wire serving step, ``StreamingGenerator``'s: normalize
    (raw class ids for a label model), generate, quantize; the carry is
    the last ``n_prev`` generated frames in fp32."""
    from ir2rgb_tpu_torch.infer.wire import _dev_normalize, _dev_quantize
    norm = ((lambda a: a.to(torch.float32)) if model.cfg.model.label_nc > 0
            else _dev_normalize)
    if temporal:
        def step(params, a_u8, carry):
            fake = generate_with(params)(norm(a_u8), prev=carry)
            new_carry = torch.cat([fake.to(torch.float32), carry],
                                  dim=-1)[..., :carry_c].contiguous()
            return _dev_quantize(fake), new_carry
    else:
        def step(params, a_u8):
            return _dev_quantize(generate_with(params)(norm(a_u8)))
    return step


def _multistream_step(model, generate_with, temporal: bool, carry_c: int):
    """``build_tick``'s batched tick with its reset / valid masks, over
    explicit weights."""
    from ir2rgb_tpu_torch.infer.multistream import build_tick
    if temporal:
        def step(params, frames_u8, carry, reset, valid):
            return build_tick(model, True, carry_c, generate_with(params))(
                frames_u8, carry, reset, valid)
    else:
        def step(params, frames_u8, reset, valid):
            return build_tick(model, False, carry_c, generate_with(params))(
                frames_u8, reset, valid)
    return step


class _Step(torch.nn.Module):
    """The step as the module ``torch.export`` takes. It holds the step as
    a plain attribute, not the generator as a submodule, so the program
    lifts no weights of its own: they are its ``params`` input."""

    def __init__(self, step):
        super().__init__()
        self.step = step

    def forward(self, params, *args):
        return self.step(params, *args)


def _trace(step, params, args):
    """``torch.export`` of ``step(params, *args)``, outside inference mode
    and without a graph (the serving forward records none)."""
    with torch.inference_mode(False), torch.no_grad():
        return torch.export.export(_Step(step), (params, *args))


def _export(model, frame_hw, path, batch, platforms, multistream):
    _check_exportable(model)
    platforms = _platforms(platforms)
    cfgm = model.cfg.model
    temporal = cfgm.model == "temporal"
    carry_c = cfgm.output_nc * model.n_prev
    wire_nc = 1 if cfgm.label_nc > 0 else cfgm.input_nc
    h, w = frame_hw
    dev = model.device
    generate_with, params, mode = _serving_forward(model)
    # one eager frame first: it keeps the index tensors of the pads and
    # the subpixel deconvs (nn/ops.py), which the trace then takes as
    # constants instead of recording the ops that make them every frame
    model.generate(torch.zeros((1, h, w, wire_nc), device=dev))
    frames = torch.zeros((batch, h, w, wire_nc), dtype=torch.uint8,
                         device=dev)
    carry = torch.zeros((batch, h, w, carry_c), dtype=torch.float32,
                        device=dev)
    if multistream:
        step = _multistream_step(model, generate_with, temporal, carry_c)
        # two tensors: the trace takes one tensor passed twice for one
        # input
        reset = torch.zeros(batch, dtype=torch.bool, device=dev)
        valid = torch.zeros_like(reset)
        args = (frames, carry, reset, valid) if temporal else \
            (frames, reset, valid)
    else:
        step = _single_step(model, generate_with, temporal, carry_c)
        args = (frames, carry) if temporal else (frames,)
    program = _trace(step, params, args)
    meta = {
        "temporal": temporal,
        "frame_hw": [h, w],
        "batch": batch,
        "input_nc": wire_nc,
        "label_nc": cfgm.label_nc,
        "output_nc": cfgm.output_nc,
        "carry_c": carry_c,
        "platforms": platforms,
        "quant": mode,
        "compute_dtype": cfgm.compute_dtype,
    }
    if multistream:
        meta["multistream"] = True
    _write_artifact(path, program, params, meta,
                    _FORMAT_VERSION_MULTI if multistream else
                    _FORMAT_VERSION)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _write_artifact(path: str, program, params: dict, meta: dict,
                    version: int) -> None:
    meta = dict(meta, format_version=version, program_format=PROGRAM_FORMAT,
                param_paths=list(params),
                param_dtypes=[_dtype_name(v.dtype) for v in params.values()])
    # the trace's example inputs are the weights: the program keeps none
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    # the weights are stored, not deflated: trained fp32 weights do not
    # compress, and a full-width generator's are hundreds of megabytes
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("program.bin", buf.getvalue())
        zf.writestr("meta.json", json.dumps(meta))
        for i, v in enumerate(params.values()):
            arr = io.BytesIO()
            np.save(arr, v.detach().to("cpu", torch.float32).numpy())
            zf.writestr(f"param_{i}.npy", arr.getvalue())


def export_serving_artifact(model, frame_hw: Tuple[int, int], path: str,
                            batch: int = 1,
                            platforms: Optional[Sequence[str]] = None
                            ) -> None:
    """Seal ``model``'s serving step and its generator's weights into
    ``path``.

    ``batch`` fixes the batch of a call; for multi-stream serving
    (independent carries, join/leave masks) use
    :func:`export_multistream_artifact`. ``platforms`` defaults to
    ``("cuda", "cpu")``: one artifact for the card and CPU CI."""
    _export(model, frame_hw, path, int(batch), platforms, False)


def export_multistream_artifact(model, frame_hw: Tuple[int, int], path: str,
                                n_slots: int = 8,
                                platforms: Optional[Sequence[str]] = None
                                ) -> None:
    """Seal the multi-stream batched tick (``infer/multistream.py``): N
    independent streams with per-slot carries and reset / valid masks,
    served by ``MultiStreamServer.from_artifact`` (and ``cli.serve
    --artifact``) with no model code behind it. ``n_slots`` is the sealed
    physical batch."""
    _export(model, frame_hw, path, int(n_slots), platforms, True)


# ---------------------------------------------------------------------------
# Load and serve
# ---------------------------------------------------------------------------

def _read_artifact(path: str, device=None):
    """(program callable on ``device``, params on ``device``, meta)."""
    dev = resolve_device(device)
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        if meta.get("format_version") not in _KNOWN_VERSIONS:
            raise ValueError(
                f"artifact format v{meta.get('format_version')} not in "
                f"{_KNOWN_VERSIONS} supported by this loader")
        if meta.get("program_format") != PROGRAM_FORMAT:
            raise ValueError(
                f"{path}: meta.json has program_format "
                f"{meta.get('program_format')!r}, not {PROGRAM_FORMAT!r}: "
                "not an artifact of this package (the JAX package's "
                "artifacts are StableHLO; serve them with ir2rgb_tpu)")
        if dev.type not in meta["platforms"]:
            raise ValueError(f"{path} was exported for {meta['platforms']}, "
                             f"not {dev.type}")
        program = torch.export.load(io.BytesIO(zf.read("program.bin")))
        params = {}
        for i, (key, dt) in enumerate(zip(meta["param_paths"],
                                          meta["param_dtypes"])):
            arr = np.load(io.BytesIO(zf.read(f"param_{i}.npy")))
            t = torch.from_numpy(arr).to(dev, getattr(torch, dt))
            if t.dim() == 4:  # the port keeps conv weights channels-last
                t = t.contiguous(memory_format=torch.channels_last)
            params[key] = t
    program = move_to_device_pass(program, dev)
    return program.module(), params, meta


class ExportedStream:
    """Serve from an artifact: ``StreamingGenerator``'s surface (push /
    stream / reset) with no model code behind it."""

    def __init__(self, program, params: dict, meta: dict,
                 device: torch.device):
        self._fn = program
        self._params = params
        self.meta = meta
        self.device = device
        self.temporal = meta["temporal"]
        self.batch = meta["batch"]
        h, w = meta["frame_hw"]
        self._carry = (torch.zeros((self.batch, h, w, meta["carry_c"]),
                                   dtype=torch.float32, device=device)
                       if self.temporal else None)

    def reset(self) -> None:
        if self._carry is not None:
            self._carry = torch.zeros_like(self._carry)

    @property
    def carry(self) -> Optional[torch.Tensor]:
        return self._carry

    def push_device(self, a_u8: torch.Tensor) -> torch.Tensor:
        """Device-in device-out step: uint8 NHWC frames on the artifact's
        device -> uint8 RGB frames there (no host sync)."""
        with torch.inference_mode():
            if self.temporal:
                out, self._carry = self._fn(self._params, a_u8, self._carry)
                return out
            return self._fn(self._params, a_u8)

    def _dispatch(self, a_host: np.ndarray):
        """Upload one host frame, queue the step and the copy of its
        output to the host; returns (host tensor, done event or None)."""
        a = np.asarray(a_host)
        if a.ndim == 3:
            a = a[None]
        if a.dtype != np.uint8:
            # the one shared conversion keeps this path bit-identical to
            # the live and multi-stream surfaces
            a = host_to_wire_u8(a, self.meta.get("label_nc", 0) > 0)
        out = self.push_device(torch.from_numpy(a).to(self.device))
        if self.device.type != "cuda":
            return out, None
        host = out.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _fetch(host: torch.Tensor, done) -> np.ndarray:
        if done is not None:
            done.synchronize()
        arr = host.numpy()
        return arr[0] if arr.shape[0] == 1 else arr

    def push(self, a_host: np.ndarray) -> np.ndarray:
        """uint8 (or [-1,1] float) IR frame in, uint8 RGB out."""
        return self._fetch(*self._dispatch(a_host))

    def stream(self, frames: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Depth-1 pipelined loop (as ``StreamingGenerator.stream``)."""
        pending = None
        for a_host in frames:
            out = self._dispatch(a_host)
            if pending is not None:
                yield self._fetch(*pending)
            pending = out
        if pending is not None:
            yield self._fetch(*pending)


def load_serving_artifact(path: str, device=None,
                          mesh=None) -> ExportedStream:
    """Load an artifact written by :func:`export_serving_artifact` onto
    ``device`` (None: the CUDA device) and return a ready stream. A
    sealed program serves one card, as the JAX package's does (its
    loader takes no mesh): a ``mesh`` raises ``ValueError``."""
    if mesh is not None:
        raise ValueError(ONE_CARD)
    program, params, meta = _read_artifact(path, device)
    if meta.get("multistream"):
        raise ValueError(
            f"{path} is a MULTI-STREAM artifact (per-slot carries + "
            f"masks); load it with MultiStreamServer.from_artifact "
            f"(or serve it with cli.serve --artifact)")
    return ExportedStream(program, params, meta, resolve_device(device))


def load_multistream_artifact(path: str, device=None):
    """Load an artifact written by :func:`export_multistream_artifact`
    onto ``device`` (None: the CUDA device); returns ``(tick, params,
    meta)`` for ``MultiStreamServer.from_artifact``, the tick called as
    ``tick(params, frames_u8, [carry,] reset, valid)``."""
    program, params, meta = _read_artifact(path, device)
    if not meta.get("multistream"):
        raise ValueError(
            f"{path} is a single-stream artifact; load it with "
            f"load_serving_artifact (or re-export with "
            f"export_multistream_artifact / cli.export --slots N)")
    return program, params, meta
