"""Int8 quantized serving — the port of ``ir2rgb_tpu/nn/quant.py``.

Every generator conv of ``nn/ops.py`` asks :func:`mode_for` which mode it
runs in and, when that is not ``"none"``, computes through :func:`conv`:

- ``"none"`` (default): the fp path, untouched (``ops.conv`` as before,
  the bias fused into ``F.conv2d``).
- ``"int8"``: dynamic symmetric quantization. Activations per tensor
  (scale = amax / 127 over the whole tensor, the batch included),
  weights per output channel, an exact int8 x int8 -> int32 product,
  then the fp32 rescale ``y * (sx * sw)`` in JAX's association, cast to
  the activation dtype; the caller adds the bias after that. No
  zero-points, so padding and dilation zeros stay exact.
- ``"int8_mixed"``: a conv quantizes as ``"int8"`` only when both channel
  widths of the weight it convolves are at least ``MIXED_MIN_CH`` (32;
  ``IR2RGB_QUANT_MIXED_MIN`` overrides), else it runs fp. The widths are
  those of the conv the port runs: for a subpixel transposed conv the
  rearranged weight, whose output is 4·cout wide. The JAX package reads
  the same widths off the convs it lowers; from 128 px it folds some
  convs space-to-depth (``ir2rgb_tpu/nn/ops.py::_use_s2d``), which widen
  and then quantize there. The port has no such fold.
- ``"int8_w"``: weight-only. Per-output-channel int8 weights dequantized
  to the activation dtype, then the normal fp conv.

The mode is a ``contextvars`` scope, not a process global:
``GanModel.generate`` serves inside ``using(resolve(cfg.infer.quant))``
for the duration of each call, so two models with different modes serve
side by side in one process. ``IR2RGB_QUANT`` (read at import) overrides
every model's config. Training runs in ``"none"``: rounding has no
gradient, and ``cli.train`` refuses a quant mode.

Rounding is ``torch.round``, half to even like ``jnp.round``; the
scales are fp32 and the division is IEEE on both devices, so the int8
tensors are JAX's bit for bit.

The int8 product. The JAX package runs it in XLA
(``lax.conv_general_dilated`` with an int32 accumulator), outside any
Pallas kernel, and so does the port through a library GEMM: im2col of the
padded int8 activation (``Tensor.unfold``), then on a CUDA tensor
``torch._int_mm`` (cuBLASLt, int8 x int8 -> int32), zero-padded to what it
takes (more than 16 rows, K and N multiples of 8; the padding adds
nothing). On the CPU the plain version computes the same product in
float64 (:func:`int_mm_reference`), which is exact: each term is at most
127², and every partial sum of at most 3·3·1024 of them stays an integer
below 2^53. The two agree bit for bit.

``quant.dot`` of the JAX package serves only its space-to-depth
matmuls (``nn/s2d_space.py``), which the port does not have; it is not
ported.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

_VALID = ("none", "int8", "int8_w", "int8_mixed")

# int8_mixed: a conv quantizes only when both its channel widths reach this
MIXED_MIN_CH = int(os.environ.get("IR2RGB_QUANT_MIXED_MIN", "32"))

# experiment override (read once at import): wins over every model's
# cfg.infer.quant
_ENV_OVERRIDE = os.environ.get("IR2RGB_QUANT", "") or ""

_MODE_VAR: contextvars.ContextVar = contextvars.ContextVar(
    "ir2rgb_torch_quant_mode", default="none")

Padding = Union[int, Sequence[Tuple[int, int]]]


def _validate(m: str) -> str:
    m = m or "none"
    if m not in _VALID:
        raise ValueError(
            f"unknown quant mode {m!r} (none | int8 | int8_w)")
    return m


def mode() -> str:
    """The mode in effect for ops run right now."""
    return _MODE_VAR.get()


def env_override() -> str:
    """The IR2RGB_QUANT experiment override ('' when unset); raises for an
    invalid value."""
    if _ENV_OVERRIDE:
        _validate(_ENV_OVERRIDE)
    return _ENV_OVERRIDE


def resolve(cfg_mode: str) -> str:
    """Effective mode for a model: the IR2RGB_QUANT override if set, else
    the model's own config value."""
    return _validate(_ENV_OVERRIDE or cfg_mode)


@contextlib.contextmanager
def using(m: str):
    """Ops run inside this scope compute in mode ``m``."""
    token = _MODE_VAR.set(_validate(m))
    try:
        yield
    finally:
        _MODE_VAR.reset(token)


def mode_for(cin: int, cout: int) -> str:
    """What a conv of ``cin`` -> ``cout`` channels computes in under the
    current mode: ``"none"``, ``"int8"`` or ``"int8_w"`` (``int8_mixed``
    resolved by its width gate)."""
    m = _MODE_VAR.get()
    if m == "int8_mixed":
        return "int8" if min(cin, cout) >= MIXED_MIN_CH else "none"
    return m


def _q8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.round(x / scale).clamp_(-127, 127).to(torch.int8)


def _act_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric scale from the fp32 amax of all of ``x``."""
    return torch.clamp(x.float().abs().amax(), min=1e-12) / 127.0


def _w_q8_per_channel(w32: torch.Tensor):
    """OIHW fp32 weights -> (int8 weights, fp32 scale per output
    channel)."""
    sw = torch.clamp(w32.abs().amax(dim=(1, 2, 3)), min=1e-12) / 127.0
    return _q8(w32, sw.view(-1, 1, 1, 1)), sw


# parameter -> (its version, {(derivation, dtype, what): tensors})
_kept = WeakIdKeyDictionary()

Source = Tuple[torch.Tensor, object]


def _weight_entry(w: torch.Tensor, source, what: str, make):
    """``make()`` for the conv weight ``w``, kept until the parameter it
    was made from changes. ``source`` is (that parameter, a tag naming
    how ``w`` was derived from it: cast, flip, subpixel rearrangement),
    or None when ``w`` is the parameter itself. The quantized weights
    depend only on the parameters, so a serving frame requantizes
    nothing, whatever temporary its caller casts or rearranges. Made
    outside inference mode and without a graph; an inference-tensor
    parameter has no version counter and is quantized at every call.
    While a program is exported (``infer/export.py``) the parameter is a
    program input: nothing is read from or written to the cache, and the
    program quantizes the weight in every call, as the JAX package's
    exported step quantizes its ``params``."""
    if torch.compiler.is_exporting():
        return make()

    def build():
        with torch.inference_mode(False), torch.no_grad():
            return make()
    param, tag = (w, None) if source is None else source
    if param.is_inference():
        return build()
    kept = _kept.get(param)
    if kept is None or kept[0] != param._version:
        kept = (param._version, {})
        _kept[param] = kept
    key = (tag, w.dtype, what)
    if key not in kept[1]:
        kept[1][key] = build()
    return kept[1][key]


def weight_q8(w: torch.Tensor, source: Optional[Source] = None):
    """(int8 OIHW weights, fp32 per-output-channel scales) of OIHW ``w``
    as it is (the caller casts it to the compute dtype first, as JAX
    quantizes the compute-dtype weight); ``source`` as
    :func:`_weight_entry` keeps it."""
    return _weight_entry(w, source, "q8",
                         lambda: _w_q8_per_channel(w.float()))


def dequantized(w: torch.Tensor,
                source: Optional[Source] = None) -> torch.Tensor:
    """``int8_w``'s weight: OIHW ``w`` quantized per output channel and
    dequantized back to ``w``'s dtype."""
    def make():
        qw, sw = weight_q8(w, source)
        return (qw.float() * sw.view(-1, 1, 1, 1)).to(w.dtype)
    return _weight_entry(w, source, "deq", make)


def int_mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` of int8 ``a`` (M, K) and ``b`` (N, K) -> int32 (M, N),
    computed in float64, exactly (see the module docstring)."""
    return (a.double() @ b.double().T).to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same product through ``torch._int_mm`` on the card, the
    operands zero-padded to more than 16 rows and K, N multiples of 8."""
    m, k = a.shape
    n = b.shape[0]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b = F.pad(b, (0, kp - k, 0, np_ - n))
    y = torch._int_mm(a, b.T)
    return y if (mp, np_) == (m, n) else y[:m, :n]


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (N, K) -> int32 (M, N) = ``a @ b.T``: the
    library's int8 GEMM on a CUDA tensor, the float64 plain version on
    the CPU."""
    if a.device.type == "cpu":
        return int_mm_reference(a, b)
    return int_mm_cuda(a, b)


def _pads(padding: Padding) -> Tuple[int, int, int, int]:
    """``padding`` as F.pad's (w_lo, w_hi, h_lo, h_hi) over NHWC's W, H."""
    if isinstance(padding, int):
        return (padding,) * 4
    (h_lo, h_hi), (w_lo, w_hi) = padding
    return (w_lo, w_hi, h_lo, h_hi)


def _dilate(x: torch.Tensor, s: int) -> torch.Tensor:
    """NHWC ``x`` with ``s - 1`` zeros between neighbouring pixels (the
    lhs dilation of a transposed conv)."""
    if s == 1:
        return x
    n, h, w, c = x.shape
    out = x.new_zeros((n, (h - 1) * s + 1, (w - 1) * s + 1, c))
    out[:, ::s, ::s] = x
    return out


def int8_conv(xq: torch.Tensor, wq: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
    """The exact int32 conv of int8 NHWC ``xq`` (already padded) with
    int8 OIHW ``wq``: im2col, then :func:`int_mm`. Returns NHWC int32."""
    o, _, kh, kw = wq.shape
    cols = xq.unfold(1, kh, stride).unfold(2, kw, stride)  # N,Ho,Wo,C,kh,kw
    n, ho, wo = cols.shape[:3]
    y = int_mm(cols.reshape(n * ho * wo, -1), wq.reshape(o, -1))
    return y.reshape(n, ho, wo, o)


def conv(x: torch.Tensor, w: torch.Tensor, m: str, stride: int = 1,
         padding: Padding = 0, lhs_dilation: int = 1,
         source: Optional[Source] = None) -> torch.Tensor:
    """NHWC conv of ``x`` with OIHW ``w`` (in x's dtype) in mode ``m``
    (``"int8"`` or ``"int8_w"``, from :func:`mode_for`), no bias; the
    result in x's dtype. ``padding``: an int, or ((h_lo, h_hi), (w_lo,
    w_hi)); ``lhs_dilation``: zeros between input pixels, applied before
    the padding (the direct form of a transposed conv); ``source``: the
    parameter ``w`` was derived from, and how (:func:`_weight_entry`)."""
    pads = _pads(padding)
    if m == "int8_w":
        xp = F.pad(_dilate(x, lhs_dilation), (0, 0) + pads)
        y = F.conv2d(xp.permute(0, 3, 1, 2), dequantized(w, source),
                     stride=stride)
        return y.permute(0, 2, 3, 1).contiguous()
    if m != "int8":
        raise ValueError(f"quant.conv computes int8 or int8_w, not {m!r}")
    qw, sw = weight_q8(w, source)
    sx = _act_scale(x)
    xq = F.pad(_dilate(_q8(x.float(), sx), lhs_dilation), (0, 0) + pads)
    y = int8_conv(xq, qw, stride)
    return (y.float() * (sx * sw)).to(x.dtype)
