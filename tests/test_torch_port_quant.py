"""Quantized serving in the port (``ir2rgb_tpu_torch/nn/quant.py``), held to
the JAX package's ``ir2rgb_tpu/nn/quant.py`` on the CPU on the same numpy
inputs:

- the int8 rounding (half to even, at exact .5 ties), the per-tensor
  activation scale and the per-output-channel weight scales, bit for bit;
- every conv the generators run (plain conv, stride 1 and 2; the
  transposed conv's subpixel and dilated routes) in ``int8``, ``int8_w``
  and ``int8_mixed``, fp32 and bf16: the int32 product exactly, the
  dequantized weights bit for bit, ``int8`` outputs within 1 fp32 ulp
  (bf16: equal), ``int8_w`` outputs within the fp conv's rounding;
- the ``int8_mixed`` width gate, on the widths of the conv that runs
  (a subpixel deconv's 4·cout);
- whole generators (ResNet-6, global, local, U-Net-128) per mode, fp32,
  within 1e-5. At 128 px JAX would fold the U-Net's convs space-to-depth
  (``ops._use_s2d``), which ``int8_mixed`` gates differently (ROADMAP
  §C); the test selects JAX's plain lowering. At the U-Net's 1-4 px
  levels an instance norm over at most 16 pixels magnifies fp32 rounding
  until an int8 rounding tie flips: where a conv's int8 activations
  differ from JAX's, and only there, its input is pinned to JAX's, after
  it is held to it within fp32 rounding;
- two models with different modes serving side by side, the
  ``IR2RGB_QUANT`` override and its validation, the training CLI's
  refusal, and a multi-stream tick, whose activation scale spans the
  whole batch;
- on the meta device, what a full-size quantized frame of each preset
  sends to the kernels, against ``chip_smoke.py``'s tables.

Sizes are <= 64 px (128 for the U-Net), one intra-op thread."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

import ir2rgb_tpu.nn.ops as jops
from ir2rgb_tpu.nn import quant as jq
from ir2rgb_tpu.nn.generators import GenConfig as JGenConfig
from ir2rgb_tpu.nn.generators import define_g as jax_define_g

from ir2rgb_tpu_torch.checkpoint import generator_state_dict_from_jax
from ir2rgb_tpu_torch.checkpoint.from_jax import conv_w, deconv_w
from ir2rgb_tpu_torch.config import PRESETS
from ir2rgb_tpu_torch.nn import GenConfig, define_g, ops, quant
from ir2rgb_tpu_torch.train import create_model

from test_torch_port_train_zoo import _params

MODES = ("int8", "int8_w", "int8_mixed")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small CPU tensors (the suite
    runs several test processes on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rounding_and_scales_match_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    # exact .5 ties (scale a power of two): half to even on both sides
    s = np.float32(0.25)
    ties = (np.arange(-300, 301, dtype=np.float32) + 0.5) * s
    np.testing.assert_array_equal(
        quant._q8(_t(ties), torch.tensor(s)).numpy(),
        np.asarray(jq._q8(jnp.asarray(ties), s)))
    assert quant._q8(_t([0.5, 1.5, 2.5, -2.5]), torch.tensor(1.0)
                     ).tolist() == [0, 2, 2, -2]
    r = np.random.RandomState(0)
    x = (r.randn(2, 9, 7, 5) * 3).astype(np.float32)
    w = (r.randn(3, 3, 5, 6) * 0.1).astype(np.float32)
    xt, wt = _t(x, tdt), _t(conv_w(w), tdt)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    sx = quant._act_scale(xt)
    assert sx.dtype == torch.float32
    assert float(sx) == float(jq._act_scale(xj))
    qw, sw = quant.weight_q8(wt)
    jqw, jsw = jq._w_q8_per_channel(wj.astype(jnp.float32), (0, 1, 2),
                                    (1, 1, 1, -1))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    np.testing.assert_array_equal(qw.numpy(),
                                  conv_w(np.asarray(jqw)))
    np.testing.assert_array_equal(
        quant._q8(xt.float(), sx).numpy(),
        np.asarray(jq._q8(xj.astype(jnp.float32), jq._act_scale(xj))))


def test_int_mm_reference_is_exact():
    """The plain int8 product (float64) equals the int64 product at the
    largest K the generators give it (3x3x1024), full int8 range."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (40, 9216), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (24, 9216), generator=g, dtype=torch.int8)
    a[0], b[0] = 127, 127  # the largest sum, 9216 * 127^2
    want = a.long() @ b.long().T
    got = quant.int_mm_reference(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), want)
    assert int(got[0, 0]) == 9216 * 127 * 127


def _jax_int32(x, w_hwio, strides, padding, lhs_dilation=(1, 1)):
    """JAX's int8 conv at its quant points: (int32 product, sx, sw)."""
    x32 = x.astype(jnp.float32)
    sx = jq._act_scale(x)
    qw, sw = jq._w_q8_per_channel(w_hwio.astype(jnp.float32), (0, 1, 2),
                                  (1, 1, 1, -1))
    y = lax.conv_general_dilated(
        jq._q8(x32, sx), qw, strides, padding, lhs_dilation=lhs_dilation,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return np.asarray(y), float(sx), np.asarray(sw)


def _hold(mode, tdt, got, want, int32_got=None, int32_want=None):
    """The bars of the module docstring for one conv's output."""
    if int32_got is not None:
        np.testing.assert_array_equal(int32_got, int32_want)
    got, want = _np(got), np.asarray(want, np.float32)
    if mode == "int8":
        if tdt == torch.bfloat16:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
    elif tdt == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_conv_matches_jax(mode, stride, dtype):
    tdt, jdt = DTYPES[dtype]
    r = np.random.RandomState(stride)
    x = r.randn(2, 12, 10, 40).astype(np.float32)
    w = (r.randn(3, 3, 40, 48) * 0.1).astype(np.float32)
    b = (r.randn(48) * 0.1).astype(np.float32)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    with jq.using(mode):
        want = jops.conv_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                               jnp.asarray(x), stride=stride, padding=1,
                               compute_dtype=jdt)
    xt, wt = _t(x, tdt), _t(conv_w(w), tdt)
    with quant.using(mode):
        got = ops.conv(xt, _t(conv_w(w)), _t(b), stride=stride, padding=1)
    assert got.dtype == tdt
    i32 = j32 = None
    if mode != "int8_w":  # int8_mixed quantizes this 40 -> 48 conv
        j32 = _jax_int32(xj, wj, (stride, stride), [(1, 1), (1, 1)])[0]
        qw, _ = quant.weight_q8(wt)
        xq = quant._q8(xt.float(), quant._act_scale(xt))
        i32 = quant.int8_conv(F.pad(xq, (0, 0, 1, 1, 1, 1)), qw,
                              stride).numpy()
    else:
        deq = jq._w_q8_per_channel(wj.astype(jnp.float32), (0, 1, 2),
                                   (1, 1, 1, -1))
        deq = (deq[0].astype(jnp.float32) * deq[1].reshape(1, 1, 1, -1)
               ).astype(jdt)
        np.testing.assert_array_equal(_np(quant.dequantized(wt)),
                                      conv_w(np.asarray(deq, np.float32)))
    _hold("int8" if mode != "int8_w" else mode, tdt, got, want, i32, j32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("lowering", ["subpixel", "dilated"])
@pytest.mark.parametrize("mode", MODES)
def test_deconv_matches_jax(mode, lowering, dtype):
    """The ResNet up (k3 p1 op1) by both routes; each quantizes the conv
    it runs (the subpixel route its rearranged weight)."""
    tdt, jdt = DTYPES[dtype]
    r = np.random.RandomState(3)
    x = r.randn(2, 6, 8, 40).astype(np.float32)
    w = (r.randn(3, 3, 40, 36) * 0.1).astype(np.float32)  # flipped HWIO
    b = (r.randn(36) * 0.1).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    with jq.using(mode):
        want = jops.deconv_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                 jnp.asarray(x), compute_dtype=jdt,
                                 lowering=lowering)
    xt, wt = _t(x, tdt), _t(deconv_w(w), tdt)
    with quant.using(mode):
        got = ops.deconv(xt, _t(deconv_w(w)), _t(b), lowering=lowering)
    assert got.shape == (2, 12, 16, 36) and got.dtype == tdt
    i32 = j32 = None
    quantized = mode == "int8" or (mode == "int8_mixed"
                                   and lowering == "subpixel")
    if quantized and lowering == "subpixel":
        wk, kk, omin = jops._subpixel_kernel(jnp.asarray(w, jdt), 3, 1)
        pad = [(-omin, kk - 1 + omin)] * 2
        j32 = _jax_int32(xj, wk, (1, 1), pad)[0]
        wkt = ops.subpixel_weight(wt, 1)
        xq = quant._q8(xt.float(), quant._act_scale(xt))
        i32 = quant.int8_conv(F.pad(xq, (0, 0, -omin, kk - 1 + omin,
                                         -omin, kk - 1 + omin)),
                              quant.weight_q8(wkt)[0]).numpy()
    elif quantized:
        j32 = _jax_int32(xj, jnp.asarray(w, jdt), (1, 1), [(1, 2), (1, 2)],
                         (2, 2))[0]
        wf = wt.permute(1, 0, 2, 3).flip(2, 3)
        xq = quant._q8(xt.float(), quant._act_scale(xt))
        i32 = quant.int8_conv(F.pad(quant._dilate(xq, 2),
                                    (0, 0, 1, 2, 1, 2)),
                              quant.weight_q8(wf)[0]).numpy()
    bar = "int8" if quantized else ("int8_w" if mode == "int8_w"
                                    else "none")
    _hold(bar, tdt, got, want, i32, j32)


@pytest.mark.parametrize("kind,ci,co,quantizes", [
    ("conv", 48, 16, False),       # min(48, 16) < 32: fp
    ("conv", 32, 40, True),
    ("subpixel", 32, 8, True),     # the run conv is 32 -> 4·8 = 32 wide
    ("dilated", 32, 8, False),     # the direct form's 32 -> 8 stays fp
])
def test_mixed_gate_reads_the_run_convs_widths(kind, ci, co, quantizes):
    r = np.random.RandomState(ci + co)
    x = _t(r.randn(1, 8, 8, ci))
    if kind == "conv":
        w = _t(r.randn(co, ci, 3, 3) * 0.1)
        run = lambda: ops.conv(x, w, padding=1)  # noqa: E731
    else:
        w = _t(r.randn(ci, co, 3, 3) * 0.1)
        run = lambda: ops.deconv(x, w, lowering=kind)  # noqa: E731
    with quant.using("int8_mixed"):
        mixed = run()
    with quant.using("int8" if quantizes else "none"):
        want = run()
    assert torch.equal(mixed, want)
    with quant.using("none"):
        assert torch.equal(run(), want) is not quantizes


NETS = {
    "resnet_6blocks": (dict(ngf=8), 32),
    "global": (dict(ngf=8, n_downsample_global=3, n_blocks_global=1), 32),
    "local": (dict(ngf=8, n_downsample_global=2, n_blocks_global=2,
                   n_blocks_local=1, n_local_enhancers=1), 32),
    "unet_128": (dict(ngf=8), 128),
}


@pytest.fixture(scope="module")
def jax_generator():
    """``jax_generator(net_g)``: (params, input, {mode: JAX's output},
    {mode: JAX's quantized convs' inputs}) of ``NETS[net_g]``. The three
    modes are traced into one jitted function (the mode is read at trace
    time), compiled once a net. It also returns each conv's lhs in call
    order (``quant.conv``'s lhs where it quantizes, else None): the
    U-Net's convs and ups are one call each on both sides. At 128 px JAX takes its plain lowering, as the port
    has no s2d fold."""
    kept = {}

    def forward(net_g):
        if net_g in kept:
            return kept[net_g]
        kw, size = NETS[net_g]
        init, apply = jax_define_g(JGenConfig(net_g=net_g, **kw))
        params = _params(init, 0)
        x = np.random.RandomState(1).uniform(
            -1, 1, (2, size, size, 3)).astype(np.float32)
        real = jq.conv
        traced = {m: [] for m in MODES}

        def conv(v, rhs, *a, **kwargs):
            m = jq.mode()
            q = m == "int8" or (m == "int8_mixed" and min(
                rhs.shape[2], rhs.shape[3]) >= jq.MIXED_MIN_CH)
            traced[m].append(v if q else None)
            return real(v, rhs, *a, **kwargs)

        def every_mode(p, xj):
            out = {}
            for m in MODES:
                with jq.using(m):
                    out[m] = apply(p, xj)
            return out, traced
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jops, "_use_s2d", lambda *a: False)
            mp.setattr(jq, "conv", conv)
            ys, lhs = jax.jit(every_mode)(params, jnp.asarray(x))
        kept[net_g] = (params, x, {m: np.asarray(y) for m, y in ys.items()},
                       {m: [None if v is None else np.array(v) for v in vs]
                        for m, vs in lhs.items()})
        return kept[net_g]
    return forward


def _pin_where_flipped(monkeypatch, lhs):
    """The port's ``ops.conv`` / ``ops.deconv`` input replaced by JAX's
    (``lhs``, in call order) only at a conv whose int8 activations
    differ from JAX's (a rounding tie flipped): every other conv runs on
    the port's own input. Each replaced input is held to JAX's within
    fp32 rounding first. Returns the flips of each pinned conv."""
    calls, pinned = iter(lhs), []

    def q8(x):
        return quant._q8(x.float(), quant._act_scale(x))

    def pinning(fn):
        def run(x, *a, **kw):
            saved = next(calls)
            if saved is not None:
                jx = torch.from_numpy(saved)
                flips = int((q8(x) != q8(jx)).sum())
                if flips:
                    np.testing.assert_allclose(
                        x.numpy(), saved, rtol=0,
                        atol=1e-5 * np.abs(saved).max())
                    pinned.append(flips)
                    x = jx
            return fn(x, *a, **kw)
        return run
    monkeypatch.setattr(ops, "conv", pinning(ops.conv))
    monkeypatch.setattr(ops, "deconv", pinning(ops.deconv))
    return pinned


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("net_g", sorted(NETS))
def test_generator_matches_jax(net_g, mode, monkeypatch, jax_generator):
    params, x, want, lhs = jax_generator(net_g)
    cfg = GenConfig(net_g=net_g, **NETS[net_g][0])
    with torch.device("meta"):
        g = define_g(cfg)
    g.load_state_dict(generator_state_dict_from_jax(params, cfg),
                      assign=True)
    pinned = []
    if net_g.startswith("unet"):
        pinned = _pin_where_flipped(monkeypatch, lhs[mode])
    with quant.using(mode), torch.inference_mode():
        got = g.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want[mode], atol=1e-5)
    # int8 pins 1 of the U-Net's 14 quantized convs, int8_mixed 2
    assert len(pinned) <= 3 and max(pinned, default=0) <= 4, pinned


@pytest.mark.parametrize("route", ["conv", "subpixel", "dilated"])
def test_quantized_weights_are_kept_per_parameter(monkeypatch, route):
    """Each route quantizes its parameter once, whatever temporary it
    convolves (a cast to bf16, the subpixel rearrangement, the dilated
    route's flip), and again once the parameter changes."""
    made = []
    real = quant._w_q8_per_channel
    monkeypatch.setattr(quant, "_w_q8_per_channel",
                        lambda w: made.append(w.shape) or real(w))
    r = np.random.RandomState(5)
    x = _t(r.randn(1, 6, 6, 8), torch.bfloat16)
    shape = (8, 8, 3, 3)
    w = torch.nn.Parameter(_t(r.randn(*shape) * 0.1))
    if route == "conv":
        run = lambda: ops.conv(x, w, padding=1)  # noqa: E731
    else:
        run = lambda: ops.deconv(x, w, lowering=route)  # noqa: E731
    with quant.using("int8"), torch.inference_mode():
        first, again = run(), run()
    assert len(made) == 1 and torch.equal(first, again)
    with torch.no_grad():
        w.mul_(2)
    with quant.using("int8"), torch.inference_mode():
        assert not torch.equal(run(), first)
    assert len(made) == 2


def _tiny(quant_mode="none", **model):
    cfg = PRESETS["pix2pixhd_512"]
    return cfg.replace(
        model=dataclasses.replace(cfg.model, ngf=4, ndf=4,
                                  n_downsample_global=2, n_blocks_global=1,
                                  n_blocks_local=1, **model),
        data=dataclasses.replace(cfg.data, crop_size=32),
        loss=dataclasses.replace(cfg.loss, no_vgg_loss=True),
        infer=dataclasses.replace(cfg.infer, quant=quant_mode))


def test_two_models_serve_side_by_side():
    """Each model serves in its own config's mode, interleaved in one
    process (``tests/test_quant.py::test_side_by_side_modes``)."""
    models = {m: create_model(_tiny(m), device="cpu", seed=0)
              for m in ("int8", "int8_w")}
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (1, 32, 32, 3)).astype(np.float32))
    want = {}
    net = models["int8"].netG
    for m in ("none", *models):
        with quant.using(m), torch.inference_mode():
            want[m] = net(x)
    assert not torch.equal(want["int8"], want["none"])
    assert not torch.equal(want["int8_w"], want["none"])
    for _ in range(2):
        for m, model in models.items():
            assert torch.equal(model.generate(x), want[m]), m
    assert quant.mode() == "none"  # each call's scope ended with it
    # a training forward runs in "none", whatever scope it is called in
    q = models["int8"]
    with torch.no_grad():
        fp = q.netG(q._generator_input(x), train=True)
        with quant.using("int8"):
            assert torch.equal(q._fake(x), fp)


def test_env_override_wins_and_is_validated():
    """``IR2RGB_QUANT`` is read at import: one subprocess imports the
    module with a valid override, then reloads it with an invalid one."""
    code = (
        "import importlib, os\n"
        "os.environ['IR2RGB_QUANT'] = 'int8_w'\n"
        "from ir2rgb_tpu_torch.nn import quant\n"
        "print(quant.resolve('none'), quant.env_override())\n"
        "os.environ['IR2RGB_QUANT'] = 'fp4'\n"
        "importlib.reload(quant)\n"
        "try:\n"
        "    quant.env_override()\n"
        "except ValueError as e:\n"
        "    print(e)\n")
    env = {k: v for k, v in os.environ.items() if k != "IR2RGB_QUANT"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    lines = out.stdout.splitlines()
    assert lines[0].split() == ["int8_w", "int8_w"]
    assert lines[1] == "unknown quant mode 'fp4' (none | int8 | int8_w)"
    with pytest.raises(ValueError, match="unknown quant mode"):
        with quant.using("fp4"):
            pass


@pytest.mark.parametrize("env,err", [("int8", SystemExit),
                                     ("fp4", ValueError)])
def test_train_cli_refuses_the_quant_override(monkeypatch, env, err):
    from ir2rgb_tpu_torch.cli import train as ptrain
    monkeypatch.setattr(quant, "_ENV_OVERRIDE", env)
    with pytest.raises(err, match="serving-only" if err is SystemExit
                       else "unknown quant mode"):
        ptrain.main(["--device", "cpu", "--data.dataroot", "/nonexistent"])


def test_multistream_tick_scales_over_the_batch():
    """An int8 tick equals ``generate`` on the whole batched tick (one
    activation scale over every stream), not each stream's batch-1
    frame; an int8_w tick equals batch 1."""
    from ir2rgb_tpu_torch.infer.multistream import MultiStreamServer
    from ir2rgb_tpu_torch.infer.stream import _dev_normalize, _dev_quantize
    frames = np.random.RandomState(4).randint(0, 256, (2, 32, 32, 3),
                                              np.uint8)
    for mode in ("int8", "int8_w"):
        model = create_model(_tiny(mode), device="cpu", seed=1)
        srv = MultiStreamServer(model, (32, 32), n_slots=2)
        sids = [srv.open(), srv.open()]
        got = srv.step({sids[0]: frames[0], sids[1]: frames[1]})
        x = _dev_normalize(torch.from_numpy(frames))
        batched = _dev_quantize(model.generate(x)).numpy()
        single = [_dev_quantize(model.generate(x[i:i + 1])).numpy()[0]
                  for i in range(2)]
        for i, sid in enumerate(sids):
            np.testing.assert_array_equal(got[sid], batched[i])
            if mode == "int8_w":
                np.testing.assert_array_equal(got[sid], single[i])
        if mode == "int8":
            assert any(not np.array_equal(got[s], single[i])
                       for i, s in enumerate(sids))


@pytest.mark.parametrize("preset,mode", [(p, "int8") for p in sorted(
    PRESETS)] + [("pix2pixhd_512", "int8_mixed"), ("pix2pixhd_512",
                                                   "int8_w")])
def test_quantized_frame_sends_chip_smokes_launches(monkeypatch, preset,
                                                    mode):
    """``chip_smoke.py`` holds each quantized frame's launches to
    ``quant_per_frame``: the norms and ups of "none" (``SERVE``), and B2
    but under int8, whose tail is an int8 conv in PyTorch ops."""
    from test_torch_port_serve_zoo import (
        _chip_smoke,
        kernel_inputs,
        served_frame,
    )
    cs = _chip_smoke()
    # the int8 product on the meta device: an int32 tensor of its shape
    monkeypatch.setattr(quant, "int_mm", lambda a, b: a.new_empty(
        (a.shape[0], b.shape[0]), dtype=torch.int32))
    with quant.using(mode):
        b1, tails, d2s, _ = kernel_inputs(monkeypatch, served_frame(preset))
    table = cs.SERVE[preset]
    assert b1 == table["b1"] and d2s == table["d2s"]
    assert tails == ([] if mode == "int8" else table["tail"])
    assert cs.quant_per_frame(preset, mode)["tail_fused"] == len(tails)
