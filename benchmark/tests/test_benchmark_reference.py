"""The plain reference agrees with the program's CPU path at narrow
widths on the same seeded weights: the generators (temporal and not),
the multiscale discriminator's taps, the VGG19's stages, and whole fp32
runs of each cell, whose compared numbers then read near zero."""

import time

import pytest
import torch

from benchmark.harness import program, synth, weights
from benchmark.harness.frames import nchw, nhwc
from benchmark.reference import gan
from benchmark.run import execute
from benchmark.tests.conftest import TINY, load_cell

CPU = torch.device("cpu")
FP32 = {"model": {**TINY["model"], "compute_dtype": "float32"},
        "crop_size": TINY["crop_size"]}


def _pair(name):
    cell = load_cell(name)
    model_cfg = program.reference_model(cell.config, FP32)
    ref = gan.build(model_cfg, CPU, with_d=True)
    sds = weights.draw(ref, 2**31 + 5, CPU)
    for k, net in ref.items():
        net.load_state_dict(sds[k])
    port = program.build(program.port_config(cell.config, True, FP32), CPU,
                         3, sds)
    return ref, port


@pytest.mark.parametrize("name", ["temporal_512.cams16",
                                  "pix2pixhd_1024.cam1"])
def test_generator(name):
    ref, port = _pair(name)
    n_in = port.gen_cfg.input_nc
    x = torch.rand((2, 32, 32, n_in), generator=torch.Generator()
                   .manual_seed(0)) * 2 - 1
    want = nhwc(ref["netG"](nchw(x).contiguous()))
    got = (port.generate(x[..., :3], prev=x[..., 3:]) if n_in > 3
           else port.generate(x))
    assert (got - want).abs().max() < 1e-5


def test_discriminator_and_vgg():
    ref, port = _pair("pix2pixhd_1024.cam1")
    pair = torch.rand((1, 32, 32, 6), generator=torch.Generator()
                      .manual_seed(1)) * 2 - 1
    with torch.no_grad():
        got = port.netD(pair)
        want = ref["netD"](nchw(pair).contiguous())
        for gs, ws in zip(got, want):
            for g, w in zip(gs, ws):
                assert (g - nhwc(w)).abs().max() < 1e-5
        img = pair[..., 3:]
        for g, w in zip(port.vgg(img), ref["vgg"](nchw(img).contiguous())):
            assert (g - nhwc(w)).abs().max() < 1e-4 * max(1.0,
                                                          w.abs().max())


def test_state_dict_keys_are_shared():
    ref, port = _pair("pix2pixhd_1024.cam1")
    for k in ("netG", "netD", "vgg"):
        assert set(getattr(port, k).state_dict()) == set(ref[k].state_dict())


def test_synthetic_clips_repeat_from_the_seed():
    a = synth.clips(2**31 + 3, 2, 3, 16, CPU)
    assert torch.equal(a, synth.clips(2**31 + 3, 2, 3, 16, CPU))
    assert not torch.equal(a, synth.clips(2**31 + 4, 2, 3, 16, CPU))
    assert a.dtype == torch.uint8 and a.shape == (2, 3, 16, 16, 3)


@pytest.mark.parametrize("name,most", [
    ("temporal_512.cams16", {"first_rms16": 0.2, "carried_rms": 1.0}),
    ("pix2pixhd_1024.cam1", {"frame_rms16": 0.2})])
def test_fp32_program_reads_near_zero(name, most):
    """The program at fp32 against the fp32 reference: a frame within a
    fifth of a level (a truncation at a level's edge flips one), a frame
    that conditions on the previous served frame within a level (the
    reference's carry is that frame rounded to the wire's uint8, the
    program's its fp32 output)."""
    res, _ = execute(load_cell(name), 2**31 + 9, 0.5, False, CPU,
                     time.perf_counter(), overrides=FP32)
    assert set(res.checks) == set(most)
    assert all(v <= most[k] for k, (v, _) in res.checks.items()), res.checks
