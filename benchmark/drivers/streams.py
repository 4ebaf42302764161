"""Many cameras, one card: ``MultiStreamServer.step``, closed loop.

Every tick, each of ``streams`` cameras hands its next uint8 frame to one
``MultiStreamServer(n_slots=streams)`` (physical batch ``streams``), the
call the TCP daemon makes, and waits for its uint8 output on the host.
Camera s plays its own seeded clip of ``clip_frames`` frames from phase
``s * clip_frames // streams``, cycled; where its clip starts over (a
scene cut, a reconnect) the stream is closed and opened again, so its
carry restarts from zero.

- ``frames_per_s``: frames returned in the window over its seconds.
- ``frame_p95_ms``: the 95th percentile over every frame of the window of
  the time from its hand-off to its output on the host (a tick's frames
  share their tick's time).
- Checks: a seeded uniform sample of each camera's frames over the whole
  window (reservoir sampling, ``sample_first`` frames right after a
  reset and ``sample_carried`` others from every camera, so that every
  slot is read) against the fp32 reference (``harness/frames.py``):
  ``first_rms16``, the worst frame right after a reset compared in
  16 x 16 blocks, and ``carried_rms``, the worst frame conditioned on its
  stream's previous output compared pixel by pixel (the statistics the
  limits file names).
"""

from __future__ import annotations

import random
from typing import Dict

import numpy as np
import torch

from benchmark.harness import core, frames, program, synth, weights
from benchmark.reference import gan, nets


class ControlStreams:
    """The reference in the server's place, at the control's precision:
    the same slot lifecycle and ``step``, a raw fp32 carry a slot."""

    def __init__(self, G: torch.nn.Module, carry_c: int, device):
        self.G, self.carry_c, self.device = G, carry_c, device
        self.carry: Dict[int, torch.Tensor] = {}
        self._next = 0

    def open(self) -> int:
        sid, self._next = self._next, self._next + 1
        return sid

    def close(self, sid: int) -> None:
        self.carry.pop(sid, None)

    @torch.no_grad()
    def step(self, frames_by_sid: Dict[int, np.ndarray]):
        sids = sorted(frames_by_sid)
        x = synth.to_unit(torch.from_numpy(np.stack(
            [frames_by_sid[s] for s in sids])).to(self.device))
        prev = torch.stack([self.carry.get(s, torch.zeros(
            x.shape[1:3] + (self.carry_c,), device=self.device))
            for s in sids])
        out = frames.nhwc(self.G(frames.nchw(torch.cat([x, prev], -1))
                                 .contiguous()))
        for i, s in enumerate(sids):
            self.carry[s] = out[i]
        u8 = frames.quantize(out).cpu().numpy()
        return {s: u8[i] for i, s in enumerate(sids)}


def run(run: core.Run) -> core.Result:
    cfg, tr, dev = run.config, run.traffic, run.device
    n, length = tr["streams"], tr["clip_frames"]
    size = program.crop_size(cfg, run.overrides)
    model_cfg = program.reference_model(cfg, run.overrides)
    # the program's role reads only the reference's shapes
    ref = gan.build(model_cfg, dev if run.role == "control" else "meta",
                    with_d=False)
    sds = weights.draw(ref, run.sub_seed("weights"), dev)
    clips = synth.clips(run.sub_seed("frames"), n, length, size, dev
                        ).cpu().numpy()
    carry_c = model_cfg["output_nc"]
    if run.role == "program":
        from ir2rgb_tpu_torch.infer import MultiStreamServer
        model = program.build(program.port_config(cfg, False, run.overrides),
                              dev, run.seed, sds)
        system = MultiStreamServer(model, (size, size), n_slots=n)
    else:
        ref["netG"].load_state_dict(sds["netG"])
        system = ControlStreams(nets.set_precision(ref["netG"], "fp8"),
                                carry_c, dev)
    if run.plant is not None:
        run.plant(system)
    sds = {k: {n_: t.cpu() for n_, t in sd.items()} for k, sd in sds.items()}
    phase = [s * length // n for s in range(n)]

    sids = [system.open() for _ in range(n)]
    for t in range(tr["warmup_ticks"]):
        system.step({sids[s]: clips[s][(phase[s] + t) % length]
                     for s in range(n)})
    run.sync()
    for sid in sids:
        system.close(sid)
    sids = [system.open() for _ in range(n)]

    rng = random.Random(run.sub_seed("sample"))
    first = [frames.Reservoir(tr["sample_first"], rng) for _ in range(n)]
    carried = [frames.Reservoir(tr["sample_carried"], rng)
               for _ in range(n)]
    lat_s, prev = [], {}
    span, tick = run.tracer.span, 0
    setup_s = run.setup_s()
    core.peak_reset(dev)
    run.tracer.start()
    start = end = run.now()
    while end - start < run.seconds:
        if tick == tr["trace_ticks"]:
            run.tracer.stop(run.sync)
        with span("prepare"):
            batch, reset = {}, []
            for s in range(n):
                pos = (phase[s] + tick) % length
                if pos == 0 and tick > 0:
                    system.close(sids[s])
                    sids[s] = system.open()
                batch[sids[s]] = clips[s][pos]
                reset.append(pos == 0 or tick == 0)
        with span("call"):
            t_in = run.now()
            outs = system.step(batch)
            end = run.now()
        with span("read"):
            lat_s.append(end - t_in)
            for s in range(n):
                pos = (phase[s] + tick) % length
                out = outs[sids[s]]
                if reset[s]:
                    first[s].offer(lambda: dict(frame=clips[s][pos],
                                                out=out.copy(), prev=None))
                else:
                    carried[s].offer(lambda: dict(frame=clips[s][pos],
                                                  out=out.copy(),
                                                  prev=prev[s].copy()))
                prev[s] = out
        tick += 1
    run.tracer.stop(run.sync)
    window_s = end - start
    peak = core.peak_bytes(dev)
    del system, outs, prev
    if run.role == "program":
        del model
    core.free(dev)

    G = gan.build(model_cfg, dev, with_d=False)["netG"]
    G.load_state_dict(sds["netG"])
    block = tr["reference_block"]
    with nets.no_tf32():
        gaps = {what: frames.worst_gaps(
            G, [it for r in res for it in r.items], carry_c, dev, block)
            for what, res in (("first", first), ("carried", carried))}
    checks, extra = frames.checks(gaps, run.limits)
    return core.Result(
        metrics={"setup_s": setup_s,
                 "frames_per_s": tick * n / window_s,
                 "frame_p95_ms": core.p95(np.repeat(lat_s, n)) * 1e3},
        attempted=tick * n, failed=0, checks=checks, extra=extra,
        units_traced=min(tick, tr["trace_ticks"]) * n,
        memory_peak_bytes=peak)
