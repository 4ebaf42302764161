"""One camera: ``StreamingGenerator.stream``, the depth-1 pipeline the
serving CLI runs, closed loop.

The camera's seeded clip of ``clip_frames`` uint8 frames is fed, cycled,
to one ``StreamingGenerator`` as fast as it takes them: frame t is handed
over when the pipeline asks for it, and its uint8 output arrives on the
host after frame t + 1 was handed over.

- ``frames_per_s``: frames returned in the window (from the first
  hand-off to the last output) over its seconds.
- ``frame_p95_ms``: the 95th percentile, over every frame of the window,
  of the time from its hand-off to its output on the host.
- Checks: ``frame_rms16``, the worst of a seeded uniform sample of the
  window's frames (reservoir sampling) against the fp32 reference,
  compared in 16 x 16 blocks (``harness/frames.py``).
"""

from __future__ import annotations

import random

import torch

from benchmark.harness import core, frames, program, synth, weights
from benchmark.reference import gan, nets


class ControlStream:
    """The reference in the pipeline's place, at the control's
    precision."""

    def __init__(self, G: torch.nn.Module, device):
        self.G, self.device = G, device

    def stream(self, feed):
        for a in feed:
            x = torch.from_numpy(a[None]).to(self.device)
            yield frames.generate(self.G, x).cpu().numpy()[0]


def run(run: core.Run) -> core.Result:
    cfg, tr, dev = run.config, run.traffic, run.device
    length = tr["clip_frames"]
    size = program.crop_size(cfg, run.overrides)
    model_cfg = program.reference_model(cfg, run.overrides)
    # the program's role reads only the reference's shapes
    ref = gan.build(model_cfg, dev if run.role == "control" else "meta",
                    with_d=False)
    sds = weights.draw(ref, run.sub_seed("weights"), dev)
    clip = synth.clips(run.sub_seed("frames"), 1, length, size, dev
                       )[0].cpu().numpy()
    if run.role == "program":
        from ir2rgb_tpu_torch.infer import StreamingGenerator
        model = program.build(program.port_config(cfg, False, run.overrides),
                              dev, run.seed, sds)
        system = StreamingGenerator(model, (size, size))
    else:
        ref["netG"].load_state_dict(sds["netG"])
        system = ControlStream(nets.set_precision(ref["netG"], "fp8"), dev)
    if run.plant is not None:
        run.plant(system)
    sds = {k: {n: t.cpu() for n, t in sd.items()} for k, sd in sds.items()}
    for _ in system.stream(clip[:tr["warmup_frames"]]):
        pass
    run.sync()

    span, tracer = run.tracer.span, run.tracer
    handed, state = [], {"stop": False}

    def feed():
        i = 0
        while not state["stop"]:
            with span("prepare"):
                a = clip[i % length]
            handed.append(run.now())
            yield a
            i += 1

    sample = frames.Reservoir(tr["sample"], random.Random(
        run.sub_seed("sample")))
    lat_s, done = [], 0
    setup_s = run.setup_s()
    core.peak_reset(dev)
    tracer.start()
    outputs = system.stream(feed())
    while True:
        with span("call"):
            out = next(outputs, None)
            t_out = run.now()
        if out is None:
            break
        with span("read"):
            lat_s.append(t_out - handed[done])
            i = done
            sample.offer(lambda: dict(frame=clip[i % length], out=out.copy(),
                                      prev=None))
            done += 1
            if done == tr["trace_frames"]:
                tracer.stop(run.sync)
            if t_out - handed[0] >= run.seconds:
                state["stop"] = True
    tracer.stop(run.sync)
    window_s = t_out - handed[0]
    peak = core.peak_bytes(dev)
    del system, outputs
    if run.role == "program":
        del model
    core.free(dev)

    G = gan.build(model_cfg, dev, with_d=False)["netG"]
    G.load_state_dict(sds["netG"])
    with nets.no_tf32():
        gaps = {"frame": frames.worst_gaps(G, sample.items, 0, dev,
                                           tr["reference_block"])}
    checks, extra = frames.checks(gaps, run.limits)
    return core.Result(
        metrics={"setup_s": setup_s, "frames_per_s": done / window_s,
                 "frame_p95_ms": core.p95(lat_s) * 1e3},
        attempted=len(handed), failed=len(handed) - done, checks=checks,
        extra=extra,
        units_traced=min(done, tr["trace_frames"]),
        memory_peak_bytes=peak)
