"""Run one cell of the benchmark of ``ir2rgb_tpu_torch`` on this machine's
card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Set-up (weights and inputs from the seed,
the program built, every shape warmed up), then a window of ``--seconds``,
then the comparison of what the window produced with the plain reference
(``benchmark/reference/``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window's first units), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also close standard error.

Exits 2 without a result where there is no CUDA card (or fewer than the
cell asks for), and 3 where ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``ir2rgb_tpu`` was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# compared by whole top-level name: ir2rgb_tpu_torch is not ir2rgb_tpu
FORBIDDEN = {"jax", "jaxlib", "flax", "ir2rgb_tpu"}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell, seed: int, seconds: float, trace: bool, device, t0: float,
            role: str = "program", overrides=None, plant=None):
    """Run ``cell`` (``harness.cells.Cell``) on ``device``: the driver's
    Result, and its trace (None untraced)."""
    from benchmark.harness import cells
    from benchmark.harness.core import Run
    from benchmark.harness.trace import Tracer
    tracer = Tracer(trace)
    run = Run(cell=cell.name, config=cell.config, traffic=cell.traffic,
              limits=cell.limits, seed=seed, seconds=seconds, device=device,
              t0=t0, tracer=tracer, role=role, overrides=overrides,
              plant=plant)
    result = cells.driver(cell.traffic["driver"]).run(run)
    return result, tracer.trace


def per_layer(cell, result, trace, device_name: str):
    """The cell's per-layer metrics its readers find in ``trace``."""
    from benchmark.harness import cells, peaks, work
    from benchmark.harness.metrics import Context
    ctx = Context(trace=trace, units=result.units_traced,
                  work=work.summary(cell.config, cell.traffic["work"]),
                  peaks=peaks.peaks(device_name))
    out = {}
    for name in cell.per_layer:
        value = cells.reader(cell.here, name)(ctx)
        if value is not None:
            out[name] = value
    return out


def record(cell, result, trace, trace_on: bool, device_name: str,
           power_w: float) -> dict:
    values = (per_layer(cell, result, trace, device_name) if trace_on
              else {k: result.metrics[k] for k in cell.end_to_end})
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": result.memory_peak_bytes,
              "power_limit_w": power_w if math.isfinite(power_w) else None}
    out = {"correct": result.correct, "attempted": result.attempted,
           "failed": result.failed,
           "metrics": {k: {"value": v, "unit": cell.units[k]}
                       for k, v in values.items()},
           "device": device}
    if trace_on and trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.top_ops(10),
                            "idle_gaps": trace.idle_gaps(10)}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in result.checks.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    # every build and kernel cache of the run stays inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cells, peaks
    cell = cells.load(ROOT, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload}: needs {cell.chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; the benchmark does not run on the CPU", file=sys.stderr)
        return 2
    import ir2rgb_tpu_torch  # noqa: F401  (the system under test)
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(device)
    result, trace = execute(cell, args.seed, args.seconds, bool(args.trace),
                            device, T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark "
              "runs the PyTorch port alone", file=sys.stderr)
        return 3
    out = record(cell, result, trace, bool(args.trace), name,
                 peaks.power_limit_w())
    for k, v in result.extra.items():
        print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
