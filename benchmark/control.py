"""Readings of a cell's compared numbers over many seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--role control|program] [--seconds 3]

``--role control`` (the default) puts the plain reference in the
program's place at the precision below the configuration's (bf16 ->
fp8: every conv's input and weight rounded to e4m3), ``--role
program`` runs the program; each seed runs the cell's
set-up, a window of ``--seconds`` at the cell's own load and its
comparison. One JSON line a seed: its checks, each with the cell's limit,
and whether they pass. The limits in ``checks/<cell>.json`` are set from
these readings: above the program's highest, below the control's lowest.

Needs the card the cell asks for; the tests run the same at narrow
widths on the CPU (``tests/test_benchmark_control.py``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seeds, role: str, seconds: float, device,
             overrides=None, plant=None):
    """One dict a seed: the seed, the role, whether it passed, the checks
    and (for the program) the end-to-end metrics."""
    from benchmark.run import execute
    out = []
    for seed in seeds:
        res, _ = execute(cell, seed, seconds, False, device,
                         time.perf_counter(), role=role, overrides=overrides,
                         plant=plant)
        out.append({"seed": seed, "role": role, "correct": res.correct,
                    "checks": {k: {"value": v, "limit": lim}
                               for k, (v, lim) in res.checks.items()},
                    "extra": res.extra, "metrics": res.metrics})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--role", choices=("control", "program"),
                    default="control")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cells
    cell = cells.load(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for row in readings(cell, seeds, args.role, args.seconds,
                        torch.device("cuda", 0)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
