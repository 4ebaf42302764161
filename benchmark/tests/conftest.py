"""The benchmark's own tests, on the CPU at narrow widths.

    python3 -m pytest benchmark/tests -q -p no:randomly

A test that needs a CUDA card is marked ``card`` and skips, with its
reason, where there is none: it decides inside the test, never while the
module is imported.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the narrow model the CPU tests run every cell at
TINY = {"model": {"ngf": 4, "n_blocks_global": 1, "n_blocks_local": 1,
                  "n_downsample_global": 2, "ndf": 8},
        "crop_size": 32}
# the published widths and depths on 128-px frames: the size at which the
# limits hold the control and the faults apart on the CPU (PERF.md §2)
WIDE = {"crop_size": 128}
# and fewer cameras, so that a tick fits a test
FEW = {"streams": 4, "warmup_ticks": 1, "warmup_frames": 2}


def load_cell(name: str):
    from benchmark.harness import cells
    return cells.load(ROOT, name)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips "
                            "without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
