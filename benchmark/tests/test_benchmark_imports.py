"""Nothing the benchmark runs imports ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``ir2rgb_tpu``, compared by whole top-level name (the
port, ``ir2rgb_tpu_torch``, begins with the JAX package's name), and the
reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from benchmark.run import FORBIDDEN
from benchmark.tests.conftest import ROOT

SOURCES = sorted((ROOT / "benchmark").rglob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_source_imports_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark/reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "contextlib", "typing",
                                   "torch"}


def test_a_run_loads_no_jax():
    """The harness, every driver and the program's entry points, loaded
    as a run loads them."""
    probe = ("import sys; sys.path.insert(0, '.'); "
             "from benchmark import run, control; "
             "from benchmark.harness import cells; "
             "[cells.driver(d) for d in ('streams', 'stream')]; "
             "from ir2rgb_tpu_torch.infer import MultiStreamServer, "
             "StreamingGenerator; "
             "from ir2rgb_tpu_torch.train import create_model; "
             "print(','.join(run.forbidden_modules()))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""
