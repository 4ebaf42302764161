"""The harness finds every piece by name, a cell added as files runs
without an edit, the work arithmetic matches a hand count, the trace
reduction and the readers, and ``run.py``'s refusals."""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import run as brun
from benchmark.harness import cells, frames, trace, work
from benchmark.harness.metrics import Context
from benchmark.tests.conftest import ROOT, TINY
from benchmark.tools import layer_list

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = cells.load(ROOT, name)
    assert cells.driver(cell.traffic["driver"]).run
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for metric in cell.per_layer:
        assert callable(cells.reader(cell.here, metric))


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reads_nothing_from_an_empty_trace(metric):
    read = cells.reader(ROOT / "benchmark", metric)
    empty = trace.Trace((0.0, 1e6), [], [])
    ctx = Context(trace=empty, units=10, work={"flops": 1.0, "b1_bytes": 1.0},
                  peaks={"bf16_flops": 1.0, "hbm_bytes_per_s": 1.0})
    assert read(ctx) is None
    assert read(Context(None, 0, ctx.work, ctx.peaks)) is None


def test_bench_file_is_within_its_contract():
    names = ([m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + CELLS + [c["name"] for c in BENCH["configs"]])
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert c["source"] == cfg["source"]
    assert all(e["bound"] <= 0.25 for e in BENCH["end_to_end"])


def test_added_cell_runs_without_edits(tmp_path):
    """A new traffic mix, its limits and a BENCHMARK.json entry: files and
    an entry added, none edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "temporal_512.cams2",
                               "config": "temporal_512", "traffic": "cams2",
                               "chips": 1, "why": "two cameras"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "temporal_512.cams16" in m.get("workloads", ()):
            m["workloads"].append("temporal_512.cams2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "benchmark/traffic/cams16.json").read_text())
    traffic.update(streams=2, trace_ticks=3)
    (tmp_path / "benchmark/traffic/cams2.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "benchmark/checks/temporal_512.cams16.json",
                tmp_path / "benchmark/checks/temporal_512.cams2.json")
    cell = cells.load(tmp_path, "temporal_512.cams2")
    res, tr = brun.execute(cell, 2**31 + 11, 0.5, True, torch.device("cpu"),
                           time.perf_counter(), overrides=TINY)
    assert res.attempted % 2 == 0 and res.units_traced == 6
    rec = brun.record(cell, res, tr, True, "NVIDIA H100 80GB HBM3",
                      float("nan"))
    assert list(rec)[-1] == "checks" and tr.window_s > 0


def _hand_flops_g(size):
    """A local enhancer at ngf 2 (trunk 4), 1 down, 1 block each, input 3,
    by hand: conv MACs = out pixels * k^2 * cin * cout, transposed conv
    MACs = in pixels * k^2 * cin * cout."""
    h, q = size // 2, size // 4  # trunk at half size; its one down
    trunk = (h * h * 49 * 3 * 4          # c7s1-4
             + q * q * 9 * 4 * 8         # down to 8
             + 2 * q * q * 9 * 8 * 8     # one block
             + q * q * 9 * 8 * 4)        # up: input pixels
    enh = (size * size * 49 * 3 * 2      # c7s1-2
           + h * h * 9 * 2 * 4           # down to 4
           + 2 * h * h * 9 * 4 * 4       # one block
           + h * h * 9 * 4 * 2           # up
           + size * size * 49 * 2 * 3)   # tail
    return 2 * (trunk + enh)


def test_flops_and_b1_bytes_match_a_hand_count():
    model = {"model": "pix2pixhd", "net_g": "local", "input_nc": 3,
             "output_nc": 3, "ngf": 2, "n_downsample_global": 1,
             "n_blocks_global": 1, "n_blocks_local": 1, "n_local_enhancers": 1,
             "ndf": 4, "n_layers_d": 3, "num_d": 2, "n_frames_g": 2,
             "compute_dtype": "bf16"}
    size = 16
    cfg = {"model": model, "layers": layer_list.layer_list(model, size),
           "passes": {"serve": {"G": {"fwd": 1, "norm_fwd": 1}},
                      "train": {"G": {"fwd": 1, "wgrad": 1, "dgrad": 1,
                                      "dgrad_input": 0}}}}
    g = _hand_flops_g(size)
    assert work.flops(cfg, "serve") == g
    # backward: both weight and input gradients but the two input convs'
    h = size // 2
    inputs = 2 * (h * h * 49 * 3 * 4 + size * size * 49 * 3 * 2)
    assert work.flops(cfg, "train") == 3 * g - inputs
    q = size // 4
    norm_elems = (h * h * 4 + q * q * 8 + 2 * q * q * 8 + h * h * 4     # trunk
                  + size * size * 2 + h * h * 4 + 2 * h * h * 4
                  + size * size * 2)                                    # enh.
    assert work.b1_bytes(cfg, "serve") == 2 * 2 * norm_elems


@pytest.mark.parametrize("name", ["temporal_512", "pix2pixhd_1024"])
def test_committed_layer_lists_are_the_references(name):
    cfg = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    assert cfg["layers"] == layer_list.layer_list(cfg["model"],
                                                  cfg["crop_size"])


def test_trace_reduction():
    ops = [("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("copy", 50.0, 60.0)]
    spans = [("window", 0.0, 100.0), ("call", 5.0, 40.0),
             ("read", 40.0, 45.0), ("prepare", 60.0, 100.0)]
    t = trace.Trace((0.0, 100.0), ops, spans)
    assert t.busy_s == pytest.approx(30e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert t.op_seconds(("k",)) == pytest.approx(25e-6)
    assert t.top_ops(2) == [["k2", 15e-6], ["k1", 10e-6]]
    assert t.idle_gaps(3) == [["prepare", 40e-6], ["call", 20e-6],
                              ["none", 10e-6]]


def test_readers_arithmetic():
    t = trace.Trace((0.0, 2e6), [("in_fwd_kernel<bf16>", 0.0, 1e5),
                                 ("gemm", 1e5, 1e6)], [])
    ctx = Context(trace=t, units=4, work={"flops": 1e12, "b1_bytes": 1e9},
                  peaks={"bf16_flops": 1e13, "hbm_bytes_per_s": 1e11})
    read = lambda m: cells.reader(ROOT / "benchmark", m)(ctx)  # noqa: E731
    assert read("mfu.serve") == pytest.approx(100 * 4e12 / 2 / 1e13)
    assert read("b1_roofline.serve") == pytest.approx(100 * 0.04 / 0.1)
    assert read("idle_share.serve") == pytest.approx(50.0)
    assert read("launches_per_frame.serve") == pytest.approx(0.5)


def test_forbidden_modules_are_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ir2rgb_tpu_torch_probe", sys)
    assert brun.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ir2rgb_tpu.probe", sys)
    assert brun.forbidden_modules() == ["ir2rgb_tpu"]


def test_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = brun.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_run_refuses_in_a_bare_checkout(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files:
    no program to run, so no result, even where a card is claimed."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    claim = ("import runpy, sys, torch; "
             "torch.cuda.is_available = lambda: True; "
             "torch.cuda.device_count = lambda: 1; "
             "torch.cuda.get_device_name = lambda *a: 'NVIDIA H100'; "
             f"sys.argv = ['run.py', '--workload', '{CELLS[0]}', "
             "'--seed', '1', '--seconds', '1']; "
             "runpy.run_path('benchmark/run.py', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", claim], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "No module named 'ir2rgb_tpu_torch'" in proc.stderr


def test_frame_gaps_in_blocks():
    """A uniform gap reads the same at every resolution; a +-1
    checkerboard reads 1 pixel by pixel and nothing in blocks."""
    a = np.full((64, 64, 3), 100, np.uint8)
    assert frames.stats(a + 2, a) == {"rms": 2.0, "rms4": 2.0, "rms16": 2.0,
                                      "rms64": 2.0}
    board = (np.indices((64, 64)).sum(0) % 2 * 2 - 1)[..., None]
    got = frames.stats((a + board).astype(np.uint8), a)
    assert got["rms"] == 1.0 and got["rms4"] == got["rms64"] == 0.0
    assert set(frames.stats(a[:32, :32], a[:32, :32])) == {"rms", "rms4",
                                                          "rms16"}
