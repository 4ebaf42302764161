"""The comparison that decides ``correct`` fails what it must: the
control (the reference at fp8 in the program's place) and each fault a
cell can have, planted underneath the timed path, read ``correct``
false against the cell's own limits. The faults: a step that returns its
state unchanged, half of the batch left out, an answer altered where it
is produced (a batch-1 cell has no half to leave out; one card has no
exchange between chips).

On the CPU at the published widths on 128-px frames, four cameras a
tick; on a card, the control at the cell's own size on three seeds
(``card``)."""

import time

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.harness import cells
from benchmark.run import execute
from benchmark.tests.conftest import FEW, ROOT, WIDE, load_cell

CPU = torch.device("cpu")
CELLS = ["temporal_512.cams16", "pix2pixhd_1024.cam1"]


def _run(name, plant=None, role="program"):
    cell = load_cell(name)
    cell.traffic = {**cell.traffic, **FEW}
    res, _ = execute(cell, 2**31 + 101, 2.5, False, CPU, time.perf_counter(),
                     role=role, overrides=WIDE, plant=plant)
    return res


def carry_unchanged(server):
    tick = server._tick

    def frozen(frames, carry, reset, valid):
        out, _ = tick(frames, carry, reset, valid)
        return out, carry
    server._tick = frozen


def half_batch(server):
    tick = server._tick

    def half(frames, carry, reset, valid):
        h = frames.shape[0] // 2
        out, new = tick(frames[:h], carry[:h], reset[:h], valid[:h])
        return torch.cat([out, out]), torch.cat([new, carry[h:]])
    server._tick = half


def altered_steps(server):
    step = server.step

    def altered(frames):
        return {s: 255 - o for s, o in step(frames).items()}
    server.step = altered


def altered_stream(gen):
    stream = gen.stream

    def altered(feed):
        for out in stream(feed):
            yield np.ascontiguousarray(255 - out)
    gen.stream = altered


FAULTS = [("temporal_512.cams16", carry_unchanged),
          ("temporal_512.cams16", half_batch),
          ("temporal_512.cams16", altered_steps),
          ("pix2pixhd_1024.cam1", altered_stream)]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = _run(name, role="control")
    assert not res.correct, res.checks


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_fault_is_not_correct(name, fault):
    res = _run(name, plant=fault)
    assert not res.correct, res.checks


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_at_full_size_is_not_correct(card, name):
    rows = control.readings(cells.load(ROOT, name), [7, 8, 9], "control",
                            3.0, card)
    assert not any(r["correct"] for r in rows), rows
