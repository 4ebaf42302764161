"""Run checkpoints on ``torch.save`` — the port of
``ir2rgb_tpu/checkpoint/manager.py`` (Orbax there).

A checkpoint is one file per step, ``<dir>/<step>.pt``, holding a nested
dict of tensors and plain values (the trainer saves everything the train
step reads: G, D, both Adam states, the step, the random state and the
pool). It is read back with ``torch.load(weights_only=True)``, so a
checkpoint file cannot run code.

Kept from the JAX manager: ``max_to_keep`` retention with the steps that
an epoch label names pinned, the ``epochs.json`` labels (``record_epoch``,
``step_for_label``), ``delete_after`` (a resume from an older epoch forks
the run), ``clear`` (a fresh run), and asynchronous saves.

Three rules make an asynchronous save safe:

- ``save`` copies every tensor of the state to host memory before it
  returns. The optimizer's step changes parameters in place, so a writer
  that read the live tensors later would write a later step's weights.
- The writer thread writes to a temporary name and ``os.replace``\\ s it
  into place, so a crash leaves no half-written step for
  ``latest_step`` to pick.
- An epoch label for the step being written reaches ``epochs.json`` only
  once that step is on disk, so a failed write leaves no label naming a
  step that does not exist.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
from typing import Any, List, Optional

import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"{int(step)}.pt")


def snapshot(state: Any) -> Any:
    """``state`` with every tensor copied to host memory (a CPU tensor is
    cloned too), so later in-place updates of the live tensors do not
    reach it."""
    if isinstance(state, torch.Tensor):
        t = state.detach()
        return t.to("cpu") if t.device.type != "cpu" else t.clone()
    if isinstance(state, dict):
        return {k: snapshot(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(snapshot(v) for v in state)
    return state


def _write(path: str, state: Any) -> None:
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """Numbered checkpoints in one directory, with reference-style epoch
    labels ('latest' is the newest step)."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[int] = None
        self._pending_labels: dict = {}  # epoch -> the pending step
        self._error: Optional[BaseException] = None

    # -- saving ---------------------------------------------------------

    def save(self, step: int, state: Any) -> None:
        """Save ``state`` as ``step``: copied to host memory now, written
        in the background (``wait`` for it)."""
        self.wait()
        snap = snapshot(state)
        path = _step_path(self._dir, step)

        def run():
            try:
                _write(path, snap)
            except BaseException as e:  # raised by the next wait()
                self._error = e

        self._pending = int(step)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the pending save is on disk (raising its error),
        then record its epoch labels and apply retention."""
        if self._thread is not None:
            self._thread.join()
            self._thread, self._pending = None, None
        labels, self._pending_labels = self._pending_labels, {}
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if labels:
            self._write_labels({**self._labels(), **labels})
        self._gc()

    def close(self) -> None:
        self.wait()

    def _gc(self) -> None:
        """Keep the newest ``max_to_keep`` steps and every labelled one."""
        labelled = {int(s) for s in self._labels().values()}
        steps = self._disk_steps()
        for s in steps[:max(len(steps) - self._max_to_keep, 0)]:
            if s not in labelled:
                os.remove(_step_path(self._dir, s))

    # -- reading --------------------------------------------------------

    def _disk_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self._dir)) if m)

    def all_steps(self) -> List[int]:
        """Every saved step, the one being written included."""
        steps = set(self._disk_steps())
        if self._pending is not None:
            steps.add(self._pending)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Any:
        """The state saved as ``step`` (the latest when None), tensors on
        the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        if step == self._pending:
            self.wait()
        return _load(_step_path(self._dir, step))

    # -- forks and fresh runs -------------------------------------------

    def delete_after(self, step: int) -> None:
        """Drop checkpoints (and epoch labels) newer than ``step`` — a
        resume from a non-latest epoch starts a new trajectory. The
        dropped steps are logged first: a mistyped which_epoch otherwise
        destroys later training history with no trace."""
        self.wait()
        newer = [s for s in self._disk_steps() if s > step]
        if newer:
            logging.getLogger(__name__).warning(
                "checkpoint: resuming from step %d FORKS the run — "
                "permanently deleting %d newer checkpoint(s) %s from %s",
                step, len(newer), newer, self._dir)
        for s in newer:
            os.remove(_step_path(self._dir, s))
        if os.path.exists(self._epochs_path()):
            self._write_labels({e: s for e, s in self._labels().items()
                                if int(s) <= step})

    def clear(self) -> None:
        """Delete every step and the epoch index (a fresh run into an
        existing directory overwrites it, as the reference does)."""
        self.wait()
        for s in self._disk_steps():
            os.remove(_step_path(self._dir, s))
        if os.path.exists(self._epochs_path()):
            os.remove(self._epochs_path())

    # -- epoch labels (reference --which_epoch) -------------------------

    def _epochs_path(self) -> str:
        return os.path.join(self._dir, "epochs.json")

    def _labels(self) -> dict:
        if not os.path.exists(self._epochs_path()):
            return {}
        with open(self._epochs_path()) as fh:
            return json.load(fh)

    def _write_labels(self, labels: dict) -> None:
        tmp = self._epochs_path() + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(labels, fh, indent=0, sort_keys=True)
        os.replace(tmp, self._epochs_path())

    def record_epoch(self, epoch: int, step: int) -> None:
        """Remember that ``step`` is the end of ``epoch`` (once the step
        is on disk, if it is still being written)."""
        if step == self._pending:
            self._pending_labels[str(epoch)] = int(step)
            return
        labels = self._labels()
        labels[str(epoch)] = int(step)
        self._write_labels(labels)

    def step_for_label(self, label: str) -> Optional[int]:
        """A ``which_epoch`` label ('latest', an epoch number or a saved
        step) -> its step. None for 'latest' with no checkpoints; raises
        for a label that was never saved."""
        if label in ("latest", "", None):
            return self.latest_step()
        if self._pending_labels:
            self.wait()
        labels = self._labels()
        if str(label) in labels:
            return int(labels[str(label)])
        try:
            step = int(label)
        except ValueError:
            step = None
        if step is not None and step in self.all_steps():
            return step
        raise FileNotFoundError(
            f"which_epoch={label!r} not found in {self._dir}; "
            f"epochs recorded: {sorted(labels)}; steps: "
            f"{self.all_steps()}")


def save_train_state(directory: str, step: int, state: Any) -> None:
    """One-shot synchronous save (no retention)."""
    os.makedirs(directory, exist_ok=True)
    _write(_step_path(os.path.abspath(directory), step), snapshot(state))


def restore_train_state(directory: str, step: int) -> Any:
    return _load(_step_path(os.path.abspath(directory), step))
