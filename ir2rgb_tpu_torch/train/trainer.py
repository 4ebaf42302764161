"""Training driver — the port of ``ir2rgb_tpu/train/trainer.py``.

``Trainer`` runs the reference's epoch/step loop around
``GanModel.train_step`` on one device: ``print_freq`` loss lines (the
window's metrics read back in one host sync), ``display_freq`` image
dumps through the serving forward, ``save_latest_freq`` and per-epoch
checkpoints (``checkpoint/manager.py``), a fresh run that clears the
run's old checkpoints, ``continue_train`` resume at ``which_epoch``, and
the ``load_pretrain`` warm start (a tolerant partial load of every
network, which also grafts a global generator into a local enhancer's
trunk, and restarts the EMA shadow from the loaded weights).

Data-parallel, spatial and multi-host training are not ported: the
trainer raises for them before any step.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Iterable, Optional

import torch
import torch.nn as nn

from ir2rgb_tpu_torch.checkpoint import CheckpointManager
from ir2rgb_tpu_torch.config import Config, save_config
from ir2rgb_tpu_torch.train.model import GanModel

log = logging.getLogger(__name__)


def _partial_merge(net: nn.Module, src: Dict[str, torch.Tensor],
                   name: str) -> None:
    """The reference BaseModel's tolerant load: copy every entry of
    ``src`` whose key exists in ``net``'s state_dict with the same shape
    (cast to the destination's dtype), keep the fresh init elsewhere, and
    log a summary; never raise on a mismatch. A global generator's
    ``model.*`` keys land on a local enhancer's trunk (``model``, the
    same layers without the output head), so the pix2pixHD coarse-to-fine
    warm start is this load."""
    dst = net.state_dict()
    merged, copied, skipped = {}, [], []
    for k, d in dst.items():
        s = src.get(k)
        if s is not None and tuple(s.shape) == tuple(d.shape):
            merged[k] = s.to(d.dtype)
            copied.append(k)
        else:
            merged[k] = d
            skipped.append(f"{k} (missing in pretrain)" if s is None else
                           f"{k} (shape {tuple(s.shape)} vs "
                           f"{tuple(d.shape)})")
    net.load_state_dict(merged)
    if skipped:
        log.warning("load_pretrain %s: partial load — %d entries copied, "
                    "%d kept fresh: %s%s", name, len(copied), len(skipped),
                    "; ".join(skipped[:8]),
                    " ..." if len(skipped) > 8 else "")
    else:
        log.info("load_pretrain %s: all %d entries loaded", name,
                 len(copied))


class Trainer:
    def __init__(self, model: GanModel, cfg: Config, visualizer=None):
        tcfg = cfg.train
        # num_devices 0 means every visible device, as in the JAX package
        devices = tcfg.num_devices or (torch.cuda.device_count()
                                       if model.device.type == "cuda" else 1)
        unported = {f"{devices} devices (data parallel; pass "
                    "--train.num_devices 1 for one)": devices > 1,
                    "spatial_devices > 1": tcfg.spatial_devices > 1,
                    "multihost": tcfg.multihost}
        for what, bad in unported.items():
            if bad:
                raise NotImplementedError(
                    f"training with {what} is not ported yet; the port "
                    "trains on one device")
        self.model = model
        self.cfg = cfg
        self.visualizer = visualizer
        run_dir = cfg.run_dir()
        os.makedirs(run_dir, exist_ok=True)
        save_config(cfg, os.path.join(run_dir, "config.json"))
        self.ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
        if not tcfg.continue_train:
            # a fresh run into an existing directory overwrites it, as the
            # reference does; say what goes (a forgotten continue_train or
            # a run-name typo should leave a trace)
            existing = self.ckpt.all_steps()
            if existing:
                log.warning(
                    "fresh run (no --continue_train) into %s: deleting %d "
                    "existing checkpoint step(s) %s and the epoch index — "
                    "pass --train.continue_train true to resume instead",
                    run_dir, len(existing), existing)
            self.ckpt.clear()
        self._last_saved: Optional[int] = None

    # ------------------------------------------------------------------

    def init_or_restore(self) -> None:
        """Warm-start from ``load_pretrain`` (G and D weights only; fresh
        optimizers, step and random state), then with ``continue_train``
        restore everything from ``which_epoch``. A resume from an older
        step than the run's newest forks it: the later checkpoints go."""
        tcfg = self.cfg.train
        if tcfg.load_pretrain:
            src = CheckpointManager(os.path.join(tcfg.load_pretrain,
                                                 "ckpt")).restore()
            model = self.model
            for name, net in (*model.g_nets().items(),
                              *model.d_nets().items()):
                _partial_merge(net, src.get(name, {}),
                               name[3:].replace("_", "."))
            if model.ema is not None:
                # the EMA tracks the warm-started weights, not the fresh
                # init it started from
                model.init_ema()
        if tcfg.continue_train:
            step = self.ckpt.step_for_label(tcfg.which_epoch)
            if step is not None:
                self.model.load_state_dict(self.ckpt.restore(step))
                if any(s > step for s in self.ckpt.all_steps()):
                    self.ckpt.delete_after(step)

    # ------------------------------------------------------------------

    def fit(self, data: Iterable[Dict[str, Any]],
            total_steps: Optional[int] = None) -> None:
        """Train over an iterable of device batches until ``total_steps``
        (the config's epochs when None), with the reference's cadence."""
        tcfg = self.cfg.train
        steps_per_epoch = self.model.steps_per_epoch
        if total_steps is None:
            total_steps = (tcfg.niter + tcfg.niter_decay) * steps_per_epoch
        t0 = time.time()
        window = []
        step = self.model.step
        for batch in data:
            if step >= total_steps:
                break
            metrics = self.model.train_step(batch)
            step += 1
            window.append(metrics)
            if step % tcfg.print_freq == 0:
                # one device->host read for the whole window
                names = sorted(window[0])  # JAX's pytree order
                host = torch.stack([torch.stack([m[k].float()
                                                 for k in names])
                                    for m in window]).cpu()
                dt = (time.time() - t0) / len(window)
                avg = dict(zip(names, host.mean(dim=0).tolist()))
                epoch = (step - 1) // steps_per_epoch + 1
                if self.visualizer is not None:
                    self.visualizer.print_current_errors(epoch, step, avg, dt)
                window.clear()
                t0 = time.time()
            if (self.visualizer is not None
                    and step % tcfg.display_freq == 0):
                self._display(batch, step)
            if step % tcfg.save_latest_freq == 0:
                self._save(step)
            if step % steps_per_epoch == 0:
                epoch = step // steps_per_epoch
                if epoch % tcfg.save_epoch_freq == 0:
                    self._save(step)
                    self.ckpt.record_epoch(epoch, step)
        # final save, unless the step is on disk already (a completed run
        # relaunched with continue_train)
        if step not in self.ckpt.all_steps():
            self._save(step)
        self.ckpt.wait()
        if self.visualizer is not None:
            self.visualizer.flush()

    def _save(self, step: int) -> None:
        """Save once per step (a step can land on both cadences)."""
        if step == self._last_saved:
            return
        self.ckpt.save(step, self.model.state_dict())
        self._last_saved = step

    def _display(self, batch: Dict[str, torch.Tensor], step: int) -> None:
        """The display hook: sample 0's input, generated and target frames
        (the first frame of a window), generated by the serving forward
        (``generate``) and conditioned as training is (instance edges)."""
        from ir2rgb_tpu_torch.infer.stream import label2im, tensor2im
        from ir2rgb_tpu_torch.nn.encoders import instance_edges
        model = self.model
        a, b = batch["a"], batch["b"]
        if a.ndim == 5:
            a, b = a[:, 0], b[:, 0]
        a, b = a[:1], b[:1]
        edges = None
        if "inst" in batch and self.cfg.model.use_instance_edges:
            edges = instance_edges(batch["inst"][:1].to(model.device))
        fake = model.generate(a.to(model.device), edges=edges)
        epoch = (step - 1) // model.steps_per_epoch + 1
        label_nc = self.cfg.model.label_nc
        self.visualizer.display_current_results(
            {"input": label2im(a, label_nc) if label_nc > 0 else tensor2im(a),
             "generated": tensor2im(fake), "target": tensor2im(b)},
            epoch, step)
