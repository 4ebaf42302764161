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

Data-parallel training, on one host or several, runs over the mesh of
``parallel/``: the trainer builds it from ``train.num_devices`` (0: the
process group's world size; more than one card without a group raises,
naming ``torchrun``), brings the group up for ``train.multihost``
(``multihost.initialize(require=True)``) and replicates rank 0's state
after every restore. Only rank 0 does the run's I/O (``config.json``, the
fresh run's clear, checkpoints and the epoch index, loss lines, display
images); the other ranks wait at a barrier where they read what rank 0
wrote. Every rank restores the same files.

Spatially partitioned training (``train.spatial_devices`` S > 1) runs on
``dp_sp_mesh(train.num_devices, S)``, as JAX's trainer builds it: a group
of dp·S processes, each S ranks of a data row reading the same images
(the same crop and flip) and keeping their rows of them
(``model.train_step`` runs partitioned, ``parallel/spatial.py``),
temporal windows (their rows over dim 2), ``remat``, WGAN-GP and
CycleGAN (its ``a`` and ``b`` domains' blocks, its two pools whole on
every rank) included. I/O stays on rank 0, whose checkpoint holds every
network and pool whole; the display gathers the frame first
(``spatial.gather_block``; a window's first frame), on every rank. What
such a step does not cover (netE and instance edges, the U-Net) raises
before any collective (``model.spatial_train_refusal``, ROADMAP A16b).
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
from ir2rgb_tpu_torch.parallel import (
    data_parallel_mesh,
    dp_sp_mesh,
    multihost,
    replicate,
    spatial,
)
from ir2rgb_tpu_torch.train.model import GanModel, spatial_train_refusal

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
        if tcfg.spatial_devices > 1:
            spatial_train_refusal(cfg)
        if tcfg.multihost:
            multihost.initialize(require=True)
        if tcfg.spatial_devices > 1:
            self.mesh = dp_sp_mesh(tcfg.num_devices, tcfg.spatial_devices,
                                   device=model.device)
        else:
            self.mesh = data_parallel_mesh(tcfg.num_devices,
                                           device=model.device)
        self.writer = self.mesh.rank == 0
        self.model = model
        self.cfg = cfg
        self.visualizer = visualizer if self.writer else None
        run_dir = cfg.run_dir()
        ckpt_dir = os.path.join(run_dir, "ckpt")
        if self.writer:
            os.makedirs(run_dir, exist_ok=True)
            save_config(cfg, os.path.join(run_dir, "config.json"))
            self.ckpt = CheckpointManager(ckpt_dir)
            if not tcfg.continue_train:
                # a fresh run into an existing directory overwrites it, as
                # the reference does; say what goes (a forgotten
                # continue_train or a run-name typo should leave a trace)
                existing = self.ckpt.all_steps()
                if existing:
                    log.warning(
                        "fresh run (no --continue_train) into %s: deleting "
                        "%d existing checkpoint step(s) %s and the epoch "
                        "index — pass --train.continue_train true to resume "
                        "instead", run_dir, len(existing), existing)
                self.ckpt.clear()
        # the other ranks read the directory rank 0 made and cleared
        self.mesh.barrier()
        if not self.writer:
            self.ckpt = CheckpointManager(ckpt_dir)
        replicate(model, self.mesh)
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
                # every rank has read the files before rank 0 forks them
                self.mesh.barrier()
                if self.writer and any(s > step
                                       for s in self.ckpt.all_steps()):
                    self.ckpt.delete_after(step)
        replicate(self.model, self.mesh)

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
            if step % tcfg.display_freq == 0:
                self.display(batch, step)
            if step % tcfg.save_latest_freq == 0:
                self._save(step)
            if step % steps_per_epoch == 0:
                epoch = step // steps_per_epoch
                if epoch % tcfg.save_epoch_freq == 0:
                    self._save(step)
                    if self.writer:
                        self.ckpt.record_epoch(epoch, step)
        if self.writer:
            # final save, unless the step is on disk already (a completed
            # run relaunched with continue_train)
            if step not in self.ckpt.all_steps():
                self._save(step)
            self.ckpt.wait()
        # a restore on any rank reads what rank 0 has just written
        self.mesh.barrier()
        if self.visualizer is not None:
            self.visualizer.flush()

    def _save(self, step: int) -> None:
        """Save once per step (a step can land on both cadences); rank 0
        alone writes."""
        if step == self._last_saved or not self.writer:
            return
        self.ckpt.save(step, self.model.state_dict())
        self._last_saved = step

    def display(self, batch: Dict[str, torch.Tensor], step: int) -> None:
        """The display hook, called on every rank: on a dp×sp mesh the
        frames of ``batch`` (this rank's block) are gathered whole first,
        on every rank; then rank 0, where it has a visualizer, shows them
        (:meth:`_display`)."""
        if self.mesh.sp > 1:
            batch = {k: spatial.gather_block(batch[k], self.mesh)
                     for k in ("a", "b")}
        if self.visualizer is not None:
            self._display(batch, step)

    def _display(self, batch: Dict[str, torch.Tensor], step: int) -> None:
        """Sample 0's input, generated and target frames (the first frame
        of a window), generated by the serving forward (``generate``, one
        process's forward of the whole frame) and conditioned as training
        is: the edge channel and netE's style of the real target, where
        the batch has instance maps (``trainer.py:120-135`` of the JAX
        package)."""
        from ir2rgb_tpu_torch.infer.stream import label2im, tensor2im
        from ir2rgb_tpu_torch.nn.encoders import instance_edges
        model = self.model
        a, b = batch["a"], batch["b"]
        if a.ndim == 5:
            a, b = a[:, 0], b[:, 0]
        a, b = a[:1], b[:1]
        edges = feat = None
        if "inst" in batch:
            inst = batch["inst"][:1].to(model.device)
            if self.cfg.model.use_instance_edges:
                edges = instance_edges(inst)
            if model.netE is not None:
                feat = model.encode_features(b, inst)
        fake = model.generate(a.to(model.device), edges=edges, feat=feat)
        epoch = (step - 1) // model.steps_per_epoch + 1
        label_nc = self.cfg.model.label_nc
        self.visualizer.display_current_results(
            {"input": label2im(a, label_nc) if label_nc > 0 else tensor2im(a),
             "generated": tensor2im(fake), "target": tensor2im(b)},
            epoch, step)
