"""Training entry point of the port — ``python -m
ir2rgb_tpu_torch.cli.train``, the counterpart of ``ir2rgb_tpu/cli/train.py``.

Example:
    python -m ir2rgb_tpu_torch.cli.train --preset pix2pixhd_512 \\
        --data.dataroot /data/ir2rgb --train.name run1

It runs on the CUDA device; ``--device cpu`` runs the port's plain
PyTorch path on the CPU. An fp32 model (the presets' default) trains with
its convolutions in true fp32 (TF32 off), as the JAX package runs f32
convolutions at HIGHEST precision. Every model trains, ``cycle_gan`` on
``unaligned`` folders (trainA / trainB) among them. Each uint8 host batch from the folder loader is
pinned and copied to the card without blocking, then cropped, flipped
and normalized there (``data/transforms.py``); the crop and flip draws
come from a CPU generator seeded ``train.seed + 1``.

Data-parallel, one process a card (``parallel/``):

    torchrun --standalone --nproc_per_node N -m ir2rgb_tpu_torch.cli.train \
        --preset pix2pixhd_512 --train.num_devices N ...

Under torchrun's environment (or ``--train.multihost true``, which
requires a cluster) the process group comes up first
(``multihost.initialize``: NCCL on the cards, gloo with ``--device cpu``)
and each rank trains on ``cuda:LOCAL_RANK``. ``data.batch_size`` is the
global batch: every rank decodes its own rows of it, crops and flips them
as the one-process run would, and rank 0 alone writes the run.
``--dist_timeout S`` bounds every collective (default 300 s): a rank that
dies or hangs fails the others. ``--deterministic`` selects cuDNN's
deterministic algorithms (a run repeats bit for bit). ``--dist_backend
gloo`` runs the group on gloo with the ranks on the card (several ranks
on one card, which NCCL refuses); each rank takes the current card.

Spatially partitioned, each frame's rows over S ranks of a dp×S mesh
(``parallel/spatial.py``), world = dp·S:

    torchrun --standalone --nproc_per_node 4 -m ir2rgb_tpu_torch.cli.train \
        --preset pix2pixhd_2048 --train.spatial_devices 4 ...

The S ranks of a data row decode the same images (the loader is sharded
over dp), crop and flip them alike, then each keeps its image rows (of
every frame, for a temporal folder's windows; of both domains'
frames, for an unaligned folder's). Temporal windows, ``--model.remat
true``, ``--loss.gan_mode wgangp`` and CycleGAN train partitioned; netE
and instance edges, and the U-Net raise before any collective (ROADMAP
A16b):

    torchrun --standalone --nproc_per_node 2 -m ir2rgb_tpu_torch.cli.train \
        --preset temporal_512 --train.spatial_devices 2 ...
    torchrun --standalone --nproc_per_node 2 -m ir2rgb_tpu_torch.cli.train \
        --preset cyclegan_256 --train.spatial_devices 2 ...
"""

from __future__ import annotations

import os
import sys
from itertools import chain

import numpy as np
import torch


def _launched() -> bool:
    """Started by torchrun (its rank variables are set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def main(argv=None) -> int:
    from ir2rgb_tpu_torch.cli.common import pop_flag
    from ir2rgb_tpu_torch.config import parse_cli
    from ir2rgb_tpu_torch.data import (
        DataLoader,
        preprocess_pair_batch,
        preprocess_sequence_batch,
    )
    from ir2rgb_tpu_torch.nn import quant
    from ir2rgb_tpu_torch.obs import Visualizer
    from ir2rgb_tpu_torch.parallel import (
        data_parallel_mesh,
        dp_sp_mesh,
        multihost,
    )
    from ir2rgb_tpu_torch.parallel.mesh import image_rows, sharded
    from ir2rgb_tpu_torch.train.model import spatial_train_refusal
    from ir2rgb_tpu_torch.runtime import resolve_device, set_parity_mode
    from ir2rgb_tpu_torch.train import Trainer, create_model

    argv = list(sys.argv[1:] if argv is None else argv)
    deterministic = "--deterministic" in argv
    if deterministic:
        argv.remove("--deterministic")
    device_flag = pop_flag(argv, "--device")
    timeout_s = pop_flag(argv, "--dist_timeout")
    backend = pop_flag(argv, "--dist_backend")
    cfg = parse_cli(argv)
    if cfg.train.multihost or _launched():
        multihost.initialize(
            require=cfg.train.multihost,
            backend=backend or ("gloo" if device_flag == "cpu" else None),
            timeout_s=float(timeout_s or multihost.DEFAULT_TIMEOUT_S))
    if device_flag is None and torch.distributed.is_initialized():
        # the rank's card, made current by initialize
        device_flag = f"cuda:{torch.cuda.current_device()}"
    device = resolve_device(device_flag)
    sp = cfg.train.spatial_devices
    if sp > 1:
        spatial_train_refusal(cfg)
        mesh = dp_sp_mesh(cfg.train.num_devices, sp, device=device)
    else:
        mesh = data_parallel_mesh(cfg.train.num_devices, device=device)
    if quant.env_override() or cfg.infer.quant != "none":
        # int8 rounding has zero gradient: a quantized train step would
        # learn nothing (quantization is a serving-only path)
        raise SystemExit(
            "quantized mode is serving-only (IR2RGB_QUANT / "
            "--infer.quant): unset it to train")
    if cfg.data.dataset_mode == "single":
        raise SystemExit(
            "dataset_mode=single has no ground-truth RGB targets — it is "
            "an inference-only mode; training needs aligned (or temporal) "
            "pairs")
    if (cfg.model.model == "cycle_gan"
            and cfg.data.dataset_mode == "temporal"):
        raise SystemExit(
            "cycle_gan expects frame batches (aligned or unaligned "
            "dataset_mode), not temporal windows")
    if cfg.model.compute_dtype == "float32":
        # full-fp32 convolutions, as the JAX package's HIGHEST precision
        set_parity_mode()
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    loader = DataLoader(cfg, shard=(mesh.dp, mesh.dp_rank))
    model = create_model(cfg, device=device,
                         steps_per_epoch=max(len(loader), 1),
                         seed=cfg.train.seed)
    # rank 0 alone writes the run
    vis = Visualizer(cfg.run_dir(), cfg.train.name) if mesh.rank == 0 \
        else None
    trainer = Trainer(model, cfg, visualizer=vis)

    temporal = cfg.data.dataset_mode == "temporal"
    unpaired = cfg.data.dataset_mode == "unaligned"
    prep = preprocess_sequence_batch if temporal else preprocess_pair_batch
    generator = torch.Generator().manual_seed(cfg.train.seed + 1)
    # non-crop preprocess modes (scale_width / none) train at decode size
    crop = cfg.data.crop_size if "crop" in cfg.data.preprocess else None

    accum = max(1, cfg.train.grad_accum)

    def batches():
        for i, host in enumerate(loader):
            # this rank's rows; the first batch checks every rank feeds the
            # same count (every later one has the same shape)
            x = multihost.global_batch(
                {k: np.ascontiguousarray(v) for k, v in host.items()
                 if k in ("a", "b", "inst")}, mesh, check=i == 0,
                whole_images=True)
            kw = {}
            if not temporal and "inst" in x:
                kw["inst"] = x["inst"]
            if not temporal and cfg.model.label_nc > 0:
                kw["label_a"] = True
            if unpaired:
                kw["unpaired"] = True
            with sharded(mesh, accum):
                batch = prep(x["a"], x["b"], generator, crop_size=crop,
                             no_flip=cfg.data.no_flip, train=True, **kw)
            # on a dp×sp mesh, this rank's image rows of the cropped frames
            yield {k: image_rows(v, mesh).contiguous()
                   for k, v in batch.items()}

    it = batches()
    first = next(it)
    trainer.init_or_restore()
    trainer.fit(chain([first], it))
    # the final sample dump through the trainer's display hook
    trainer.display(first, model.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
