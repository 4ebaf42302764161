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
"""

from __future__ import annotations

import sys
from itertools import chain

import numpy as np
import torch


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


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
    from ir2rgb_tpu_torch.runtime import resolve_device, set_parity_mode
    from ir2rgb_tpu_torch.train import Trainer, create_model

    argv = list(sys.argv[1:] if argv is None else argv)
    device = resolve_device(pop_flag(argv, "--device"))
    cfg = parse_cli(argv)
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
    loader = DataLoader(cfg)
    model = create_model(cfg, device=device,
                         steps_per_epoch=max(len(loader), 1),
                         seed=cfg.train.seed)
    vis = Visualizer(cfg.run_dir(), cfg.train.name)
    trainer = Trainer(model, cfg, visualizer=vis)

    temporal = cfg.data.dataset_mode == "temporal"
    unpaired = cfg.data.dataset_mode == "unaligned"
    prep = preprocess_sequence_batch if temporal else preprocess_pair_batch
    generator = torch.Generator().manual_seed(cfg.train.seed + 1)
    # non-crop preprocess modes (scale_width / none) train at decode size
    crop = cfg.data.crop_size if "crop" in cfg.data.preprocess else None

    def batches():
        for host in loader:
            kw = {}
            if not temporal and "inst" in host:
                kw["inst"] = _to_device(host["inst"], device)
            if not temporal and cfg.model.label_nc > 0:
                kw["label_a"] = True
            if unpaired:
                kw["unpaired"] = True
            yield prep(_to_device(host["a"], device),
                       _to_device(host["b"], device), generator,
                       crop_size=crop, no_flip=cfg.data.no_flip, train=True,
                       **kw)

    it = batches()
    first = next(it)
    trainer.init_or_restore()
    trainer.fit(chain([first], it))
    # the final sample dump through the trainer's display hook
    trainer._display(first, model.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
