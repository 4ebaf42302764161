"""Export entry point of the port — ``python -m ir2rgb_tpu_torch.cli.export``,
the counterpart of ``ir2rgb_tpu/cli/export.py``: seal a trained
generator into a ``.ir2rgb`` serving artifact (a ``torch.export``
program, its weights and its geometry; ``infer/export.py``). The
artifact serves through ``load_serving_artifact`` (or, with ``--slots``,
``cli.serve --artifact``) with no model code, config or checkpoint
behind it.

    python -m ir2rgb_tpu_torch.cli.export --preset temporal_512 \\
        --train.name run1 --train.checkpoints_dir ckpts \\
        --out run1.ir2rgb [--batch 4 | --slots 8] [--platforms cuda,cpu] \\
        [--size HxW] [--device cpu]

``--torch_g model.pth`` exports straight from a reference checkpoint
(``checkpoint/torch_import.py``); otherwise the run's checkpoint at
``--infer.which_epoch`` (its EMA shadow with ``--infer.use_ema``).
``--infer.quant`` seals the quantized serving program. The program is
traced on the CUDA device unless ``--device cpu``; an fp32 model is
traced with TF32 off, as it serves.
"""

from __future__ import annotations

import dataclasses
import os
import sys


def _positive_int(flag: str, val: str) -> int:
    try:
        n = int(val)
    except ValueError:
        raise SystemExit(f"{flag} expects an integer, got {val!r}")
    if n < 1:
        raise SystemExit(f"{flag} must be >= 1, got {n}")
    return n


def main(argv=None) -> int:
    from ir2rgb_tpu_torch.cli.common import load_generator_params, pop_flag
    from ir2rgb_tpu_torch.config import parse_cli
    from ir2rgb_tpu_torch.infer.export import (
        export_multistream_artifact,
        export_serving_artifact,
    )
    from ir2rgb_tpu_torch.runtime import resolve_device, set_parity_mode
    from ir2rgb_tpu_torch.train import create_model

    argv = list(sys.argv[1:] if argv is None else argv)
    device_flag = pop_flag(argv, "--device")
    torch_g = pop_flag(argv, "--torch_g")
    out = pop_flag(argv, "--out")
    batch_flag = pop_flag(argv, "--batch")
    slots = pop_flag(argv, "--slots")  # multi-stream artifact
    if batch_flag is not None and slots is not None:
        raise SystemExit("--batch and --slots are mutually exclusive "
                         "(--slots IS the multi-stream batch)")
    batch = (_positive_int("--batch", batch_flag)
             if batch_flag is not None else 1)
    if slots is not None:
        slots = _positive_int("--slots", slots)
    platforms = tuple((pop_flag(argv, "--platforms") or
                       "cuda,cpu").split(","))
    size_flag = pop_flag(argv, "--size")
    cfg = parse_cli(argv)
    device = resolve_device(device_flag)
    if cfg.model.compute_dtype == "float32":
        # traced as it serves: full-fp32 convolutions
        set_parity_mode()
    # serving needs no VGG
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, no_vgg_loss=True))
    if out is None:
        out = os.path.join(cfg.run_dir(), f"{cfg.train.name}.ir2rgb")

    # The artifact is sealed at one geometry. Crop-style training serves
    # at crop_size x crop_size; scale_width / none runs serve at the
    # dataset's native geometry, which export cannot probe: they need
    # --size HxW (which also overrides the crop anywhere).
    if size_flag is not None:
        parts = size_flag.lower().split("x")
        size_hw = ((int(parts[0]), int(parts[1])) if len(parts) == 2
                   else (int(parts[0]), int(parts[0])))
    elif "crop" in cfg.data.preprocess:
        size_hw = (cfg.data.crop_size, cfg.data.crop_size)
    else:
        raise SystemExit(
            f"--data.preprocess {cfg.data.preprocess} serves at the "
            f"dataset's native geometry, which export cannot infer; "
            f"pass --size HxW (the frame size the artifact will serve)")

    # cfg.infer.quant seals the quantized serving program: the model
    # traces its serving forward in its own mode (nn/quant.py)
    model = create_model(cfg, device=device, steps_per_epoch=1,
                         seed=cfg.train.seed)
    model.netG.load_state_dict(load_generator_params(cfg, model, torch_g))
    if slots is not None:
        export_multistream_artifact(model, size_hw, out, n_slots=slots,
                                    platforms=platforms)
        kind = f"multistream slots {slots}"
    else:
        export_serving_artifact(model, size_hw, out, batch=batch,
                                platforms=platforms)
        kind = f"batch {batch}"
    print(f"exported {out} ({os.path.getsize(out)} bytes, "
          f"{size_hw[0]}x{size_hw[1]} {kind}, "
          f"platforms {','.join(platforms)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
