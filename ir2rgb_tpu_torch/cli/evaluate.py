"""Evaluation entry point of the port — ``python -m
ir2rgb_tpu_torch.cli.evaluate``, the counterpart of
``ir2rgb_tpu/cli/evaluate.py``: PSNR and SSIM (and flicker over the
sequence) between a folder of generated frames and one of ground truth.

    python -m ir2rgb_tpu_torch.cli.evaluate --generated DIR --target DIR \\
        [--json_out FILE] [--device cpu]

The metrics run on the CUDA device; ``--device cpu`` runs them on the
CPU. It prints the same JSON as the JAX CLI and exits 1 when no pair of
frames is comparable.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 127.5 - 1.0


def main(argv=None) -> int:
    import torch

    from ir2rgb_tpu_torch.data.folder import make_dataset
    from ir2rgb_tpu_torch.infer.metrics import flicker, psnr, ssim
    from ir2rgb_tpu_torch.runtime import resolve_device

    p = argparse.ArgumentParser("ir2rgb-eval")
    p.add_argument("--generated", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--json_out", default=None)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    gen_paths = make_dataset(args.generated)
    tgt_paths = make_dataset(args.target)
    n = min(len(gen_paths), len(tgt_paths))
    if n == 0:
        print("no images found", file=sys.stderr)
        return 1

    psnrs, ssims, gen_frames = [], [], []
    for g, t in zip(gen_paths[:n], tgt_paths[:n]):
        gi, ti = _load(g), _load(t)
        if gi.shape != ti.shape:
            print(f"skip shape mismatch: {g} {gi.shape} vs {t} {ti.shape}",
                  file=sys.stderr)
            continue
        gd = torch.from_numpy(gi).to(device)
        td = torch.from_numpy(ti).to(device)
        psnrs.append(float(psnr(gd, td)))
        ssims.append(float(ssim(gd, td)))
        gen_frames.append(gi)

    if not psnrs:
        # np.mean([]) would print NaN (invalid JSON) and exit 0
        print("no comparable pairs (every pair skipped for shape "
              "mismatch)", file=sys.stderr)
        return 1

    # flicker needs one stackable (T, H, W, C) clip: mixed result sizes
    # (several videos at different resolutions) can't be scored
    same_shape = all(f.shape == gen_frames[0].shape for f in gen_frames)
    if not same_shape:
        print("mixed generated-frame sizes: skipping flicker metric",
              file=sys.stderr)
    result = {
        "frames": len(psnrs),
        "psnr_mean": float(np.mean(psnrs)),
        "psnr_std": float(np.std(psnrs)),
        "ssim_mean": float(np.mean(ssims)),
        "flicker": float(flicker(torch.from_numpy(
            np.stack(gen_frames)).to(device)))
        if len(gen_frames) > 1 and same_shape else None,
    }
    print(json.dumps(result, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(result, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
