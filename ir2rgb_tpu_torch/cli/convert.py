"""Checkpoint conversion CLI of the port — ``python -m
ir2rgb_tpu_torch.cli.convert``, the counterpart of
``ir2rgb_tpu/cli/convert.py``:

- reference -> port: ``g`` / ``d`` import a reference ``.pth`` generator
  or discriminator (``checkpoint/torch_import.py``) into a port checkpoint
  at step 0 (``<out>/0.pt`` holding ``netG`` or ``netD``: point a run's
  ``ckpt/`` directory there and ``cli.infer`` / ``cli.serve`` serve it);
- port -> reference: ``export-g`` / ``export-d`` write a run's G or D as a
  reference-layout ``.pth`` filled into a template
  (``checkpoint/torch_export.py``); ``--net G_A|G_B`` / ``D_A|D_B`` pick a
  ``cycle_gan`` run's network;
- ``vgg19``: torchvision's ``vgg19-*.pth`` -> the npz the perceptual loss
  reads (``nn/vgg.py``).

    python -m ir2rgb_tpu_torch.cli.convert g --pth latest_net_G.pth \\
        --preset pix2pixhd_512 --out ./ckpts/imported/ckpt
    python -m ir2rgb_tpu_torch.cli.convert export-g --run ./ckpts/exp1 \\
        --epoch latest --template ref_net_G.pth --out 200_net_G.pth
    python -m ir2rgb_tpu_torch.cli.convert vgg19 --pth vgg19.pth \\
        --out vgg19.npz

It runs on the CPU: conversion moves weights, it computes nothing.
"""

from __future__ import annotations

import argparse
import os
import sys


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ir2rgb_tpu_torch.cli.convert")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("g", "d"):
        sp = sub.add_parser(name)
        sp.add_argument("--pth", required=True)
        sp.add_argument("--preset", default="resnet9_256")
        sp.add_argument("--out", required=True,
                        help="checkpoint directory (written: <out>/0.pt)")
    for name in ("export-g", "export-d"):
        sp = sub.add_parser(name)
        sp.add_argument("--run", required=True,
                        help="training run dir (contains ckpt/)")
        sp.add_argument("--epoch", default="latest",
                        help="epoch label or step (reference --which_epoch)")
        sp.add_argument("--template", required=True,
                        help="reference .pth of the same architecture "
                             "(any checkpoint, or torch.save of a freshly "
                             "constructed reference net's state_dict)")
        sp.add_argument("--preset", default="",
                        help="override architecture; default: the run's "
                             "own config.json")
        sp.add_argument("--net", default="",
                        help="cycle_gan runs hold two nets per side: "
                             "G_A (A->B, default) | G_B for export-g, "
                             "D_A (judges B) | D_B for export-d")
        sp.add_argument("--out", required=True)
    spv = sub.add_parser("vgg19")
    spv.add_argument("--pth", required=True)
    spv.add_argument("--out", required=True)
    return p


def _configs(cfg):
    """{network name: its configuration}: ``G_A`` / ``G_B`` / ``D_A`` /
    ``D_B`` of a cycle_gan config, else ``G`` / ``D``."""
    if cfg.model.model == "cycle_gan":
        from ir2rgb_tpu_torch.train.cycle import cycle_network_configs
        g_a, g_b, d_a, d_b = cycle_network_configs(cfg)
        return {"G_A": g_a, "G_B": g_b, "D_A": d_a, "D_B": d_b}
    from ir2rgb_tpu_torch.train.model import network_configs
    g, d = network_configs(cfg)
    return {"G": g, "D": d}


# a network's name in a port checkpoint
_STATE_KEYS = {"G": "netG", "D": "netD", "G_A": "netG", "G_B": "netG_B",
               "D_A": "netD", "D_B": "netD_B"}


def main(argv=None) -> int:
    p = _parser()
    args = p.parse_args(argv)

    if args.cmd == "vgg19":
        from ir2rgb_tpu_torch.checkpoint import convert_vgg19_pth
        convert_vgg19_pth(args.pth, args.out)
        print(f"wrote {args.out}")
        return 0

    from ir2rgb_tpu_torch.config import PRESETS, load_config

    if args.cmd in ("export-g", "export-d"):
        from ir2rgb_tpu_torch.checkpoint import (
            CheckpointManager,
            export_discriminator,
            export_generator,
            save_torch_state_dict,
        )
        if args.preset:
            cfg = PRESETS[args.preset]
        else:
            cfg_path = os.path.join(args.run, "config.json")
            if not os.path.exists(cfg_path):
                p.error(f"{cfg_path} not found; pass --preset")
            cfg = load_config(cfg_path)
        configs = _configs(cfg)
        side = args.cmd[-1].upper()
        if cfg.model.model == "cycle_gan":
            net = args.net or f"{side}_A"
            if net not in (f"{side}_A", f"{side}_B"):
                p.error(f"--net must be {side}_A or {side}_B for "
                        f"{args.cmd} on a cycle_gan run")
        else:
            net = side
        ckpt = CheckpointManager(os.path.join(args.run, "ckpt"))
        step = ckpt.step_for_label(args.epoch)
        state = ckpt.restore(step)[_STATE_KEYS[net]]
        fill = export_generator if side == "G" else export_discriminator
        out_sd = fill(state, configs[net], args.template)
        save_torch_state_dict(out_sd, args.out)
        n = sum(int(v.size) for v in out_sd.values())
        print(f"exported {n:,} params (epoch {args.epoch}, step {step}) "
              f"-> {args.out}")
        return 0

    from ir2rgb_tpu_torch.checkpoint import (
        import_discriminator,
        import_generator,
        save_train_state,
    )
    configs = _configs(PRESETS[args.preset])
    if args.cmd == "g":
        name, sd = "netG", import_generator(args.pth, configs[
            "G_A" if "G_A" in configs else "G"])
    else:
        name, sd = "netD", import_discriminator(args.pth, configs[
            "D_A" if "D_A" in configs else "D"])
    save_train_state(args.out, 0, {name: sd})
    n = sum(int(v.numel()) for v in sd.values())
    print(f"imported {n:,} params -> {os.path.join(args.out, '0.pt')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
