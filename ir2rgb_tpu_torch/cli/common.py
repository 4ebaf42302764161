"""Shared CLI plumbing (the port of ``ir2rgb_tpu/cli/common.py``): the
``pop_flag`` argv helper and the serving generator's weights.

Both serving entry points (``cli.infer`` and ``cli.serve``) load the
generator the same three ways: a run checkpoint of
``checkpoint/manager.py`` at a named epoch, its EMA shadow, or a
reference ``.pth`` (``--torch_g``) imported by
``checkpoint/torch_import.py``.
"""

from __future__ import annotations

import os
from typing import Optional


def pop_flag(argv: list, name: str) -> Optional[str]:
    """Extract a ``--name value`` pair that isn't part of the typed
    config surface (e.g. --device, --torch_g) from an argv list, in
    place."""
    if name in argv:
        i = argv.index(name)
        if i + 1 >= len(argv):
            raise SystemExit(f"{name} requires a value")
        value = argv[i + 1]
        del argv[i:i + 2]
        return value
    return None


def load_generator_params(cfg, model, torch_g: Optional[str] = None,
                          name: str = "netG"):
    """The serving state_dict of generator ``name`` (``netG``; a
    CycleGAN's reverse generator is ``netG_B``; a ``use_instance_feat``
    model's feature encoder is ``netE``) for ``model`` per ``cfg.infer``.

    ``torch_g`` imports a reference ``.pth`` of ``netG`` (None for
    any other: the import holds one network); otherwise the run's
    checkpoint at ``--infer.which_epoch``, or its EMA shadow with
    ``--infer.use_ema``. Raises SystemExit with the JAX CLI's messages
    when the flags ask for weights that are not there."""
    from ir2rgb_tpu_torch.checkpoint import CheckpointManager
    from ir2rgb_tpu_torch.checkpoint.torch_import import import_generator

    if torch_g is not None:
        if cfg.infer.use_ema:
            raise SystemExit("--infer.use_ema needs a run checkpoint; "
                             "--torch_g imports raw reference weights (no "
                             "EMA state)")
        return (import_generator(torch_g, model.gen_cfg) if name == "netG"
                else None)

    ckpt = CheckpointManager(os.path.join(cfg.run_dir(), "ckpt"))
    state = ckpt.restore(ckpt.step_for_label(cfg.infer.which_epoch))
    if cfg.infer.use_ema:
        if not state.get("ema_g"):
            raise SystemExit(
                "--infer.use_ema: this checkpoint has no EMA weights "
                "(train with --train.ema_decay > 0)")
        return state[model.ema_key(name)]
    return state[name]
