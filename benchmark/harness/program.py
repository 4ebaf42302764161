"""The system under test: the PyTorch and CUDA package, built from a
configuration file and loaded with the benchmark's weights.

The benchmark takes from the program only its model, its serving entry
points (``create_model``, ``MultiStreamServer``, ``StreamingGenerator``)
and its configuration type; everything else (inputs, weights, the reference, the comparison,
the metrics) is the benchmark's own.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import torch


def port_config(config: dict, training: bool,
                overrides: Optional[dict] = None):
    """The program's ``Config`` for a configuration file: its preset, with
    the file's compute dtype, raising where the preset's sizes and
    hyperparameters differ from the file's. ``overrides`` (tests only)
    narrows the model and the frame size."""
    from ir2rgb_tpu_torch.config import PRESETS
    cfg = PRESETS[config["preset"]]
    model = dataclasses.replace(cfg.model,
                                compute_dtype=config["model"]["compute_dtype"])
    loss = dataclasses.replace(cfg.loss, no_vgg_loss=not training)
    for section, have in (("model", model), ("loss", loss),
                          ("train", cfg.train)):
        for k, want in config[section].items():
            got = getattr(have, k)
            if got != want:
                raise ValueError(f"{config['name']}: the preset's "
                                 f"{section}.{k} is {got!r}, the "
                                 f"configuration file says {want!r}")
    if config["crop_size"] != cfg.data.crop_size:
        raise ValueError(f"{config['name']}: crop size {cfg.data.crop_size}"
                         f" in the preset, {config['crop_size']} in the file")
    data = cfg.data
    if overrides:
        model = dataclasses.replace(model, **overrides.get("model", {}))
        data = dataclasses.replace(data, crop_size=overrides.get(
            "crop_size", data.crop_size))
    return cfg.replace(model=model, loss=loss, data=data)


def reference_model(config: dict, overrides: Optional[dict] = None) -> dict:
    """The configuration file's ``model`` section with ``overrides``."""
    model = dict(config["model"])
    if overrides:
        model.update(overrides.get("model", {}))
    return model


def crop_size(config: dict, overrides: Optional[dict] = None) -> int:
    return (overrides or {}).get("crop_size", config["crop_size"])


def build(cfg, device, seed: int, sds: Dict[str, Dict[str, torch.Tensor]]):
    """``create_model`` of the program, with the benchmark's weights
    loaded into every network it has (G; D and the VGG when training)."""
    from ir2rgb_tpu_torch.train import create_model
    with warnings.catch_warnings():
        # the VGG is loaded with the benchmark's weights right after
        warnings.filterwarnings("ignore", message="VGG perceptual loss")
        model = create_model(cfg, device=device, seed=seed % (1 << 31))
    model.netG.load_state_dict(sds["netG"])
    if "netD" in sds and not cfg.loss.no_vgg_loss:
        model.netD.load_state_dict(sds["netD"])
        model.vgg.load_state_dict(sds["vgg"])
    return model
