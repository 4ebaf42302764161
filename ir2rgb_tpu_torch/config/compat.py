"""Reference-flag compatibility table (the port's copy of
``ir2rgb_tpu/config/compat.py``, over the port's own config classes).

Maps the reference's argparse flag names (SURVEY.md §2.4,
``options/base_options.py`` / ``train_options.py`` / ``test_options.py``)
onto this framework's ``Config`` fields, so a reference launch command can be
translated 1:1.  ``from_reference_flags`` consumes a dict of reference flags
(e.g. parsed from an ``opt.txt`` archived by the reference) and returns a
``Config``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

from .config import Config

# reference flag -> (section, field, converter | None)
REFERENCE_FLAG_TABLE: Dict[str, Tuple[str, str, Any]] = {
    # base_options
    "name": ("train", "name", None),
    "checkpoints_dir": ("train", "checkpoints_dir", None),
    "model": ("model", "model", None),
    "netG": ("model", "net_g", None),
    "netD": ("model", "net_d", None),
    "ngf": ("model", "ngf", int),
    "ndf": ("model", "ndf", int),
    "norm": ("model", "norm", None),
    "input_nc": ("model", "input_nc", int),
    "label_nc": ("model", "label_nc", int),
    "output_nc": ("model", "output_nc", int),
    "n_layers_D": ("model", "n_layers_d", int),
    "num_D": ("model", "num_d", int),
    "n_downsample_global": ("model", "n_downsample_global", int),
    "n_blocks_global": ("model", "n_blocks_global", int),
    "n_blocks_local": ("model", "n_blocks_local", int),
    "n_local_enhancers": ("model", "n_local_enhancers", int),
    "dataroot": ("data", "dataroot", None),
    "batchSize": ("data", "batch_size", int),
    "loadSize": ("data", "load_size", int),
    "fineSize": ("data", "crop_size", int),
    "resize_or_crop": ("data", "preprocess", None),
    "no_dropout": ("model", "use_dropout", lambda v: not v),
    # pix2pixHD instance/edge conditioning: --no_instance turns the
    # default-on boundary channel OFF (ir2rgb's real-IR launches pass it)
    "no_instance": ("model", "use_instance_edges", lambda v: not v),
    # pix2pixHD feature-encoder netE (instance-wise style features)
    "instance_feat": ("model", "use_instance_feat", bool),
    "feat_num": ("model", "feat_num", int),
    "nef": ("model", "nef", int),
    "n_downsample_E": ("model", "n_downsample_e", int),
    "serial_batches": ("data", "serial_batches", bool),
    "no_flip": ("data", "no_flip", bool),
    "nThreads": ("data", "num_workers", int),
    "max_dataset_size": ("data", "max_dataset_size",
                         lambda v: None if v in (None, "inf", float("inf")) else int(v)),
    "phase": ("data", "phase", None),
    # train_options
    "niter": ("train", "niter", int),
    "niter_decay": ("train", "niter_decay", int),
    "niter_fix_global": ("train", "niter_fix_global", int),
    "lr": ("train", "lr", float),
    "beta1": ("train", "beta1", float),
    "init_type": ("model", "init_type", None),
    "lr_policy": ("train", "lr_policy", None),
    "lr_decay_iters": ("train", "lr_decay_iters", int),
    "continue_train": ("train", "continue_train", bool),
    "which_epoch": ("train", "which_epoch", None),
    "load_pretrain": ("train", "load_pretrain", None),
    "save_latest_freq": ("train", "save_latest_freq", int),
    "save_epoch_freq": ("train", "save_epoch_freq", int),
    "print_freq": ("train", "print_freq", int),
    "display_freq": ("train", "display_freq", int),
    "lambda_L1": ("loss", "lambda_l1", float),
    # pix2pix-era repos spell the L1 weight --lambda_A; under
    # --model cycle_gan the same flag is the forward-cycle weight —
    # from_reference_flags routes it by the model flag
    "lambda_A": ("loss", "lambda_l1", float),
    "lambda_B": ("loss", "lambda_b", float),
    "lambda_identity": ("loss", "lambda_identity", float),
    "lambda_feat": ("loss", "lambda_feat", float),
    "no_ganFeat_loss": ("loss", "no_gan_feat_loss", bool),
    "no_vgg_loss": ("loss", "no_vgg_loss", bool),
    "no_lsgan": ("loss", "gan_mode", lambda v: "vanilla" if v else "lsgan"),
    "gan_mode": ("loss", "gan_mode", None),
    "dataset_mode": ("data", "dataset_mode", None),
    "which_direction": ("data", "direction", None),
    "pool_size": ("loss", "pool_size", int),
    # test_options
    "results_dir": ("infer", "results_dir", None),
    "how_many": ("infer", "how_many",
                 lambda v: None if v in (None, "inf") else int(v)),
    # newer family repos spell how_many as num_test
    "num_test": ("infer", "how_many",
                 lambda v: None if v in (None, "inf") else int(v)),
    "aspect_ratio": ("infer", "aspect_ratio", float),
    "use_encoded_image": ("infer", "use_encoded_image", bool),
    "cluster_path": ("infer", "cluster_path", None),
    "n_clusters": ("infer", "n_clusters", int),
}

# reference netG names -> ours (identity for most)
_NETG_ALIASES = {
    "resnet_9blocks": "resnet_9blocks",
    "resnet_6blocks": "resnet_6blocks",
    "unet_256": "unet_256",
    "unet_128": "unet_128",
    "global": "global",
    "local": "local",
}


def from_reference_flags(flags: Mapping[str, Any],
                         base: Optional[Config] = None) -> Config:
    """Translate a reference ``opt``-style flag dict into a Config."""
    cfg = base or Config()
    per_section: Dict[str, Dict[str, Any]] = {}
    for ref_name, value in flags.items():
        entry = REFERENCE_FLAG_TABLE.get(ref_name)
        if entry is None:
            continue  # unknown/irrelevant flags (gpu_ids, display_winsize, ...)
        section, field_name, conv = entry
        if conv is not None:
            value = conv(value)
        if ref_name == "netG":
            value = _NETG_ALIASES.get(value, value)
        # "which_epoch" appears in both train and test options; route to both.
        per_section.setdefault(section, {})[field_name] = value
    if "which_epoch" in flags:
        per_section.setdefault("infer", {})["which_epoch"] = str(flags["which_epoch"])
    if "lambda_A" in flags and str(flags.get("model", "")) == "cycle_gan":
        # CycleGAN semantics: lambda_A/lambda_B are the cycle weights,
        # not pix2pix's L1 weight
        loss_sec = per_section.setdefault("loss", {})
        loss_sec.pop("lambda_l1", None)
        loss_sec["lambda_a"] = float(flags["lambda_A"])
    updates = {
        section: dataclasses.replace(getattr(cfg, section), **vals)
        for section, vals in per_section.items()
    }
    return cfg.replace(**updates)


def parse_opt_txt(path: str) -> Dict[str, Any]:
    """Parse the reference's archived ``opt.txt`` (lines of ``key: value``)."""
    flags: Dict[str, Any] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or ":" not in line or line.startswith("-"):
                continue
            key, _, value = line.partition(":")
            value = value.split("[default")[0].strip()
            if value in ("True", "False"):
                flags[key.strip()] = value == "True"
            else:
                try:
                    flags[key.strip()] = int(value)
                except ValueError:
                    try:
                        flags[key.strip()] = float(value)
                    except ValueError:
                        flags[key.strip()] = value
    return flags
