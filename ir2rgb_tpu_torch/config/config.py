"""Typed configuration: the port's copy of ``ir2rgb_tpu/config/config.py``.

Frozen dataclasses grouped by subsystem, every preset of the JAX package
(``cyclegan_256`` included), and the CLI helpers
(``parse_cli``: ``--preset name --section.field value``) and the JSON
dump every run writes into its run directory (``save_config`` /
``load_config``).

A copy, not an import: the port keeps its own definitions. Field names,
types, defaults and preset values match the JAX package's, so one
``config.json`` or one command line drives both. A field whose feature
the port does not have yet is accepted here and refused where it would
be used (``train/model.py``, ``train/trainer.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field, fields
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Generator and discriminator architecture knobs."""

    # pix2pix (GAN + L1) | pix2pixhd (multiscale D + FM + VGG) | temporal
    # (previous-frame conditioning) | cycle_gan (unpaired, train/cycle.py)
    model: str = "pix2pix"
    # resnet_9blocks | resnet_6blocks | unet_256 | unet_128 | global | local
    net_g: str = "resnet_9blocks"
    # discriminator: n_layers (PatchGAN) | multiscale | pixel
    net_d: str = "n_layers"
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    ndf: int = 64
    n_layers_d: int = 3
    num_d: int = 2  # pyramid scales of the multiscale D
    norm: str = "instance"  # instance | batch | none
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    n_blocks_local: int = 3
    n_local_enhancers: int = 1
    # generator upsampler: deconv (ConvTranspose parity) | resize_conv
    # (nearest x2 + zero-padded 3x3 conv)
    upsample: str = "deconv"
    # D taps intermediate features (the feature-matching loss needs them)
    get_interm_feat: bool = True
    # generator dropout 0.5 when training (serving never drops)
    use_dropout: bool = False
    # normal | xavier | kaiming | orthogonal (ops.apply_init_type)
    init_type: str = "normal"
    # pix2pixHD feature encoder netE (not ported yet: create_model raises)
    use_instance_feat: bool = False
    feat_num: int = 3
    nef: int = 16
    n_downsample_e: int = 4
    # the instance-edge channel after the input (G and D)
    use_instance_edges: bool = False
    # > 0: the input is a (B, H, W, 1) class-id map, one-hot encoded on
    # the device into label_nc channels
    label_nc: int = 0
    # netE's hashed instance slots (with use_instance_feat)
    num_instances: int = 1024
    # temporal mode: how many previous generated frames condition G
    n_frames_g: int = 2
    # parameters stay fp32; this is the dtype G, D and the VGG compute in
    compute_dtype: str = "float32"
    # recompute residual blocks in the backward (activation memory for
    # recompute time)
    remat: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline knobs."""

    dataroot: str = ""
    phase: str = "train"
    # resize_and_crop | crop | scale_width | scale_width_and_crop | none
    preprocess: str = "resize_and_crop"
    load_size: int = 286
    crop_size: int = 256
    batch_size: int = 1
    serial_batches: bool = False
    no_flip: bool = False
    max_dataset_size: Optional[int] = None
    num_workers: int = 2
    # temporal dataset: frames per training window
    n_frames_total: int = 4
    # AtoB trains A->B (IR->RGB); BtoA swaps each pair
    direction: str = "AtoB"
    # aligned | unaligned (unpaired trainA/trainB) | temporal | single
    # (input only, inference)
    dataset_mode: str = "aligned"


@dataclass(frozen=True)
class LossConfig:
    """Loss weights and switches."""

    gan_mode: str = "lsgan"  # lsgan | vanilla | hinge | wgangp
    lambda_gp: float = 10.0  # wgangp gradient-penalty weight
    lambda_l1: float = 100.0
    lambda_feat: float = 10.0
    lambda_vgg: float = 10.0
    no_gan_feat_loss: bool = False
    no_vgg_loss: bool = False
    # pretrained-VGG19 .npz (from the JAX package's `cli/convert.py
    # vgg19`); empty = He-random fallback (create_model warns)
    vgg_weights: str = ""
    # image pool of D's fakes (train/image_pool.py); 0: none
    pool_size: int = 0
    # cycle_gan's cycle and identity weights
    lambda_a: float = 10.0
    lambda_b: float = 10.0
    lambda_identity: float = 0.5


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule, checkpoint and logging cadence."""

    name: str = "experiment"
    checkpoints_dir: str = "./checkpoints"
    niter: int = 100          # epochs at constant lr
    niter_decay: int = 100    # epochs of linear lr decay to 0
    lr: float = 2e-4
    lr_policy: str = "linear"  # linear | step | cosine
    lr_decay_iters: int = 50   # step policy period, in epochs
    beta1: float = 0.5
    beta2: float = 0.999
    # coarse-to-fine: epochs during which only the local enhancer trains
    niter_fix_global: int = 0
    save_latest_freq: int = 1000   # steps
    save_epoch_freq: int = 10      # epochs
    print_freq: int = 100          # steps
    display_freq: int = 400        # steps
    continue_train: bool = False
    # resume from this epoch label ('latest', an epoch or a saved step)
    which_epoch: str = "latest"
    # warm-start G and D from another run directory (partial load)
    load_pretrain: str = ""
    seed: int = 0
    # data-parallel devices (0: all visible), hosts and spatial
    # partitioning: the port trains on one device (Trainer raises for
    # more)
    num_devices: int = 0
    multihost: bool = False
    spatial_devices: int = 1
    # the port's step updates in place; accepted for either value
    donate: bool = True
    # micro-batches a step (their gradients summed, then averaged)
    grad_accum: int = 1
    # > 0: an fp32 EMA shadow of G, e <- d·e + (1 − d)·p after each step
    ema_decay: float = 0.0
    # "bf16": Adam's first moments stored in bf16 (train/optim.py)
    adam_mu_dtype: str = "f32"


@dataclass(frozen=True)
class InferConfig:
    """Inference and serving knobs (``cli/infer.py``, ``cli/serve.py``);
    netE's ``use_encoded_image`` / ``cluster_path`` / ``n_clusters`` are
    not ported yet and are kept so a config.json loads in both
    packages."""

    results_dir: str = "./results"
    which_epoch: str = "latest"
    how_many: Optional[int] = None
    aspect_ratio: float = 1.0
    use_encoded_image: bool = False
    cluster_path: str = ""
    n_clusters: int = 10
    use_ema: bool = False
    # serving quantization mode (none | int8 | int8_mixed | int8_w;
    # nn/quant.py)
    quant: str = "none"
    video: str = ""
    video_fps: float = 30.0
    video_quality: int = 90
    serve_host: str = "127.0.0.1"
    serve_port: int = 7788
    serve_slots: int = 8
    serve_encode: str = "raw"
    serve_quality: int = 90
    serve_tick_ms: float = 5.0
    serve_max_pending: int = 32


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)

    def run_dir(self) -> str:
        return os.path.join(self.train.checkpoints_dir, self.train.name)


PRESETS = {
    # single-frame 256x256 ResNet-9
    "resnet9_256": Config(
        model=ModelConfig(model="pix2pix", net_g="resnet_9blocks"),
        data=DataConfig(load_size=286, crop_size=256),
    ),
    # pix2pix U-Net + 70x70 PatchGAN (the flat `model` layout), GAN + L1
    "pix2pix_unet256": Config(
        model=ModelConfig(model="pix2pix", net_g="unet_256", net_d="n_layers",
                          get_interm_feat=False),
        loss=LossConfig(no_gan_feat_loss=True, no_vgg_loss=True),
    ),
    # pix2pixHD global+local at 512, multiscale D, FM + VGG: ngf=32 for
    # the local tier, so the global trunk runs at ngf_global = 32 * 2^1 = 64
    "pix2pixhd_512": Config(
        model=ModelConfig(model="pix2pixhd", net_g="local",
                          net_d="multiscale", num_d=2, ngf=32),
        data=DataConfig(load_size=572, crop_size=512),
        loss=LossConfig(lambda_l1=0.0),
        train=TrainConfig(niter_fix_global=10),
    ),
    # pix2pixHD global-only at 512 (the coarse stage)
    "pix2pixhd_global_512": Config(
        model=ModelConfig(model="pix2pixhd", net_g="global",
                          net_d="multiscale", num_d=2),
        data=DataConfig(load_size=572, crop_size=512),
        loss=LossConfig(lambda_l1=0.0),
    ),
    # 1024p coarse-to-fine: local enhancer ngf 32 around the ngf 64
    # trunk, 3-scale D
    "pix2pixhd_1024": Config(
        model=ModelConfig(model="pix2pixhd", net_g="local",
                          net_d="multiscale", num_d=3, ngf=32),
        data=DataConfig(load_size=1124, crop_size=1024),
        loss=LossConfig(lambda_l1=0.0),
        train=TrainConfig(niter_fix_global=10),
    ),
    # 2048p: two local enhancers around the global trunk (which runs at 512)
    "pix2pixhd_2048": Config(
        model=ModelConfig(model="pix2pixhd", net_g="local",
                          net_d="multiscale", num_d=3, ngf=16,
                          n_local_enhancers=2),
        data=DataConfig(load_size=2248, crop_size=2048),
        loss=LossConfig(lambda_l1=0.0),
        train=TrainConfig(niter_fix_global=10),
    ),
    # pix2pixhd_1024 with the previous generated frame carried on the device
    "temporal_1024": Config(
        model=ModelConfig(model="temporal", net_g="local",
                          net_d="multiscale", num_d=3, ngf=32,
                          n_frames_g=2),
        data=DataConfig(dataset_mode="temporal", n_frames_total=4,
                        load_size=1124, crop_size=1024),
        loss=LossConfig(lambda_l1=0.0),
        train=TrainConfig(niter_fix_global=10),
    ),
    # unpaired IR<->RGB (the family's CycleGAN recipe): two ResNet-9
    # generators and two 70x70 PatchGANs, LSGAN + cycle consistency +
    # identity, a 50-image pool per domain
    "cyclegan_256": Config(
        model=ModelConfig(model="cycle_gan", net_g="resnet_9blocks",
                          net_d="n_layers", get_interm_feat=False),
        data=DataConfig(dataset_mode="unaligned", load_size=286,
                        crop_size=256),
        loss=LossConfig(no_gan_feat_loss=True, no_vgg_loss=True,
                        lambda_l1=0.0, pool_size=50),
    ),
    # ResNet-9 at 256 with previous-frame conditioning
    "temporal_256": Config(
        model=ModelConfig(model="temporal", net_g="resnet_9blocks",
                          net_d="multiscale", num_d=2, n_frames_g=2),
        data=DataConfig(dataset_mode="temporal", n_frames_total=4),
    ),
    # the same generator as pix2pixhd_512 with the previous generated
    # frame carried on the device (streaming video)
    "temporal_512": Config(
        model=ModelConfig(model="temporal", net_g="local",
                          net_d="multiscale", num_d=2, ngf=32,
                          n_frames_g=2),
        data=DataConfig(dataset_mode="temporal", n_frames_total=4,
                        load_size=572, crop_size=512),
        loss=LossConfig(lambda_l1=0.0),
        train=TrainConfig(niter_fix_global=10),
    ),
}


def _add_dataclass_args(parser: argparse.ArgumentParser, cls,
                        prefix: str) -> None:
    for f in fields(cls):
        name = f"--{prefix}{f.name}"
        if f.type in ("bool", bool):
            parser.add_argument(
                name, type=lambda s: s.lower() in ("1", "true", "yes"),
                default=None)
        elif f.type in ("Optional[int]", Optional[int], "int", int):
            parser.add_argument(name, type=int, default=None)
        elif f.type in ("float", float):
            parser.add_argument(name, type=float, default=None)
        else:
            parser.add_argument(name, type=str, default=None)


_SECTIONS = {"model": ModelConfig, "data": DataConfig, "loss": LossConfig,
             "train": TrainConfig, "infer": InferConfig}


def parse_cli(argv=None, default: Optional[Config] = None) -> Config:
    """Parse ``--preset name --section.field value`` style CLI overrides
    (or ``--config path.json`` as the base)."""
    parser = argparse.ArgumentParser("ir2rgb_tpu_torch")
    parser.add_argument("--preset", type=str, default=None,
                        choices=sorted(PRESETS.keys()))
    parser.add_argument("--config", type=str, default=None,
                        help="path to a config JSON to start from")
    for section, cls in _SECTIONS.items():
        _add_dataclass_args(parser, cls, f"{section}.")
    args = parser.parse_args(argv)
    cfg = default or Config()
    if args.config and args.preset:
        # the preset would replace every setting of the file: refuse
        parser.error("--config and --preset both set a complete base "
                     "config; pass one (then override fields with "
                     "--section.field flags)")
    if args.config:
        cfg = load_config(args.config)
    if args.preset:
        cfg = PRESETS[args.preset]
    return config_from_args(cfg, args)


def config_from_args(cfg: Config, args: argparse.Namespace) -> Config:
    """``cfg`` with every ``--section.field`` that ``args`` sets."""
    updates = {}
    for section, cls in _SECTIONS.items():
        sec_updates = {}
        for f in fields(cls):
            v = getattr(args, f"{section}.{f.name}", None)
            if v is not None:
                sec_updates[f.name] = v
        if sec_updates:
            updates[section] = dataclasses.replace(getattr(cfg, section),
                                                   **sec_updates)
    return cfg.replace(**updates) if updates else cfg


def save_config(cfg: Config, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2, sort_keys=True)


def load_config(path: str) -> Config:
    with open(path) as fh:
        raw = json.load(fh)
    return Config(**{
        section: cls(**raw.get(section, {}))
        for section, cls in _SECTIONS.items()
    })
