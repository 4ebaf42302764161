"""The subset of ``ir2rgb_tpu/config/config.py`` that serving and the
train step read, and every preset but ``cyclegan_256``
(whose model, ``train/cycle.py``, is not ported yet).

A copy, not an import: the port keeps its own definitions. Field names,
defaults and preset values match the JAX package's so one set of
settings drives both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    """Generator and discriminator architecture knobs."""

    # pix2pix | pix2pixhd | temporal (previous-frame conditioning)
    model: str = "pix2pix"
    # resnet_9blocks | resnet_6blocks | unet_256 | unet_128 | global | local
    net_g: str = "resnet_9blocks"
    # discriminator: n_layers (PatchGAN) | multiscale
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
    # temporal mode: how many previous generated frames condition G
    n_frames_g: int = 2
    # > 0: the input is a (B, H, W, 1) class-id map, one-hot encoded on
    # the device into label_nc channels
    label_nc: int = 0
    # pix2pixHD instance-edge channel (after the input); the netE feature
    # input is not ported yet
    use_instance_edges: bool = False
    use_instance_feat: bool = False
    # parameters stay fp32; this is the dtype G, D and the VGG compute in
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class DataConfig:
    load_size: int = 286
    crop_size: int = 256
    batch_size: int = 1
    # temporal dataset: frames per training window
    n_frames_total: int = 4
    # aligned | unaligned | temporal | single
    dataset_mode: str = "aligned"


@dataclass(frozen=True)
class LossConfig:
    """Loss weights and switches."""

    gan_mode: str = "lsgan"  # lsgan | vanilla | hinge | wgangp
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


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer and schedule."""

    niter: int = 100          # epochs at constant lr
    niter_decay: int = 100    # epochs of linear lr decay to 0
    lr: float = 2e-4
    lr_policy: str = "linear"  # linear | step | cosine
    lr_decay_iters: int = 50   # step policy period, in epochs
    beta1: float = 0.5
    beta2: float = 0.999
    # coarse-to-fine: epochs during which only the local enhancer trains
    niter_fix_global: int = 0
    # not ported yet: a model with other values serves, and its
    # train_step raises
    grad_accum: int = 1
    ema_decay: float = 0.0
    adam_mu_dtype: str = "f32"
    seed: int = 0


@dataclass(frozen=True)
class InferConfig:
    # serving quantization mode (none | int8 | int8_mixed | int8_w); only
    # "none" is ported
    quant: str = "none"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)


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
