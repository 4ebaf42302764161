"""The subset of ``ir2rgb_tpu/config/config.py`` that serving and the
non-temporal train step read.

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
    net_g: str = "resnet_9blocks"
    # discriminator: n_layers (PatchGAN) | multiscale
    net_d: str = "n_layers"
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    ndf: int = 64
    n_layers_d: int = 3
    num_d: int = 2  # pyramid scales of the multiscale D
    norm: str = "instance"
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    n_blocks_local: int = 3
    n_local_enhancers: int = 1
    # generator upsampler; only "deconv" (ConvTranspose parity) is ported
    upsample: str = "deconv"
    # D taps intermediate features (the feature-matching loss needs them)
    get_interm_feat: bool = True
    # temporal mode: how many previous generated frames condition G
    n_frames_g: int = 2
    # > 0: integer semantic-label input (not ported yet)
    label_nc: int = 0
    # pix2pixHD instance-edge channel / netE feature input (not ported yet)
    use_instance_edges: bool = False
    use_instance_feat: bool = False
    # parameters stay fp32; this is the dtype G, D and the VGG compute in
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class DataConfig:
    crop_size: int = 256
    batch_size: int = 1


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
    pool_size: int = 0  # image pool (not ported yet: > 0 raises)


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
    # not ported yet (values other than these defaults raise)
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
    # pix2pixHD global+local at 512, multiscale D, FM + VGG: ngf=32 for
    # the local tier, so the global trunk runs at ngf_global = 32 * 2^1 = 64
    "pix2pixhd_512": Config(
        model=ModelConfig(model="pix2pixhd", net_g="local",
                          net_d="multiscale", num_d=2, ngf=32),
        data=DataConfig(crop_size=512),
        loss=LossConfig(lambda_l1=0.0),
        train=TrainConfig(niter_fix_global=10),
    ),
    # the same generator with the previous generated frame carried on the
    # device (streaming video)
    "temporal_512": Config(
        model=ModelConfig(model="temporal", net_g="local",
                          net_d="multiscale", num_d=2, ngf=32,
                          n_frames_g=2),
        data=DataConfig(crop_size=512),
        loss=LossConfig(lambda_l1=0.0),
        train=TrainConfig(niter_fix_global=10),
    ),
}
