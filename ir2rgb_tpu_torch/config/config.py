"""The subset of ``ir2rgb_tpu/config/config.py`` that serving reads.

A copy, not an import: the port keeps its own definitions. Field names,
defaults and preset values match the JAX package's so one set of
settings drives both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    """Generator architecture knobs that ``create_model``/``generate`` use."""

    # pix2pix | pix2pixhd | temporal (previous-frame conditioning)
    model: str = "pix2pix"
    net_g: str = "resnet_9blocks"
    input_nc: int = 3
    output_nc: int = 3
    ngf: int = 64
    norm: str = "instance"
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    n_blocks_local: int = 3
    n_local_enhancers: int = 1
    # temporal mode: how many previous generated frames condition G
    n_frames_g: int = 2
    # > 0: integer semantic-label input (not ported yet)
    label_nc: int = 0
    # pix2pixHD instance-edge channel / netE feature input (not ported yet)
    use_instance_edges: bool = False
    use_instance_feat: bool = False
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class DataConfig:
    crop_size: int = 256


@dataclass(frozen=True)
class InferConfig:
    # serving quantization mode (none | int8 | int8_mixed | int8_w); only
    # "none" is ported
    quant: str = "none"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    infer: InferConfig = field(default_factory=InferConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)


PRESETS = {
    # pix2pixHD global+local at 512: ngf=32 for the local tier, so the
    # global trunk runs at ngf_global = 32 * 2^1 = 64
    "pix2pixhd_512": Config(
        model=ModelConfig(model="pix2pixhd", net_g="local", ngf=32),
        data=DataConfig(crop_size=512),
    ),
    # the same generator with the previous generated frame carried on the
    # device (streaming video)
    "temporal_512": Config(
        model=ModelConfig(model="temporal", net_g="local", ngf=32,
                          n_frames_g=2),
        data=DataConfig(crop_size=512),
    ),
}
