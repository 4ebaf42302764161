"""The serving half of ``ir2rgb_tpu/train/model.py``: ``create_model`` and
``GanModel.generate``.

``create_model(cfg)`` builds the generator on the CUDA device (or the
device the caller names) with the reference ``weights_init`` drawn from a
seeded ``torch.Generator``; load trained or JAX-converted weights with
``model.netG.load_state_dict``. ``generate`` assembles the generator input
as the JAX model does — the input frame, then in temporal mode the
previous generated frame(s), zeros at t=0 — and runs the forward without
autograd.

Not ported yet (each raises ``NotImplementedError``): the label one-hot
input (``label_nc > 0``), the instance-edge and netE feature inputs, the
serving quantization modes, and every generator but ``net_g="local"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ir2rgb_tpu_torch.config import Config
from ir2rgb_tpu_torch.nn.generators import GenConfig, LocalEnhancer, init_weights
from ir2rgb_tpu_torch.runtime import resolve_device, resolve_dtype


@dataclasses.dataclass
class GanModel:
    cfg: Config
    gen_cfg: GenConfig
    netG: LocalEnhancer
    device: torch.device

    @property
    def n_prev(self) -> int:
        m = self.cfg.model
        return m.n_frames_g - 1 if m.model == "temporal" else 0

    def generate(self, a: torch.Tensor, prev: Optional[torch.Tensor] = None,
                 feat: Optional[torch.Tensor] = None,
                 edges: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Single-frame G forward on NHWC ``a``. In temporal mode ``prev``
        is the previously generated frame stack (zeros when None).
        Returns (B, H, W, output_nc) in the compute dtype."""
        if feat is not None or edges is not None:
            raise NotImplementedError(
                "feature / instance-edge inputs are not ported yet")
        m = self.cfg.model
        if m.model == "temporal":
            if prev is None:
                prev = a.new_zeros(a.shape[:-1] + (m.output_nc * self.n_prev,))
            a = torch.cat([a, prev.to(a.dtype)], dim=-1)
        with torch.inference_mode():
            return self.netG(a)


def create_model(cfg: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0) -> GanModel:
    """Build the serving model. ``device=None`` means the CUDA device and
    raises when there is none; pass ``device="cpu"`` for the CPU."""
    dev = resolve_device(device)
    m = cfg.model
    if m.label_nc > 0:
        raise NotImplementedError("label_nc > 0 (one-hot label input) is "
                                  "not ported yet")
    if m.use_instance_edges or m.use_instance_feat:
        raise NotImplementedError("instance-edge / netE feature inputs are "
                                  "not ported yet")
    if cfg.infer.quant != "none":
        raise NotImplementedError(f"quant={cfg.infer.quant!r} is not "
                                  "ported yet")
    if m.net_g != "local":
        raise NotImplementedError(f"net_g={m.net_g!r} is not ported yet")
    if m.model not in ("pix2pix", "pix2pixhd", "temporal"):
        raise NotImplementedError(f"model={m.model!r} is not ported yet")
    n_prev = m.n_frames_g - 1 if m.model == "temporal" else 0
    dtype = resolve_dtype(m.compute_dtype)
    gen_cfg = GenConfig(
        net_g=m.net_g, input_nc=m.input_nc + m.output_nc * n_prev,
        output_nc=m.output_nc, ngf=m.ngf, norm=m.norm,
        n_downsample_global=m.n_downsample_global,
        n_blocks_global=m.n_blocks_global, n_blocks_local=m.n_blocks_local,
        n_local_enhancers=m.n_local_enhancers, compute_dtype=dtype)
    with torch.device("meta"):
        net = LocalEnhancer(gen_cfg)
    net = net.to_empty(device=dev)
    init_weights(net, torch.Generator().manual_seed(seed))
    # channels-last conv weights: with them cuDNN writes channels-last
    # output, which is contiguous NHWC; load_state_dict keeps the layout
    net = net.to(dtype=dtype, memory_format=torch.channels_last).eval()
    return GanModel(cfg=cfg, gen_cfg=gen_cfg, netG=net, device=dev)
