"""CycleGAN, the unpaired model — the port of ``ir2rgb_tpu/train/cycle.py``.

Two generators, ``G_A`` (A -> B, the serving ``netG``) and ``G_B``
(``netG_B``), and two unconditional PatchGANs padded 1 (the pix2pix
convention): ``D_A`` (``netD``) judges B-domain images, ``D_B``
(``netD_B``) A-domain ones. One Adam covers both generators, one both
discriminators. The loss (``cycle.py:127-197``), in JAX's call order:

- four generator forwards, each with its own dropout draw: fake_b =
  G_A(a), fake_a = G_B(b), rec_a = G_B(fake_b), rec_b = G_A(fake_a);
- G side, D frozen: the GAN loss of D_A(fake_b) and D_B(fake_a), the
  cycle L1 of rec_a to a (× ``lambda_a``) and rec_b to b (× ``lambda_b``)
  and, with ``lambda_identity > 0``, G_A(b) to b and G_B(a) to a
  (× ``lambda_b`` / ``lambda_a`` × ``lambda_identity``);
- D side, on the detached fakes through one pool per domain (fake_b's,
  then fake_a's): D_A on b and the pooled fake_b, D_B on a and the
  pooled fake_a.

Metrics ``G_A G_B Cyc_A Cyc_B [Idt_A Idt_B] D_A D_B``. The model is a
:class:`GanModel`, whose ``train_step`` it keeps: grad-accum, EMA (of
both generators) and the bf16 Adam compose with it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from ir2rgb_tpu_torch.config import Config
from ir2rgb_tpu_torch.losses import gan_loss_d_parts, gan_loss_g, l1_loss
from ir2rgb_tpu_torch.nn.discriminators import DiscConfig, define_d
from ir2rgb_tpu_torch.nn.generators import GenConfig, define_g
from ir2rgb_tpu_torch.runtime import resolve_device, resolve_dtype
from ir2rgb_tpu_torch.train.image_pool import init_pool, query_pool
from ir2rgb_tpu_torch.train.model import (
    Batch,
    GanModel,
    _build,
    _no_param_grads,
    make_adam,
    make_schedule,
)


@dataclasses.dataclass
class CycleGanModel(GanModel):
    gen_cfg_b: Optional[GenConfig] = None
    disc_cfg_b: Optional[DiscConfig] = None
    netG_B: Optional[nn.Module] = None  # G_B: B -> A
    netD_B: Optional[nn.Module] = None  # D_B: judges A-domain images

    def g_nets(self) -> Dict[str, nn.Module]:
        return {"netG": self.netG, "netG_B": self.netG_B}

    def d_nets(self) -> Dict[str, nn.Module]:
        return {"netD": self.netD, "netD_B": self.netD_B}

    def _gen_cfg_of(self, name: str) -> GenConfig:
        return self.gen_cfg_b if name == "netG_B" else self.gen_cfg

    def generate(self, a: torch.Tensor, prev: Optional[torch.Tensor] = None,
                 feat: Optional[torch.Tensor] = None,
                 edges: Optional[torch.Tensor] = None,
                 direction: str = "AtoB") -> torch.Tensor:
        """Serve one direction: A -> B through ``G_A`` (the default; the
        stream, the trainer's display and the CLIs call this), or
        ``direction="BtoA"`` through ``G_B`` (the gallery's
        reconstruction)."""
        if direction not in ("AtoB", "BtoA"):
            raise ValueError(f"unknown direction {direction!r} (AtoB | BtoA)")
        net = self.serving_generator("netG" if direction == "AtoB"
                                     else "netG_B")
        with torch.inference_mode():
            return net(a)

    def _g(self, net: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return net(x, train=True, generator=self.generator)

    def loss_and_metrics(self, batch: Batch, freeze_trunk: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Dict[str, torch.Tensor]]:
        """(loss_g, loss_d, metrics) of one unpaired batch
        (``batch["a"]`` from domain A, ``batch["b"]`` from B, NHWC in
        [-1, 1]); ``loss_g`` reaches only the generators, ``loss_d`` only
        the discriminators."""
        loss_cfg = self.cfg.loss
        mode = loss_cfg.gan_mode
        a, b = batch["a"].to(self.device), batch["b"].to(self.device)
        a_c, b_c = a.to(self.dtype), b.to(self.dtype)
        g_a, g_b, d_a, d_b = self.netG, self.netG_B, self.netD, self.netD_B

        fake_b = self._g(g_a, a_c)
        fake_a = self._g(g_b, b_c)
        rec_a = self._g(g_b, fake_b)
        rec_b = self._g(g_a, fake_a)

        metrics: Dict[str, torch.Tensor] = {}
        with _no_param_grads((*d_a.parameters(), *d_b.parameters())):
            metrics["G_A"] = gan_loss_g(d_a(fake_b), mode)
            metrics["G_B"] = gan_loss_g(d_b(fake_a), mode)
        metrics["Cyc_A"] = l1_loss(rec_a, a) * loss_cfg.lambda_a
        metrics["Cyc_B"] = l1_loss(rec_b, b) * loss_cfg.lambda_b
        loss_g = (metrics["G_A"] + metrics["G_B"] + metrics["Cyc_A"]
                  + metrics["Cyc_B"])
        if loss_cfg.lambda_identity > 0:
            idt_a = self._g(g_a, b_c)
            idt_b = self._g(g_b, a_c)
            metrics["Idt_A"] = (l1_loss(idt_a, b) * loss_cfg.lambda_b
                                * loss_cfg.lambda_identity)
            metrics["Idt_B"] = (l1_loss(idt_b, a) * loss_cfg.lambda_a
                                * loss_cfg.lambda_identity)
            loss_g = loss_g + metrics["Idt_A"] + metrics["Idt_B"]

        fb_d, fa_d = fake_b.detach(), fake_a.detach()
        if self.pool is not None:
            fb_d, pool_b = query_pool(self.pool["fake_b"], fb_d,
                                      self.generator)
            fa_d, pool_a = query_pool(self.pool["fake_a"], fa_d,
                                      self.generator)
            self.pool = {"fake_a": pool_a, "fake_b": pool_b}
        da_real, da_fake = gan_loss_d_parts(
            d_a(b_c), d_a(fb_d.to(self.dtype).detach()), mode)
        db_real, db_fake = gan_loss_d_parts(
            d_b(a_c), d_b(fa_d.to(self.dtype).detach()), mode)
        metrics["D_A"] = da_real + da_fake
        metrics["D_B"] = db_real + db_fake
        loss_d = metrics["D_A"] + metrics["D_B"]
        metrics["_loss_g"] = loss_g
        metrics["_loss_d"] = loss_d
        return loss_g, loss_d, metrics


def cycle_network_configs(cfg: Config
                          ) -> Tuple[GenConfig, GenConfig, DiscConfig,
                                     DiscConfig]:
    """G_A's, G_B's, D_A's and D_B's configurations, raising the JAX
    package's ``ValueError`` for what CycleGAN does not combine with
    (``cycle.py:206-225``)."""
    m = cfg.model
    for flag, name in ((m.label_nc > 0, "label_nc"),
                       (m.use_instance_feat, "use_instance_feat"),
                       (m.use_instance_edges, "use_instance_edges")):
        if flag:
            raise ValueError(
                f"cycle_gan does not combine with {name} (the family "
                f"keeps unpaired translation and pix2pixHD semantic "
                f"conditioning separate)")
    if cfg.loss.gan_mode == "wgangp":
        raise ValueError(
            "cycle_gan + wgangp is not offered (the family's CycleGAN "
            "uses lsgan/vanilla; use one of those, or hinge)")
    if cfg.loss.lambda_identity > 0 and m.input_nc != m.output_nc:
        raise ValueError(
            f"the identity loss feeds B-domain images ({m.output_nc}ch) "
            f"through G_A (expects {m.input_nc}ch) — set "
            f"--loss.lambda_identity 0 when input_nc != output_nc, as "
            f"the reference requires")
    if cfg.infer.quant != "none":
        raise NotImplementedError(f"quant={cfg.infer.quant!r} is not "
                                  "ported yet")
    dtype = resolve_dtype(m.compute_dtype)
    gen_a = GenConfig(
        net_g=m.net_g, input_nc=m.input_nc, output_nc=m.output_nc,
        ngf=m.ngf, norm=m.norm, upsample=m.upsample,
        use_dropout=m.use_dropout, n_downsample_global=m.n_downsample_global,
        n_blocks_global=m.n_blocks_global, n_blocks_local=m.n_blocks_local,
        n_local_enhancers=m.n_local_enhancers, compute_dtype=dtype,
        remat=m.remat)
    gen_b = dataclasses.replace(gen_a, input_nc=m.output_nc,
                                output_nc=m.input_nc)
    # unconditional (no input to pair with), padded 1 as pix2pix pads
    disc_a = DiscConfig(
        net_d=m.net_d, input_nc=m.output_nc, ndf=m.ndf, n_layers=m.n_layers_d,
        num_d=m.num_d, norm=m.norm, get_interm_feat=m.get_interm_feat,
        d_pad=1, compute_dtype=dtype)
    disc_b = dataclasses.replace(disc_a, input_nc=m.input_nc)
    return gen_a, gen_b, disc_a, disc_b


def create_cycle_model(cfg: Config,
                       device: Optional[Union[str, torch.device]] = None,
                       steps_per_epoch: int = 1000,
                       seed: int = 0) -> CycleGanModel:
    """``create_model`` for ``model="cycle_gan"``: G_A's weights from
    ``seed``, D_A's from ``seed + 1``, G_B's from ``seed + 4``, D_B's from
    ``seed + 5``, the dropout and pool draws from ``seed + 3``. No VGG
    (the family's CycleGAN has no perceptual loss)."""
    gen_a, gen_b, disc_a, disc_b = cycle_network_configs(cfg)
    dev = resolve_device(device)
    m = cfg.model
    g_a = _build(lambda: define_g(gen_a), dev, seed, m.init_type)
    d_a = _build(lambda: define_d(disc_a), dev, seed + 1, m.init_type)
    g_b = _build(lambda: define_g(gen_b), dev, seed + 4, m.init_type)
    d_b = _build(lambda: define_d(disc_b), dev, seed + 5, m.init_type)
    schedule = make_schedule(cfg, steps_per_epoch)
    adam = make_adam(cfg, schedule)
    pool = None
    if cfg.loss.pool_size > 0:
        crop = cfg.data.crop_size
        pool = {"fake_a": init_pool(cfg.loss.pool_size,
                                    (crop, crop, m.input_nc),
                                    gen_a.compute_dtype, dev),
                "fake_b": init_pool(cfg.loss.pool_size,
                                    (crop, crop, m.output_nc),
                                    gen_a.compute_dtype, dev)}
    model = CycleGanModel(
        cfg=cfg, gen_cfg=gen_a, netG=g_a, device=dev, disc_cfg=disc_a,
        netD=d_a, vgg=None,
        opt_g=adam([*g_a.parameters(), *g_b.parameters()]),
        opt_d=adam([*d_a.parameters(), *d_b.parameters()]),
        schedule=schedule, steps_per_epoch=steps_per_epoch, fix_steps=0,
        generator=torch.Generator(device=dev).manual_seed(seed + 3),
        pool=pool, gen_cfg_b=gen_b, disc_cfg_b=disc_b, netG_B=g_b,
        netD_B=d_b)
    if cfg.train.ema_decay > 0:
        model.init_ema()
    return model
