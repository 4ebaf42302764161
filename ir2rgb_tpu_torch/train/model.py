"""The GAN model — the port of ``ir2rgb_tpu/train/model.py`` for serving
and for the non-temporal train step.

``create_model(cfg)`` builds, on the CUDA device (or the device the
caller names), the generator ``netG``, the discriminator ``netD``, the
VGG19 of the perceptual loss and two Adam optimizers. Parameters are fp32
master weights; G, D and the VGG compute in ``cfg.model.compute_dtype``
and cast the weights at use, as the JAX package does. Weights are the
reference ``weights_init`` drawn from seeded ``torch.Generator``s; load
trained or JAX-converted weights with ``load_state_dict``.

- ``generate`` is the serving forward (no autograd). In bf16 it runs a
  bf16 copy of ``netG`` that is rebuilt when a weight of ``netG``
  changes, so a serving frame casts nothing.
- ``train_step(batch)`` is one G + D update with the JAX package's
  stop-gradient walls (``model.py:13-21``): G's gradient comes through D
  with D's parameters frozen, D's from the detached fake, and the G-side
  real passes (feature-matching targets, VGG of the target) record no
  graph. The four D passes are separate, as in the JAX default.
  Adam is optax's ``adam`` (eps 1e-8, bias correction on both moments),
  the lr is set from the schedule before each step, and the
  coarse-to-fine freeze (``niter_fix_global``) zeroes the trunk's grads
  until ``fix_steps``, where G's Adam state is cleared, as the reference's
  fresh optimizer at the unfreeze. On a frozen step the trunk records no
  graph: its gradients are zero by definition.

Not ported yet (each raises ``NotImplementedError``): the label one-hot
input (``label_nc > 0``), the instance-edge and netE feature inputs, the
serving quantization modes, every generator but ``net_g="local"``, and in
training the temporal model, the image pool, grad-accum, EMA,
``adam_mu_dtype="bf16"`` and WGAN-GP.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch
import torch.nn as nn

from ir2rgb_tpu_torch.config import Config
from ir2rgb_tpu_torch.losses import (
    feature_matching_loss,
    gan_loss_d_parts,
    gan_loss_g,
    l1_loss,
    vgg_loss,
)
from ir2rgb_tpu_torch.nn.discriminators import DiscConfig, define_d
from ir2rgb_tpu_torch.nn.generators import GenConfig, LocalEnhancer, init_weights
from ir2rgb_tpu_torch.nn.vgg import Vgg19, load_vgg19_npz
from ir2rgb_tpu_torch.runtime import resolve_device, resolve_dtype
from ir2rgb_tpu_torch.train.schedule import global_freeze_mask, lr_schedule

Batch = Dict[str, torch.Tensor]


@contextlib.contextmanager
def _no_param_grads(params: Iterable[nn.Parameter]):
    """Treat ``params`` as constants for the ops recorded inside: the
    graph still reaches the inputs, never these parameters."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


@dataclasses.dataclass
class GanModel:
    cfg: Config
    gen_cfg: GenConfig
    netG: LocalEnhancer
    device: torch.device
    disc_cfg: Optional[DiscConfig] = None
    netD: Optional[nn.Module] = None
    vgg: Optional[Vgg19] = None
    opt_g: Optional[torch.optim.Adam] = None
    opt_d: Optional[torch.optim.Adam] = None
    schedule: Optional[Callable[[int], float]] = None
    steps_per_epoch: int = 1000
    # coarse-to-fine unfreeze boundary in steps (niter_fix_global *
    # steps_per_epoch); > 0 only for net_g=local
    fix_steps: int = 0
    step: int = 0
    _serving: Optional[Tuple[tuple, tuple, LocalEnhancer]] = dataclasses.field(
        default=None, repr=False)

    @property
    def n_prev(self) -> int:
        m = self.cfg.model
        return m.n_frames_g - 1 if m.model == "temporal" else 0

    @property
    def dtype(self) -> torch.dtype:
        return self.gen_cfg.compute_dtype

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------

    def serving_generator(self) -> LocalEnhancer:
        """``netG`` in fp32; in bf16 a bf16 copy of it, rebuilt when any
        of ``netG``'s parameters was replaced or changed in place."""
        if self.dtype == torch.float32:
            return self.netG
        params = tuple(self.netG.parameters())
        versions = tuple(p._version for p in params)
        kept = self._serving
        if (kept is None or len(kept[0]) != len(params) or versions != kept[1]
                or any(a is not b for a, b in zip(kept[0], params))):
            with torch.device("meta"):
                g = LocalEnhancer(self.gen_cfg)
            with torch.no_grad():
                g.load_state_dict({k: v.to(self.dtype) for k, v in
                                   self.netG.state_dict().items()},
                                  assign=True)
            kept = self._serving = (params, versions,
                                    g.requires_grad_(False).eval())
        return kept[2]

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
        net = self.serving_generator()  # built outside inference mode
        with torch.inference_mode():
            return net(a)

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def trunk_parameters(self):
        return self.netG.model.parameters()

    def loss_and_metrics(self, batch: Batch, freeze_trunk: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Dict[str, torch.Tensor]]:
        """(loss_g, loss_d, metrics) for one batch of NHWC frames in
        [-1, 1] (``batch["a"]`` the input, ``batch["b"]`` the target),
        with the graph recorded for both losses. ``loss_g`` reaches only
        G's parameters, ``loss_d`` only D's; ``freeze_trunk`` records no
        graph through the global trunk."""
        if self.cfg.model.model == "temporal":
            raise NotImplementedError("training the temporal model "
                                      "(_temporal_losses) is not ported yet")
        if self.netD is None:
            raise ValueError("this model has no discriminator")
        loss_cfg = self.cfg.loss
        a, b = batch["a"].to(self.device), batch["b"].to(self.device)
        frozen = self.trunk_parameters() if freeze_trunk else ()
        with _no_param_grads(frozen):
            fake = self.netG(a, train=True)
        # D pairs in the generator's compute dtype; losses reduce in fp32
        cdt = fake.dtype
        a_c, b_c = a.to(cdt), b.to(cdt)
        pair_real = torch.cat([a_c, b_c], dim=-1)
        pair_fake = torch.cat([a_c, fake], dim=-1)

        # G side: D's parameters frozen, the real taps without a graph
        want_fm = not loss_cfg.no_gan_feat_loss and self.disc_cfg.get_interm_feat
        with _no_param_grads(self.netD.parameters()):
            d_out_fake_g = self.netD(pair_fake)
        metrics: Dict[str, torch.Tensor] = {}
        loss_g = gan_loss_g(d_out_fake_g, loss_cfg.gan_mode)
        metrics["G_GAN"] = loss_g
        if want_fm:
            with torch.no_grad():
                d_out_real_g = self.netD(pair_real)
            fm = feature_matching_loss(d_out_fake_g, d_out_real_g,
                                       self.disc_cfg.n_layers)
            fm = fm * loss_cfg.lambda_feat
            metrics["G_GAN_Feat"] = fm
            loss_g = loss_g + fm
        if not loss_cfg.no_vgg_loss and self.vgg is not None:
            vgg_dtype = torch.bfloat16 if cdt == torch.bfloat16 else None
            vl = vgg_loss(self.vgg, fake, b, dtype=vgg_dtype) \
                * loss_cfg.lambda_vgg
            metrics["G_VGG"] = vl
            loss_g = loss_g + vl
        if loss_cfg.lambda_l1 > 0:
            l1 = l1_loss(fake, b) * loss_cfg.lambda_l1
            metrics["G_L1"] = l1
            loss_g = loss_g + l1

        # D side: live D parameters, the fake detached from G
        d_out_real = self.netD(pair_real)
        d_out_fake = self.netD(pair_fake.detach())
        d_real, d_fake = gan_loss_d_parts(d_out_real, d_out_fake,
                                          loss_cfg.gan_mode)
        metrics["D_real"] = d_real
        metrics["D_fake"] = d_fake
        return loss_g, d_real + d_fake, metrics

    def compute_grads(self, batch: Batch, freeze_trunk: bool = False
                      ) -> Dict[str, torch.Tensor]:
        """Backward of loss_g + loss_d into the ``.grad`` of G's and D's
        parameters (cleared first). Returns the metrics, detached."""
        for p in (*self.netG.parameters(), *self.netD.parameters()):
            p.grad = None
        loss_g, loss_d, metrics = self.loss_and_metrics(batch, freeze_trunk)
        (loss_g + loss_d).backward()
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One fused G + D update; returns the metrics as 0-dim tensors
        on the device (reading them waits for the step)."""
        step = self.step
        frozen = step < self.fix_steps
        metrics = self.compute_grads(batch, freeze_trunk=frozen)
        if self.fix_steps > 0:
            global_freeze_mask(self.fix_steps)(self.netG.named_parameters(),
                                               step)
            if step == self.fix_steps:
                # the reference's fresh optimizer at the unfreeze: G's
                # moments and per-parameter step counts restart; D's
                # optimizer is never reset
                self.opt_g.state.clear()
        lr = self.schedule(step)
        for opt in (self.opt_g, self.opt_d):
            for group in opt.param_groups:
                group["lr"] = lr
        self.opt_g.step()
        self.opt_d.step()
        self.step = step + 1
        return metrics


def _check_supported(cfg: Config) -> None:
    m, loss, tr = cfg.model, cfg.loss, cfg.train
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
    if m.upsample != "deconv":
        raise NotImplementedError(f"upsample={m.upsample!r} is not ported "
                                  "yet")
    unported = {"pool_size > 0 (image pool)": loss.pool_size > 0,
                "gan_mode='wgangp' (gradient penalty)":
                    loss.gan_mode == "wgangp",
                "grad_accum > 1": tr.grad_accum > 1,
                "ema_decay > 0": tr.ema_decay > 0,
                "adam_mu_dtype='bf16'": tr.adam_mu_dtype in ("bf16",
                                                             "bfloat16")}
    for what, bad in unported.items():
        if bad:
            raise NotImplementedError(f"training with {what} is not ported "
                                      "yet")


def _build(module_fn, dev: torch.device, seed: int) -> nn.Module:
    """Build on the meta device, materialise on ``dev``, draw the
    reference init from ``seed`` and make the conv weights channels-last
    (so cuDNN writes channels-last output, which is contiguous NHWC)."""
    with torch.device("meta"):
        net = module_fn()
    net = net.to_empty(device=dev)
    init_weights(net, torch.Generator().manual_seed(seed))
    return net.to(memory_format=torch.channels_last)


def create_model(cfg: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 steps_per_epoch: int = 1000,
                 vgg_weights_npz: Optional[str] = None,
                 seed: int = 0) -> GanModel:
    """Build G, D, the VGG and their optimizers. ``device=None`` means the
    CUDA device and raises when there is none; pass ``device="cpu"`` for
    the CPU. G's weights come from ``seed``, D's from ``seed + 1`` and a
    random VGG's from ``seed + 2``."""
    dev = resolve_device(device)
    _check_supported(cfg)
    m = cfg.model
    n_prev = m.n_frames_g - 1 if m.model == "temporal" else 0
    dtype = resolve_dtype(m.compute_dtype)
    gen_cfg = GenConfig(
        net_g=m.net_g, input_nc=m.input_nc + m.output_nc * n_prev,
        output_nc=m.output_nc, ngf=m.ngf, norm=m.norm,
        n_downsample_global=m.n_downsample_global,
        n_blocks_global=m.n_blocks_global, n_blocks_local=m.n_blocks_local,
        n_local_enhancers=m.n_local_enhancers, compute_dtype=dtype)
    disc_cfg = DiscConfig(
        net_d=m.net_d, input_nc=m.input_nc + m.output_nc, ndf=m.ndf,
        n_layers=m.n_layers_d, num_d=m.num_d, norm=m.norm,
        get_interm_feat=m.get_interm_feat, compute_dtype=dtype)
    net_g = _build(lambda: LocalEnhancer(gen_cfg), dev, seed)
    net_d = _build(lambda: define_d(disc_cfg), dev, seed + 1)

    vgg = None
    if not cfg.loss.no_vgg_loss:
        npz = vgg_weights_npz or (cfg.loss.vgg_weights or None)
        if npz is not None:
            vgg = load_vgg19_npz(npz)
        else:
            warnings.warn(
                "VGG perceptual loss is running on RANDOM (He-init) "
                "weights — no pretrained VGG19 file was supplied. The "
                "reference's VGGLoss uses ImageNet-pretrained features; "
                "set cfg.loss.vgg_weights to an .npz produced by "
                "`ir2rgb-convert vgg19 <vgg19.pth>` for matching "
                "semantics, or set cfg.loss.no_vgg_loss to silence "
                "this.", stacklevel=2)
            vgg = Vgg19().init_random(seed + 2)
        vgg = vgg.to(dev, memory_format=torch.channels_last)
        vgg.requires_grad_(False)

    tcfg = cfg.train
    schedule = lr_schedule(tcfg.lr_policy, tcfg.lr, tcfg.niter,
                           tcfg.niter_decay, steps_per_epoch,
                           tcfg.lr_decay_iters)

    def adam(params):
        return torch.optim.Adam(params, lr=schedule(0),
                                betas=(tcfg.beta1, tcfg.beta2), eps=1e-8)

    fix_steps = tcfg.niter_fix_global * steps_per_epoch
    return GanModel(cfg=cfg, gen_cfg=gen_cfg, netG=net_g, device=dev,
                    disc_cfg=disc_cfg, netD=net_d, vgg=vgg,
                    opt_g=adam(net_g.parameters()),
                    opt_d=adam(net_d.parameters()), schedule=schedule,
                    steps_per_epoch=steps_per_epoch,
                    fix_steps=fix_steps if m.net_g == "local" else 0)
