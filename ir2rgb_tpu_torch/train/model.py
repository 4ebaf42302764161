"""The GAN model — the port of ``ir2rgb_tpu/train/model.py`` for serving
and for the train step, temporal windows included.

``create_model(cfg)`` builds, on the CUDA device (or the device the
caller names), the generator ``netG`` (any ``net_g`` of ``define_g``),
the discriminator ``netD`` (n-layer, multiscale or pixel), the VGG19 of
the perceptual loss, with ``use_instance_feat`` the feature encoder
``netE`` (``nn/encoders.py``), two Adam optimizers, one seeded
``torch.Generator`` on the device for dropout, the image pool and the
gradient penalty's mixing weights (JAX's ``TrainState.rng``), with ``pool_size > 0`` the
pool (``train/image_pool.py``, compute-dtype frames of the crop size)
and with ``ema_decay > 0`` an fp32 shadow of G's parameters. A
``cycle_gan`` config builds the unpaired model instead
(``train/cycle.py``). Parameters are fp32 master weights; G, D and the
VGG compute in ``cfg.model.compute_dtype`` and cast the weights at use,
as the JAX package does. Weights are the reference ``weights_init`` drawn
from seeded ``torch.Generator``s, re-drawn per ``init_type``; load
trained or JAX-converted weights with ``load_state_dict``.

- ``generate`` is the serving forward (no autograd). Its input is, in
  channel order (``model.py:199-221``): the frame, or with ``label_nc >
  0`` the one-hot of a (B, H, W, 1) class-id map (``encode_label``); the
  instance-edge channel (``use_instance_edges``; zeros when none is
  given); netE's feature map (``use_instance_feat``; zeros when none is
  given: ``encode_features`` of a real image, or clustered styles from
  ``infer/features.py``); in temporal mode the previous generated
  frames. In bf16 it runs a bf16 copy of ``netG`` (batch-norm parameters
  stay fp32, as the JAX package reads them) that is rebuilt when a
  weight of ``netG`` changes, so a serving frame casts nothing. It
  serves in the model's own quantization mode (``cfg.infer.quant``,
  ``nn/quant.py``), set for the duration of the call; every training
  forward runs in "none".
- ``train_step(batch)`` is one G + D update with the JAX package's
  stop-gradient walls (``model.py:13-21``): G's gradient comes through D
  with D's parameters frozen, D's from the detached (pool-mixed) fake,
  and the G-side real passes (feature-matching targets, VGG of the
  target) record no graph. The four D passes are separate, as in the JAX
  default. With ``gan_mode="wgangp"`` D's loss adds the gradient penalty
  on the detached real and fake pairs, a second derivative through D.
  The input may be a label map (one-hot on the device) with an
  instance-edge channel (``batch["inst"]``); with netE, E encodes the
  real target pooled per instance of ``batch["inst"]`` and G conditions
  on it (D does not see it); E is in G's Adam, live through the
  coarse-to-fine freeze, and the step reports ``inst_collisions``
  (hash segments shared by distinct ids); G drops out with
  ``use_dropout``; a temporal model trains on (B, T, H, W, C) windows,
  the carry keeping G's graph (``_temporal_losses``). With ``grad_accum
  = K`` the batch is cut into K micro-batches in order, each one's
  gradient taken at the same parameters and summed, the pool and the
  random draws running through them in order; the step divides by K and
  reports the micro-batches' mean metrics (``model.py:451-505``).
  Adam is optax's ``adam`` (eps 1e-8, bias correction on both moments;
  ``train/optim.py`` with ``adam_mu_dtype="bf16"``), the lr is set from
  the schedule before each step, and the coarse-to-fine freeze
  (``niter_fix_global``) zeroes the trunk's grads until ``fix_steps``,
  where G's Adam state is cleared, as the reference's fresh optimizer at
  the unfreeze. On a frozen step the trunk records no graph: its
  gradients are zero by definition. After the update the EMA shadow
  becomes ``d·e + (1 − d)·p`` (``model.py:537-541``).

- Data-parallel (``parallel/``: ``replicate`` attaches ``mesh``): each
  rank steps on its rows of the global batch and does exactly what JAX's
  sharded ``train_step`` does over it. The passes run inside
  ``parallel.mesh.sharded``: dropout masks and WGAN-GP's weights are
  drawn at the global shape and sliced, the pool queries the gathered
  global fakes, batch norm takes global statistics. After the last
  backward one averaging all-reduce of every gradient (a flat buffer a
  network) and one of the metrics (``inst_collisions`` summed); the
  freeze, both Adams and the EMA then run unchanged on every rank. No
  ``DistributedDataParallel``: ``netD`` runs outside any wrapper's
  forward and the step is one backward of ``loss_g + loss_d``.

- Spatially partitioned (a dp×sp mesh, ``parallel.dp_sp_mesh``): the
  batch holds this rank's block (its data row's images, its rows of
  them) and the passes run under ``parallel.spatial.serving``: the ops
  exchange halo rows and B1's statistics, and their transposes in the
  backward; every loss is this rank's partial sum over the frame's
  element count, so the ``sp`` ranks' losses and gradients add up to
  their data row's; the draws are the data row's on each of its ranks,
  and the pool gathers whole frames. The one all-reduce of the
  gradients and of the metrics then sums over every rank and divides by
  ``dp``. A temporal window runs frame by frame as in one process, each
  rank carrying its rows of the previous fakes (the carry keeps the
  fakes' partition); each frame's dropout masks and pool query are the
  data row's, drawn in one process's order. With ``remat`` a residual
  block's recompute replays its halo exchanges and statistics merges in
  the backward, on every rank alike. WGAN-GP's penalty runs on this
  rank's rows of x̂, its second derivative through the halos and the
  split B1 (each twice differentiable) and each sample's norm summed
  over the ranks (``losses.gradient_penalty``); a CycleGAN
  (``train/cycle.py``) runs its four networks and two pools the same
  way. netE runs on the rank's rows of the real target, its pooling
  adding the ranks' segment sums, and the edge channel is the rank's
  rows of the whole map's edges (id maps stay whole on every rank);
  ``inst_collisions`` counts each data row's maps once. The U-Net
  (``pix2pix_unet256``, ``unet_128``) trains so too: its inner levels'
  shards are uneven or empty, its ups realigned to its skips
  (``nn/generators.py``), and batch norm's moments span every rank's
  rows, a rank of no rows adding zeros.

- ``state_dict`` / ``load_state_dict`` hold everything ``train_step``
  reads (JAX's ``TrainState``, the EMA shadows as ``ema_g`` and
  ``ema_e``), for ``checkpoint/manager.py``.

Refused as the JAX package refuses them (at ``create_model``): labels,
instance edges or netE features with temporal mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import warnings
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch
import torch.nn as nn

from ir2rgb_tpu_torch.config import Config
from ir2rgb_tpu_torch.losses import (
    feature_matching_loss,
    gan_loss_d_parts,
    gan_loss_g,
    gradient_penalty,
    l1_loss,
    vgg_loss,
)
from ir2rgb_tpu_torch.nn import ops, quant
from ir2rgb_tpu_torch.nn.discriminators import DiscConfig, define_d
from ir2rgb_tpu_torch.nn.encoders import (
    EncoderConfig,
    define_e,
    instance_collision_count,
    instance_edges,
)
from ir2rgb_tpu_torch.nn.generators import GenConfig, define_g, init_weights
from ir2rgb_tpu_torch.nn.vgg import Vgg19, load_vgg19_npz
from ir2rgb_tpu_torch.parallel import mesh as pmesh
from ir2rgb_tpu_torch.parallel import spatial
from ir2rgb_tpu_torch.parallel.mesh import DataParallelMesh
from ir2rgb_tpu_torch.runtime import resolve_device, resolve_dtype
from ir2rgb_tpu_torch.train.image_pool import PoolState, init_pool, query_pool
from ir2rgb_tpu_torch.train.optim import AdamBf16Mu
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
    netG: nn.Module
    device: torch.device
    disc_cfg: Optional[DiscConfig] = None
    netD: Optional[nn.Module] = None
    vgg: Optional[Vgg19] = None
    opt_g: Optional[torch.optim.Optimizer] = None
    opt_d: Optional[torch.optim.Optimizer] = None
    schedule: Optional[Callable[[int], float]] = None
    steps_per_epoch: int = 1000
    # coarse-to-fine unfreeze boundary in steps (niter_fix_global *
    # steps_per_epoch); > 0 only for net_g=local
    fix_steps: int = 0
    step: int = 0
    # dropout and pool draws (on the model's device); the pool's state
    generator: Optional[torch.Generator] = None
    pool: Optional[PoolState] = None
    # the fp32 EMA shadows of the generators' parameters (ema_decay > 0):
    # net name (g_nets) -> parameter name -> tensor
    ema: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
    # the feature encoder (use_instance_feat)
    enc_cfg: Optional[EncoderConfig] = None
    netE: Optional[nn.Module] = None
    # the data-parallel mesh the steps run over (``parallel.replicate``
    # attaches it); None: one process
    mesh: Optional[DataParallelMesh] = None
    # generator name -> (its parameters, their versions, the bf16 copy)
    _serving: Dict[str, Tuple[tuple, tuple, nn.Module]] = dataclasses.field(
        default_factory=dict, repr=False)
    # (mesh, its Shards): the partition a dp×sp step runs on, kept so that
    # its halo indices are built once
    _shards: Optional[tuple] = dataclasses.field(default=None, repr=False)

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

    def serving_generator(self, name: str = "netG") -> nn.Module:
        """Generator ``name`` (``g_nets``) in fp32; in bf16 a bf16 copy of
        it, rebuilt when any of its parameters was replaced or changed in
        place. The copy keeps batch-norm parameters and buffers as they
        are. It is built with inference mode off, also when asked for
        inside it, so its weights are normal tensors that ``Deconv`` can
        key its kept weight on."""
        src = self.g_nets()[name]
        if self.dtype == torch.float32:
            return src
        params = tuple(src.parameters())
        versions = tuple(p._version for p in params)
        kept = self._serving.get(name)
        if (kept is None or len(kept[0]) != len(params) or versions != kept[1]
                or any(a is not b for a, b in zip(kept[0], params))):
            with torch.device("meta"):
                g = define_g(self._gen_cfg_of(name))
            bn = tuple(f"{n}." for n, m in g.named_modules()
                       if isinstance(m, nn.BatchNorm2d))
            with torch.inference_mode(False), torch.no_grad():
                g.load_state_dict({k: v if k.startswith(bn) else
                                   v.to(self.dtype) for k, v in
                                   src.state_dict().items()},
                                  assign=True)
            kept = self._serving[name] = (params, versions,
                                          g.requires_grad_(False).eval())
        return kept[2]

    def _gen_cfg_of(self, name: str) -> GenConfig:
        """The configuration generator ``name`` was built from."""
        return self.gen_cfg

    def encode_label(self, a: torch.Tensor) -> torch.Tensor:
        """``label_nc > 0``: a (B, H, W, 1) class-id map (ids rounded half
        to even) -> its one-hot (B, H, W, label_nc) in the compute dtype,
        on ``a``'s device; an id outside [0, label_nc) gives an all-zero
        row, as ``jax.nn.one_hot`` (``model.py:157-169``). The identity
        when ``label_nc == 0``."""
        label_nc = self.cfg.model.label_nc
        if label_nc <= 0:
            return a
        ids = torch.round(a[..., :1].float()).long()
        classes = torch.arange(label_nc, device=a.device)
        return (ids == classes).to(self.dtype)

    def encode_features(self, image: torch.Tensor,
                        inst: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """netE's serving forward (no autograd): the features of NHWC
        ``image`` (a real RGB frame in [-1, 1]), pooled per instance of
        the (B, H, W) ids ``inst`` when given, in the compute dtype
        (``model.py:149-155``)."""
        if self.netE is None:
            raise ValueError("encode_features needs a use_instance_feat "
                             "model (this one has no netE)")
        with torch.inference_mode():
            return self.netE(image.to(self.device), inst if inst is None
                             else inst.to(self.device))

    def _generator_input(self, a: torch.Tensor,
                        prev: Optional[torch.Tensor] = None,
                        edges: Optional[torch.Tensor] = None,
                        feat: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """G's input: the (encoded) frame, the edge channel, netE's
        features, the temporal prev, in that order (``model.py:199-221``);
        zeros for any of the last three that is not given."""
        m = self.cfg.model
        a = self.encode_label(a)
        if m.use_instance_edges:
            if edges is None:
                edges = a.new_zeros(a.shape[:-1] + (1,))
            a = torch.cat([a, edges.to(a.dtype)], dim=-1)
        if self.enc_cfg is not None:
            if feat is None:
                feat = a.new_zeros(a.shape[:-1] + (self.enc_cfg.feat_num,))
            a = torch.cat([a, feat.to(a.dtype)], dim=-1)
        if m.model == "temporal":
            if prev is None:
                prev = a.new_zeros(a.shape[:-1] + (m.output_nc * self.n_prev,))
            a = torch.cat([a, prev.to(a.dtype)], dim=-1)
        return a

    def generate(self, a: torch.Tensor, prev: Optional[torch.Tensor] = None,
                 feat: Optional[torch.Tensor] = None,
                 edges: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Single-frame G forward on NHWC ``a`` (with ``label_nc > 0`` a
        (B, H, W, 1) id map). ``prev``: in temporal mode the previously
        generated frame stack; ``edges``: the (B, H, W, 1) instance
        boundary map of a ``use_instance_edges`` model; ``feat``: the
        (B, H, W, feat_num) netE feature map of a ``use_instance_feat``
        model. Each is zeros when None. Runs in the model's quant mode.
        Returns (B, H, W, output_nc) in the compute dtype."""
        net = self.serving_generator()
        with torch.inference_mode(), quant.using(
                quant.resolve(self.cfg.infer.quant)):
            return net(self._generator_input(a, prev, edges, feat))

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def trunk_parameters(self):
        return self.netG.model.parameters()

    def g_nets(self) -> Dict[str, nn.Module]:
        """The generators one Adam covers (netE with them, as the
        reference's optimizer_G), by state_dict key."""
        if self.netE is None:
            return {"netG": self.netG}
        return {"netG": self.netG, "netE": self.netE}

    def d_nets(self) -> Dict[str, nn.Module]:
        """The discriminators the other Adam covers, by state_dict key."""
        return {"netD": self.netD}

    def _fake(self, a: torch.Tensor, prev: Optional[torch.Tensor] = None,
              edges: Optional[torch.Tensor] = None,
              freeze_trunk: bool = False,
              feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """G's training forward (differentiable tail, dropout drawn from
        ``generator``, quant mode "none"). ``freeze_trunk``: the global
        trunk's parameters get no gradient; the graph still runs through
        the trunk where its input needs one (a temporal carry)."""
        frozen = self.trunk_parameters() if freeze_trunk else ()
        with _no_param_grads(frozen), quant.using("none"):
            return self.netG(self._generator_input(a, prev, edges, feat),
                             train=True, generator=self.generator)

    def _for_d(self, fake: torch.Tensor) -> torch.Tensor:
        """The fake D's own update sees: through the image pool when
        there is one (the pool advances), else the fake."""
        if self.pool is None:
            return fake
        out, self.pool = query_pool(self.pool, fake.detach(), self.generator)
        return out

    def _frame_losses(self, a_d: torch.Tensor, b: torch.Tensor,
                      fake_for_d: torch.Tensor, fake: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        """The conditional-GAN losses of one frame batch
        (``model.py:223-323``): D's condition ``a_d`` (the encoded input
        and the edge channel), the target ``b``, ``fake`` carrying G's
        graph and ``fake_for_d`` (pool-mixed, no graph) for D's own
        update. Metrics, with the two totals as ``_loss_g`` (reaching only
        G) and ``_loss_d`` (only D)."""
        loss_cfg = self.cfg.loss
        # D pairs in the generator's compute dtype; losses reduce in fp32
        cdt = fake.dtype
        a_c, b_c = a_d.to(cdt), b.to(cdt)
        pair_real = torch.cat([a_c, b_c], dim=-1)
        pair_fake = torch.cat([a_c, fake], dim=-1)
        pair_fake_d = torch.cat([a_c, fake_for_d.detach().to(cdt)], dim=-1)

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

        # D side: live D parameters, the fake without G's graph
        d_out_real = self.netD(pair_real)
        d_out_fake = self.netD(pair_fake_d)
        d_real, d_fake = gan_loss_d_parts(d_out_real, d_out_fake,
                                          loss_cfg.gan_mode)
        metrics["D_real"] = d_real
        metrics["D_fake"] = d_fake
        loss_d = d_real + d_fake
        if loss_cfg.gan_mode == "wgangp":
            # on the detached pairs, D's parameters live: its gradient is
            # a second derivative through D (model.py:311-320)
            gp = gradient_penalty(self.netD, pair_real, pair_fake_d,
                                  self.generator, loss_cfg.lambda_gp)
            metrics["D_GP"] = gp
            loss_d = loss_d + gp
        metrics["_loss_g"] = loss_g
        metrics["_loss_d"] = loss_d
        return metrics

    def _temporal_losses(self, batch: Batch, freeze_trunk: bool
                         ) -> Dict[str, torch.Tensor]:
        """One window of ``batch["a"]`` / ``batch["b"]`` (B, T, H, W, C)
        frame by frame (``model.py:386-432``): G sees cat(a_t, prev), prev
        starting as zeros in the compute dtype and then the last
        ``n_frames_g - 1`` fakes, newest first. The carry keeps G's graph,
        as JAX's scan does (no stop-gradient): frame t's loss reaches G
        through every earlier frame. Each frame draws its own dropout and
        pool decisions. Metrics are the means over the frames;
        ``_frame_loss_g`` holds each frame's G loss. On a partitioned step
        the window holds this rank's rows of every frame: the zero carry
        is its rows, and the carry keeps the fakes' partition (a channel
        concat records none)."""
        a_seq = batch["a"].to(self.device)
        b_seq = batch["b"].to(self.device)
        out_nc = self.cfg.model.output_nc
        n_prev = self.n_prev
        prev = torch.zeros(a_seq.shape[:1] + a_seq.shape[2:4]
                           + (out_nc * n_prev,), dtype=self.dtype,
                           device=self.device)
        frames = []
        for t in range(a_seq.shape[1]):
            a_t, b_t = a_seq[:, t], b_seq[:, t]
            fake = self._fake(a_t, prev=prev, freeze_trunk=freeze_trunk)
            frames.append(self._frame_losses(a_t, b_t, self._for_d(fake),
                                             fake))
            if n_prev > 0:
                prev = next_carry(fake, prev, out_nc * n_prev)
        metrics = {k: torch.stack([f[k] for f in frames]).mean()
                   for k in frames[0]}
        metrics["_frame_loss_g"] = torch.stack([f["_loss_g"]
                                                for f in frames])
        return metrics

    def loss_and_metrics(self, batch: Batch, freeze_trunk: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Dict[str, torch.Tensor]]:
        """(loss_g, loss_d, metrics) for one batch, with the graph
        recorded for both losses (``model.py:325-384``). ``loss_g``
        reaches only G's parameters, ``loss_d`` only D's; ``freeze_trunk``
        keeps the global trunk's parameters out of the graph.

        ``batch["a"]`` is the input in [-1, 1] (with ``label_nc > 0`` a
        (B, H, W, 1) class-id map), ``batch["b"]`` the target, NHWC; a
        temporal model takes (B, T, H, W, C) windows. With
        ``use_instance_edges``, ``batch["inst"]`` holds the (B, H, W)
        instance ids, whose edge channel G and D both see. With netE, E
        encodes the real ``b`` (pooled per instance when the batch has
        ``inst``) and G conditions on it, its gradient reaching E through
        G's losses; D does not see it (``model.py:346-382``). Metrics whose
        name starts with ``_`` are the totals (and a window's per-frame G
        losses), not reported by ``train_step``."""
        m = self.cfg.model
        if m.model == "temporal":
            metrics = self._temporal_losses(batch, freeze_trunk)
        else:
            a, b = batch["a"].to(self.device), batch["b"].to(self.device)
            inst = batch.get("inst")
            inst = None if inst is None else inst.to(self.device)
            # a partitioned step's id maps are whole on every rank
            part = spatial.active()
            edges = feat = None
            if m.use_instance_edges:
                if inst is None:
                    raise ValueError(
                        "use_instance_edges is on but the batch has no "
                        "'inst' maps (<phase>Inst/ folder missing?)")
                edges = instance_edges(inst)
                if part is not None:
                    edges = part.rows_of(edges, a)
            if self.netE is not None:
                feat = self.netE(b, inst)
            fake = self._fake(a, edges=edges, freeze_trunk=freeze_trunk,
                              feat=feat)
            # D conditions on the encoded input and the edge channel
            a_d = self.encode_label(a)
            if edges is not None:
                a_d = torch.cat([a_d, edges.to(a_d.dtype)], dim=-1)
            metrics = self._frame_losses(a_d, b, self._for_d(fake), fake)
            if self.netE is not None and inst is not None:
                # a diagnostic count, not a loss term, summed over the
                # data rows: one rank of a data row counts its whole maps
                count = instance_collision_count(
                    inst, self.enc_cfg.num_instances).to(torch.float32)
                metrics["inst_collisions"] = (
                    count if part is None or part.rank == 0
                    else torch.zeros_like(count))
        return metrics["_loss_g"], metrics["_loss_d"], metrics

    def _params(self) -> Iterable[nn.Parameter]:
        for net in (*self.g_nets().values(), *self.d_nets().values()):
            yield from net.parameters()

    def compute_grads(self, batch: Batch, freeze_trunk: bool = False
                      ) -> Dict[str, torch.Tensor]:
        """Backward of loss_g + loss_d into the ``.grad`` of G's and D's
        parameters (cleared first). With ``grad_accum = K`` the batch is
        cut into K micro-batches in order, whose gradients add up before
        the division by K. Returns the reported metrics (the mean over
        the micro-batches), detached.

        Over a mesh (``self.mesh`` with a process group) ``batch`` is this
        rank's rows (``parallel.shard_batch``'s layout with K), the passes
        run inside ``parallel.mesh.sharded`` (draws, pool and batch norm
        over the global batch), and after the last backward one averaging
        all-reduce of every gradient and one of the metrics make them the
        global batch's on every rank. On a dp×sp mesh ``batch`` is this
        rank's block and the passes run partitioned
        (``parallel.spatial.serving``)."""
        accum = max(1, int(self.cfg.train.grad_accum))
        part = self.mesh is not None and self.mesh.sp > 1
        if part:
            if self._shards is None or self._shards[0] is not self.mesh:
                self._shards = (self.mesh, spatial.Shards.of(self.mesh))
        n = next(iter(batch.values())).shape[0]
        if n % accum:
            raise ValueError(f"train.grad_accum={accum} must divide the "
                             f"batch size ({n})")
        for p in self._params():
            p.grad = None
        metrics = []
        ctx = (spatial.serving(self.mesh, self._shards[1]) if part
               else pmesh.sharded(self.mesh))
        # a partitioned step's backward exchanges rows and sums in the
        # order the autograd engine runs its nodes, which must be every
        # rank's. With a second derivative (WGAN-GP) that takes the calling
        # thread alone: on a card the device's worker thread makes the
        # nodes of the penalty's inner gradient, and the engine orders
        # them against the forward's by two threads' counters, which
        # differ between ranks that did different work before (a rank-0
        # reference step): the ranks' exchanges then cross
        one_thread = (torch.autograd.set_multithreading_enabled(False)
                      if part and self.cfg.loss.gan_mode == "wgangp"
                      else contextlib.nullcontext())
        with ctx, one_thread:
            for i in range(accum):
                micro = batch if accum == 1 else {
                    k: v[i * n // accum:(i + 1) * n // accum]
                    for k, v in batch.items()}
                loss_g, loss_d, m = self.loss_and_metrics(micro,
                                                          freeze_trunk)
                (loss_g + loss_d).backward()
                metrics.append({k: v.detach() for k, v in m.items()
                                if not k.startswith("_")})
        dp = self.mesh is not None and self.mesh.group is not None
        if dp:
            pmesh.all_reduce_grads((*self.g_nets().values(),
                                    *self.d_nets().values()), self.mesh)
        if accum > 1:
            for p in self._params():
                if p.grad is not None:
                    p.grad.div_(accum)
            metrics = [{k: torch.stack([m[k] for m in metrics]).mean()
                        for k in metrics[0]}]
        if dp:
            return pmesh.all_reduce_metrics(metrics[0], self.mesh)
        return metrics[0]

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
        if self.ema is not None:
            self._update_ema()
        self.step = step + 1
        return metrics

    # ------------------------------------------------------------------
    # EMA of the generators
    # ------------------------------------------------------------------

    def init_ema(self) -> None:
        """Start the shadows from the generators' parameters (fp32
        copies), as at creation and after a warm start."""
        self.ema = {name: {k: p.detach().float().clone()
                           for k, p in net.named_parameters()}
                    for name, net in self.g_nets().items()}

    @torch.no_grad()
    def _update_ema(self) -> None:
        """e <- d·e + (1 − d)·p, in that form (``model.py:537-541``)."""
        d = float(self.cfg.train.ema_decay)
        for name, net in self.g_nets().items():
            shadow = self.ema[name]
            for k, p in net.named_parameters():
                shadow[k].mul_(d).add_(p.float() * (1.0 - d))

    @staticmethod
    def ema_key(name: str) -> str:
        """The checkpoint key of network ``name``'s EMA state_dict:
        ``ema_g`` (netG), ``ema_g_B`` (netG_B), ``ema_e`` (netE)."""
        return "ema_" + name[3].lower() + name[4:]

    def ema_state_dict(self, name: str = "netG") -> Dict[str, torch.Tensor]:
        """The state_dict of generator ``name`` with its parameters
        replaced by their EMA shadows (its buffers as they are): what
        ``--infer.use_ema`` serves."""
        sd = dict(self.g_nets()[name].state_dict())
        sd.update(self.ema[name])
        return sd

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def state_dict(self) -> Dict[str, object]:
        """Everything ``train_step`` reads (JAX's ``TrainState``): the
        networks' parameters and buffers (``netG`` / ``netD``, and a
        CycleGAN's ``netG_B`` / ``netD_B``), both optimizers' states, the
        step, the state of the device generator that draws dropout, the
        pool and the penalty's weights, the pool(s), the EMA shadows as
        full state_dicts (``ema_key``: ``ema_g``, ``ema_g_B``, ``ema_e``)
        and the config as JSON (with netE, ``netE`` is a network too).
        Tensors are the live ones: a checkpoint manager copies them."""
        state = {name: net.state_dict() for name, net in
                 (*self.g_nets().items(), *self.d_nets().items())}
        state.update(opt_g=self.opt_g.state_dict(),
                     opt_d=self.opt_d.state_dict(), step=self.step,
                     generator=self.generator.get_state(),
                     pool=_pool_state(self.pool),
                     config=json.dumps(dataclasses.asdict(self.cfg),
                                       sort_keys=True))
        if self.ema is not None:
            for name in self.ema:
                state[self.ema_key(name)] = self.ema_state_dict(name)
        return state

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Resume from :meth:`state_dict`'s output (tensors on any
        device): parameters, moments, the EMA shadows and the pool are
        copied into the live tensors, which keep their device and
        dtype."""
        for name, net in (*self.g_nets().items(), *self.d_nets().items()):
            net.load_state_dict(state[name])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
        self.pool = _load_pool(self.pool, state["pool"], self.device)
        if self.ema is not None:
            for name, shadow in self.ema.items():
                src = state[self.ema_key(name)]
                for k, v in shadow.items():
                    v.copy_(src[k])


def next_carry(fake: torch.Tensor, prev: torch.Tensor,
               width: int) -> torch.Tensor:
    """A window's carry after frame ``fake``: the newest ``width``
    channels of cat(fake, prev), G's graph kept. On a partitioned step it
    keeps ``fake``'s partition, which a channel concat does not record."""
    return spatial.same_rows(torch.cat([fake, prev], dim=-1)[..., :width],
                             fake)


def _pool_state(pool):
    """A pool (or a dict of pools, or None) as checkpoint data."""
    if isinstance(pool, dict):
        return {k: p._asdict() for k, p in pool.items()}
    return None if pool is None else pool._asdict()


def _load_pool(pool, saved, device: torch.device):
    """``pool`` (a pool, a dict of pools, or None) with ``saved``'s
    buffer and count copied in."""
    if isinstance(pool, dict):
        return {k: _load_pool(p, saved[k], device) for k, p in pool.items()}
    if pool is None:
        return None
    pool.buffer.copy_(saved["buffer"])
    return PoolState(pool.buffer, saved["count"].to(device))


def _check_supported(cfg: Config) -> None:
    """Raise for what the JAX package's ``create_model`` refuses."""
    m = cfg.model
    if m.model not in ("pix2pix", "pix2pixhd", "temporal", "cycle_gan"):
        raise ValueError(f"unknown model: {m.model!r}")
    if m.model == "temporal" and (m.label_nc > 0 or m.use_instance_edges):
        # as the JAX package's create_model asserts
        raise ValueError("label / instance-edge inputs and temporal mode "
                         "are not combined")
    if m.model == "temporal" and m.use_instance_feat:
        raise ValueError("instance features + temporal mode are not "
                         "combined (the reference families keep them "
                         "separate)")


def encoder_config(cfg: Config) -> Optional[EncoderConfig]:
    """netE's configuration (``model.py:587-596``): it encodes the
    output_nc-channel real image; None without ``use_instance_feat``."""
    m = cfg.model
    if not m.use_instance_feat:
        return None
    return EncoderConfig(input_nc=m.output_nc, feat_num=m.feat_num,
                         nef=m.nef, n_downsample_e=m.n_downsample_e,
                         norm=m.norm, num_instances=m.num_instances,
                         compute_dtype=resolve_dtype(m.compute_dtype))


def network_configs(cfg: Config) -> Tuple[GenConfig, DiscConfig]:
    """G's and D's configurations for ``cfg`` (raises on what the port
    cannot build). Their input channels: the frame (or ``label_nc`` one-hot
    channels), the edge channel with ``use_instance_edges`` (G and D
    both, ``model.py:565-585``), netE's ``feat_num`` with
    ``use_instance_feat`` (G only), then G's temporal prev."""
    _check_supported(cfg)
    m = cfg.model
    n_prev = m.n_frames_g - 1 if m.model == "temporal" else 0
    dtype = resolve_dtype(m.compute_dtype)
    base_nc = (m.label_nc if m.label_nc > 0 else m.input_nc) + int(
        m.use_instance_edges)
    gen_cfg = GenConfig(
        net_g=m.net_g, input_nc=base_nc + m.output_nc * n_prev
        + (m.feat_num if m.use_instance_feat else 0),
        output_nc=m.output_nc, ngf=m.ngf, norm=m.norm, upsample=m.upsample,
        use_dropout=m.use_dropout,
        n_downsample_global=m.n_downsample_global,
        n_blocks_global=m.n_blocks_global, n_blocks_local=m.n_blocks_local,
        n_local_enhancers=m.n_local_enhancers, compute_dtype=dtype,
        remat=m.remat)
    disc_cfg = DiscConfig(
        net_d=m.net_d, input_nc=base_nc + m.output_nc, ndf=m.ndf,
        n_layers=m.n_layers_d, num_d=m.num_d, norm=m.norm,
        get_interm_feat=m.get_interm_feat, compute_dtype=dtype)
    return gen_cfg, disc_cfg


def _build(module_fn, dev: torch.device, seed: int,
           init_type: str = "normal") -> nn.Module:
    """Build on the meta device, materialise on ``dev``, draw the
    reference init from ``seed`` (then the ``init_type`` re-draw from the
    same generator) and make the conv weights channels-last (so cuDNN
    writes channels-last output, which is contiguous NHWC)."""
    with torch.device("meta"):
        net = module_fn()
    net = net.to_empty(device=dev)
    gen = torch.Generator().manual_seed(seed)
    init_weights(net, gen)
    ops.apply_init_type(net, init_type, gen)
    return net.to(memory_format=torch.channels_last)


def make_adam(cfg: Config, schedule: Callable[[int], float]):
    """One Adam as the JAX package builds it (``model.py:665-668``):
    optax's formula, with bf16 first moments when ``adam_mu_dtype`` says
    so (``train/optim.py``), else ``torch.optim.Adam``."""
    tcfg = cfg.train
    if tcfg.adam_mu_dtype in ("bf16", "bfloat16"):
        return lambda params: AdamBf16Mu(params, lr=schedule(0),
                                         betas=(tcfg.beta1, tcfg.beta2),
                                         eps=1e-8)
    return lambda params: torch.optim.Adam(params, lr=schedule(0),
                                           betas=(tcfg.beta1, tcfg.beta2),
                                           eps=1e-8)


def make_schedule(cfg: Config, steps_per_epoch: int
                  ) -> Callable[[int], float]:
    tcfg = cfg.train
    return lr_schedule(tcfg.lr_policy, tcfg.lr, tcfg.niter, tcfg.niter_decay,
                       steps_per_epoch, tcfg.lr_decay_iters)


def create_model(cfg: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 steps_per_epoch: int = 1000,
                 vgg_weights_npz: Optional[str] = None,
                 seed: int = 0) -> GanModel:
    """Build G, D, the VGG, their optimizers, the random state, the pool
    and the EMA shadow. ``device=None`` means the CUDA device and raises
    when there is none; pass ``device="cpu"`` for the CPU. G's weights
    come from ``seed``, D's from ``seed + 1``, a random VGG's from ``seed
    + 2``, the dropout, pool and penalty draws from ``seed + 3`` and
    netE's from ``seed + 6``. A ``cycle_gan`` config builds
    ``train/cycle.py``'s model."""
    if cfg.model.model == "cycle_gan":
        from ir2rgb_tpu_torch.train.cycle import create_cycle_model
        return create_cycle_model(cfg, device, steps_per_epoch, seed)
    dev = resolve_device(device)
    gen_cfg, disc_cfg = network_configs(cfg)
    m = cfg.model
    net_g = _build(lambda: define_g(gen_cfg), dev, seed, m.init_type)
    net_d = _build(lambda: define_d(disc_cfg), dev, seed + 1, m.init_type)
    enc_cfg = encoder_config(cfg)
    net_e = (None if enc_cfg is None else
             _build(lambda: define_e(enc_cfg), dev, seed + 6, m.init_type))

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

    schedule = make_schedule(cfg, steps_per_epoch)
    adam = make_adam(cfg, schedule)
    fix_steps = cfg.train.niter_fix_global * steps_per_epoch
    pool = None
    if cfg.loss.pool_size > 0:
        crop = cfg.data.crop_size
        pool = init_pool(cfg.loss.pool_size, (crop, crop, m.output_nc),
                         gen_cfg.compute_dtype, dev)
    model = GanModel(cfg=cfg, gen_cfg=gen_cfg, netG=net_g, device=dev,
                     disc_cfg=disc_cfg, netD=net_d, vgg=vgg,
                     opt_g=adam([*net_g.parameters(), *(
                         () if net_e is None else net_e.parameters())]),
                     opt_d=adam(net_d.parameters()),
                     schedule=schedule, steps_per_epoch=steps_per_epoch,
                     fix_steps=fix_steps if m.net_g == "local" else 0,
                     generator=torch.Generator(device=dev).manual_seed(
                         seed + 3),
                     pool=pool, enc_cfg=enc_cfg, netE=net_e)
    if cfg.train.ema_decay > 0:
        model.init_ema()
    return model
