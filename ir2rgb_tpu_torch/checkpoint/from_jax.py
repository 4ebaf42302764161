"""JAX parameters -> the port's ``state_dict``s (generator,
discriminator, VGG19).

The JAX package keeps its parameters as nested dicts of arrays (its
``*_init`` functions: every generator of ``define_g``, the PatchGAN and
multiscale discriminators, ``vgg19_init``): conv kernels HWIO,
transposed-conv kernels as the equivalent *forward* conv kernel, spatially
flipped HWIO (``ir2rgb_tpu/nn/ops.py:176-181``), and batch norms as
``gamma`` / ``beta`` (with ``running_mean`` / ``running_var`` when they
came from a torch checkpoint). This module turns such a dict (of numpy
arrays) into a port ``state_dict``, whose keys are the reference family's
(torchvision's for the VGG), with its own copy of the layout math:

- conv: HWIO -> OIHW;
- deconv: flipped HWIO -> IOHW, by transposing back and then unflipping;
- batch norm: gamma -> weight, beta -> bias; running stats as given, else
  0 and 1 (batch statistics are what the generators compute with).

A CycleGAN's composite trees (``{"G_A", "G_B"}``, ``{"D_A", "D_B"}``,
and its EMA's) convert net by net (:func:`cycle_generators_from_jax`,
:func:`cycle_discriminators_from_jax`). The pixel discriminator's
``conv0`` / ``conv1`` / ``head`` fill the reference's ``net.0`` /
``net.2`` (+ its batch norm at ``net.3``) / ``net.5``.

The slots pair each JAX parameter with its module key in the orders of
``ir2rgb_tpu/checkpoint/torch_import.py:79-131``. The maps are linear, so
they convert gradients of the same trees too.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch

from ir2rgb_tpu_torch.nn.discriminators import DiscConfig, define_d
from ir2rgb_tpu_torch.nn.generators import (
    Deconv,
    GenConfig,
    LocalEnhancer,
    ResnetStack,
    UnetGenerator,
    define_g,
)
from ir2rgb_tpu_torch.nn.vgg import VGG_CONVS, Vgg19

Params = Dict[str, Any]


def conv_w(w: np.ndarray) -> np.ndarray:
    """HWIO -> torch Conv2d OIHW."""
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def deconv_w(w: np.ndarray) -> np.ndarray:
    """Flipped-HWIO forward-conv kernel -> torch ConvTranspose2d IOHW."""
    return np.ascontiguousarray(
        np.asarray(w).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


def _norm_slot(prefix: str, p: Params, norm: str):
    """A batch norm's slot (instance norm and none carry no parameters)."""
    if norm == "batch":
        yield prefix, p, "norm"


def _conv_norm_slots(seq: str, i: int, p: Params, norm: str):
    """``p["conv"]`` at ``{seq}.{i}``, its norm at ``{seq}.{i + 1}``."""
    yield f"{seq}.{i}", p["conv"], "conv"
    yield from _norm_slot(f"{seq}.{i + 1}", p.get("norm"), norm)


def _up_slots(seq: str, i: int, up: torch.nn.Module, p: Params, norm: str):
    kind = "deconv" if isinstance(up, Deconv) else "conv"  # resize_conv
    yield f"{seq}.{i}", p["up"], kind
    yield from _norm_slot(f"{seq}.{i + 1}", p.get("norm"), norm)


def _block_slots(prefix: str, block, p: Params, norm: str):
    for j, i in enumerate(block.convs):
        yield from _conv_norm_slots(f"{prefix}.conv_block", i, p[f"conv{j}"],
                                    norm)


def _resnet_slots(stack: ResnetStack, p: Params, norm: str,
                  prefix: str = "model"):
    """A ResNet stack (with or without its tail): the JAX
    ``resnet_generator_init`` tree."""
    yield from _conv_norm_slots(prefix, stack.head, p["head"], norm)
    for i, idx in enumerate(stack.downs):
        yield from _conv_norm_slots(prefix, idx, p[f"down{i}"], norm)
    for i, idx in enumerate(stack.blocks):
        yield from _block_slots(f"{prefix}.{idx}", stack[idx], p[f"block{i}"],
                                norm)
    for i, idx in enumerate(stack.ups):
        yield from _up_slots(prefix, idx, stack[idx], p[f"up{i}"], norm)
    if stack.tail is not None:
        yield f"{prefix}.{stack.tail}", p["tail"]["conv"], "conv"


def _local_enhancer_slots(g: LocalEnhancer, params: Params):
    """(torch key prefix, JAX params, kind) in module order."""
    norm = g.cfg.norm
    yield from _resnet_slots(g.model, params["global"], norm)
    for n in range(1, g.cfg.n_local_enhancers + 1):
        pe = params[f"enhancer{n}"]
        yield from _conv_norm_slots(f"model{n}_1", 1, pe["down0"], norm)
        yield from _conv_norm_slots(f"model{n}_1", 4, pe["down1"], norm)
        up = getattr(g, f"model{n}_2")
        for i in range(up.n_blocks):
            yield from _block_slots(f"model{n}_2.{i}", up[i],
                                    pe[f"block{i}"], norm)
        yield from _up_slots(f"model{n}_2", up.n_blocks, up[up.n_blocks],
                             pe["up"], norm)
        if up.tail is not None:
            yield f"model{n}_2.{up.tail}", pe["tail"]["conv"], "conv"


def _unet_slots(g: UnetGenerator, params: Params):
    """``level{i}`` (outermost first) -> the nested blocks' keys."""
    norm = g.cfg.norm
    for i, (prefix, blk) in enumerate(g.levels()):
        lv, seq = params[f"level{i}"], f"{prefix}.model"
        yield f"{seq}.{blk.down}", lv["down_conv"], "conv"
        if blk.down_norm is not None:
            yield from _norm_slot(f"{seq}.{blk.down_norm}", lv.get(
                "down_norm"), norm)
        yield f"{seq}.{blk.up}", lv["up_conv"], "deconv"
        if blk.up_norm is not None:
            yield from _norm_slot(f"{seq}.{blk.up_norm}", lv.get("up_norm"),
                                  norm)


def _tensors(p: Params, kind: str, prefix: str):
    """The state_dict entries of one slot."""
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32).copy())  # noqa: E731
    if kind == "norm":
        c = np.asarray(p["gamma"]).shape
        yield prefix + ".weight", f32(p["gamma"])
        yield prefix + ".bias", f32(p["beta"])
        yield prefix + ".running_mean", f32(p.get("running_mean",
                                                  np.zeros(c)))
        yield prefix + ".running_var", f32(p.get("running_var", np.ones(c)))
        yield prefix + ".num_batches_tracked", torch.zeros((),
                                                           dtype=torch.long)
        return
    w = deconv_w(p["w"]) if kind == "deconv" else conv_w(p["w"])
    yield prefix + ".weight", torch.from_numpy(w.astype(np.float32))
    if "b" in p:
        yield prefix + ".bias", f32(p["b"])


def _checked(module: torch.nn.Module, slots
             ) -> "OrderedDict[str, torch.Tensor]":
    """The state_dict that ``slots`` ((key prefix, JAX params, kind)
    triples, kind conv, deconv or norm) fill, in ``module``'s key order.
    Raises unless it fills every key of ``module`` with the right
    shape."""
    want = module.state_dict()
    got: Dict[str, torch.Tensor] = {}
    for prefix, p, kind in slots:
        got.update(_tensors(p, kind, prefix))
    if set(got) != set(want):
        raise ValueError(f"key mismatch: missing {sorted(set(want) - set(got))}"
                         f", unexpected {sorted(set(got) - set(want))}")
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for k, v in want.items():
        if tuple(got[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: module {tuple(v.shape)}"
                             f", params {tuple(got[k].shape)}")
        out[k] = got[k]
    return out


def generator_state_dict_from_jax(params_np: Params, cfg: GenConfig
                                  ) -> "OrderedDict[str, torch.Tensor]":
    """The port's generator state_dict (``define_g(cfg)``) from the JAX
    params of the same ``net_g``.

    Raises if the params do not fill every key of the configured module
    with the right shape."""
    with torch.device("meta"):
        g = define_g(cfg)
    if cfg.net_g == "local":
        slots = _local_enhancer_slots(g, params_np)
    elif cfg.net_g in ("unet_256", "unet_128"):
        slots = _unet_slots(g, params_np)
    else:  # resnet_9blocks, resnet_6blocks, global
        slots = _resnet_slots(g.model, params_np, cfg.norm)
    return _checked(g, slots)


def _disc_slots(d: torch.nn.Module, layers, p: Params, norm: str):
    """One PatchGAN's slots: ``layers`` (its module groups, head last, as
    ``d.layers()`` gives them) named by their keys in ``d``."""
    names = {id(m): n for n, m in d.named_modules()}
    last = len(layers) - 1
    for j, seq in enumerate(layers):
        q = p["head"] if j == last else p[f"conv{j}"]
        yield names[id(seq[0])], q["conv"], "conv"
        if len(seq) == 3:  # conv, norm, activation
            yield from _norm_slot(names[id(seq[1])], q.get("norm"), norm)


def discriminator_state_dict_from_jax(params_np: Params, cfg: DiscConfig
                                      ) -> "OrderedDict[str, torch.Tensor]":
    """The port's discriminator state_dict from JAX D params, in either
    layout. The JAX ``scale{i}`` (i = 0 the full resolution) becomes the
    reference's scale ``num_d - 1 - i``, which is the module the port
    runs on that resolution."""
    with torch.device("meta"):
        d = define_d(cfg)
    if cfg.net_d == "pixel":
        slots = [("net.0", params_np["conv0"]["conv"], "conv"),
                 ("net.2", params_np["conv1"]["conv"], "conv"),
                 *_norm_slot("net.3", params_np["conv1"].get("norm"),
                             cfg.norm),
                 ("net.5", params_np["head"]["conv"], "conv")]
    elif cfg.net_d == "n_layers":
        slots = _disc_slots(d, d.layers(), params_np, cfg.norm)
    else:
        slots = (s for i in range(cfg.num_d) for s in _disc_slots(
            d, d.layers(cfg.num_d - 1 - i), params_np[f"scale{i}"],
            cfg.norm))
    return _checked(d, slots)


def cycle_generators_from_jax(params_np: Params, cfg_a: GenConfig,
                              cfg_b: GenConfig
                              ) -> Dict[str, "OrderedDict[str, torch.Tensor]"]:
    """A CycleGAN's ``{"G_A", "G_B"}`` JAX tree (its ``g_params``, or its
    ``ema_g``) -> ``{"netG": G_A's, "netG_B": G_B's}`` state_dicts."""
    return {"netG": generator_state_dict_from_jax(params_np["G_A"], cfg_a),
            "netG_B": generator_state_dict_from_jax(params_np["G_B"], cfg_b)}


def cycle_discriminators_from_jax(params_np: Params, cfg_a: DiscConfig,
                                  cfg_b: DiscConfig
                                  ) -> Dict[str,
                                            "OrderedDict[str, torch.Tensor]"]:
    """A CycleGAN's ``{"D_A", "D_B"}`` JAX tree -> ``{"netD": D_A's,
    "netD_B": D_B's}`` state_dicts."""
    return {"netD": discriminator_state_dict_from_jax(params_np["D_A"],
                                                      cfg_a),
            "netD_B": discriminator_state_dict_from_jax(params_np["D_B"],
                                                        cfg_b)}


def vgg_state_dict_from_jax(params_np: Params
                            ) -> "OrderedDict[str, torch.Tensor]":
    """The port's ``Vgg19`` state_dict from JAX ``vgg19_init`` params
    (``conv{i}`` -> ``features.{idx}``, HWIO -> OIHW)."""
    with torch.device("meta"):
        vgg = Vgg19()
    return _checked(vgg, ((f"features.{idx}", params_np[f"conv{i}"], "conv")
                          for i, (idx, _, _) in enumerate(VGG_CONVS)))
