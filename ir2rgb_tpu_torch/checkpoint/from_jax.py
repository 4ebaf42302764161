"""JAX parameters -> the port's ``state_dict``s (generator,
discriminator, VGG19).

The JAX package keeps its parameters as nested dicts of arrays
(``local_enhancer_init``, ``multiscale_disc_init``, ``vgg19_init``): conv
kernels HWIO, and transposed-conv kernels as the equivalent *forward* conv
kernel, spatially flipped HWIO (``ir2rgb_tpu/nn/ops.py:176-181``). This
module turns such a dict (of numpy arrays) into a port ``state_dict``,
whose keys are the reference family's (torchvision's for the VGG), with
its own copy of the layout math:

- conv: HWIO -> OIHW;
- deconv: flipped HWIO -> IOHW, by transposing back and then unflipping.

The maps are linear, so they convert gradients of the same trees too.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from ir2rgb_tpu_torch.nn.discriminators import DiscConfig, define_d
from ir2rgb_tpu_torch.nn.generators import GenConfig, LocalEnhancer
from ir2rgb_tpu_torch.nn.vgg import VGG_CONVS, Vgg19

Params = Dict[str, Any]


def conv_w(w: np.ndarray) -> np.ndarray:
    """HWIO -> torch Conv2d OIHW."""
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def deconv_w(w: np.ndarray) -> np.ndarray:
    """Flipped-HWIO forward-conv kernel -> torch ConvTranspose2d IOHW."""
    return np.ascontiguousarray(
        np.asarray(w).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


def _block_slots(prefix: str, p: Params) -> Iterator[Tuple[str, Params, str]]:
    yield f"{prefix}.conv_block.1", p["conv0"]["conv"], "conv"
    yield f"{prefix}.conv_block.5", p["conv1"]["conv"], "conv"


def _local_enhancer_slots(g: LocalEnhancer, params: Params):
    """(torch key prefix, JAX conv params, kind) in module order."""
    trunk, pg = g.model, params["global"]
    yield f"model.{trunk.head}", pg["head"]["conv"], "conv"
    for i, idx in enumerate(trunk.downs):
        yield f"model.{idx}", pg[f"down{i}"]["conv"], "conv"
    for i, idx in enumerate(trunk.blocks):
        yield from _block_slots(f"model.{idx}", pg[f"block{i}"])
    for i, idx in enumerate(trunk.ups):
        yield f"model.{idx}", pg[f"up{i}"]["up"], "deconv"
    for n in range(1, g.cfg.n_local_enhancers + 1):
        pe = params[f"enhancer{n}"]
        yield f"model{n}_1.1", pe["down0"]["conv"], "conv"
        yield f"model{n}_1.4", pe["down1"]["conv"], "conv"
        up = getattr(g, f"model{n}_2")
        for i in range(up.n_blocks):
            yield from _block_slots(f"model{n}_2.{i}", pe[f"block{i}"])
        yield f"model{n}_2.{up.n_blocks}", pe["up"]["up"], "deconv"
        if up.tail is not None:
            yield f"model{n}_2.{up.tail}", pe["tail"]["conv"], "conv"


def _checked(module: torch.nn.Module, slots
             ) -> "OrderedDict[str, torch.Tensor]":
    """The state_dict that ``slots`` ((key prefix, JAX conv params,
    kind) triples) fill, in ``module``'s key order. Raises unless it
    fills every key of ``module`` with the right shape."""
    want = module.state_dict()
    got: Dict[str, torch.Tensor] = {}
    for prefix, p, kind in slots:
        w = deconv_w(p["w"]) if kind == "deconv" else conv_w(p["w"])
        got[prefix + ".weight"] = torch.from_numpy(w.astype(np.float32))
        if "b" in p:
            got[prefix + ".bias"] = torch.from_numpy(
                np.asarray(p["b"], np.float32).copy())
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
    """The port's ``LocalEnhancer`` state_dict from JAX generator params.

    Raises if the params do not fill every key of the configured module
    with the right shape."""
    if cfg.net_g != "local":
        raise NotImplementedError(f"net_g={cfg.net_g!r} is not ported yet")
    with torch.device("meta"):
        g = LocalEnhancer(cfg)
    return _checked(g, _local_enhancer_slots(g, params_np))


def _disc_slots(p: Params, prefix: str, n_layers: int):
    for j in range(n_layers + 1):
        yield f"{prefix}{j}.0", p[f"conv{j}"]["conv"], "conv"
    yield f"{prefix}{n_layers + 1}.0", p["head"]["conv"], "conv"


def discriminator_state_dict_from_jax(params_np: Params, cfg: DiscConfig
                                      ) -> "OrderedDict[str, torch.Tensor]":
    """The port's discriminator state_dict from JAX D params. The JAX
    ``scale{i}`` (i = 0 the full resolution) becomes the reference's
    ``scale{num_d-1-i}``, which is the module the port runs on that
    resolution."""
    with torch.device("meta"):
        d = define_d(cfg)
    if cfg.net_d == "n_layers":
        slots = _disc_slots(params_np, "model", cfg.n_layers)
    else:
        slots = (s for i in range(cfg.num_d) for s in _disc_slots(
            params_np[f"scale{i}"], f"scale{cfg.num_d - 1 - i}_layer",
            cfg.n_layers))
    return _checked(d, slots)


def vgg_state_dict_from_jax(params_np: Params
                            ) -> "OrderedDict[str, torch.Tensor]":
    """The port's ``Vgg19`` state_dict from JAX ``vgg19_init`` params
    (``conv{i}`` -> ``features.{idx}``, HWIO -> OIHW)."""
    with torch.device("meta"):
        vgg = Vgg19()
    return _checked(vgg, ((f"features.{idx}", params_np[f"conv{i}"], "conv")
                          for i, (idx, _, _) in enumerate(VGG_CONVS)))
