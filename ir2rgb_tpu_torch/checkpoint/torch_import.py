"""Reference ``.pth`` state_dicts -> the port's ``state_dict``s (the port
of ``ir2rgb_tpu/checkpoint/torch_import.py``).

The port's modules keep the reference family's ``nn.Sequential`` layout
and key names, so a clean reference checkpoint loads with
``load_state_dict``. A real one does not always match key for key: the
Sequential indices shift with norm and dropout choices, and some
reference variants keep a conv bias right before a batch norm. So the
import is *order-based*, as in the JAX package: the checkpoint is walked
in insertion order and grouped into layers (a 4-D conv weight with its
bias; a 1-D norm weight with its bias and running stats), and those
layers fill the port module's own layers in the port module's order,
convs and norms each in turn. Weights keep torch's layouts (conv OIHW,
transposed conv IOHW), so a layer moves across as it is; its shape must
match. Composite modules are matched group by group:

- the local enhancer: ``model.`` (the global trunk), then
  ``model{n}_1.`` and ``model{n}_2.`` (each enhancer's branches);
- the multiscale discriminator: one group a scale. The port indexes
  scales as the reference does (scale ``num_d - 1`` sees the full
  resolution), so the checkpoint's scale ``i`` fills the port's scale
  ``i``; the JAX importer reverses them because its ``scale0`` is the
  full resolution. A checkpoint without intermediate features names its
  scales ``layer{i}``.

A conv bias that the port module has no key for is dropped: the port
leaves a conv's bias out only right before a batch norm, which subtracts
the batch mean and so cancels it. A missing running mean or variance is
0 or 1 (batch statistics are what the port's batch norms compute with).
An unmatched or mis-shaped layer raises with both names.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ir2rgb_tpu_torch.nn.discriminators import DiscConfig, define_d
from ir2rgb_tpu_torch.nn.generators import GenConfig, ResnetGenerator, define_g

StateDict = "OrderedDict[str, torch.Tensor]"
Layer = Dict[str, Tuple[str, torch.Tensor]]  # field -> (key, tensor)


def load_state_dict(path: str) -> StateDict:
    """Read a torch ``.pth`` (a state_dict, or a module) into an ordered
    name -> CPU tensor dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return OrderedDict((k, v.detach().cpu()) for k, v in sd.items())


def _iter_layers(sd) -> Iterator[Tuple[str, Layer]]:
    """Group state_dict entries into layers, preserving order: ("conv",
    weight [+ bias]) or ("norm", weight [+ bias, running stats,
    num_batches_tracked]). Other 0-d entries are skipped."""
    items = list(sd.items())
    i = 0
    while i < len(items):
        name, arr = items[i]
        base = name.rsplit(".", 1)[0]
        if name.endswith(".weight") and arr.dim() == 4:
            layer = {"weight": (name, arr)}
            if i + 1 < len(items) and items[i + 1][0] == base + ".bias":
                layer["bias"] = items[i + 1]
                i += 1
            yield "conv", layer
        elif name.endswith(".weight") and arr.dim() == 1:
            layer = {"weight": (name, arr)}
            j = i + 1
            while j < len(items) and items[j][0].startswith(base + "."):
                suffix = items[j][0][len(base) + 1:]
                if suffix not in ("bias", "running_mean", "running_var",
                                  "num_batches_tracked"):
                    break
                layer[suffix] = items[j]
                j += 1
            i = j - 1
            yield "norm", layer
        i += 1


def _filter_prefix(sd, prefix: str) -> StateDict:
    return OrderedDict((k, v) for k, v in sd.items() if k.startswith(prefix))


def _mismatch(kind: str, got: List[Layer], want: List[Layer]) -> str:
    """Names the first layer one side has and the other lacks."""
    n = min(len(got), len(want))
    extra = (f"first unmatched checkpoint layer {got[n]['weight'][0]!r}"
             if len(got) > n else
             f"first unmatched module layer {want[n]['weight'][0]!r}")
    return (f"{kind} count mismatch: checkpoint has {len(got)}, "
            f"architecture expects {len(want)} ({extra})")


def assign_in_order(sd, module_sd) -> StateDict:
    """``module_sd``'s keys filled from ``sd``'s layers, matched by order
    (convs with convs, norms with norms). Raises on a count or shape
    mismatch, naming the checkpoint's and the module's key."""
    got = list(_iter_layers(sd))
    want = list(_iter_layers(module_sd))
    pairs = []
    for kind in ("conv", "norm"):
        g = [layer for k, layer in got if k == kind]
        w = [layer for k, layer in want if k == kind]
        if len(g) != len(w):
            msg = _mismatch(kind, g, w)
            if kind == "norm":
                msg += (" -- check --norm (instance norms carry no "
                        "parameters; batch norms do)")
            raise ValueError(msg)
        pairs += zip(g, w)
    out: StateDict = OrderedDict()
    for src, dst in pairs:
        for field, (key, like) in dst.items():
            if field in src:
                skey, val = src[field]
            elif field == "running_mean":
                skey, val = "(default 0)", torch.zeros(like.shape)
            elif field == "running_var":
                skey, val = "(default 1)", torch.ones(like.shape)
            elif field == "num_batches_tracked":
                skey, val = "(default 0)", torch.zeros(
                    (), dtype=torch.long)
            else:
                raise ValueError(
                    f"{key} has no counterpart: checkpoint layer "
                    f"{src['weight'][0]!r} carries no {field}")
            if tuple(val.shape) != tuple(like.shape):
                raise ValueError(
                    f"shape mismatch: checkpoint {skey} "
                    f"{tuple(val.shape)} for module {key} "
                    f"{tuple(like.shape)}")
            out[key] = val.to(like.dtype).clone()
    return out


def _assign_groups(sd, module: torch.nn.Module,
                   groups: List[Tuple[str, str]]) -> StateDict:
    """Order-based assignment group by group: (checkpoint prefix, module
    prefix) pairs that between them cover every key of ``module``."""
    module_sd = module.state_dict()
    filled: Dict[str, torch.Tensor] = {}
    for src, dst in groups:
        filled.update(assign_in_order(_filter_prefix(sd, src),
                                      _filter_prefix(module_sd, dst)))
    missing = [k for k in module_sd if k not in filled]
    if missing:
        raise ValueError(f"module keys left unfilled: {missing}")
    return OrderedDict((k, filled[k]) for k in module_sd)


def import_generator(sd_or_path, cfg: GenConfig,
                     n_blocks: Optional[int] = None) -> StateDict:
    """The port's generator state_dict (``define_g(cfg)``; a ResNet
    generator may have ``n_blocks`` blocks instead of its name's) from a
    reference checkpoint or its path."""
    sd = (load_state_dict(sd_or_path) if isinstance(sd_or_path, str)
          else sd_or_path)
    name = cfg.net_g
    with torch.device("meta"):
        if name in ("resnet_9blocks", "resnet_6blocks"):
            g = ResnetGenerator(
                cfg.input_nc, cfg.output_nc, cfg.ngf,
                n_blocks if n_blocks is not None else
                (9 if name.endswith("9blocks") else 6), 2,
                cfg.norm, upsample=cfg.upsample,
                use_dropout=cfg.use_dropout)
        else:
            g = define_g(cfg)
    groups = [("", "")]
    if name == "local":
        groups = [("model.", "model.")] + [
            (f"model{n}_{b}.", f"model{n}_{b}.")
            for n in range(1, cfg.n_local_enhancers + 1) for b in (1, 2)]
    return _assign_groups(sd, g, groups)


def import_discriminator(sd_or_path, cfg: DiscConfig) -> StateDict:
    """The port's discriminator state_dict (``define_d(cfg)``) from a
    reference checkpoint or its path."""
    sd = (load_state_dict(sd_or_path) if isinstance(sd_or_path, str)
          else sd_or_path)
    with torch.device("meta"):
        d = define_d(cfg)
    if cfg.net_d != "multiscale":
        return _assign_groups(sd, d, [("", "")])
    dst = [f"scale{i}_" if cfg.get_interm_feat else f"layer{i}."
           for i in range(cfg.num_d)]
    scales = sorted({int(m.group(1)) for m in
                     (re.match(r"scale(\d+)_", k) for k in sd) if m})
    src = ([f"scale{i}_" for i in scales] if scales else
           [f"layer{i}." for i in range(cfg.num_d)])
    if len(src) != cfg.num_d:
        raise ValueError(f"scale count mismatch: checkpoint has "
                         f"{len(src)}, architecture expects {cfg.num_d}")
    return _assign_groups(sd, d, list(zip(src, dst)))


def convert_vgg19_pth(pth_path: str, npz_out: str,
                      num_convs: int = 13) -> None:
    """Convert torchvision's vgg19 ``.pth`` to the npz that
    ``nn/vgg.py::load_vgg19_npz`` reads (``conv{i}_w`` HWIO, ``conv{i}_b``):
    the first ``num_convs`` convs, through conv5_1."""
    sd = load_state_dict(pth_path)
    convs = [(k, v) for k, v in sd.items()
             if v.dim() == 4 and ("features" in k or k.endswith(".weight"))]
    out: Dict[str, np.ndarray] = {}
    for i, (k, w) in enumerate(convs[:num_convs]):
        base = k.rsplit(".", 1)[0]
        out[f"conv{i}_w"] = np.ascontiguousarray(
            w.numpy().transpose(2, 3, 1, 0))
        out[f"conv{i}_b"] = sd[base + ".bias"].numpy()
    np.savez(npz_out, **out)
