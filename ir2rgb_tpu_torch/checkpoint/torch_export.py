"""The port's ``state_dict``s -> reference ``.pth`` state_dicts (the port
of ``ir2rgb_tpu/checkpoint/torch_export.py``, the importer's mirror).

``torch_import.py`` lets reference checkpoints serve and train here; this
module writes networks trained here back into the reference's layout, so
they deploy into an unchanged PyTorch serving stack (the reference loads
plain ``<epoch>_net_<G|D>.pth`` state_dicts).

The strategy is the JAX package's *template fill*: a **template
state_dict** of the reference architecture (any reference checkpoint of
it, or ``torch.save(net.state_dict(), ...)`` of a freshly built reference
network) has its entries filled, in order, from the port's layers, group
by group as ``torch_import`` reads them (the local enhancer's ``model.``
/ ``model{n}_1.`` / ``model{n}_2.``; one group a discriminator scale, in
the reference's scale order, which the port keeps). The port's modules
already keep the reference's layouts (conv OIHW, transposed conv IOHW),
so a layer moves across as it is; what the fill adds is the template's
order and names and loud checks:

- the conv and norm layer counts must match (instance norms carry no
  parameters, batch norms do: a template of the other norm fails here);
- every filled entry must have the template's shape;
- a trained conv bias the template has no entry for fails (dropping it
  would write a wrong checkpoint), and so does a template conv bias the
  port has no value for, but where a batch norm follows: the port leaves
  that bias out because the norm's batch mean cancels it
  (``torch_import``), so it is written as 0, which computes the same;
- a template running mean or variance the port has no value for gets 0
  or 1, and ``num_batches_tracked`` keeps the template's value.

Entries are written as float32 arrays, as the JAX exporter writes them.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import List, Tuple

import numpy as np
import torch

from ir2rgb_tpu_torch.nn.discriminators import DiscConfig
from ir2rgb_tpu_torch.nn.generators import GenConfig

from .torch_import import _filter_prefix, _iter_layers, load_state_dict

Exported = "OrderedDict[str, np.ndarray]"


def _template(sd_or_path) -> "OrderedDict[str, torch.Tensor]":
    sd = (load_state_dict(sd_or_path) if isinstance(sd_or_path, str)
          else sd_or_path)
    return OrderedDict((k, torch.as_tensor(np.asarray(v))) for k, v in
                       sd.items())


def _fill_in_order(sd, template, out) -> None:
    """Fill ``out``'s entries (the template's names) from ``sd``'s layers,
    matched by order: convs with convs, norms with norms."""
    got = list(_iter_layers(sd))
    want = list(_iter_layers(template))
    # template convs a batch norm follows: their bias cancels in the norm
    before_bn = {id(layer) for (k, layer), (nk, nxt) in zip(want, want[1:])
                 if k == "conv" and nk == "norm" and "running_mean" in nxt}
    pairs = []
    for kind in ("conv", "norm"):
        g = [layer for k, layer in got if k == kind]
        w = [layer for k, layer in want if k == kind]
        if len(g) != len(w):
            msg = (f"{kind} count mismatch: template has {len(w)}, the "
                   f"network has {len(g)}")
            if kind == "norm":
                msg += (" parameterized norm layers -- wrong --model.norm "
                        "for this template? (instance norms carry no "
                        "parameters; batch norms do)")
            raise ValueError(msg)
        pairs += zip(g, w)
    for src, dst in pairs:
        if "bias" in src and "bias" not in dst:
            raise ValueError(
                f"{src['bias'][0]!r} is a trained bias but template "
                f"layer {dst['weight'][0]!r} has none -- dropping it "
                "would corrupt the export (wrong norm for this "
                "template?)")
        for field, (key, like) in dst.items():
            if field == "num_batches_tracked":
                continue
            if field in src:
                val = src[field][1]
            elif field == "running_mean":
                val = torch.zeros(like.shape)
            elif field == "running_var":
                val = torch.ones(like.shape)
            elif field == "bias" and id(dst) in before_bn:
                val = torch.zeros(like.shape)
            else:
                raise ValueError(
                    f"template entry {key!r} expects a {field} but "
                    f"layer {src['weight'][0]!r} has none")
            if tuple(val.shape) != tuple(like.shape):
                raise ValueError(
                    f"shape mismatch at template entry {key!r}: "
                    f"template {tuple(like.shape)}, exported "
                    f"{tuple(val.shape)} -- the architecture does not "
                    "match this template")
            out[key] = val.detach().to("cpu", torch.float32).numpy()


def _fill(sd, template, groups: List[Tuple[str, str]]) -> Exported:
    """The template filled group by group: (port prefix, template prefix)
    pairs that between them cover every entry."""
    tmpl = _template(template)
    out: Exported = OrderedDict((k, v.numpy()) for k, v in tmpl.items())
    for src, dst in groups:
        _fill_in_order(_filter_prefix(sd, src), _filter_prefix(tmpl, dst),
                       out)
    return out


def export_generator(sd, cfg: GenConfig, template) -> Exported:
    """A reference generator state_dict: ``template`` (a state_dict or a
    ``.pth`` path) filled from the port generator's ``sd``."""
    groups = [("", "")]
    if cfg.net_g == "local":
        groups = [("model.", "model.")] + [
            (f"model{n}_{b}.", f"model{n}_{b}.")
            for n in range(1, cfg.n_local_enhancers + 1) for b in (1, 2)]
    return _fill(sd, template, groups)


def export_discriminator(sd, cfg: DiscConfig, template) -> Exported:
    """A reference discriminator state_dict: ``template`` filled from the
    port discriminator's ``sd``, a multiscale one scale by scale in the
    reference's order (either naming: ``scale{i}_`` or ``layer{i}``)."""
    if cfg.net_d != "multiscale":
        return _fill(sd, template, [("", "")])
    tmpl = _template(template)
    scales = sorted({int(m.group(1)) for m in
                     (re.match(r"scale(\d+)_", k) for k in tmpl) if m})
    dst = ([f"scale{i}_" for i in scales] if scales else
           [f"layer{i}." for i in range(cfg.num_d)])
    src = [f"scale{i}_" if cfg.get_interm_feat else f"layer{i}."
           for i in range(cfg.num_d)]
    if len(dst) != len(src):
        raise ValueError(f"scale count mismatch: template has {len(dst)}, "
                         f"the network has {len(src)}")
    return _fill(sd, tmpl, list(zip(src, dst)))


def save_torch_state_dict(sd: Exported, path: str) -> None:
    """``torch.save`` an exported state_dict as tensors (the reference's
    format)."""
    torch.save(OrderedDict((k, torch.from_numpy(np.asarray(v)))
                           for k, v in sd.items()), path)
