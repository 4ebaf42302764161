"""pix2pixHD's networks as a configuration names them (Wang et al.,
arXiv:1711.11585; github.com/NVIDIA/pix2pixHD), built from a
configuration file's ``model`` section: the generator a serving cell
compares against, and the multiscale discriminator and VGG19 of the
recipe's train step, whose layers the configuration's layer list counts
(``tools/layer_list.py``) and whose state-dict keys the program shares.
"""

from __future__ import annotations

from typing import Dict

import torch

from .nets import LocalEnhancer, MultiscaleDiscriminator, Vgg19Features


def build(model: dict, device, with_d: bool = True) -> Dict[str, torch.nn.Module]:
    """The networks a configuration's ``model`` section names, fp32 on
    ``device``, their weights unset (load a state dict)."""
    n_prev = model["n_frames_g"] - 1 if model["model"] == "temporal" else 0
    in_nc = model["input_nc"] + model["output_nc"] * n_prev
    with torch.device("meta"):
        nets = {"netG": LocalEnhancer(in_nc, model["output_nc"], model["ngf"],
                                      model["n_downsample_global"],
                                      model["n_blocks_global"],
                                      model["n_blocks_local"])}
        if with_d:
            nets["netD"] = MultiscaleDiscriminator(
                model["input_nc"] + model["output_nc"], model["ndf"],
                model["n_layers_d"], model["num_d"])
            nets["vgg"] = Vgg19Features()
    out = {}
    for k, net in nets.items():
        net = net.to_empty(device=device)
        if isinstance(net, Vgg19Features):
            net.mean = torch.tensor((0.485, 0.456, 0.406), device=device
                                    ).view(1, 3, 1, 1)
            net.std = torch.tensor((0.229, 0.224, 0.225), device=device
                                   ).view(1, 3, 1, 1)
        out[k] = net
    return out
