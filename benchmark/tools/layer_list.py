"""Write a configuration file's layer list from the plain reference.

    python3 benchmark/tools/layer_list.py benchmark/configs/<name>.json

runs the reference networks the file's ``model`` section names on the
meta device (no memory, no device) at the file's ``crop_size`` and
replaces the file's ``layers`` with every conv, transposed conv and
instance norm in call order: its network (``G``, ``D``, ``VGG``), its
state-dict name, ``cin``/``cout``/``k``/``stride`` and ``h``/``w`` (a
conv's output pixels, a transposed conv's input pixels; a norm's ``c``,
``h``, ``w``). ``input`` marks a network's first conv, whose input
gradient no step needs unless the network's input needs one.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path
from typing import List

import torch
import torch.nn as nn

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.reference import gan  # noqa: E402

INPUT_LAYERS = re.compile(r"^(model\.1|model1_1\.1|scale\d+_layer0\.0|"
                          r"features\.0)$")
NET_TAGS = {"netG": "G", "netD": "D", "vgg": "VGG"}


def layer_list(model: dict, size: int) -> List[dict]:
    nets = gan.build(model, "meta", with_d=True)
    in_nc = model["input_nc"] + model["output_nc"] * (
        model["n_frames_g"] - 1 if model["model"] == "temporal" else 0)
    inputs = {"netG": in_nc, "netD": model["input_nc"] + model["output_nc"],
              "vgg": 3}
    rows: List[dict] = []

    def hook(net, name):
        def fn(mod, args, out):
            x = args[0]
            row = {"net": NET_TAGS[net], "name": name}
            if isinstance(mod, nn.ConvTranspose2d):
                row.update(op="deconv", cin=mod.in_channels,
                           cout=mod.out_channels, k=mod.kernel_size[0],
                           stride=mod.stride[0], h=x.shape[2], w=x.shape[3])
            elif isinstance(mod, nn.Conv2d):
                row.update(op="conv", cin=mod.in_channels,
                           cout=mod.out_channels, k=mod.kernel_size[0],
                           stride=mod.stride[0], h=out.shape[2],
                           w=out.shape[3])
                if INPUT_LAYERS.match(name):
                    row["input"] = True
            else:
                row.update(op="norm", c=x.shape[1], h=x.shape[2],
                           w=x.shape[3])
            rows.append(row)
        return fn

    for net, module in nets.items():
        for name, mod in module.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d,
                                nn.InstanceNorm2d)):
                mod.register_forward_hook(hook(net, name))
        x = torch.empty((1, inputs[net], size, size), device="meta")
        with torch.no_grad():
            module(x)
    return rows


def main(argv=None) -> int:
    path = Path((argv or sys.argv[1:])[0])
    cfg = json.loads(path.read_text())
    cfg["layers"] = layer_list(cfg["model"], cfg["crop_size"])
    text = json.dumps(cfg, indent=1)
    # one layer a line keeps the file short and its diffs readable
    text = re.sub(r"\{\n\s+(\"net\"[^{}]*?)\n\s+\}",
                  lambda m: "{" + re.sub(r"\n\s+", " ", m.group(1)) + "}",
                  text)
    path.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
