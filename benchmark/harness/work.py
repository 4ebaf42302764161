"""The work a frame or a train step needs, counted from a configuration's
layer list, whatever the program launches to do it.

A configuration file lists every conv, transposed conv and instance norm
of its networks at its frame size (``layers``) and how often a unit of
work runs each network (``passes``: per frame when serving, per step when
training). Counting rules:

- FLOPs are 2 x MACs. A conv's MACs are its output pixels x k^2 x cin x
  cout; a transposed conv's its input pixels x k^2 x cin x cout. A
  forward pass counts every layer once; a backward pass counts a
  weight-gradient product per layer (``wgrad``) and an input-gradient
  product per layer (``dgrad``), the latter for a network's input layer
  only in the passes whose input needs a gradient (``dgrad_input``).
- B1's bytes: a forward norm reads its input once and writes its output
  once; a backward norm reads x and g once and writes dx once; in the
  compute dtype's element size.
"""

from __future__ import annotations

from typing import Dict

DTYPE_BYTES = {"bf16": 2, "bfloat16": 2, "float32": 4}


def macs(layer: dict) -> int:
    return layer["h"] * layer["w"] * layer["k"] ** 2 * layer["cin"] \
        * layer["cout"]


def flops(config: dict, kind: str) -> float:
    """FLOPs of one unit of ``kind`` ("serve": a frame, "train": a
    step)."""
    passes = config["passes"][kind]
    total = 0
    for layer in config["layers"]:
        if layer["op"] not in ("conv", "deconv"):
            continue
        p = passes.get(layer["net"])
        if p is None:
            continue
        n = p.get("fwd", 0) + p.get("wgrad", 0)
        n += p.get("dgrad_input", 0) if layer.get("input") else p.get(
            "dgrad", 0)
        total += n * macs(layer)
    return 2.0 * total


def b1_bytes(config: dict, kind: str) -> float:
    """Bytes kernel B1's work needs in one unit of ``kind``."""
    passes = config["passes"][kind]
    size = DTYPE_BYTES[config["model"]["compute_dtype"]]
    total = 0
    for layer in config["layers"]:
        if layer["op"] != "norm":
            continue
        p = passes.get(layer["net"])
        if p is None:
            continue
        elems = layer["h"] * layer["w"] * layer["c"]
        total += elems * size * (2 * p.get("norm_fwd", 0)
                                 + 3 * p.get("norm_bwd", 0))
    return float(total)


def summary(config: dict, kind: str) -> Dict[str, float]:
    return {"flops": flops(config, kind), "b1_bytes": b1_bytes(config, kind)}
