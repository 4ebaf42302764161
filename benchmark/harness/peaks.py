"""Published peaks of the cards the benchmark runs on (dense rates, no
sparsity). An NVIDIA H100 SXM: 989 TFLOP/s bf16 and fp16, 1,979 fp8,
494.7 TF32, 66.9 float32 outside the tensor cores, 3.35 TB/s of HBM3
(NVIDIA H100 Tensor Core GPU data sheet), at its 700 W power limit; a
card set below that limit runs slower under load, so every result names
the card and its limit."""

from __future__ import annotations

import subprocess
from typing import Dict

# substring of torch.cuda.get_device_name() -> peaks
PEAKS = {
    "H100": {"bf16_flops": 989e12, "fp8_flops": 1979e12,
             "tf32_flops": 494.7e12, "fp32_flops": 66.9e12,
             "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> Dict[str, float]:
    for frag, p in PEAKS.items():
        if frag in device_name:
            return p
    raise KeyError(f"no published peaks for {device_name!r}")


def power_limit_w() -> float:
    """The card's power limit in watts, from nvidia-smi (nan where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return float("nan")
