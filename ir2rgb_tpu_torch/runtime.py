"""Device and precision policy.

- Entry points run on the CUDA device by default. Without one they raise,
  unless the caller asks for the CPU with ``device="cpu"``; nothing falls
  back silently.
- fp32 parity mode turns TF32 off in cuDNN and cuBLAS. This mirrors the
  JAX package's ``Precision.HIGHEST`` f32 convolutions: cuDNN's default
  TF32 keeps about three decimal digits.
- Serving mode is bf16 compute with fp32 instance-norm statistics (the
  norm kernel always reduces in fp32).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16,
          "bfloat16": torch.bfloat16}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA device; raise if there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def resolve_dtype(name: str) -> torch.dtype:
    """A config's ``compute_dtype`` name -> torch dtype."""
    if name not in DTYPES:
        raise ValueError(f"unknown compute dtype: {name!r}")
    return DTYPES[name]


def set_parity_mode() -> None:
    """Full-fp32 convolutions and matmuls (no TF32), process-wide."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
