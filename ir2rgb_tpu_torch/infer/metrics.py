"""Image quality metrics — the port of ``ir2rgb_tpu/infer/metrics.py``:
PSNR and SSIM against ground truth (the reference family's evaluation
protocol) and a temporal-flicker metric for video.

Plain PyTorch on NHWC or HWC tensors (numpy arrays are taken as they
are), computed in fp32 on the tensors' device; ``peak`` is 2 for [-1, 1]
frames and 255 for uint8 ones. Each returns a 0-d fp32 tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def psnr(a, b, peak: float = 2.0) -> torch.Tensor:
    mse = torch.mean((_f32(a) - _f32(b)) ** 2)
    return 10.0 * torch.log10(peak * peak / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a, b, peak: float = 2.0) -> torch.Tensor:
    """Single-scale SSIM with an 11x11 Gaussian window (sigma 1.5),
    per channel and averaged: a depthwise VALID convolution in fp32."""
    a, b = _f32(a), _f32(b)
    if a.dim() == 3:
        a, b = a[None], b[None]
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    c = a.shape[-1]
    kern = _gaussian_kernel().to(a.device).expand(c, 1, 11, 11)

    cudnn = torch.backends.cudnn

    def filt(x):
        # full fp32 on the card too: no TF32 in the window sums
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            y = F.conv2d(x.permute(0, 3, 1, 2).contiguous(), kern,
                         groups=c)
        return y.permute(0, 2, 3, 1)

    mu_a, mu_b = filt(a), filt(b)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sig_a = filt(a * a) - mu_a2
    sig_b = filt(b * b) - mu_b2
    sig_ab = filt(a * b) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sig_ab + c2)) / (
        (mu_a2 + mu_b2 + c1) * (sig_a + sig_b + c2))
    return torch.mean(s)


def flicker(frames) -> torch.Tensor:
    """Mean absolute frame-to-frame difference of (T, H, W, C) or (T, B,
    ...) frames: the temporal-stability metric of video translation
    (lower is less flicker)."""
    f = _f32(frames)
    return torch.mean(torch.abs(f[1:] - f[:-1]))
