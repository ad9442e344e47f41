"""Batched SSIM / PSNR (PyTorch) — ref pipeline/metrics.py:232-233.

skimage defaults: 7×7 uniform window, unbiased covariance normalisation
NP/(NP−1), K1=0.01, K2=0.03, border crop of (win−1)//2, reflect boundary.
"""

from __future__ import annotations

import torch

from mdx_torch.ops.filters import box_filter


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         win_size: int = 7) -> torch.Tensor:
    """Per-image structural similarity of [N,H,W] pairs → [N]."""
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    ux = box_filter(x, win_size)
    uy = box_filter(y, win_size)
    uxx = box_filter(x * x, win_size)
    uyy = box_filter(y * y, win_size)
    uxy = box_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return s[:, pad:-pad, pad:-pad].mean(dim=(1, 2))


def psnr(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Per-image peak SNR → [N]; identical images give +inf (as NumPy)."""
    mse = torch.square(x - y).mean(dim=(1, 2))
    return 10.0 * torch.log10((data_range * data_range) / mse)
