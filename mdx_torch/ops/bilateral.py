"""Batched bilateral filter (PyTorch) — ref pipeline/enhancement.py:102-143.

Counterpart of ``mdx/ops/bilateral.py`` and of both TPU bilateral kernels
(``bilateral_tpu`` and ``bilateral_banded_tpu``): the d² window offsets
as shifted multiply-accumulates in window-ascending order (dy, then dx) on
a reflect pad.  On a CUDA tensor :func:`bilateral` launches the bilateral
kernel (``csrc/bilateral.cu``) at every size; on a CPU tensor it runs
:func:`bilateral_plain`.
"""

from __future__ import annotations

import torch

from mdx_torch import kernels
from mdx_torch.ops.filters import as_n, pad2


def _norm_d(d: int) -> int:
    """Reference diameter semantics: clamp to ≤9, force odd."""
    d = min(int(d), 9)
    if d % 2 == 0:
        d += 1
    return d


def bilateral_plain(x: torch.Tensor, d: int = 5, sigma_color=0.05,
                    sigma_space=0.05) -> torch.Tensor:
    """The plain PyTorch version of the bilateral kernel; ``d`` is
    normalised by :func:`_norm_d`, and d ≤ 0 returns ``x``."""
    if d <= 0:
        return x
    d = _norm_d(d)
    r = d // 2
    _, h, w = x.shape
    sc = torch.as_tensor(sigma_color, dtype=x.dtype, device=x.device)
    ss = torch.as_tensor(sigma_space, dtype=x.dtype, device=x.device)
    if sc.ndim == 1:
        sc = sc[:, None, None]
    if ss.ndim == 1:
        ss = ss[:, None, None]
    inv_2sc2 = 1.0 / (2.0 * sc * sc)
    inv_2ss2d2 = 1.0 / (2.0 * ss * ss * float(d * d))

    padded = pad2(x, r, r, "reflect")
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = padded[:, r + dy:r + dy + h, r + dx:r + dx + w]
            sw = torch.exp(-float(dx * dx + dy * dy) * inv_2ss2d2)
            iw = torch.exp(-torch.square(x - shifted) * inv_2sc2)
            wgt = sw * iw
            num = num + wgt * shifted
            den = den + wgt
    return num / (den + 1e-10)


def bilateral(x: torch.Tensor, d: int = 5, sigma_color=0.05,
              sigma_space=0.05) -> torch.Tensor:
    """Edge-preserving smoothing of [N,H,W]: spatial × intensity Gaussian,
    per-image (or scalar) sigmas.  CUDA tensor → the bilateral kernel; CPU
    tensor → :func:`bilateral_plain`."""
    if d <= 0:
        return x
    if kernels.use_kernel(x):
        return kernels.bilateral(x.contiguous(), _norm_d(d),
                                 as_n(sigma_color, x), as_n(sigma_space, x))
    return bilateral_plain(x, d, sigma_color, sigma_space)
