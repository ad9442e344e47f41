"""Batched bilateral filter (PyTorch) — ref pipeline/enhancement.py:102-143.

Counterpart of the XLA lowering of ``mdx/ops/bilateral.py``: the d² window
offsets are unrolled as shifted multiply-accumulates in window-ascending
order (dy, then dx) on a reflect pad.  At ≤1024² the JAX package lowers
this op with XLA, not its Pallas kernel, so it stays plain PyTorch here.
"""

from __future__ import annotations

import torch

from mdx_torch.ops.filters import pad2


def _norm_d(d: int) -> int:
    """Reference diameter semantics: clamp to ≤9, force odd."""
    d = min(int(d), 9)
    if d % 2 == 0:
        d += 1
    return d


def bilateral(x: torch.Tensor, d: int = 5, sigma_color=0.05,
              sigma_space=0.05) -> torch.Tensor:
    """Edge-preserving smoothing of [N,H,W]: spatial × intensity Gaussian,
    per-image (or scalar) sigmas."""
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
