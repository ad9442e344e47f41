"""Batched separable 2-D DWT / BayesShrink wavelet denoising (PyTorch).

Counterpart of the XLA branch of ``mdx/ops/wavelet.py``: symmetric
half-sample extension, analysis length ``floor((n+L−1)/2)``, orthogonal
reconstruction, strided shift-MAC analysis and polyphase synthesis in the
same accumulation order.

* ``estimate_sigma`` — ref pipeline/metrics.py:47 (db2 HH MAD / Φ⁻¹(0.75))
* ``denoise_wavelet`` — ref pipeline/enhancement.py:169-174 (db1 BayesShrink);
  the CUDA kernel ``csrc/wavelet.cu`` on the card, ``denoise_wavelet_plain``
  on the CPU

The filter constants below are the PyWavelets ones that
``mdx.refimpl.wavelet_np`` defines; they are restated here so that the
port imports nothing of the ``mdx`` package, and a test holds the two equal.
"""

from __future__ import annotations

import numpy as np
import torch

from mdx_torch import kernels
from mdx_torch.ops.filters import pad_axis
from mdx_torch.ops.quantile import median_rows

_SQRT3 = float(np.sqrt(3.0))
# Orthonormal Daubechies decomposition low-pass filters (PyWavelets order).
FILTERS: dict[str, np.ndarray] = {
    "db1": np.array([1.0, 1.0]) / np.sqrt(2.0),
    "db2": np.array([(1 + _SQRT3) / 4.0, (3 + _SQRT3) / 4.0,
                     (3 - _SQRT3) / 4.0, (1 - _SQRT3) / 4.0])[::-1]
    / np.sqrt(2.0),
}
# MAD → sigma conversion constant: 1 / Φ⁻¹(0.75)
MAD_TO_SIGMA = 1.0 / 0.6744897501960817


def qmf_pair(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(dec_lo, dec_hi) of an orthonormal wavelet; hi[k] = (−1)^k lo[L−1−k]."""
    lo = FILTERS[name]
    L = len(lo)
    return lo, np.array([(-1.0) ** k * lo[L - 1 - k] for k in range(L)])


def max_level(shape, wavelet: str) -> int:
    """PyWavelets ``dwt_max_level`` over the smaller image dimension."""
    L = len(FILTERS[wavelet])
    n = min(shape)
    if n < L - 1 or L < 2:
        return 0
    if L == 2:
        return int(np.floor(np.log2(n)))
    return int(np.floor(np.log2(n / (L - 1.0))))


def _f32(v) -> float:
    """A tap as the float32 value the JAX package multiplies by."""
    return float(np.float32(v))


def _analysis_last(x: torch.Tensor, wavelet: str):
    """One analysis step along the last axis of [..., n] → (a, d)."""
    lo, hi = qmf_pair(wavelet)
    L = len(lo)
    n = x.shape[-1]
    ext = pad_axis(x, x.ndim - 1, L - 1, L - 1, "symmetric")[..., 1:]
    n_out = (n + L - 1) // 2
    lo_r, hi_r = lo[::-1], hi[::-1]
    a = d = None
    for i in range(L):
        s = ext[..., i:i + 2 * n_out:2][..., :n_out]
        ta = _f32(lo_r[i]) * s
        td = _f32(hi_r[i]) * s
        a = ta if a is None else a + ta
        d = td if d is None else d + td
    return a, d


def strided_taps_mac(ext: torch.Tensor, taps, n_out: int,
                     axis: int) -> torch.Tensor:
    """Σᵢ taps[i]·ext[…, i:i+2·n_out:2, …] along ``axis`` (1 or 2) of a
    pre-extended [N, H, W] signal, tap-ascending (``taps`` already
    time-reversed) — the analysis sweep of :func:`_analysis_last` on either
    spatial axis (``mdx.ops.wavelet.strided_taps_mac``)."""
    acc = None
    for i in range(len(taps)):
        s = ext.narrow(axis, i, ext.shape[axis] - i)
        s = (s[:, ::2] if axis == 1 else s[:, :, ::2]).narrow(axis, 0, n_out)
        t = _f32(taps[i]) * s
        acc = t if acc is None else acc + t
    return acc


def _synthesis_last(a: torch.Tensor, d: torch.Tensor, wavelet: str,
                    n_out: int) -> torch.Tensor:
    """Inverse of :func:`_analysis_last` (polyphase), cropped to n_out."""
    lo, hi = qmf_pair(wavelet)
    half = len(lo) // 2
    n_even = (n_out + 1) // 2
    ap = pad_axis(a, a.ndim - 1, 0, half, "constant")
    dp = pad_axis(d, d.ndim - 1, 0, half, "constant")
    even = odd = None
    for p in range(half):
        sa = ap[..., p:p + n_even]
        sd = dp[..., p:p + n_even]
        te = _f32(lo[2 * p + 1]) * sa + _f32(hi[2 * p + 1]) * sd
        to = _f32(lo[2 * p]) * sa + _f32(hi[2 * p]) * sd
        even = te if even is None else even + te
        odd = to if odd is None else odd + to
    inter = torch.stack([even, odd], dim=-1)
    return inter.reshape(a.shape[:-1] + (2 * n_even,))[..., :n_out]


def _swap_hw(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def dwt2(x: torch.Tensor, wavelet: str = "db1"):
    """Single-level batched 2-D DWT of [N,H,W] → (LL, (LH, HL, HH))."""
    a, d = _analysis_last(_swap_hw(x), wavelet)       # along H
    a, d = _swap_hw(a), _swap_hw(d)
    ll, lh = _analysis_last(a, wavelet)               # along W
    hl, hh = _analysis_last(d, wavelet)
    return ll, (lh, hl, hh)


def idwt2(ll, details, wavelet: str, out_shape):
    h, w = out_shape
    lh, hl, hh = details
    a = _synthesis_last(ll, lh, wavelet, w)
    d = _synthesis_last(hl, hh, wavelet, w)
    return _swap_hw(_synthesis_last(_swap_hw(a), _swap_hw(d), wavelet, h))


def wavedec2(x: torch.Tensor, wavelet: str, level: int):
    shapes, details = [], []
    ll = x
    for _ in range(level):
        shapes.append(tuple(ll.shape[-2:]))
        ll, det = dwt2(ll, wavelet)
        details.append(det)
    return ll, details[::-1], shapes[::-1]


def waverec2(ll, details, shapes, wavelet: str):
    for det, shp in zip(details, shapes):
        ll = idwt2(ll, det, wavelet, shp)
    return ll


def mad_sigma_from_hh(hh: torch.Tensor) -> torch.Tensor:
    """Per-image MAD noise sigma [N] from a finest-HH subband [N,h,w]."""
    n = hh.shape[0]
    return median_rows(hh.reshape(n, -1).abs()) * _f32(MAD_TO_SIGMA)


def estimate_sigma(x: torch.Tensor) -> torch.Tensor:
    """Per-image wavelet-MAD noise sigma, [N] (ref pipeline/metrics.py:47)."""
    _, (_, _, hh) = dwt2(x, "db2")
    return mad_sigma_from_hh(hh)


def _soft(x, t):
    return torch.sign(x) * torch.clamp_min(x.abs() - t, 0.0)


def _hard(x, t):
    return torch.where(x.abs() > t, x, 0.0)


_LEVEL_OFFSET = 3  # levels = max_level − 3, min 1 (skimage convention)


def default_levels(shape, wavelet: str = "db1") -> int:
    return max(max_level(tuple(shape), wavelet) - _LEVEL_OFFSET, 1)


def denoise_wavelet(
    x: torch.Tensor,
    sigma=None,
    mode: str = "soft",
    wavelet: str = "db1",
    wavelet_levels: int | None = None,
    soft_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Batched BayesShrink wavelet denoise of [N,H,W].

    ``sigma``: None (estimated per image from the finest HH subband), a
    scalar or an [N] tensor.  ``soft_mask`` ([N] bool) selects soft/hard
    thresholding per image and overrides ``mode``.

    A CUDA tensor with ``wavelet == "db1"`` and H, W divisible by
    ``2**levels`` (the JAX package's gate for its fused kernel, without the
    TPU's VMEM size limit) launches the CUDA kernel
    (:func:`mdx_torch.kernels.wavelet_denoise`); anything else runs
    :func:`denoise_wavelet_plain`."""
    n, h, w = x.shape
    if wavelet_levels is None:
        wavelet_levels = default_levels(x.shape[-2:], wavelet)
    div = 1 << wavelet_levels
    if (kernels.use_kernel(x) and wavelet == "db1" and h % div == 0
            and w % div == 0):
        if sigma is not None:
            sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device
                                    ).reshape(-1).expand(n).contiguous()
        soft = (soft_mask.to(torch.bool).contiguous() if soft_mask is not None
                else torch.full((n,), mode == "soft", dtype=torch.bool,
                                device=x.device))
        return kernels.wavelet_denoise(x.contiguous(), sigma, soft,
                                       wavelet_levels)
    return denoise_wavelet_plain(x, sigma, mode, wavelet, wavelet_levels,
                                 soft_mask)


def denoise_wavelet_plain(
    x: torch.Tensor,
    sigma=None,
    mode: str = "soft",
    wavelet: str = "db1",
    wavelet_levels: int | None = None,
    soft_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`denoise_wavelet` (same
    arguments): strided slices per level.  Each band's mean of squares is
    summed in float64 and rounded once to float32, as the kernel does, so
    both derive the same thresholds."""
    n = x.shape[0]
    if wavelet_levels is None:
        wavelet_levels = default_levels(x.shape[-2:], wavelet)
    ll, details, shapes = wavedec2(x, wavelet, wavelet_levels)
    if sigma is None:
        sigma = mad_sigma_from_hh(details[-1][2])
    sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device
                            ).reshape(-1).expand(n)
    noise_var = sigma * sigma
    eps = float(np.finfo(np.float32).eps)

    def _shrink(band):
        sq = (band.reshape(n, -1) ** 2).to(torch.float64)
        dvar = (sq.sum(dim=-1) / sq.shape[-1]).to(x.dtype)
        t = (noise_var / torch.sqrt(torch.clamp_min(dvar - noise_var, eps)))
        t = t[:, None, None]
        if soft_mask is not None:
            return torch.where(soft_mask[:, None, None], _soft(band, t),
                               _hard(band, t))
        return _soft(band, t) if mode == "soft" else _hard(band, t)

    new_details = [tuple(_shrink(b) for b in det) for det in details]
    return waverec2(ll, new_details, shapes, wavelet)
