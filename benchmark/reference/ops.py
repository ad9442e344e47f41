"""Plain PyTorch forms of the QA pass's operations on [N, H, W] tensors.

Frozen copy of the plain forms at commit 3b08b1a of
``mdx_torch/ops/filters.py`` (pads, Laplacian, Sobel, box and Gaussian
filters, ``unsharp_mask_plain``, ``adjust_gamma``), ``hist.py``,
``quantile.py`` (``percentiles_exact``), ``wavelet.py`` (the DWT,
``estimate_sigma``, ``denoise_wavelet_plain``), ``clahe.py``
(``clahe_plain``) and ``ssim.py``, with no kernel dispatch: every function
here runs the same operations on the CPU and on the card.  Every constant
follows the input's dtype, so the same code run on bfloat16 input is the
benchmark's lower-precision control.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------- filters


def pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int,
             mode: str) -> torch.Tensor:
    """``jnp.pad`` along one axis: "symmetric" (edge repeated), "reflect"
    (edge not repeated), "edge" (clamp) or "constant" (zeros)."""
    if mode == "constant":
        shape = list(x.shape)
        parts = []
        if lo:
            shape[axis] = lo
            parts.append(x.new_zeros(shape))
        parts.append(x)
        if hi:
            shape[axis] = hi
            parts.append(x.new_zeros(shape))
        return torch.cat(parts, dim=axis)
    n = x.shape[axis]
    i = torch.arange(-lo, n + hi, device=x.device)
    if mode == "symmetric":
        i = torch.remainder(i, 2 * n)
        i = torch.where(i >= n, 2 * n - 1 - i, i)
    elif mode == "reflect" and n == 1:
        i = torch.zeros_like(i)
    elif mode == "reflect":
        i = torch.remainder(i, 2 * n - 2)
        i = torch.where(i >= n, 2 * n - 2 - i, i)
    elif mode == "edge":
        i = i.clamp(0, n - 1)
    else:
        raise ValueError(f"unknown pad mode {mode!r}")
    return x.index_select(axis, i)


def pad2(x: torch.Tensor, lo: int, hi: int, mode: str) -> torch.Tensor:
    return pad_axis(pad_axis(x, 1, lo, hi, mode), 2, lo, hi, mode)


def laplace(x: torch.Tensor) -> torch.Tensor:
    """3x3 cross Laplacian, symmetric boundary."""
    xp = pad2(x, 1, 1, "symmetric")
    return (4.0 * xp[:, 1:-1, 1:-1] - xp[:, :-2, 1:-1] - xp[:, 2:, 1:-1]
            - xp[:, 1:-1, :-2] - xp[:, 1:-1, 2:])


def _smooth3(xp: torch.Tensor, axis: int) -> torch.Tensor:
    n = xp.shape[axis] - 2
    return (0.5 * xp.narrow(axis, 0, n) + xp.narrow(axis, 1, n)
            + 0.5 * xp.narrow(axis, 2, n))


def _diff3(xp: torch.Tensor, axis: int) -> torch.Tensor:
    n = xp.shape[axis] - 2
    return 0.5 * (xp.narrow(axis, 2, n) - xp.narrow(axis, 0, n))


def gradient_magnitude(x: torch.Tensor) -> torch.Tensor:
    """hypot of the two smoothed Sobel derivatives, each /4."""
    xp = pad2(x, 1, 1, "symmetric")
    sh = _smooth3(_diff3(xp, 1), 2)
    sv = _smooth3(_diff3(xp, 2), 1)
    return torch.hypot(sh, sv)


def box_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """size x size mean, SciPy ``uniform_filter`` (left-heavy window for
    even sizes, symmetric boundary): row sums x 1/size, then column sums
    x 1/size."""
    lo = size // 2
    xr = pad_axis(x, 1, lo, size - lo - 1, "symmetric")
    h = xr.shape[1] - (size - 1)
    acc = xr[:, 0:h, :]
    for i in range(1, size):
        acc = acc + xr[:, i:i + h, :]
    acc = pad_axis(acc * (1.0 / size), 2, lo, size - lo - 1, "symmetric")
    w = acc.shape[2] - (size - 1)
    out = acc[:, :, 0:w]
    for i in range(1, size):
        out = out + acc[:, :, i:i + w]
    return out * (1.0 / size)


def local_variance(x: torch.Tensor, size: int) -> torch.Tensor:
    m = box_filter(x, size)
    m2 = box_filter(x * x, size)
    return torch.clamp_min(m2 - m * m, 0.0)


_GAUSS_MAX_RADIUS = 12


def as_n(v, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Scalar or [N] parameter -> [N] tensor on ``x``'s device."""
    dtype = x.dtype if dtype is None else dtype
    v = torch.as_tensor(v, device=x.device).to(dtype).reshape(-1)
    return v.expand(x.shape[0]).contiguous()


def gaussian_blur(x: torch.Tensor, sigma) -> torch.Tensor:
    """Separable Gaussian on a fixed +-12 support, edge boundary, taps zero
    beyond int(4 sigma + 0.5) and normalised; along H, then W."""
    r = _GAUSS_MAX_RADIUS
    _, h, wd = x.shape
    sigma = as_n(sigma, x)[:, None]
    taps = torch.arange(-r, r + 1, device=x.device).to(x.dtype)[None, :]
    radius_eff = torch.floor(4.0 * sigma + 0.5)
    w = torch.exp(-0.5 * torch.square(taps / torch.clamp_min(sigma, 1e-6)))
    w = torch.where(taps.abs() <= radius_eff, w, 0.0)
    w = w / w.sum(dim=-1, keepdim=True)
    xp = pad_axis(x, 1, r, r, "edge")
    acc = None
    for k in range(w.shape[1]):
        t = w[:, k][:, None, None] * xp[:, k:k + h, :]
        acc = t if acc is None else acc + t
    xp = pad_axis(acc, 2, r, r, "edge")
    out = None
    for k in range(w.shape[1]):
        t = w[:, k][:, None, None] * xp[:, :, k:k + wd]
        out = t if out is None else out + t
    return out


def unsharp_mask(x: torch.Tensor, radius, amount) -> torch.Tensor:
    """clip(x + (x - gaussian(x, radius)) * amount, 0, 1)."""
    amount = as_n(amount, x)[:, None, None]
    return torch.clamp(x + (x - gaussian_blur(x, radius)) * amount, 0.0, 1.0)


def adjust_gamma(x: torch.Tensor, gamma) -> torch.Tensor:
    gamma = as_n(gamma, x)[:, None, None]
    return torch.pow(torch.clamp_min(x, 0.0), gamma)


# ---------------------------------------------------------------- histograms


def bin_indices(x: torch.Tensor, bins: int, hi=None) -> torch.Tensor:
    """numpy.histogram bin index per value (floor-multiply, then one-step
    fixups against the edges ``(k / bins) * hi``): [N, P] -> int64."""
    if hi is None:
        idx = torch.floor(x * float(bins))
        idxf = torch.clamp(idx, 0.0, bins - 1.0)
        e_lo = idxf / bins
        e_hi = (idxf + 1.0) / bins
    else:
        hi_s = torch.clamp_min(hi, 1e-30)[:, None]
        idx = torch.floor(x * (float(bins) / hi_s))
        idxf = torch.clamp(idx, 0.0, bins - 1.0)
        e_lo = (idxf / bins) * hi_s
        e_hi = ((idxf + 1.0) / bins) * hi_s
    i = idxf - (x < e_lo).to(idxf.dtype) + (x >= e_hi).to(idxf.dtype)
    return torch.clamp(i, 0.0, bins - 1.0).to(torch.int64)


def counts(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """[N, P] bin indices -> [N, bins] float32 counts."""
    n = idx.shape[0]
    offs = torch.arange(n, device=idx.device)[:, None] * bins
    c = torch.bincount((idx + offs).reshape(-1), minlength=n * bins)
    return c.reshape(n, bins).to(torch.float32)


def entropy_from_hist(hist: torch.Tensor, dtype) -> torch.Tensor:
    """Shannon entropy in bits per row of [N, bins] counts, empty bins out."""
    hist = hist.to(dtype)
    total = hist.sum(dim=-1, keepdim=True)
    p = hist / torch.clamp_min(total, 1.0)
    logp = torch.where(p > 0, torch.log2(torch.clamp_min(p, 1e-30)), 0.0)
    return -(p * logp).sum(dim=-1)


# ---------------------------------------------------------------- quantiles


def percentiles(x: torch.Tensor, qs) -> torch.Tensor:
    """Per-image percentiles by numpy's 'linear' rule -> [len(qs), N]."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    m = flat.shape[1]
    srt = torch.sort(flat, dim=-1).values
    out = []
    for q in qs:
        pos = float(q) / 100.0 * (m - 1)
        k = min(int(pos), m - 1)
        frac = pos - k
        lo = srt[:, k]
        if frac:
            hi = srt[:, min(k + 1, m - 1)]
            out.append(lo * (1.0 - frac) + hi * frac)
        else:
            out.append(lo)
    return torch.stack(out, 0)


# ---------------------------------------------------------------- wavelets

_SQRT3 = float(np.sqrt(3.0))
FILTERS = {
    "db1": np.array([1.0, 1.0]) / np.sqrt(2.0),
    "db2": np.array([(1 + _SQRT3) / 4.0, (3 + _SQRT3) / 4.0,
                     (3 - _SQRT3) / 4.0, (1 - _SQRT3) / 4.0])[::-1]
    / np.sqrt(2.0),
}
MAD_TO_SIGMA = 1.0 / 0.6744897501960817


def qmf_pair(name: str):
    lo = FILTERS[name]
    L = len(lo)
    return lo, np.array([(-1.0) ** k * lo[L - 1 - k] for k in range(L)])


def _f32(v) -> float:
    return float(np.float32(v))


def _analysis_last(x: torch.Tensor, wavelet: str):
    """One analysis step along the last axis -> (approximation, detail)."""
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


def _synthesis_last(a, d, wavelet: str, n_out: int):
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


def dwt2(x: torch.Tensor, wavelet: str):
    a, d = _analysis_last(x.transpose(-1, -2), wavelet)
    a, d = a.transpose(-1, -2), d.transpose(-1, -2)
    ll, lh = _analysis_last(a, wavelet)
    hl, hh = _analysis_last(d, wavelet)
    return ll, (lh, hl, hh)


def idwt2(ll, details, wavelet: str, out_shape):
    h, w = out_shape
    lh, hl, hh = details
    a = _synthesis_last(ll, lh, wavelet, w)
    d = _synthesis_last(hl, hh, wavelet, w)
    return _synthesis_last(a.transpose(-1, -2), d.transpose(-1, -2),
                           wavelet, h).transpose(-1, -2)


def mad_sigma(hh: torch.Tensor) -> torch.Tensor:
    n = hh.shape[0]
    return percentiles(hh.reshape(n, -1).abs(), [50.0])[0] * _f32(
        MAD_TO_SIGMA)


def estimate_sigma(x: torch.Tensor) -> torch.Tensor:
    """Per-image noise sigma: MAD of the finest db2 HH band / 0.6745."""
    return mad_sigma(dwt2(x, "db2")[1][2])


def default_levels(shape) -> int:
    """PyWavelets' db1 max level over the smaller side, less 3, at least 1."""
    n = min(shape)
    return max(int(np.floor(np.log2(n))) - 3, 1)


def denoise_wavelet(x: torch.Tensor, sigma=None, soft_mask=None,
                    mode: str = "soft") -> torch.Tensor:
    """BayesShrink db1 denoise over ``default_levels`` levels; each band's
    mean square summed in float64 and rounded once to the input's dtype."""
    n = x.shape[0]
    levels = default_levels(x.shape[-2:])
    shapes, details = [], []
    ll = x
    for _ in range(levels):
        shapes.append(tuple(ll.shape[-2:]))
        ll, det = dwt2(ll, "db1")
        details.append(det)
    details, shapes = details[::-1], shapes[::-1]
    if sigma is None:
        sigma = mad_sigma(details[-1][2])
    sigma = as_n(sigma, x)
    noise_var = sigma * sigma
    eps = float(np.finfo(np.float32).eps)

    def shrink(band):
        sq = (band.reshape(n, -1) ** 2).to(torch.float64)
        dvar = (sq.sum(dim=-1) / sq.shape[-1]).to(x.dtype)
        t = noise_var / torch.sqrt(torch.clamp_min(dvar - noise_var, eps))
        t = t[:, None, None]
        soft = torch.sign(band) * torch.clamp_min(band.abs() - t, 0.0)
        hard = torch.where(band.abs() > t, band, 0.0)
        if soft_mask is not None:
            return torch.where(soft_mask[:, None, None], soft, hard)
        return soft if mode == "soft" else hard

    for det, shp in zip(details, shapes):
        ll = idwt2(ll, tuple(shrink(b) for b in det), "db1", shp)
    return ll


# ---------------------------------------------------------------- CLAHE


def clahe(x: torch.Tensor, clip_limit, tile_size: int = 16,
          nbins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalisation: reflect-pad to the
    tile grid, per-tile integer histograms clipped at max(clip * t^2, 1)
    with the excess spread evenly, scaled CDF LUTs, bilinear blend of the
    four surrounding tiles' LUTs."""
    n, h, w = x.shape
    t = int(tile_size)
    pad_h, pad_w = (-h) % t, (-w) % t
    xp = torch.clamp(x, 0.0, 1.0)
    if pad_h or pad_w:
        xp = pad_axis(pad_axis(xp, 1, 0, pad_h, "reflect"), 2, 0, pad_w,
                      "reflect")
    ph, pw = h + pad_h, w + pad_w
    gy, gx = ph // t, pw // t
    ntiles = gy * gx
    dev = x.device
    q = torch.clamp_max((xp * nbins).to(torch.int64), nbins - 1)
    ty = torch.arange(ph, device=dev) // t
    tx = torch.arange(pw, device=dev) // t
    tile_id = ty[:, None] * gx + tx[None, :]
    base = (torch.arange(n, device=dev) * ntiles * nbins)[:, None, None]
    hists = torch.bincount((base + tile_id[None] * nbins + q).reshape(-1),
                           minlength=n * ntiles * nbins)
    hists = hists.to(x.dtype).reshape(n, ntiles, nbins)
    clim = torch.clamp_min(as_n(clip_limit, x) * float(t * t), 1.0)
    clim = clim[:, None, None]
    excess = torch.clamp_min(hists - clim, 0.0).sum(dim=-1, keepdim=True)
    hists = torch.minimum(hists, clim) + excess / nbins
    cdf = torch.cumsum(hists, dim=-1)
    cdf_min = cdf[..., :1]
    denom = torch.clamp_min(cdf[..., -1:] - cdf_min, 1e-12)
    lut = ((cdf - cdf_min) / denom).reshape(n, -1)

    fy = (torch.arange(ph, device=dev).to(x.dtype) + 0.5) / t - 0.5
    fx = (torch.arange(pw, device=dev).to(x.dtype) + 0.5) / t - 0.5
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, gy - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, gx - 1)
    y1 = torch.clamp_max(y0 + 1, gy - 1)
    x1 = torch.clamp_max(x0 + 1, gx - 1)
    wy = torch.clamp(fy - y0.to(x.dtype), 0.0, 1.0)[None, :, None]
    wx = torch.clamp(fx - x0.to(x.dtype), 0.0, 1.0)[None, None, :]

    def sample(yi, xi):
        tid = yi[:, None] * gx + xi[None, :]
        gidx = (tid[None] * nbins + q).reshape(n, -1)
        return torch.gather(lut, 1, gidx).reshape(n, ph, pw)

    v00, v01 = sample(y0, x0), sample(y0, x1)
    v10, v11 = sample(y1, x0), sample(y1, x1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))
    return out[:, :h, :w]


# ---------------------------------------------------------------- SSIM, PSNR


def ssim(x: torch.Tensor, y: torch.Tensor, win: int = 7) -> torch.Tensor:
    """skimage's SSIM (7 x 7 uniform window, unbiased covariance, K1 0.01,
    K2 0.03, data range 1, border crop) per image."""
    np_ = win * win
    cov_norm = np_ / (np_ - 1.0)
    ux, uy = box_filter(x, win), box_filter(y, win)
    uxx, uyy = box_filter(x * x, win), box_filter(y * y, win)
    uxy = box_filter(x * y, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    p = (win - 1) // 2
    return s[:, p:-p, p:-p].mean(dim=(1, 2))


def psnr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    mse = torch.square(x - y).mean(dim=(1, 2))
    return 10.0 * torch.log10(1.0 / mse)
