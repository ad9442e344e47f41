"""Batched CLAHE on [N,H,W] (PyTorch) — ref pipeline/enhancement.py:183-187.

Counterpart of ``mdx/ops/clahe.py``: contrast-limited adaptive histogram
equalisation, numerically matching ``mdx.refimpl.filters_np.clahe``:

  1. reflect-pad (bottom/right) to a multiple of the tile size,
  2. per-tile ``nbins`` histograms,
  3. clip at ``max(clip_limit·tile_pixels, 1)`` with uniform excess
     redistribution (per-image clip limit),
  4. per-tile CDF look-up tables,
  5. bilinear interpolation between the four surrounding tile LUTs.

On a CUDA tensor :func:`clahe` launches the CLAHE kernel.
"""

from __future__ import annotations

import torch

from mdx_torch import kernels
from mdx_torch.ops.filters import as_n, pad_axis


def clahe_luts_plain(xp: torch.Tensor, clip_limit, tile_size: int,
                     nbins: int = 256) -> torch.Tensor:
    """Per-tile LUTs of a clipped [N, H, W] block whose extents are
    multiples of the tile size → [N, H/t, W/t, nbins]: integer histograms,
    clip at ``max(clip_limit·t², 1)`` with the excess spread evenly, scaled
    CDF.  The LUT stage of :func:`clahe_plain`, and the local LUTs of the
    sharded CLAHE (``mdx_torch.parallel.clahe_sp``)."""
    n, ph, pw = xp.shape
    t = int(tile_size)
    gy, gx = ph // t, pw // t
    ntiles = gy * gx
    dev = xp.device

    q = torch.clamp_max((xp * nbins).to(torch.int64), nbins - 1)  # [N,ph,pw]

    ty = torch.arange(ph, device=dev) // t
    tx = torch.arange(pw, device=dev) // t
    tile_id = ty[:, None] * gx + tx[None, :]                       # [ph,pw]

    img_base = (torch.arange(n, device=dev) * ntiles * nbins)[:, None, None]
    flat_idx = (img_base + tile_id[None] * nbins + q).reshape(-1)
    hists = torch.bincount(flat_idx, minlength=n * ntiles * nbins)
    hists = hists.to(xp.dtype).reshape(n, ntiles, nbins)

    # clip + uniform redistribution
    npix = float(t * t)
    clim = torch.clamp_min(as_n(clip_limit, xp, xp.dtype) * npix, 1.0)
    clim = clim[:, None, None]
    excess = torch.clamp_min(hists - clim, 0.0).sum(dim=-1, keepdim=True)
    hists = torch.minimum(hists, clim) + excess / nbins

    # per-tile LUT: scaled CDF
    cdf = torch.cumsum(hists, dim=-1)
    cdf_min = cdf[..., :1]
    denom = torch.clamp_min(cdf[..., -1:] - cdf_min, 1e-12)
    return ((cdf - cdf_min) / denom).reshape(n, gy, gx, nbins)


def clahe_plain(x: torch.Tensor, clip_limit, tile_size: int = 16,
                nbins: int = 256) -> torch.Tensor:
    """The plain PyTorch version of the CLAHE kernel (``clahe_xla``)."""
    n, h, w = x.shape
    t = int(tile_size)
    pad_h = (-h) % t
    pad_w = (-w) % t
    xp = torch.clamp(x, 0.0, 1.0)
    if pad_h or pad_w:
        xp = pad_axis(pad_axis(xp, 1, 0, pad_h, "reflect"), 2, 0, pad_w,
                      "reflect")
    ph, pw = h + pad_h, w + pad_w
    gy, gx = ph // t, pw // t
    dev = x.device

    q = torch.clamp_max((xp * nbins).to(torch.int64), nbins - 1)  # [N,ph,pw]
    lut_flat = clahe_luts_plain(xp, clip_limit, t, nbins).reshape(n, -1)

    # bilinear interpolation between 4 neighbouring tile LUTs
    fy = (torch.arange(ph, dtype=x.dtype, device=dev) + 0.5) / t - 0.5
    fx = (torch.arange(pw, dtype=x.dtype, device=dev) + 0.5) / t - 0.5
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, gy - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, gx - 1)
    y1 = torch.clamp_max(y0 + 1, gy - 1)
    x1 = torch.clamp_max(x0 + 1, gx - 1)
    wy = torch.clamp(fy - y0.to(x.dtype), 0.0, 1.0)[None, :, None]
    wx = torch.clamp(fx - x0.to(x.dtype), 0.0, 1.0)[None, None, :]

    def _sample(yi, xi):
        tid = yi[:, None] * gx + xi[None, :]                       # [ph,pw]
        gidx = (tid[None] * nbins + q).reshape(n, -1)              # [N,ph·pw]
        return torch.gather(lut_flat, 1, gidx).reshape(n, ph, pw)

    v00 = _sample(y0, x0)
    v01 = _sample(y0, x1)
    v10 = _sample(y1, x0)
    v11 = _sample(y1, x1)
    out = (1 - wy) * ((1 - wx) * v00 + wx * v01) + wy * ((1 - wx) * v10 + wx * v11)
    return out[:, :h, :w]


def clahe(x: torch.Tensor, clip_limit, tile_size: int = 16,
          nbins: int = 256) -> torch.Tensor:
    """CLAHE with a per-image (or scalar) clip limit: the CLAHE kernel on a
    CUDA tensor, :func:`clahe_plain` on a CPU tensor."""
    if kernels.use_kernel(x):
        return kernels.clahe(x.contiguous(), as_n(clip_limit, x),
                             int(tile_size), nbins)
    return clahe_plain(x, clip_limit, tile_size, nbins)
