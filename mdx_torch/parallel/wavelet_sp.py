"""Sharded BayesShrink db1 denoise over row blocks or tiles.

Counterpart of ``mdx/parallel/wavelet_sp.py`` (skimage ``denoise_wavelet``
semantics, ref pipeline/enhancement.py:270-273).  For even lengths the Haar
transform of a block touches only the block (output j reads inputs 2j,
2j+1), so the dense ``dwt2``/``idwt2`` on each block equal the global
transform while the block's sharded extents stay even:

1. levels ``1 … j_local`` (the deepest with even block rows, and on a 2-D
   grid even tile columns) run the dense ``dwt2`` on the block, with no
   communication;
2. the coarser levels gather the small LL image over the tile group (both
   axes) and run the dense ``wavedec2 → BayesShrink → waverec2`` on every
   rank, which takes its own rows and columns back;
3. the noise sigma, when not given, is the exact distributed median of the
   level-1 |HH|;
4. each fine band's threshold needs the global mean of its squares: summed
   in float64 per block, added over the ranks, rounded once (as the port's
   dense denoise sums them, ``mdx_torch/ops/wavelet.py``).

The JAX package runs this outside Pallas; here it is plain PyTorch too.
"""

from __future__ import annotations

import numpy as np
import torch

from mdx_torch.ops.filters import as_n
from mdx_torch.ops.quantile import percentiles_exact_sharded
from mdx_torch.ops.wavelet import (
    MAD_TO_SIGMA,
    _f32,
    _hard,
    _soft,
    default_levels,
    dwt2,
    idwt2,
    wavedec2,
    waverec2,
)
from mdx_torch.parallel import comm


def _trailing_pow2(v: int) -> int:
    """Largest j with v % 2^j == 0 (v > 0)."""
    j = 0
    while v % 2 == 0 and v > 1:
        v //= 2
        j += 1
    return j


def denoise_wavelet_sharded(x: torch.Tensor, mesh, sigma=None,
                            mode: str = "soft",
                            wavelet_levels: int | None = None,
                            soft_mask: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """BayesShrink db1 denoise of this rank's [N, Hs, Ws] block of the
    global images.  ``sigma``: None (the distributed MAD estimate), a scalar
    or [N]; ``soft_mask`` ([N] bool) selects soft/hard per image and
    overrides ``mode``.  Block rows (and, on a 2-D grid, columns) must be
    even (the entry points check)."""
    n, hs, ws = x.shape
    two_d = mesh.n_sx > 1
    if hs % 2 or (two_d and ws % 2):
        raise ValueError(f"sharded wavelet denoise needs even block extents, "
                         f"got {hs}x{ws}")
    levels = (wavelet_levels if wavelet_levels is not None
              else default_levels((hs * mesh.n_sy, ws * mesh.n_sx), "db1"))
    j_local = min(levels, _trailing_pow2(hs),
                  *((_trailing_pow2(ws),) if two_d else ()))

    # 1. fine levels: dense dwt2 on the block
    ll = x
    local_details, local_shapes = [], []
    for _ in range(j_local):
        local_shapes.append(tuple(ll.shape[-2:]))
        ll, det = dwt2(ll, "db1")
        local_details.append(det)

    # 3. sigma from the exact distributed median of level-1 |HH|
    if sigma is None:
        hh1 = local_details[0][2]
        total = hh1.shape[1] * mesh.n_space * hh1.shape[2]
        med = percentiles_exact_sharded(hh1.abs(), [50.0], mesh, total)[0]
        sigma = med * _f32(MAD_TO_SIGMA)
    sigma = as_n(sigma, x, x.dtype)
    noise_var = sigma * sigma
    eps = float(np.finfo(np.float32).eps)

    def _threshold(band, dvar):
        t = (noise_var / torch.sqrt(torch.clamp_min(dvar - noise_var, eps))
             )[:, None, None]
        if soft_mask is not None:
            return torch.where(soft_mask[:, None, None], _soft(band, t),
                               _hard(band, t))
        return _soft(band, t) if mode == "soft" else _hard(band, t)

    def _sq_sum(band):
        return (band.reshape(n, -1) ** 2).to(torch.float64).sum(dim=-1)

    # 2. coarse levels: gather the small LL and run the dense machinery
    if j_local < levels:
        llg = comm.gather_tiles(ll, mesh)
        ll_deep, deep_details, deep_shapes = wavedec2(llg, "db1",
                                                      levels - j_local)
        deep_new = [tuple(_threshold(b, (_sq_sum(b) / b[0].numel())
                                     .to(x.dtype)) for b in det)
                    for det in deep_details]
        llg = waverec2(ll_deep, deep_new, deep_shapes, "db1")
        rows, cols = ll.shape[1], ll.shape[2]
        r, c = mesh.row_index, mesh.col_index
        ll = llg[:, r * rows:(r + 1) * rows, c * cols:(c + 1) * cols]

    # 4. fine levels: global mean of squares per band, pointwise threshold,
    #    dense idwt2 on the block back up
    for det, shp in zip(reversed(local_details), reversed(local_shapes)):
        sums = comm.psum(torch.stack([_sq_sum(b) for b in det]), mesh)
        cnt = float(det[0][0].numel() * mesh.n_space)
        new_det = tuple(_threshold(b, (sums[i] / cnt).to(x.dtype))
                        for i, b in enumerate(det))
        ll = idwt2(ll, new_det, "db1", shp)
    return ll


def light_denoise_sharded(x: torch.Tensor, strength, sigma_est: torch.Tensor,
                          mesh) -> torch.Tensor:
    """(1−s)·x + s·denoise(σ = σ̂/2), no-op where σ̂ < 0.001 (ref
    pipeline/enhancement.py:80-94); ``sigma_est`` is the global [N]
    estimate (e.g. ``estimate_sigma_spatial``)."""
    den = denoise_wavelet_sharded(x, mesh, sigma=0.5 * sigma_est)
    s = as_n(strength, x, x.dtype)[:, None, None]
    blended = (1.0 - s) * x + s * den
    return torch.where((sigma_est < 1e-3)[:, None, None], x, blended)
