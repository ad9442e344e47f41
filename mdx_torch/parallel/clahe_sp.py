"""Sharded CLAHE: the CLAHE tile grid mapped onto row blocks or tiles.

Counterpart of ``mdx/parallel/clahe_sp.py`` (skimage
``equalize_adapthist`` semantics, ref pipeline/enhancement.py:277-280).
When a block's rows and columns are multiples of the CLAHE tile size, every
CLAHE tile's histogram and LUT are local to the rank that holds it; the
bilinear remap needs only one halo row of LUTs from the blocks above and
below and, on a 2-D grid, one halo column of the row-extended LUT grid from
the blocks to the left and right (its corners come with it).  At the global
top, bottom, left and right the halo is a copy of the block's own edge
LUTs, so one uniform formula — ``y0 = floor(f) + 1``,
``w = f − floor(f)`` over the halo-extended grid, no clamp — gives skimage's
clamped remap: in the first and last half-tile both neighbours are the same
LUT.

* local LUTs: kernel C's LUT stage (``kernels.clahe_luts``) on the card,
  :func:`mdx_torch.ops.clahe.clahe_luts_plain` on the CPU — the same clip
  and scan as the dense op;
* remap: TPU kernel 11's port, ``kernels.clahe_remap_ext``
  (``csrc/clahe.cu``), on the card; :func:`remap_ext_plain` on the CPU.
  Both place a pixel by its block-local column; that is the global
  alignment of the CLAHE tiles because every block's width is a multiple
  of the tile size (checked in :func:`clahe_sharded`).
"""

from __future__ import annotations

import torch

from mdx_torch import kernels
from mdx_torch.ops.clahe import clahe_luts_plain
from mdx_torch.ops.filters import as_n
from mdx_torch.parallel.spatial import halo_axis


def remap_ext_plain(xp: torch.Tensor, lut_ext: torch.Tensor, t: int,
                    nbins: int = 256) -> torch.Tensor:
    """The plain PyTorch version of kernel 11 (``_remap_ext_xla``,
    ``mdx/parallel/clahe_sp.py:81``): bilinear remap of the clipped block
    ``xp`` [N, Hs, W] against the halo-extended LUT grid ``lut_ext``
    [N, ceil(Hs/t)+2, ceil(W/t)+2, nbins]."""
    n, hs, ws = xp.shape
    gxe = lut_ext.shape[2]
    q = torch.clamp_max((xp * nbins).to(torch.int64), nbins - 1)
    dev = xp.device
    fy = (torch.arange(hs, dtype=xp.dtype, device=dev) + 0.5) / t - 0.5
    fx = (torch.arange(ws, dtype=xp.dtype, device=dev) + 0.5) / t - 0.5
    y0 = torch.floor(fy).to(torch.int64) + 1
    x0 = torch.floor(fx).to(torch.int64) + 1
    wy = (fy - torch.floor(fy))[None, :, None]
    wx = (fx - torch.floor(fx))[None, None, :]
    lut_flat = lut_ext.reshape(n, -1)

    def sample(yi, xi):
        tid = yi[:, None] * gxe + xi[None, :]
        gidx = (tid[None] * nbins + q).reshape(n, -1)
        return torch.gather(lut_flat, 1, gidx).reshape(n, hs, ws)

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def clahe_luts(xp: torch.Tensor, clip_limit, t: int,
               nbins: int = 256) -> torch.Tensor:
    """Per-tile LUTs of the clipped block → [N, Hs/t, W/t, nbins]."""
    if kernels.use_kernel(xp):
        if nbins != 256:
            raise ValueError(f"clahe kernel: nbins must be 256, got {nbins}")
        return kernels.clahe_luts(xp.contiguous(), as_n(clip_limit, xp), t)
    return clahe_luts_plain(xp, clip_limit, t, nbins)


def remap_ext(xp: torch.Tensor, lut_ext: torch.Tensor, t: int,
              nbins: int = 256) -> torch.Tensor:
    """Kernel 11 on a CUDA tensor, :func:`remap_ext_plain` on a CPU one."""
    if kernels.use_kernel(xp):
        if nbins != 256:
            raise ValueError(f"clahe kernel: nbins must be 256, got {nbins}")
        return kernels.clahe_remap_ext(xp.contiguous(), lut_ext.contiguous(),
                                       t)
    return remap_ext_plain(xp, lut_ext, t, nbins)


def clahe_sharded(x: torch.Tensor, clip_limit, tile_size: int, mesh,
                  nbins: int = 256) -> torch.Tensor:
    """CLAHE of the global images from this rank's [N, Hs, Ws] block; Hs and
    Ws must be multiples of ``tile_size``."""
    t = int(tile_size)
    if x.shape[1] % t or x.shape[2] % t:
        raise ValueError(f"sharded CLAHE: block {x.shape[1]}x{x.shape[2]} "
                         f"is not a whole number of {t}x{t} tiles")
    xp = torch.clamp(x, 0.0, 1.0)
    lut = clahe_luts(xp, clip_limit, t, nbins)          # [N, gy, gx, nbins]
    # the LUT rows next to the block: the neighbours' edge rows, or a copy
    # of this block's own at the global top and bottom; then the columns of
    # that row-extended grid, likewise (a copy on a 1-D layout)
    lut_ext = halo_axis(lut, 1, 1, 1, mesh, "edge")
    lut_ext = halo_axis(lut_ext, 1, 1, 2, mesh, "edge")
    return remap_ext(xp, lut_ext, t, nbins)
