"""Sharded CLAHE: the tile grid mapped onto the row blocks.

Counterpart of ``mdx/parallel/clahe_sp.py`` (skimage
``equalize_adapthist`` semantics, ref pipeline/enhancement.py:277-280).
When a block's rows and the width are multiples of the tile size, every
tile's histogram and LUT are local to the rank that holds it; the bilinear
remap needs only one halo row of LUTs from each neighbouring block.  At the
global top and bottom (and at the left and right edge) the halo is a copy of
the block's own edge LUTs, so one uniform formula — ``y0 = floor(f) + 1``,
``w = f − floor(f)`` over the halo-extended grid, no clamp — gives skimage's
clamped remap: in the first and last half-tile both neighbours are the same
LUT.

* local LUTs: kernel C's LUT stage (``kernels.clahe_luts``) on the card,
  :func:`mdx_torch.ops.clahe.clahe_luts_plain` on the CPU — the same clip
  and scan as the dense op;
* remap: TPU kernel 11's port, ``kernels.clahe_remap_ext``
  (``csrc/clahe.cu``), on the card; :func:`remap_ext_plain` on the CPU.
"""

from __future__ import annotations

import torch

from mdx_torch import kernels
from mdx_torch.ops.clahe import clahe_luts_plain
from mdx_torch.ops.filters import as_n
from mdx_torch.parallel import comm


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
    """CLAHE of the global images from this rank's [N, Hs, W] block; Hs and
    W must be multiples of ``tile_size`` (the entry points check)."""
    t = int(tile_size)
    xp = torch.clamp(x, 0.0, 1.0)
    lut = clahe_luts(xp, clip_limit, t, nbins)          # [N, gy, gx, nbins]
    # the LUT rows next to the block: the neighbours' edge rows, or a copy
    # of this block's own at the global top and bottom
    from_prev, from_next = comm.exchange_rows(lut[:, -1:], lut[:, :1], mesh)
    lut_ext = torch.cat([lut[:, :1] if from_prev is None else from_prev, lut,
                         lut[:, -1:] if from_next is None else from_next],
                        dim=1)
    lut_ext = torch.cat([lut_ext[:, :, :1], lut_ext, lut_ext[:, :, -1:]],
                        dim=2)
    return remap_ext(xp, lut_ext, t, nbins)
