"""The 2-D tile layer: the sharded metric pass, stencils and QA step on a
``sy × sx`` grid of tiles.

Counterpart of ``mdx/parallel/spatial2d.py``.  Row blocks cap the ranks of
one slice at H/16 (:data:`~.spatial.MIN_ROWS_PER_SHARD` rows a block);
tiles cap them at (H/16)·(W/16).  Every rank holds one ``Hs × Ws`` tile
(``mdx_torch.parallel.mesh``: rank ``r`` has tile row ``(r // sx) % sy`` and
tile column ``r % sx``):

* halos are two-phase (:func:`~.spatial.halo2`): rows from the tiles above
  and below, then the columns of the row-extended block from the tiles to
  the left and right, which carry the corners; global-edge tiles pad their
  own border with the dense op's boundary mode;
* moments, histograms and percentile counts are summed over the tile group
  (the ``space`` ranks of a data row), with the 1-D layer's reductions;
* the stride-2 db2 transform of the noise sigma keeps its global phase by
  even tile extents on both axes; each interior tile's one duplicated
  output per axis has validity weight 0 (:func:`hh_subband_2d`).

Only what differs from the 1-D layer lives here: the stencils on a block
extended on both axes (the dense ``ops/filters.py`` stages), the wavelet
sigma, SSIM's global-border crop as a mask, and the shape checks with the
JAX layer's messages.  The rank bodies (``spatial.image_stats_block``,
``enhance_block``, ``qa_block``, ``plan_sp.qa_plan_block``) take these
primitives from the mesh (``plan_sp.layout``), and the host entry points
(``spatial.image_stats_spatial``, ``enhance_spatial``, ``qa_spatial``,
``plan_sp.qa_plan_spatial``) take ``n_space=(sy, sx)``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from mdx_torch.ops import filters as F
from mdx_torch.ops.quantile import percentiles_exact_sharded
from mdx_torch.ops.wavelet import MAD_TO_SIGMA, _f32, qmf_pair, strided_taps_mac
from mdx_torch.parallel import _spmd_stats as S
from mdx_torch.parallel import comm, spatial
from mdx_torch.parallel.spatial import MIN_ROWS_PER_SHARD, halo2, halo_axis

# ---------------------------------------------------------------------------
# Stencils on the two-phase halo
# ---------------------------------------------------------------------------


def lap_sobel(x: torch.Tensor, mesh):
    """(laplacian, sobel_h, sobel_v) of the tile: the dense stencils on one
    block extended by one on both axes."""
    xp = halo2(x, 1, 1, 1, 1, mesh)
    return F.laplace_ext(xp), F.sobel_h_ext(xp), F.sobel_v_ext(xp)


def box_halo(x: torch.Tensor, size: int, mesh) -> torch.Tensor:
    """SciPy ``uniform_filter`` mean across tiles (left-heavy window for
    even sizes, symmetric boundary)."""
    lo = size // 2
    hi = size - lo - 1
    return F.box_ext(halo2(x, lo, hi, lo, hi, mesh), size)


def local_variance_halo(x: torch.Tensor, size: int, mesh) -> torch.Tensor:
    m = box_halo(x, size, mesh)
    m2 = box_halo(x * x, size, mesh)
    return torch.clamp_min(m2 - m * m, 0.0)


# ---------------------------------------------------------------------------
# Distributed wavelet-MAD sigma
# ---------------------------------------------------------------------------


def hh_subband_2d(x: torch.Tensor, mesh, wavelet: str = "db2"):
    """Finest HH detail coefficients of the global image from tiles →
    (coefficients [N, Hs/2+1, Ws/2+1], validity weights of that shape).

    Along W with halo columns, then along H with halo rows on the column
    subband; each pass starts one element into its (L−1)-wide halo and
    strides by 2, so even tile extents keep the global phase.  Each axis
    leaves one trailing output that is the global last one on the last tile
    of that axis and a duplicate of the next tile's first elsewhere; the
    weights keep it only there (``mdx/parallel/spatial2d.py:197-241``)."""
    _, hi_f = qmf_pair(wavelet)
    L = len(hi_f)
    hi_r = hi_f[::-1]
    _, hs, ws = x.shape
    extc = halo_axis(x, L - 1, L - 1, 2, mesh)[:, :, 1:ws + 2 * (L - 1)]
    d_w = strided_taps_mac(extc, hi_r, (extc.shape[2] - L) // 2 + 1, axis=2)
    extr = halo_axis(d_w, L - 1, L - 1, 1, mesh)[:, 1:hs + 2 * (L - 1)]
    d_hw = strided_taps_mac(extr, hi_r, (extr.shape[1] - L) // 2 + 1, axis=1)
    row = torch.arange(hs // 2 + 1, device=x.device)[None, :, None]
    col = torch.arange(ws // 2 + 1, device=x.device)[None, None, :]
    valid = (((row < hs // 2) | mesh.is_last)
             & ((col < ws // 2) | mesh.is_last_col)).to(torch.float32)
    return d_hw, valid


def mad_source(x: torch.Tensor, mesh):
    """(|HH| db2 subband, global valid count, validity weights): the input of
    the wavelet-MAD median, for the fused percentile search."""
    hh, valid = hh_subband_2d(x, mesh, "db2")
    _, hs2, ws2 = hh.shape
    total = ((hs2 - 1) * mesh.n_sy + 1) * ((ws2 - 1) * mesh.n_sx + 1)
    return hh.abs(), total, valid


def estimate_sigma_2d(x: torch.Tensor, mesh) -> torch.Tensor:
    """Wavelet-MAD noise sigma of the global images from tiles → [N], with
    the exact distributed median."""
    hh_abs, total, valid = mad_source(x, mesh)
    med = percentiles_exact_sharded(hh_abs, [50.0], mesh, total,
                                    weights=valid)[0]
    return med * _f32(MAD_TO_SIGMA)


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def ssim_block(x: torch.Tensor, y: torch.Tensor, mesh,
               data_range: float = 1.0, win_size: int = 7) -> torch.Tensor:
    """SSIM of the global images from tiles → [N]: the (win−1)//2 crop of
    the global border as a validity mask on the tiles that hold an edge
    (``mdx/parallel/spatial2d.py:503-536``)."""
    s = spatial.ssim_map(x, y, partial(box_halo, mesh=mesh), data_range,
                         win_size)
    pad = (win_size - 1) // 2
    _, hs, ws = x.shape
    row = torch.arange(hs, device=x.device)[None, :, None]
    col = torch.arange(ws, device=x.device)[None, None, :]
    rvalid = ~(((row < pad) & mesh.is_first)
               | ((row >= hs - pad) & mesh.is_last))
    cvalid = ~(((col < pad) & mesh.is_first_col)
               | ((col >= ws - pad) & mesh.is_last_col))
    valid = (rvalid & cvalid).to(x.dtype)
    total = comm.psum((s * valid).reshape(s.shape[0], -1).sum(dim=-1), mesh)
    cnt = float((hs * mesh.n_sy - 2 * pad) * (ws * mesh.n_sx - 2 * pad))
    return total / cnt


def prims(mesh) -> S.SpatialPrims:
    """The 2-D layer's primitives bound to ``mesh``: its stencils and sigma
    in place of the 1-D layer's, whose reductions sum over the whole tile
    group and serve both."""
    return dataclasses.replace(
        spatial.prims(mesh),
        lap_sobel=partial(lap_sobel, mesh=mesh),
        local_variance=partial(local_variance_halo, mesh=mesh),
        sigma=partial(estimate_sigma_2d, mesh=mesh),
        mad_source=partial(mad_source, mesh=mesh))


# ---------------------------------------------------------------------------
# Shape checks (``mdx/parallel/spatial2d.py:305-320, 437-446``)
# ---------------------------------------------------------------------------


def check_tiles(shape, sy: int, sx: int) -> None:
    """Both extents split evenly into even tiles of at least
    ``MIN_ROWS_PER_SHARD`` rows and columns."""
    h, w = shape[1], shape[2]
    for name, extent, k in (("H", h, sy), ("W", w, sx)):
        if extent % k or (extent // k) % 2:
            raise ValueError(
                f"{name}={extent} must split into even-sized blocks over "
                f"{k} '{'sy' if name == 'H' else 'sx'}' shards (stride-2 "
                f"wavelet phase)")
        if extent // k < MIN_ROWS_PER_SHARD:
            raise ValueError(
                f"{name}={extent} over {k} shards gives {extent // k} "
                f"{'rows' if name == 'H' else 'cols'}/shard — the widest "
                f"stencil halo needs {MIN_ROWS_PER_SHARD} (single-hop halos; "
                f"max usable {'sy' if name == 'H' else 'sx'} axis for "
                f"{name}={extent} is {extent // MIN_ROWS_PER_SHARD})")


def check_clahe_tiles(shape, sy: int, sx: int, clahe_tile: int) -> None:
    """Sharded CLAHE needs whole CLAHE tiles in every tile of the grid."""
    if not clahe_tile:
        return
    if (shape[1] // sy) % clahe_tile or (shape[2] // sx) % clahe_tile:
        raise ValueError(
            f"sharded CLAHE needs per-shard rows ({shape[1]}/{sy}) and "
            f"cols ({shape[2]}/{sx}) to be multiples of "
            f"tile_size={clahe_tile}")


# ---------------------------------------------------------------------------
# Host entry points (``mdx/parallel/spatial2d.py:323, 449, 596``)
# ---------------------------------------------------------------------------


def image_stats_spatial2d(x, layout, **kw) -> dict:
    """The fused metric pass of [N, H, W] numpy on a ``layout = (sy, sx)``
    grid of tiles: ``spatial.image_stats_spatial`` with ``n_space=layout``
    (same keywords and result)."""
    return spatial.image_stats_spatial(x, tuple(layout), **kw)


def enhance_spatial2d(x, layout, **kw):
    """The sharded enhancement chain on a grid of tiles:
    ``spatial.enhance_spatial`` with ``n_space=layout``."""
    return spatial.enhance_spatial(x, tuple(layout), **kw)


def qa_spatial2d(x, layout, **kw) -> dict:
    """Full tile-sharded QA (detect → chain → [noise guard] → metrics, SSIM,
    PSNR, pass rule): ``spatial.qa_spatial`` with ``n_space=layout``."""
    return spatial.qa_spatial(x, tuple(layout), **kw)
