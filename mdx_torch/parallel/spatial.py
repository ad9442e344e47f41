"""The 1-D row-block layer: halos, the sharded metric pass, the halo
stencils and the sharded QA step.

Counterpart of ``mdx/parallel/spatial.py``.  One slice too large for one
device (a 2048² chest X-ray and up) is split into row blocks over the
``space`` ranks (or into a grid of tiles, :mod:`.spatial2d`, whose
primitives plug into the same rank bodies):

* stencils (Laplacian, Sobel, box windows, Gaussian, bilateral, SSIM) read
  halo rows of the neighbouring blocks (:func:`halo_rows`); the first and
  last block pad their own rows as the dense op pads the image, so interior
  results equal the dense op's;
* moments and histograms are local sums added over the ranks — exact for
  integer counts, reduction-order different for float sums;
* percentiles and the wavelet-MAD median are exact order statistics found
  by the distributed bit search of :mod:`mdx_torch.ops.quantile`.

Blur, bilateral, box filters and SSIM run as plain PyTorch on the
halo-extended block, as the JAX layer runs them in XLA: the unsharp and
bilateral kernels pad at the block's own edges, which inside the image is
not the halo's semantics.

The halos (:func:`halo_axis`, :func:`halo2`), the reductions, the blur and
the bilateral filter serve both layouts: on a 2-D grid a halo takes rows
from the tiles above and below first, then the columns of that
row-extended block from the tiles to the left and right, so the corners
come with the columns (``mdx/parallel/spatial2d.py`` ``_halo2``); with one
tile column the column phase is a pad.

Per-rank functions take ``(x_block, ..., mesh=SpatialMesh)``; the rank
bodies (:func:`image_stats_block`, :func:`enhance_block`, :func:`qa_block`)
take the layout's primitives from the mesh.  The host entry points
(:func:`image_stats_spatial`, :func:`enhance_spatial`, :func:`qa_spatial`)
take ``[N, H, W]`` numpy and ``n_space`` (row blocks, or ``(sy, sx)`` tiles)
and run through :func:`mdx_torch.parallel.launch.run`.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from mdx_torch.core.metrics import detect_issues
from mdx_torch.ops import filters as F
from mdx_torch.ops import hist as H
from mdx_torch.ops.filters import as_n, pad_axis
from mdx_torch.ops.quantile import (
    percentiles_exact_sharded,
    percentiles_multi_sharded,
)
from mdx_torch.ops.wavelet import MAD_TO_SIGMA, _f32, qmf_pair, strided_taps_mac
from mdx_torch.parallel import _spmd_stats as S
from mdx_torch.parallel import comm, launch
from mdx_torch.parallel.mesh import grid

# Widest one-block halo: the unsharp Gaussian's fixed support (radius 12);
# box16 needs 8, bilateral ≤ 4, the db2 DWT 3.  Row blocks must cover it.
MIN_ROWS_PER_SHARD = 16


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


_EDGE_MODES = ("symmetric", "reflect", "edge")


def _edge_pad(x: torch.Tensor, n: int, axis: int, side: str,
              mode: str) -> torch.Tensor:
    """A global edge's ``n`` halo slabs along ``axis`` from the block's own
    border: "symmetric" (edge slab repeated, ``jnp.pad`` symmetric),
    "reflect" (edge slab excluded) or "edge" (edge slab replicated)."""
    size = x.shape[axis]
    if mode == "edge":
        shape = list(x.shape)
        shape[axis] = n
        return x.narrow(axis, 0 if side == "lo" else size - 1, 1).expand(shape)
    off = 1 if mode == "reflect" else 0
    return x.narrow(axis, off if side == "lo" else size - off - n, n).flip(axis)


def halo_axis(x: torch.Tensor, lo: int, hi: int, axis: int, mesh,
              edge_mode: str = "symmetric") -> torch.Tensor:
    """Extend axis 1 (rows) or 2 (columns) of the block by ``lo``/``hi``
    halo slabs from the neighbouring tiles on that axis; a tile at the
    global edge pads its own border with ``edge_mode``
    (``mdx/parallel/spatial2d.py`` ``_halo_axis``)."""
    if edge_mode not in _EDGE_MODES:
        raise ValueError(f"unknown edge_mode {edge_mode!r}")
    size = x.shape[axis]
    exchange = comm.exchange_rows if axis == 1 else comm.exchange_cols
    from_prev, from_next = exchange(
        x.narrow(axis, size - lo, lo) if lo else None,
        x.narrow(axis, 0, hi) if hi else None, mesh)
    parts = []
    if lo:
        parts.append(_edge_pad(x, lo, axis, "lo", edge_mode)
                     if from_prev is None else from_prev)
    parts.append(x)
    if hi:
        parts.append(_edge_pad(x, hi, axis, "hi", edge_mode)
                     if from_next is None else from_next)
    return torch.cat(parts, dim=axis) if len(parts) > 1 else x


def halo_rows(x: torch.Tensor, up: int, down: int, mesh,
              edge_mode: str = "symmetric") -> torch.Tensor:
    """[N, Hs, W] block → [N, up+Hs+down, W] with halo rows from the
    neighbouring blocks; the first and last block pad their own rows with
    ``edge_mode``."""
    return halo_axis(x, up, down, 1, mesh, edge_mode)


def halo2(x: torch.Tensor, up: int, down: int, left: int, right: int, mesh,
          edge_mode: str = "symmetric") -> torch.Tensor:
    """The two-phase halo [N, Hs, Ws] → [N, up+Hs+down, left+Ws+right]:
    rows from the tiles above and below, then the columns of the
    row-extended block from the tiles to the left and right, which carry
    the corners (no diagonal message; ``mdx/parallel/spatial2d.py``
    ``_halo2``).  With one tile column the columns are a pad."""
    return halo_axis(halo_axis(x, up, down, 1, mesh, edge_mode), left, right,
                     2, mesh, edge_mode)


def lap_sobel(x: torch.Tensor, mesh):
    """(laplacian, sobel_h, sobel_v) of the block: the dense stencils on
    its halo-extended rows."""
    xr = halo_rows(x, 1, 1, mesh)
    return (F.laplace_rows_ext(xr), F.sobel_h_rows_ext(xr),
            F.sobel_v_rows_ext(xr))


def box_halo(x: torch.Tensor, size: int, mesh) -> torch.Tensor:
    """SciPy ``uniform_filter`` mean across blocks (left-heavy window for
    even sizes, symmetric boundary)."""
    lo = size // 2
    return F.box_rows_ext(halo_rows(x, lo, size - lo - 1, mesh), size)


def local_variance_halo(x: torch.Tensor, size: int, mesh) -> torch.Tensor:
    m = box_halo(x, size, mesh)
    m2 = box_halo(x * x, size, mesh)
    return torch.clamp_min(m2 - m * m, 0.0)


# ---------------------------------------------------------------------------
# Distributed reductions
# ---------------------------------------------------------------------------


def _flat(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape[0], -1)


def pmean_img(v: torch.Tensor, mesh) -> torch.Tensor:
    """Global per-image mean of [N, Hs, W] blocks → [N]."""
    s = comm.psum(_flat(v).sum(dim=-1), mesh)
    return s / float(v[0].numel() * mesh.n_space)


def pvar_img(v: torch.Tensor, mesh):
    """Global per-image (mean, variance) from the first two moments."""
    m = pmean_img(v, mesh)
    m2 = pmean_img(v * v, mesh)
    return m, torch.clamp_min(m2 - m * m, 0.0)


def phist(v: torch.Tensor, bins: int, hi: torch.Tensor, mesh) -> torch.Tensor:
    """Global per-image histogram over [0, hi_i] → [N, bins]: exact integer
    counts per block, added over the ranks."""
    idx = H.bin_indices(_flat(v), bins, torch.clamp_min(hi, 1e-30))
    return comm.psum(H.counts_from_indices(idx, bins), mesh)


def pmax_img(v: torch.Tensor, mesh) -> torch.Tensor:
    return comm.pmax(_flat(v).amax(dim=-1), mesh)


def psum_img(v: torch.Tensor, mesh) -> torch.Tensor:
    return comm.psum(_flat(v).sum(dim=-1), mesh)


def pq(v: torch.Tensor, qs, mesh) -> torch.Tensor:
    """Exact global percentiles of the blocks → [len(qs), N]."""
    return percentiles_exact_sharded(v, qs, mesh,
                                     v[0].numel() * mesh.n_space)


def pq_multi(sources, mesh):
    """Fused exact percentiles; a ``total`` of None means the whole
    row-sharded array."""
    return percentiles_multi_sharded(
        [(v, qs, v[0].numel() * mesh.n_space if total is None else total, w)
         for v, qs, total, w in sources], mesh)


# ---------------------------------------------------------------------------
# Distributed wavelet-MAD sigma
# ---------------------------------------------------------------------------


def hh_subband_halo(x: torch.Tensor, mesh, wavelet: str = "db2"):
    """Finest HH detail coefficients of the global image from row blocks →
    (coefficients [N, Hs/2+1, Wout], validity weights [1, Hs/2+1, 1]).

    Along W locally (whole rows are on the rank), along H with halo rows.
    Every block holds an even number of rows, so the stride-2 phase is the
    global one.  Each block keeps Hs/2 output rows plus one trailing row that
    is the global bottom row on the last block and a duplicate of the next
    block's first row elsewhere; the weights keep it only on the last block
    (``mdx/parallel/spatial.py`` ``_hh_subband_halo``)."""
    _, hi_f = qmf_pair(wavelet)
    L = len(hi_f)
    n, hs, w = x.shape
    hi_r = hi_f[::-1]
    xp = pad_axis(x, 2, L - 1, L - 1, "symmetric")[..., 1:]
    d_w = strided_taps_mac(xp, hi_r, (w + L - 1) // 2, axis=2)
    ext = halo_rows(d_w, L - 1, L - 1, mesh)
    ext = ext[:, 1:1 + hs + 2 * (L - 1) - 1]
    d_hw = strided_taps_mac(ext, hi_r, (ext.shape[1] - L) // 2 + 1, axis=1)
    keep = d_hw[:, :hs // 2 + 1]
    row = torch.arange(hs // 2 + 1, device=x.device)[None, :, None]
    valid = ((row < hs // 2) | mesh.is_last).to(torch.float32)
    return keep, valid


def mad_source(x: torch.Tensor, mesh):
    """(|HH| db2 subband, global valid count, validity weights): the input of
    the wavelet-MAD median, for the fused percentile search."""
    hh, valid = hh_subband_halo(x, mesh, "db2")
    _, hs2, wout = hh.shape
    total = ((hs2 - 1) * mesh.n_space + 1) * wout
    return hh.abs(), total, valid


def estimate_sigma_spatial(x: torch.Tensor, mesh) -> torch.Tensor:
    """Wavelet-MAD noise sigma of the global images → [N], with the exact
    distributed median."""
    hh_abs, total, valid = mad_source(x, mesh)
    med = percentiles_exact_sharded(hh_abs, [50.0], mesh, total,
                                    weights=valid)[0]
    return med * _f32(MAD_TO_SIGMA)


def prims(mesh) -> S.SpatialPrims:
    """The 1-D layer's primitives bound to ``mesh`` (the 2-D layer's are
    :func:`mdx_torch.parallel.spatial2d.prims`)."""
    return S.SpatialPrims(
        lap_sobel=partial(lap_sobel, mesh=mesh),
        local_variance=partial(local_variance_halo, mesh=mesh),
        pmean=partial(pmean_img, mesh=mesh),
        pvar=partial(pvar_img, mesh=mesh),
        phist=partial(phist, mesh=mesh),
        pq=partial(pq, mesh=mesh),
        pmax_img=partial(pmax_img, mesh=mesh),
        psum_img=partial(psum_img, mesh=mesh),
        sigma=partial(estimate_sigma_spatial, mesh=mesh),
        mad_source=partial(mad_source, mesh=mesh),
        pq_multi=partial(pq_multi, mesh=mesh))


# ---------------------------------------------------------------------------
# The sharded metric pass
# ---------------------------------------------------------------------------


def _layout(mesh):
    """The layout of ``mesh`` (1-D row blocks or 2-D tiles)."""
    from mdx_torch.parallel.plan_sp import layout

    return layout(mesh)


def image_stats_block(x: torch.Tensor, *, mesh) -> dict[str, torch.Tensor]:
    """Per-rank body of the metric pass: {metric: [N]} of the global
    images, from this rank's [N, Hs, Ws] block."""
    return S.image_stats_block(x, _layout(mesh).prims)


def check_rows(h: int, k: int) -> None:
    """H must split into even blocks of at least ``MIN_ROWS_PER_SHARD``
    rows over ``k`` space ranks (``mdx/parallel/spatial.py:296-305``)."""
    if h % k or (h // k) % 2:
        raise ValueError(
            f"H={h} must split into even-sized row blocks over {k} shards")
    if h // k < MIN_ROWS_PER_SHARD:
        raise ValueError(
            f"H={h} over {k} shards gives {h // k} rows/shard — the widest "
            f"stencil halo needs {MIN_ROWS_PER_SHARD} (single-hop halos; "
            f"max usable space axis for H={h} is "
            f"{h // MIN_ROWS_PER_SHARD}); use fewer spatial shards or the "
            f"batch-sharded path")


def check_clahe_tiles(shape, k: int, clahe_tile: int) -> None:
    """Sharded CLAHE needs whole tiles in every block
    (``mdx/parallel/spatial.py:430-438``)."""
    if not clahe_tile:
        return
    if (shape[1] // k) % clahe_tile or shape[2] % clahe_tile:
        raise ValueError(
            f"sharded CLAHE needs per-shard rows ({shape[1]}/{k}) and "
            f"W={shape[2]} to be multiples of tile_size={clahe_tile}")


def check_enhance_rows(h: int, k: int) -> None:
    """``enhance_spatial``'s row check (``mdx/parallel/spatial.py:446``)."""
    if h % k or h // k < MIN_ROWS_PER_SHARD:
        raise ValueError(
            f"H={h} over {k} shards: need ≥{MIN_ROWS_PER_SHARD} "
            f"rows per shard for the single-hop stencil halos (max usable "
            f"space axis for H={h} is {h // MIN_ROWS_PER_SHARD})")


def check_grid(shape, n_space, clahe_tile: int = 0,
               check_1d=check_rows) -> None:
    """The shape checks of the entry points, with the JAX layer's messages:
    ``check_1d(H, k)`` and :func:`check_clahe_tiles` for row blocks, the
    2-D layer's :func:`~.spatial2d.check_tiles` and
    :func:`~.spatial2d.check_clahe_tiles` for a grid with ``sx > 1``."""
    sy, sx = grid(n_space)
    if sx > 1:
        from mdx_torch.parallel import spatial2d

        spatial2d.check_tiles(shape, sy, sx)
        spatial2d.check_clahe_tiles(shape, sy, sx, clahe_tile)
    else:
        check_1d(shape[1], sy)
        check_clahe_tiles(shape, sy, clahe_tile)


def image_stats_spatial(x: np.ndarray, n_space, *, n_data: int = 1,
                        device: str = "cuda",
                        timeout_s: float = 600.0) -> dict:
    """The fused metric pass on ``n_data × n_space`` ranks (``n_space``: row
    blocks, or ``(sy, sx)`` tiles): [N, H, W] numpy → {metric: [N] numpy},
    plus ``"launch"`` (backend, ranks, host round trips per rank)."""
    check_grid(x.shape, n_space)
    res = launch.run(image_stats_block, x, n_space=n_space, n_data=n_data,
                     device=device, timeout_s=timeout_s)
    out = launch.assemble(res.results, n_data, n_space, block_keys=())
    out["launch"] = res.info()
    return out


# ---------------------------------------------------------------------------
# Sharded enhancement
# ---------------------------------------------------------------------------


def gaussian_blur_halo(x: torch.Tensor, sigma, mesh,
                       max_radius: int = F._GAUSS_MAX_RADIUS) -> torch.Tensor:
    """Separable Gaussian on the fixed ±12 support with skimage's
    ``nearest`` (edge) boundary, per-image sigma, across blocks."""
    r = max_radius
    _, hs, ws = x.shape
    w = F._gauss_taps(as_n(sigma, x, x.dtype), x.dtype)
    xp = halo2(x, r, r, r, r, mesh, "edge")
    return F.shift_macs_cols(F.shift_macs_rows(xp, w, hs), w, ws)


def bilateral_halo(x: torch.Tensor, d: int, sigma_color, sigma_space,
                   mesh) -> torch.Tensor:
    """d×d bilateral across blocks (reflect boundary at the global edges):
    the shifted-MAC form of ``mdx/parallel/spatial.py`` ``_bilateral_halo``
    (and of ``spatial2d.py``'s, on the two-phase halo)."""
    d = min(int(d), 9)
    if d % 2 == 0:
        d += 1
    r = d // 2
    _, hs, w = x.shape
    sc = as_n(sigma_color, x, x.dtype)[:, None, None]
    ss = as_n(sigma_space, x, x.dtype)[:, None, None]
    inv_2sc2 = 1.0 / (2.0 * sc * sc)
    inv_2ss2d2 = 1.0 / (2.0 * ss * ss * float(d * d))
    xp = halo2(x, r, r, r, r, mesh, "reflect")
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = xp[:, r + dy:r + dy + hs, r + dx:r + dx + w]
            sw = torch.exp(-float(dx * dx + dy * dy) * inv_2ss2d2)
            iw = torch.exp(-torch.square(x - shifted) * inv_2sc2)
            wgt = sw * iw
            num = num + wgt * shifted
            den = den + wgt
    return num / (den + 1e-10)


def unsharp_halo(x: torch.Tensor, radius, amount, mesh) -> torch.Tensor:
    """clip(x + (x − blur(x))·amount, 0, 1) with the halo blur."""
    amt = as_n(amount, x, x.dtype)[:, None, None]
    return torch.clamp(x + (x - gaussian_blur_halo(x, radius, mesh)) * amt,
                       0.0, 1.0)


def enhance_block(x: torch.Tensor, *, mesh, gamma=1.0, unsharp_radius=0.8,
                  unsharp_amount=0.5, bilateral_sigma_color=0.05,
                  bilateral_sigma_space=0.05, clahe_clip=0.0, tv_weight=0.0,
                  post_denoise_strength=0.0, bilateral_d: int = 0,
                  clahe_tile: int = 0, use_tv: bool = False,
                  use_denoise: bool = False,
                  use_post_denoise: bool = False) -> torch.Tensor:
    """Per-rank enhancement chain in reference order (ref
    pipeline/enhancement.py:270-312): [denoise →] [CLAHE →] gamma →
    unsharp → [post_denoise →] [bilateral →] [TV], on row blocks or tiles."""
    from mdx_torch.parallel.clahe_sp import clahe_sharded
    from mdx_torch.parallel.tv_sp import tv_sharded
    from mdx_torch.parallel.wavelet_sp import (
        denoise_wavelet_sharded,
        light_denoise_sharded,
    )

    if use_denoise:
        x = torch.clamp(denoise_wavelet_sharded(x, mesh), 0.0, 1.0)
    if clahe_tile > 0:
        x = clahe_sharded(x, clahe_clip, clahe_tile, mesh)
    y = F.adjust_gamma(x, as_n(gamma, x, x.dtype))
    y = unsharp_halo(y, unsharp_radius, unsharp_amount, mesh)
    if use_post_denoise:
        y = light_denoise_sharded(y, post_denoise_strength,
                                  _layout(mesh).prims.sigma(y), mesh)
    if bilateral_d > 0:
        y = bilateral_halo(torch.clamp(y, 0.0, 1.0), bilateral_d,
                           bilateral_sigma_color, bilateral_sigma_space, mesh)
    if use_tv:
        y, _ = tv_sharded(torch.clamp(y, 0.0, 1.0), tv_weight, mesh)
    return torch.clamp(y, 0.0, 1.0)


def enhance_kwargs(*, gamma, unsharp_radius, unsharp_amount, bilateral_d,
                    bilateral_sigma_color, bilateral_sigma_space,
                    clahe_clip_limit, clahe_tile_size, tv_weight, denoise,
                    post_denoise_strength) -> dict:
    """The JAX entry points' keyword arguments → :func:`enhance_block`'s
    (an optional op joins when its parameter is given)."""
    return dict(
        gamma=gamma, unsharp_radius=unsharp_radius,
        unsharp_amount=unsharp_amount,
        bilateral_sigma_color=bilateral_sigma_color,
        bilateral_sigma_space=bilateral_sigma_space,
        clahe_clip=clahe_clip_limit if clahe_clip_limit is not None else 0.0,
        tv_weight=tv_weight if tv_weight is not None else 0.0,
        post_denoise_strength=(post_denoise_strength
                               if post_denoise_strength is not None else 0.0),
        bilateral_d=int(bilateral_d),
        clahe_tile=(int(clahe_tile_size) if clahe_clip_limit is not None
                    else 0),
        use_tv=tv_weight is not None, use_denoise=bool(denoise),
        use_post_denoise=post_denoise_strength is not None)


def _enhance_rank(x: torch.Tensor, *, mesh, **kw) -> dict:
    return {"enhanced": enhance_block(x, mesh=mesh, **kw)}


def enhance_spatial(x: np.ndarray, n_space, *, gamma: float = 1.0,
                    unsharp_radius: float = 0.8, unsharp_amount: float = 0.5,
                    bilateral_d: int = 0, bilateral_sigma_color: float = 0.05,
                    bilateral_sigma_space: float = 0.05,
                    clahe_clip_limit: float | None = None,
                    clahe_tile_size: int = 16, tv_weight: float | None = None,
                    denoise: bool = False,
                    post_denoise_strength: float | None = None,
                    n_data: int = 1, device: str = "cuda",
                    timeout_s: float = 600.0) -> np.ndarray:
    """The sharded enhancement chain of [N, H, W] numpy → [N, H, W] numpy
    (``n_space``: row blocks, or ``(sy, sx)`` tiles)."""
    kw = enhance_kwargs(
        gamma=gamma, unsharp_radius=unsharp_radius,
        unsharp_amount=unsharp_amount, bilateral_d=bilateral_d,
        bilateral_sigma_color=bilateral_sigma_color,
        bilateral_sigma_space=bilateral_sigma_space,
        clahe_clip_limit=clahe_clip_limit, clahe_tile_size=clahe_tile_size,
        tv_weight=tv_weight, denoise=denoise,
        post_denoise_strength=post_denoise_strength)
    check_grid(x.shape, n_space, kw["clahe_tile"], check_enhance_rows)
    res = launch.run(_enhance_rank, x, n_space=n_space, n_data=n_data,
                     device=device, timeout_s=timeout_s,
                     **kw)
    return launch.assemble(res.results, n_data, n_space)["enhanced"]


# ---------------------------------------------------------------------------
# Sharded validation and the full QA step
# ---------------------------------------------------------------------------


def ssim_map(x: torch.Tensor, y: torch.Tensor, box, data_range: float = 1.0,
             win_size: int = 7) -> torch.Tensor:
    """The SSIM map of two blocks from a halo box mean ``box(v, size)``
    (skimage: 7×7 uniform window, unbiased covariance)."""
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    ux = box(x, win_size)
    uy = box(y, win_size)
    uxx = box(x * x, win_size)
    uyy = box(y * y, win_size)
    uxy = box(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    return ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))


def ssim_block(x: torch.Tensor, y: torch.Tensor, mesh,
               data_range: float = 1.0, win_size: int = 7) -> torch.Tensor:
    """SSIM of the global images → [N] (skimage: 7×7 uniform window,
    unbiased covariance, a (win−1)//2 crop of the global border)."""
    s = ssim_map(x, y, partial(box_halo, mesh=mesh), data_range, win_size)
    pad = (win_size - 1) // 2
    n, hs, w = x.shape
    row = torch.arange(hs, device=x.device)[None, :, None]
    valid = torch.ones((1, hs, 1), dtype=torch.float32, device=x.device)
    if mesh.is_first:
        valid = torch.where(row < pad, 0.0, valid)
    if mesh.is_last:
        valid = torch.where(row >= hs - pad, 0.0, valid)
    s = s[:, :, pad:-pad] * valid
    total = comm.psum(_flat(s).sum(dim=-1), mesh)
    cnt = float((hs * mesh.n_space - 2 * pad) * (w - 2 * pad))
    return total / cnt


def psnr_block(x: torch.Tensor, y: torch.Tensor, mesh,
               data_range: float = 1.0) -> torch.Tensor:
    mse = pmean_img(torch.square(x - y), mesh)
    return 10.0 * torch.log10((data_range * data_range) / mse)


def qa_block(xb: torch.Tensor, *, mesh, use_noise_guard: bool = False,
             **enhance_kw) -> dict:
    """Per-rank body of :func:`qa_spatial`: metrics → chain → [noise guard]
    → metrics, SSIM, PSNR and the pass verdict."""
    from mdx_torch.parallel.wavelet_sp import light_denoise_sharded

    lay = _layout(mesh)
    p = lay.prims
    before = S.image_stats_block(xb, p)
    enhanced = enhance_block(xb, mesh=mesh, **enhance_kw)
    if use_noise_guard:
        # noise-amplification safeguard (ref pipeline/enhancement.py:55-63,
        # 221-226): σ_after > 1.3·σ_before → corrective light_denoise(0.4)
        sb = before["sigma"]
        sa = p.sigma(enhanced)
        noise_amp = (sb >= 1e-8) & (sa > sb * 1.3)
        fixed = torch.clamp(light_denoise_sharded(enhanced, 0.4, sa, mesh),
                            0.0, 1.0)
        enhanced = torch.where(noise_amp[:, None, None], fixed, enhanced)
    else:
        noise_amp = torch.zeros(xb.shape[0], dtype=torch.bool,
                                device=xb.device)
    after = S.image_stats_block(enhanced, p)
    s = lay.ssim(xb, enhanced)
    ps = lay.psnr(xb, enhanced)
    qi, passes = S.qa_verdict(before, after, s, ps)
    return {"stats_before": before, "stats_after": after,
            "enhanced": enhanced, "ssim": s, "psnr": ps,
            "quality_improvement": qi, "passes": passes,
            "noise_amp_guard": noise_amp}


def qa_block_kwargs(*, gamma: float = 0.95, unsharp_radius: float = 0.8,
                    unsharp_amount: float = 0.5, bilateral_d: int = 5,
                    bilateral_sigma_color: float = 0.05,
                    bilateral_sigma_space: float = 0.05,
                    clahe_clip_limit: float | None = None,
                    clahe_tile_size: int = 16,
                    tv_weight: float | None = None, denoise: bool = False,
                    post_denoise_strength: float | None = None,
                    noise_guard: bool = False) -> dict:
    """JAX's ``qa_spatial`` keywords (and defaults) → :func:`qa_block`'s
    (an optional op joins when its parameter is given)."""
    return dict(enhance_kwargs(
        gamma=gamma, unsharp_radius=unsharp_radius,
        unsharp_amount=unsharp_amount, bilateral_d=bilateral_d,
        bilateral_sigma_color=bilateral_sigma_color,
        bilateral_sigma_space=bilateral_sigma_space,
        clahe_clip_limit=clahe_clip_limit, clahe_tile_size=clahe_tile_size,
        tv_weight=tv_weight, denoise=denoise,
        post_denoise_strength=post_denoise_strength),
        use_noise_guard=bool(noise_guard))


def qa_spatial(x: np.ndarray, n_space, *, n_data: int = 1,
               device: str = "cuda", timeout_s: float = 600.0,
               **kw) -> dict:
    """Full sharded QA of [N, H, W] numpy on ``n_data × n_space`` ranks
    (``n_space``: row blocks, or ``(sy, sx)`` tiles): detect → the chain
    (``kw``: JAX's keywords, :func:`qa_block_kwargs`) → [noise guard] →
    before/after metrics, SSIM, PSNR, pass rule.  Returns JAX's fields as
    numpy (``stats_before``, ``stats_after``, ``issues``, ``enhanced``,
    ``ssim``, ``psnr``, ``quality_improvement``, ``passes``,
    ``noise_amp_guard``) plus ``"launch"``."""
    block_kw = qa_block_kwargs(**kw)
    check_grid(x.shape, n_space, block_kw["clahe_tile"])
    res = launch.run(qa_block, x, n_space=n_space, n_data=n_data,
                     device=device, timeout_s=timeout_s, **block_kw)
    out = launch.assemble(res.results, n_data, n_space)
    out["issues"] = detect_issues(out["stats_before"])
    out["launch"] = res.info()
    return out
