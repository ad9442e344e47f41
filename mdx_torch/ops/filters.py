"""Batched stencil / separable filters on [N, H, W] tensors (PyTorch).

Counterpart of ``mdx/ops/filters.py``.  Boundary conventions:
  * ``symmetric`` pad == SciPy ndimage ``mode="reflect"`` (edge repeated)
  * ``edge`` pad == SciPy ``mode="nearest"`` (skimage gaussian default)

Every stencil is a shift-add on slices with the JAX package's accumulation
order (tap-ascending, one 1/size scale per axis), never ``F.conv2d``.
``unsharp_mask`` launches the hand-written CUDA kernel on a CUDA tensor.
"""

from __future__ import annotations

import torch

from mdx_torch import kernels


def pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int,
             mode: str) -> torch.Tensor:
    """``jnp.pad`` along one axis by gathering source indices.

    ``mode``: "symmetric" (edge repeated), "reflect" (edge not repeated),
    "edge" (clamp) or "constant" (zeros).  torch's own pad has no
    symmetric mode, so every mode goes through one index rule here."""
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
    """Pad both spatial axes of [N, H, W] by (lo, hi)."""
    return pad_axis(pad_axis(x, 1, lo, hi, mode), 2, lo, hi, mode)


# The stencils below are written on an extended block.  The ``*_rows_ext``
# forms take a block whose rows are extended (a symmetric pad for the dense
# image, a row block's halo rows in ``mdx_torch.parallel.spatial``), with
# each column stage padding its own columns symmetrically, as the JAX
# package's per-axis filters do; the ``*_ext`` forms take a block extended
# on both axes (a tile's two-phase halo in ``mdx_torch.parallel.spatial2d``).
# Both run the same stages: a pad is a copy, so padding before or after a
# stage along the other axis gives the same bits.


def laplace_ext(xp: torch.Tensor) -> torch.Tensor:
    """5-point Laplacian of a [N, H+2, W+2] block → [N, H, W]."""
    return (4.0 * xp[:, 1:-1, 1:-1] - xp[:, :-2, 1:-1] - xp[:, 2:, 1:-1]
            - xp[:, 1:-1, :-2] - xp[:, 1:-1, 2:])


def laplace_rows_ext(xr: torch.Tensor) -> torch.Tensor:
    """5-point Laplacian of a [N, H+2, W] block whose rows are extended by
    one → [N, H, W]."""
    return laplace_ext(pad_axis(xr, 2, 1, 1, "symmetric"))


def laplace(x: torch.Tensor) -> torch.Tensor:
    """3×3 cross Laplacian, symmetric boundary (ref pipeline/metrics.py:48)."""
    return laplace_rows_ext(pad_axis(x, 1, 1, 1, "symmetric"))


def _smooth3_ext(xp: torch.Tensor, axis: int) -> torch.Tensor:
    """[1,2,1]/2 correlation along ``axis``, already extended by one."""
    n = xp.shape[axis] - 2
    return (0.5 * xp.narrow(axis, 0, n) + xp.narrow(axis, 1, n)
            + 0.5 * xp.narrow(axis, 2, n))


def _diff3_ext(xp: torch.Tensor, axis: int) -> torch.Tensor:
    """[-1,0,1]/2 correlation along ``axis``, already extended by one."""
    n = xp.shape[axis] - 2
    return 0.5 * (xp.narrow(axis, 2, n) - xp.narrow(axis, 0, n))


def sobel_h_rows_ext(xr: torch.Tensor) -> torch.Tensor:
    """Row diff, then column smooth, of a row-extended [N, H+2, W] block."""
    return _smooth3_ext(pad_axis(_diff3_ext(xr, 1), 2, 1, 1, "symmetric"), 2)


def sobel_h_ext(xp: torch.Tensor) -> torch.Tensor:
    """Row diff, then column smooth, of a [N, H+2, W+2] block."""
    return _smooth3_ext(_diff3_ext(xp, 1), 2)


def sobel_v_ext(xp: torch.Tensor) -> torch.Tensor:
    """Column diff, then row smooth, of a [N, H+2, W+2] block."""
    return _smooth3_ext(_diff3_ext(xp, 2), 1)


def sobel_v_rows_ext(xr: torch.Tensor) -> torch.Tensor:
    """Column diff, then row smooth, of a row-extended [N, H+2, W] block."""
    return sobel_v_ext(pad_axis(xr, 2, 1, 1, "symmetric"))


def sobel_h(x: torch.Tensor) -> torch.Tensor:
    """Smoothed horizontal-edge Sobel, /4 (ref pipeline/metrics.py:62)."""
    return sobel_h_rows_ext(pad_axis(x, 1, 1, 1, "symmetric"))


def sobel_v(x: torch.Tensor) -> torch.Tensor:
    return sobel_v_rows_ext(pad_axis(x, 1, 1, 1, "symmetric"))


def gradient_magnitude(x: torch.Tensor) -> torch.Tensor:
    return torch.hypot(sobel_h(x), sobel_v(x))


def _box_rows(xr: torch.Tensor, size: int) -> torch.Tensor:
    """Sums of ``size`` rows, ×1/size, of a row-extended block."""
    h = xr.shape[1] - (size - 1)
    acc = xr[:, 0:h, :]
    for i in range(1, size):
        acc = acc + xr[:, i:i + h, :]
    return acc * (1.0 / size)


def _box_cols(xp: torch.Tensor, size: int) -> torch.Tensor:
    """Sums of ``size`` columns, ×1/size, of a column-extended block."""
    w = xp.shape[2] - (size - 1)
    out = xp[:, :, 0:w]
    for i in range(1, size):
        out = out + xp[:, :, i:i + w]
    return out * (1.0 / size)


def box_rows_ext(xr: torch.Tensor, size: int) -> torch.Tensor:
    """size×size mean of a block whose rows are extended by ``size//2``
    above and the rest below → [N, H, W]: row sums, ×1/size, column sums
    on a symmetric column pad, ×1/size — the order of
    ``mdx.ops.filters.box_filter``."""
    lo = size // 2
    return _box_cols(pad_axis(_box_rows(xr, size), 2, lo, size - lo - 1,
                              "symmetric"), size)


def box_ext(xp: torch.Tensor, size: int) -> torch.Tensor:
    """size×size mean of a block extended on both axes by ``size//2``
    before and the rest after → [N, H, W], in :func:`box_rows_ext`'s order
    (``mdx.ops.filters.box_core``)."""
    return _box_cols(_box_rows(xp, size), size)


def box_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean filter, SciPy ``uniform_filter`` semantics (left-heavy window
    for even sizes, reflect boundary)."""
    lo = size // 2
    return box_rows_ext(pad_axis(x, 1, lo, size - lo - 1, "symmetric"), size)


def local_variance(x: torch.Tensor, size: int) -> torch.Tensor:
    """max(E[x²] − E[x]², 0) over a size×size window."""
    m = box_filter(x, size)
    m2 = box_filter(x * x, size)
    return torch.clamp_min(m2 - m * m, 0.0)


# Max unsharp radius is 3.0 (PARAM_BOUNDS) → kernel radius ≤ int(4·3+0.5)=12.
_GAUSS_MAX_RADIUS = 12


def _gauss_taps(sigma: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Fixed-support Gaussian taps for sigma (scalar or [N]) → [2r+1] or
    [N, 2r+1]; zero beyond ``int(4σ+0.5)``, normalised to sum 1."""
    r = _GAUSS_MAX_RADIUS
    sigma = torch.as_tensor(sigma, dtype=dtype)
    taps = torch.arange(-r, r + 1, dtype=dtype, device=sigma.device)
    if sigma.ndim == 1:
        taps = taps[None, :]
        sigma = sigma[:, None]
    radius_eff = torch.floor(4.0 * sigma + 0.5)
    w = torch.exp(-0.5 * torch.square(taps / torch.clamp_min(sigma, 1e-6)))
    w = torch.where(taps.abs() <= radius_eff, w, 0.0)
    return w / w.sum(dim=-1, keepdim=True)


def shift_macs_rows(xp: torch.Tensor, w: torch.Tensor, h: int) -> torch.Tensor:
    """Σₖ w[:,k]·xp[:,k:k+h,:] in tap-ascending order."""
    acc = None
    for k in range(w.shape[1]):
        t = w[:, k][:, None, None] * xp[:, k:k + h, :]
        acc = t if acc is None else acc + t
    return acc


def shift_macs_cols(xp: torch.Tensor, w: torch.Tensor, wd: int) -> torch.Tensor:
    """Σₖ w[:,k]·xp[:,:,k:k+wd] in tap-ascending order."""
    acc = None
    for k in range(w.shape[1]):
        t = w[:, k][:, None, None] * xp[:, :, k:k + wd]
        acc = t if acc is None else acc + t
    return acc


def as_n(v, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Scalar or [N] parameter → [N] tensor on ``x``'s device."""
    v = torch.as_tensor(v, dtype=dtype, device=x.device).reshape(-1)
    return v.expand(x.shape[0]).contiguous()


def gaussian_blur(x: torch.Tensor, sigma) -> torch.Tensor:
    """Separable Gaussian on a fixed ±12 support, edge boundary: along H
    first, then along W on the intermediate (skimage ``gaussian(
    mode='nearest', truncate=4)``; the shift-MAC branch of
    ``mdx.ops.filters.gaussian_blur``)."""
    r = _GAUSS_MAX_RADIUS
    _, h, wd = x.shape
    w = _gauss_taps(as_n(sigma, x, x.dtype), x.dtype)
    acc = shift_macs_rows(pad_axis(x, 1, r, r, "edge"), w, h)
    return shift_macs_cols(pad_axis(acc, 2, r, r, "edge"), w, wd)


def unsharp_mask_plain(x: torch.Tensor, radius, amount) -> torch.Tensor:
    """clip(x + (x − gaussian(x, radius))·amount, 0, 1) — the plain
    PyTorch version of the unsharp kernel."""
    amount = as_n(amount, x, x.dtype)[:, None, None]
    return torch.clamp(x + (x - gaussian_blur(x, radius)) * amount, 0.0, 1.0)


def unsharp_mask(x: torch.Tensor, radius, amount) -> torch.Tensor:
    """Unsharp mask with per-image (or scalar) ``radius`` and ``amount``
    (ref pipeline/enhancement.py:202).  CUDA tensor → the unsharp kernel;
    CPU tensor → :func:`unsharp_mask_plain`."""
    if kernels.use_kernel(x):
        return kernels.unsharp(x.contiguous(), as_n(radius, x),
                               as_n(amount, x))
    return unsharp_mask_plain(x, radius, amount)


def adjust_gamma(x: torch.Tensor, gamma) -> torch.Tensor:
    """Power-law on [0,1] (ref pipeline/enhancement.py:194); per-image ok."""
    gamma = torch.as_tensor(gamma, dtype=x.dtype, device=x.device)
    if gamma.ndim == 1:
        gamma = gamma[:, None, None]
    return torch.pow(torch.clamp_min(x, 0.0), gamma)
