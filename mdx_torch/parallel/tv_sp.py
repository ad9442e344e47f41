"""Sharded TV-Chambolle over row blocks or a 2-D grid of tiles.

Counterpart of ``mdx/parallel/tv_sp.py`` (skimage
``denoise_tv_chambolle``, ref pipeline/enhancement.py:309-312): the dense
dual ascent, stop per image when |E_prev − E| < eps·E_0.  Per iteration a
block needs one row of its neighbours' state: the previous block's last p0
row (the divergence at row 0) and the next block's first x, p0 and p1 rows
(the forward difference at the last row); the rank that holds the global
bottom row has a zero difference there (``glast``).  On a 2-D grid it also
needs one column: the left tile's last p1 column (the divergence at column
0) and the right tile's first x, p0 and p1 columns (the forward difference
at the last column; ``grlast`` at the global right edge).  The columns are
exchanged after the rows and are columns of the row-extended state, so
they carry the two corners the step reads: the up-right tile's p0 (the
right neighbour's divergence at its row 0) and the down-left tile's p1 (the
next row's divergence at column 0).  The energy sums (Σd², Σ|∇out|) are
float64 per block and added over the tile group, so every rank of a data
row sees the same energies and stops each image on the same iteration.

The loop's stop flag is reduced over ALL ranks, data rows included: every
iteration exchanges halos, so a rank that left the loop early would leave
its neighbours waiting (``tv_sp.py:189-198``).  Stopped images are no-ops,
so extra iterations change no output and no iteration count.

On a CUDA tensor each iteration is TPU kernel 12's port,
``kernels.tv_shard_step`` (``csrc/tv.cu``), whose partials this module sums
over ``space`` before ``kernels.tv_shard_finalize`` applies the stop rule;
the host reads the flags (a collective over all ranks) every
``_CHECK_EVERY`` iterations.  On a CPU tensor
:func:`tv_sharded_plain` runs, the port of the JAX layer's 1-D XLA body.
Both return (out, per-image iteration counts) and stop on the same
iterations.
"""

from __future__ import annotations

import torch

from mdx_torch import kernels
from mdx_torch.ops.filters import as_n
from mdx_torch.parallel import comm

_TAU = 0.25  # 1/(2·ndim), ndim = 2
# iterations between the kernel loop's reads of the stop flags over all ranks
_CHECK_EVERY = 8


def tv_shard_step_plain(x, p_in, p_out, out, active, weight, up_p0, dn_x,
                        dn_p0, dn_p1, glast: bool, lf_p1=None, rt_x=None,
                        rt_p0=None, rt_p1=None,
                        grlast: bool = True) -> torch.Tensor:
    """The plain PyTorch version of kernel 12: one Chambolle iteration on a
    block, with the same arguments as ``kernels.tv_shard_step``.

    ``p_in``/``p_out`` [N, 2, Hs, Ws], ``out`` [N, Hs, Ws]: the active
    images' new dual and image are written into ``p_out`` and ``out``;
    stopped images keep what those buffers held.  ``up_p0`` (the previous
    block's last p0 row), ``dn_x``/``dn_p0``/``dn_p1`` (the next block's
    first rows) are [N, Ws] or None for zeros; ``glast``: this block holds
    the global bottom row.  The column halos of a 2-D tile, None for zeros:
    ``lf_p1`` [N, Hs+1], the left tile's last p1 column for rows 0 … Hs
    (row Hs: the tile below it); ``rt_x``/``rt_p1`` [N, Hs] and ``rt_p0``
    [N, Hs+1], the right tile's first columns (``rt_p0`` for rows −1 … Hs−1:
    row −1 from the tile above it); ``grlast``: this block holds the global
    right column (a dense or row-block call passes no column halos and
    True).  Returns the block's (Σd², Σ|∇out|) [N, 2] float64, zeros for
    stopped images."""
    n, hs, w = x.shape
    p0, p1 = p_in[:, 0], p_in[:, 1]
    zrow = x.new_zeros((n, 1, w))
    zcol = x.new_zeros((n, hs, 1))

    def row(v):
        return zrow if v is None else v[:, None, :]

    def col(v, rows=hs):
        return x.new_zeros((n, rows, 1)) if v is None else v[:, :, None]

    lf = col(lf_p1, hs + 1)
    d = -(p0 + p1)
    d = d + torch.cat([row(up_p0), p0[:, :-1]], dim=1)
    d = d + torch.cat([lf[:, :hs], p1[:, :, :-1]], dim=2)
    o = x + d
    if glast:
        gy = torch.cat([o[:, 1:] - o[:, :-1], zrow], dim=1)
    else:
        # the next block's first row of out, from its x, p0 and p1 rows
        dn1 = row(dn_p1)
        ddn = -(row(dn_p0) + dn1)
        ddn = ddn + p0[:, -1:]
        ddn = ddn + torch.cat([lf[:, hs:], dn1[:, :, :-1]], dim=2)
        gy = torch.cat([o[:, 1:], row(dn_x) + ddn], dim=1) - o
    if grlast:
        gx = torch.cat([o[:, :, 1:] - o[:, :, :-1], zcol], dim=2)
    else:
        # the right tile's first column of out, from its x, p0 and p1
        r0 = col(rt_p0, hs + 1)
        drt = -(r0[:, 1:] + col(rt_p1))
        drt = drt + r0[:, :-1]
        drt = drt + p1[:, :, -1:]
        gx = torch.cat([o[:, :, 1:], col(rt_x) + drt], dim=2) - o
    norm = torch.sqrt(gy * gy + gx * gx)
    scale = norm * _TAU / weight[:, None, None] + 1.0
    a = active.bool()
    p_out[a] = torch.stack([(p0 - _TAU * gy) / scale,
                            (p1 - _TAU * gx) / scale], dim=1)[a]
    out[a] = o[a]
    sums = torch.stack([(d * d).sum(dim=(1, 2), dtype=torch.float64),
                        norm.sum(dim=(1, 2), dtype=torch.float64)], dim=1)
    return torch.where(a[:, None], sums, 0.0)


def tv_shard_finalize_plain(sums, weight, e0, e_prev, active, iters,
                            first: bool, eps: float, size: float) -> None:
    """The stop rule on the global sums [N, 2] (in place, as
    ``kernels.tv_shard_finalize``): E = (Σd² + w·Σ|∇out|) / size rounded to
    float32; the first call sets E_0; later calls count the iteration and
    stop an image when |E_prev − E| < eps·E_0."""
    a = active.bool()
    e = (sums[:, 0].to(torch.float32)
         + weight * sums[:, 1].to(torch.float32)) / size
    if first:
        e0.copy_(torch.where(a, e, e0))
        e_prev.copy_(torch.where(a, e, e_prev))
        iters.copy_(torch.where(a, 1, iters))
        return
    iters.add_(a.to(iters.dtype))
    still = (e_prev - e).abs() >= eps * e0
    e_prev.copy_(torch.where(a & still, e, e_prev))
    active.copy_((a & still).to(active.dtype))


def solve_steps(x, weight, mesh, eps, max_iter, step, finalize):
    """The sharded Chambolle loop that the kernel path runs, around a
    ``step`` and a ``finalize`` function: the kernels, or (on the CPU, for
    the tests) their plain versions → (out, iterations)."""
    n, hs, w = x.shape
    x = x.contiguous()
    weight = as_n(weight, x)
    dev = x.device
    size = float(hs * mesh.n_space * w)      # the global H·W
    two_d = mesh.n_sx > 1

    def flat(v, length):
        return None if v is None else v.reshape(n, length).contiguous()

    dn_x = flat(comm.rows_from_next(x, 1, mesh), w)
    rt_x = flat(comm.cols_from_next(x, 1, mesh), hs) if two_d else None
    p_cur = torch.zeros((n, 2, hs, w), dtype=torch.float32, device=dev)
    p_next = torch.empty_like(p_cur)
    out = torch.empty_like(x)
    e0 = torch.empty(n, dtype=torch.float32, device=dev)
    e_prev = torch.empty_like(e0)
    active = torch.ones(n, dtype=torch.int32, device=dev)
    iters = torch.zeros(n, dtype=torch.int32, device=dev)
    # p = 0 at iteration 0
    up = dn_p0 = dn_p1 = lf_p1 = rt_p0 = rt_p1 = None
    for i in range(max(int(max_iter), 1)):
        if (i and i % _CHECK_EVERY == 0
                and not comm.any_all(active, mesh)):
            break
        if i:
            from_prev, from_next = comm.exchange_rows(
                p_cur[:, 0, -1:], p_cur[:, :, :1], mesh)
            up = flat(from_prev, w)
            if from_next is not None:
                dn_p0 = flat(from_next[:, 0], w)
                dn_p1 = flat(from_next[:, 1], w)
        if i and two_d:
            # the columns of the row-extended dual, corners included: to the
            # right p1's last column and the row below's; to the left p0's
            # first column under the row above's, and p1's first column
            zero = x.new_zeros((n, 1))
            to_right = torch.cat([p_cur[:, 1, :, -1],
                                  zero if dn_p1 is None else dn_p1[:, -1:]],
                                 dim=1)
            to_left = torch.stack([
                torch.cat([zero if up is None else up[:, :1],
                           p_cur[:, 0, :, 0]], dim=1),
                torch.cat([p_cur[:, 1, :, 0], zero], dim=1)], dim=1)
            from_left, from_right = comm.exchange_cols(to_right, to_left,
                                                       mesh)
            lf_p1 = flat(from_left, hs + 1)
            if from_right is not None:
                rt_p0 = flat(from_right[:, 0], hs + 1)
                rt_p1 = flat(from_right[:, 1, :hs], hs)
        sums = step(x, p_cur, p_next, out, active, weight, up, dn_x, dn_p0,
                    dn_p1, mesh.is_last, lf_p1, rt_x, rt_p0, rt_p1,
                    mesh.is_last_col)
        finalize(comm.psum(sums, mesh), weight, e0, e_prev, active, iters,
                 i == 0, float(eps), size)
        p_cur, p_next = p_next, p_cur
    return out, iters


def tv_sharded_kernel(x: torch.Tensor, weight, mesh, eps: float = 2e-4,
                      max_iter: int = 200):
    """The sharded solve through kernel 12 (CUDA tensors)."""
    return solve_steps(x, weight, mesh, eps, max_iter,
                       kernels.tv_shard_step, kernels.tv_shard_finalize)


def tv_sharded_plain(x: torch.Tensor, weight, mesh, eps: float = 2e-4,
                     max_iter: int = 200):
    """The plain PyTorch version of the sharded solve: the JAX layer's XLA
    body (``tv_sp.py:223-301``, with ``col_axis`` on a 2-D grid) with the
    energies summed in float64, as ``mdx_torch.ops.tv.tv_chambolle_plain``
    sums them → (out, iterations).  Reads the stop flag every iteration."""
    n, hs, w = x.shape
    weight = as_n(weight, x, x.dtype)
    wcol = weight[:, None, None]
    size = float(hs * mesh.n_space * w)
    zrow = x.new_zeros((n, 1, w))
    zcol = x.new_zeros((n, hs, 1))
    two_d = mesh.n_sx > 1

    def shift_from_prev(v, axis=1):
        """Element i along ``axis`` gets global element i−1 of v (zeros
        before the image)."""
        prev = (comm.rows_from_prev if axis == 1
                else comm.cols_from_prev)(v, 1, mesh)
        if prev is None:
            prev = zrow if axis == 1 else zcol
        return torch.cat([prev, v.narrow(axis, 0, v.shape[axis] - 1)],
                         dim=axis)

    def diff_with_next(v, axis=1):
        """Global v[i+1] − v[i] along ``axis``, zero at the global end."""
        size_ax = v.shape[axis]
        nxt = (comm.rows_from_next if axis == 1
               else comm.cols_from_next)(v, 1, mesh)
        nxt = v.narrow(axis, size_ax - 1, 1) if nxt is None else nxt
        return torch.cat([v, nxt], dim=axis).narrow(axis, 1, size_ax) - v

    def energy_and_out(p0, p1, first):
        if first:
            d = torch.zeros_like(x)
            o = x
        else:
            d = -(p0 + p1)
            d = d + shift_from_prev(p0)
            d = d + (shift_from_prev(p1, 2) if two_d
                     else torch.cat([zcol, p1[:, :, :-1]], dim=2))
            o = x + d
        gy = diff_with_next(o)
        gx = (diff_with_next(o, 2) if two_d
              else torch.cat([o[:, :, 1:] - o[:, :, :-1], zcol], dim=2))
        norm = torch.sqrt(gy * gy + gx * gx)
        sums = comm.psum(torch.stack(
            [(d * d).sum(dim=(1, 2), dtype=torch.float64),
             norm.sum(dim=(1, 2), dtype=torch.float64)], dim=1), mesh)
        e = (sums[:, 0].to(x.dtype) + weight * sums[:, 1].to(x.dtype)) / size
        return o, gy, gx, norm, e

    def update_p(p0, p1, gy, gx, norm, active):
        scale = norm * _TAU / wcol + 1.0
        a = active[:, None, None]
        return (torch.where(a, (p0 - _TAU * gy) / scale, p0),
                torch.where(a, (p1 - _TAU * gx) / scale, p1))

    active = torch.ones(n, dtype=torch.bool, device=x.device)
    zero = torch.zeros_like(x)
    out, gy, gx, norm, e0 = energy_and_out(zero, zero, first=True)
    p0, p1 = update_p(zero, zero, gy, gx, norm, active)
    e_prev = e0
    iters = torch.ones(n, dtype=torch.int32, device=x.device)
    i = 1
    while i < max_iter and comm.any_all(active, mesh):
        new_out, gy, gx, norm, e = energy_and_out(p0, p1, first=False)
        out = torch.where(active[:, None, None], new_out, out)
        p0, p1 = update_p(p0, p1, gy, gx, norm, active)
        iters = iters + active.to(torch.int32)
        still = (e_prev - e).abs() >= eps * e0
        active = active & still
        e_prev = torch.where(active, e, e_prev)
        i += 1
    return out, iters


def tv_sharded(x: torch.Tensor, weight, mesh, eps: float = 2e-4,
               max_iter: int = 200):
    """TV denoise of the global images from this rank's [N, Hs, Ws] block
    with a per-image (or scalar) weight → (out block, iterations [N]):
    kernel 12 on a CUDA tensor, :func:`tv_sharded_plain` on a CPU one."""
    if kernels.use_kernel(x):
        return tv_sharded_kernel(x, weight, mesh, eps, max_iter)
    return tv_sharded_plain(x, weight, mesh, eps, max_iter)
