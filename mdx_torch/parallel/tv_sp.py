"""Sharded TV-Chambolle over row blocks or a 2-D grid of tiles.

Counterpart of ``mdx/parallel/tv_sp.py`` (skimage
``denoise_tv_chambolle``, ref pipeline/enhancement.py:309-312): the dense
dual ascent, stop per image when |E_prev − E| < eps·E_0.  The energy sums
(Σd², Σ|∇out|) are float64 per block and added over the tile group, so
every rank of a data row sees the same energies and stops each image on the
same iteration.

On a CUDA tensor the solve is TPU kernel 12's port, temporally blocked as
the dense kernel T is (``csrc/tv.cu``): a launch (``kernels.tv_shard_step``)
runs m ≤ s iterations on the block from a halo of hw = m rows above and
below and hw columns left and right of the row-extended block, the slabs of
the neighbouring blocks' state (:func:`halo_slabs`: rows first, then the
columns of the row-extended block, which carry the corners, so nothing is
sent diagonally).  x's slabs are exchanged once a solve, the dual's once a
launch; the launch's per-iteration sums are added over the tile group (one
``psum`` a launch) and ``kernels.tv_shard_finalize`` walks them with the
stop rule.  The dual lives in a ping-pong pair of buffers with a slab set
each; an image that stops keeps its last launch's input dual in that
launch's buffer, and so do its neighbours (stops are decided on global
sums), so that buffer's slabs, exchanged again later or not, still hold its
neighbours' copy; ``kernels.tv_shard_rebuild`` rebuilds the output from it
after the loop.  The host reads the stop flags over ALL ranks, data rows
included, every ``_CHECK_EVERY`` iterations: every launch exchanges halos,
so a rank that left the loop early would leave its neighbours waiting
(``tv_sp.py:189-198``); launches for stopped images change nothing.

:func:`solve_steps` is that loop around a step, a finalize and a rebuild;
:func:`tv_shard_step_plain`, :func:`tv_shard_finalize_plain` and
:func:`tv_shard_rebuild_plain` are the kernels' plain versions, with which
the CPU tests run the same loop.  On a CPU tensor :func:`tv_sharded` runs
:func:`tv_sharded_plain`, the port of the JAX layer's XLA body.  Both
return (out, per-image iteration counts) and stop on the same iterations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mdx_torch import kernels
from mdx_torch.ops.filters import as_n
from mdx_torch.parallel import comm

_TAU = 0.25  # 1/(2·ndim), ndim = 2
# iterations between the kernel loop's reads of the stop flags over all
# ranks: a multiple of the kernel's iterations a launch
_CHECK_EVERY = 8
_NAN = float("nan")
# the schedule of the last solve_steps call on this rank: iterations a
# launch, step launches, host reads of the stop flags
LAST_SOLVE: dict[str, int] = {}


def halo_slabs(v: torch.Tensor, hw: int, mesh):
    """The ``hw``-wide halo slabs of v [N, C, h, w] from the neighbouring
    blocks → (up, dn, lf, rt): the previous row block's last ``hw`` rows and
    the next one's first (up, dn [N, C, hw, w]), then on a 2-D grid the
    left tile's last ``hw`` columns and the right tile's first of the
    row-extended block (lf, rt [N, C, h + 2hw, hw], the corners included);
    None at the image's edge."""
    n, c, h, w = v.shape
    flat = v.reshape(n * c, h, w)
    up, dn = comm.exchange_rows(flat[:, h - hw:], flat[:, :hw], mesh)
    lf = rt = None
    if mesh.n_sx > 1:
        zero = flat.new_zeros((n * c, hw, w))
        rows = [zero if up is None else up, flat, zero if dn is None else dn]
        lf, rt = comm.exchange_cols(
            torch.cat([r[:, :, w - hw:] for r in rows], dim=1),
            torch.cat([r[:, :, :hw] for r in rows], dim=1), mesh)
    return tuple(None if t is None else t.reshape(n, c, *t.shape[1:])
                 for t in (up, dn, lf, rt))


class _Extended:
    """The halo-extended block of a launch, [h + 2hw, w + 2hw] around the
    block at (row0, col0) of a gh × gw image: which cells lie in the image,
    where the differences are 0 (the image's last row and column), and
    where the state is still exact after k iterations (p: from the block's
    own values and the slabs, one cell less on each side an iteration)."""

    def __init__(self, h: int, w: int, geo, device):
        gh, gw, row0, col0, hw = (int(v) for v in geo)
        self.h, self.w, self.hw = h, w, hw
        ri = torch.arange(-hw, h + hw, device=device) + row0
        cj = torch.arange(-hw, w + hw, device=device) + col0
        self.inimg = (((ri >= 0) & (ri < gh))[:, None]
                      & ((cj >= 0) & (cj < gw))[None, :])
        self.gy_ok = (ri < gh - 1)[:, None]
        self.gx_ok = (cj < gw - 1)[None, :]
        rr = torch.arange(h + 2 * hw, device=device)[:, None]
        cc = torch.arange(w + 2 * hw, device=device)[None, :]
        he, we = h + 2 * hw, w + 2 * hw
        # out exact after k iterations where p, p above and p left are; the
        # dual after iteration k where out, out below and out right are
        self.out_ok = lambda k: ((rr > k) & (rr < he - k)
                                 & (cc > k) & (cc < we - k))
        self.p_ok = lambda k: ((rr > k) & (rr < he - k - 1)
                               & (cc > k) & (cc < we - k - 1))

    def extend(self, v: torch.Tensor, slabs) -> torch.Tensor:
        """[N, C, h, w] and its slabs (None members: zeros) → [N, C, h+2hw,
        w+2hw], zeros outside the image."""
        n, c, h, w = v.shape
        hw = self.hw
        up, dn, lf, rt = (None,) * 4 if slabs is None else slabs
        zr = v.new_zeros((n, c, hw, w))
        mid = torch.cat([zr if up is None else up, v,
                         zr if dn is None else dn], dim=2)
        zc = v.new_zeros((n, c, h + 2 * hw, hw))
        full = torch.cat([zc if lf is None else lf, mid,
                          zc if rt is None else rt], dim=3)
        return torch.where(self.inimg, full, 0.0)

    def block(self, v: torch.Tensor) -> torch.Tensor:
        """The block's own cells of [..., h+2hw, w+2hw], contiguous."""
        hw = self.hw
        return v[..., hw:hw + self.h, hw:hw + self.w].contiguous()


def _div(p0, p1):
    """d = −(p0 + p1) + (p0 above) + (p1 left), zeros past the array."""
    d = -(p0 + p1)
    d = d + F.pad(p0[:, :-1, :], (0, 0, 1, 0))
    d = d + F.pad(p1[:, :, :-1], (1, 0, 0, 0))
    return d


def _step(ext: _Extended, xe, p0, p1, wgt, k):
    """Iteration k of a launch on the extended block (the plain version's
    expressions in its order) → (p0, p1, d, norm).  Cells that are no
    longer exact are NaN, so a result that read one shows it; the cells
    outside the image keep their zeros."""
    d = torch.where(ext.out_ok(k), _div(p0, p1), _NAN)
    o = xe + d
    gy = F.pad(o[:, 1:] - o[:, :-1], (0, 0, 0, 1), value=_NAN)
    gx = F.pad(o[:, :, 1:] - o[:, :, :-1], (0, 1, 0, 0), value=_NAN)
    gy = torch.where(ext.gy_ok, gy, 0.0)
    gx = torch.where(ext.gx_ok, gx, 0.0)
    norm = torch.sqrt(gy * gy + gx * gx)
    scale = norm * _TAU / wgt + 1.0
    upd = ext.p_ok(k) & ext.inimg
    keep = torch.where(ext.inimg, _NAN, p0)     # zeros outside the image
    p0 = torch.where(upd, (p0 - _TAU * gy) / scale, keep)
    p1 = torch.where(upd, (p1 - _TAU * gx) / scale,
                     torch.where(ext.inimg, _NAN, p1))
    return p0, p1, d, norm


def _check_launch(m: int, hw: int) -> None:
    if not 1 <= m <= hw:
        raise ValueError(f"tv shard step: {m} iterations need a halo of at "
                         f"least {m} (and one iteration at least), got {hw}")


def tv_shard_step_plain(x, p_in, p_out, active, weight, x_slabs, p_slabs,
                        geo, m) -> torch.Tensor:
    """The plain PyTorch version of one launch of kernel 12, with the
    arguments of ``kernels.tv_shard_step``: ``m`` iterations on the
    halo-extended block x [N, h, w] from ``p_in`` [N, 2, h, w] (None:
    p = 0) and the slabs, ``geo`` = (image height, width, the block's
    first row, first column, halo width hw ≥ m).  Writes the active
    images' dual into ``p_out``; returns the block's (Σd², Σ|∇out|) of each
    iteration [N, m, 2] float64, zeros for stopped images.  The sums run
    over the block's cells in the order of :func:`tv_sharded_plain`'s."""
    n, h, w = x.shape
    m = int(m)
    _check_launch(m, int(geo[4]))
    ext = _Extended(h, w, geo, x.device)
    xe = ext.extend(x[:, None], x_slabs)[:, 0]
    if p_in is None:
        p0 = p1 = torch.zeros_like(xe)
    else:
        pe = ext.extend(p_in, p_slabs)
        p0, p1 = pe[:, 0], pe[:, 1]
    wgt = weight[:, None, None]
    sums = []
    for k in range(m):
        p0, p1, d, norm = _step(ext, xe, p0, p1, wgt, k)
        sums.append(torch.stack([
            ext.block(d * d).sum(dim=(1, 2), dtype=torch.float64),
            ext.block(norm).sum(dim=(1, 2), dtype=torch.float64)], dim=1))
    a = active.bool()
    p_out[a] = torch.stack([ext.block(p0), ext.block(p1)], dim=1)[a]
    return torch.where(a[:, None, None], torch.stack(sums, dim=1), 0.0)


def tv_shard_finalize_plain(sums, weight, e0, e_prev, active, iters, base,
                            a, eps, size) -> None:
    """The stop rule over one launch (in place, as
    ``kernels.tv_shard_finalize``): for each of the m global sums [N, m, 2]
    in order, E = (Σd² + w·Σ|∇out|) / size rounded to float32; iteration 0
    sets E_0; later ones count the iteration and stop an image when
    |E_prev − E| < eps·E_0.  Every image active at the start gets
    ``base = a``."""
    still = active.bool()
    base.copy_(torch.where(still, int(a), base))
    for k in range(sums.shape[1]):
        e = (sums[:, k, 0].to(torch.float32)
             + weight * sums[:, k, 1].to(torch.float32)) / size
        if a + k == 0:
            e0.copy_(torch.where(still, e, e0))
            e_prev.copy_(torch.where(still, e, e_prev))
            iters.copy_(torch.where(still, 1, iters))
            continue
        iters.add_(still.to(iters.dtype))
        keep = (e_prev - e).abs() >= eps * e0
        e_prev.copy_(torch.where(still & keep, e, e_prev))
        still = still & keep
    active.copy_(still.to(active.dtype))


def tv_shard_rebuild_plain(x, p_even, p_odd, iters, base, weight, x_slabs,
                           slabs_even, slabs_odd, geo, ms) -> torch.Tensor:
    """The plain PyTorch version of kernel 12's rebuild, with the arguments
    of ``kernels.tv_shard_rebuild``: per image, p_a from ``p_even`` and its
    slabs (a / ``ms`` even) or ``p_odd`` (odd), zeros at a = 0, then
    t − 1 − a iterations and out = x + div p on the block."""
    n, h, w = x.shape
    ms = int(ms)
    _check_launch(ms, int(geo[4]))
    ext = _Extended(h, w, geo, x.device)
    a = base.long()
    r = iters.long() - 1 - a
    xe = ext.extend(x[:, None], x_slabs)[:, 0]
    odd = ((a // ms) % 2 == 1)[:, None, None, None]
    pe = torch.where(odd, ext.extend(p_odd, slabs_odd),
                     ext.extend(p_even, slabs_even))
    pe = torch.where((a == 0)[:, None, None, None], 0.0, pe)
    p0, p1 = pe[:, 0], pe[:, 1]
    wgt = weight[:, None, None]
    for k in range(int(r.max()) if n else 0):
        q0, q1, _, _ = _step(ext, xe, p0, p1, wgt, k)
        run = (k < r)[:, None, None]
        p0, p1 = torch.where(run, q0, p0), torch.where(run, q1, p1)
    return ext.block(xe + _div(p0, p1))


def solve_steps(x, weight, mesh, eps, max_iter, step, finalize, rebuild,
                steps: int):
    """The sharded Chambolle loop that the kernel path runs, around a
    ``step``, a ``finalize`` and a ``rebuild`` function (the kernels, or on
    the CPU, for the tests, their plain versions) with up to ``steps``
    iterations a launch → (out, iterations)."""
    n, hs, w = x.shape
    m_full = min(int(steps), hs, w)
    if m_full < 1:
        raise ValueError(f"tv shard solve: a block of {hs}x{w} runs no "
                         f"iteration a launch (steps {steps})")
    x = x.contiguous()
    weight = as_n(weight, x)
    dev = x.device
    gh, gw = hs * mesh.n_sy, w * mesh.n_sx
    geo = (gh, gw, mesh.row_index * hs, mesh.col_index * w, m_full)
    size = float(gh * gw)
    x_slabs = halo_slabs(x[:, None], m_full, mesh)
    # NaN until written: a read of a dual no launch wrote shows in the result
    bufs = (torch.full((n, 2, hs, w), _NAN, device=dev),
            torch.full((n, 2, hs, w), _NAN, device=dev))
    slabs = [None, None]
    e0 = torch.zeros(n, dtype=torch.float32, device=dev)
    e_prev = torch.zeros_like(e0)
    active = torch.ones(n, dtype=torch.int32, device=dev)
    iters = torch.zeros(n, dtype=torch.int32, device=dev)
    base = torch.zeros(n, dtype=torch.int32, device=dev)
    max_iter = max(int(max_iter), 1)
    a = launches = reads = 0
    next_read = _CHECK_EVERY
    while a < max_iter:
        if a >= next_read:
            reads += 1
            next_read = a + _CHECK_EVERY
            if not comm.any_all(active, mesh):
                break
        m = min(m_full, max_iter - a)
        cur = launches % 2
        p_in = bufs[cur] if a else None
        if a:
            slabs[cur] = halo_slabs(p_in, m_full, mesh)
        sums = step(x, p_in, bufs[1 - cur], active, weight, x_slabs,
                    slabs[cur] if a else None, geo, m)
        finalize(comm.psum(sums, mesh), weight, e0, e_prev, active, iters,
                 base, a, float(eps), size)
        a += m
        launches += 1
    out = rebuild(x, bufs[0], bufs[1], iters, base, weight, x_slabs,
                  slabs[0], slabs[1], geo, m_full)
    LAST_SOLVE.update(steps=m_full, launches=launches, host_reads=reads)
    return out, iters


def tv_sharded_kernel(x: torch.Tensor, weight, mesh, eps: float = 2e-4,
                      max_iter: int = 200):
    """The sharded solve through kernel 12 (CUDA tensors)."""
    return solve_steps(x, weight, mesh, eps, max_iter, kernels.tv_shard_step,
                       kernels.tv_shard_finalize, kernels.tv_shard_rebuild,
                       kernels.tv_steps())


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
