"""The schedule of the CLAHE kernel (kernel C, ``csrc/clahe.cu``), modelled in
PyTorch on the CPU and held to the plain version and to the JAX package.

The CUDA kernel runs only on the card.  This file holds its design before
the card does:

* the LUT stage, a warp per tile: the tile's histogram (integer counts, in
  any order), each lane's 8 consecutive bins, the excess as the lanes'
  8-bin sums added by a shuffle butterfly, the CDF as each lane's serial
  run over its bins plus the exclusive scan of the lane totals (the 5
  ``__shfl_up_sync`` steps), the scaled LUT;
* the remap's cells: a block of K = 64/t cells across (1 <= K <= 14)
  walking 4 cell rows between tile centres, each cell row's pixel
  rectangle from integer bounds, its LUT rows in a ring of three
  shared-memory slots (the model checks that the rows a cell row reads are
  in their slots and that a fetch never overwrites them); every pixel must
  fall in exactly one cell row of one block and find its four clamped LUT
  indices among its block's (so the kernel's device-memory path for a
  pixel outside its cell is never taken here), then the plain version's
  blend.

The model's LUTs are held to ``clahe_luts_plain`` and its output to
``clahe_plain`` and to JAX's ``mdx.ops.clahe.clahe`` (the XLA branch on the
CPU) within ``parity.KERNEL_TOL["clahe"]`` (0, 2e-5): the float32 sums of
the excess and the CDF run in another order than ``torch.sum`` and
``torch.cumsum``.  Inputs: adversarial tiles (every pixel in one bin, half
the image clipped, flat), t = 8, 16, 32 and 12, extents that are not
multiples of t, a single-tile image.  The card tests
(tests/test_torch_cuda.py) hold the kernel itself to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdx.ops.clahe import clahe as j_clahe

from mdx_torch import parity
from mdx_torch.ops import clahe as TC
from mdx_torch.ops.filters import pad_axis

torch.set_num_threads(1)

NBINS = 256
ATOL = parity.KERNEL_TOL["clahe"][1]
LANES = torch.arange(32)


WALK = 4             # cell rows a remap block walks


def cells_per_block(t):
    """``cells_per_block`` of csrc/clahe.cu."""
    return min(max(64 // t, 1), 14)


def lut_stage(x, clip, t):
    """The LUT stage's order on every tile at once → [N, gy, gx, 256]."""
    n, h, w = x.shape
    pad_h, pad_w = (-h) % t, (-w) % t
    xp = torch.clamp(x, 0.0, 1.0)
    if pad_h or pad_w:
        xp = pad_axis(pad_axis(xp, 1, 0, pad_h, "reflect"), 2, 0, pad_w,
                      "reflect")
    gy, gx = xp.shape[1] // t, xp.shape[2] // t
    q = torch.clamp_max((xp * NBINS).to(torch.int64), NBINS - 1)
    tiles = q.reshape(n, gy, t, gx, t).permute(0, 1, 3, 2, 4).reshape(
        n, gy, gx, t * t)
    hist = torch.zeros(n, gy, gx, NBINS, dtype=torch.int64)
    hist.scatter_add_(3, tiles, torch.ones_like(tiles))
    hb = hist.to(torch.float32).reshape(n, gy, gx, 32, 8)   # lane's bins
    clim = torch.clamp_min(torch.as_tensor(clip, dtype=torch.float32)
                           * float(t * t), 1.0)[:, None, None, None]
    excess = torch.zeros(n, gy, gx, 32)
    for j in range(8):
        excess = excess + torch.clamp_min(hb[..., j] - clim, 0.0)
    for o in (16, 8, 4, 2, 1):
        excess = excess + excess.index_select(3, LANES ^ o)
    assert torch.equal(excess, excess[..., :1].expand_as(excess))
    redist = excess / float(NBINS)
    run = torch.zeros(n, gy, gx, 32)
    cdf = []
    for j in range(8):
        run = run + (torch.minimum(hb[..., j], clim) + redist)
        cdf.append(run)
    incl = run
    for o in (1, 2, 4, 8, 16):
        up = incl.index_select(3, (LANES - o).clamp_min(0))
        incl = torch.where(LANES >= o, up + incl, incl)
    before = torch.where(LANES >= 1, incl.index_select(
        3, (LANES - 1).clamp_min(0)), torch.zeros(()))
    cdf = torch.stack([before + c for c in cdf], dim=-1)      # [.., 32, 8]
    cdf0 = cdf[..., 0, 0][..., None, None]
    denom = torch.clamp_min(cdf[..., 31, 7][..., None, None] - cdf0, 1e-12)
    return ((cdf - cdf0) / denom).reshape(n, gy, gx, NBINS)


def remap(x, lut, t):
    """The remap by blocks: K cells across, WALK cell rows down, the LUT rows
    in a ring of three slots (row r in slot r % 3), the next row fetched
    while a cell row computes → (out, cell rows run, pixels gathered
    outside their block's LUTs)."""
    n, h, w = x.shape
    gy, gx = lut.shape[1], lut.shape[2]
    k = cells_per_block(t)
    tf = torch.tensor(float(t))
    out = torch.full_like(x, float("nan"))
    covered = torch.zeros(h, w, dtype=torch.int64)
    outside, runs = 0, 0
    v = torch.clamp(x, 0.0, 1.0)
    q = torch.clamp_max((v * NBINS).to(torch.int32), NBINS - 1).long()
    clamp = lambda i, n: min(max(i, 0), n - 1)  # noqa: E731
    for by in range(-(-(gy + 1) // WALK)):
        cy_lo = by * WALK - 1
        cy_hi = min(cy_lo + WALK, gy)
        for bx in range(-(-(gx + 1) // k)):
            cx0 = bx * k - 1
            c_lo = max(0, cx0 * t + t // 2)
            c_hi = min(w, (cx0 + k) * t + t // 2)
            if c_lo >= c_hi:
                continue
            lx0 = clamp(cx0, gx)
            lx1 = min(clamp(cx0 + k - 1, gx) + 1, gx - 1)
            first = clamp(cy_lo, gy)
            last = min(clamp(cy_hi - 1, gy) + 1, gy - 1)
            have = min(first + 1, last)
            ring = {row % 3: row for row in range(first, have + 1)}
            for cy in range(cy_lo, cy_hi):
                ly0 = clamp(cy, gy)
                ly1 = min(ly0 + 1, gy - 1)
                assert ring[ly0 % 3] == ly0 and ring[ly1 % 3] == ly1
                fetch = have == ly1 and have < last and cy + 1 < cy_hi
                assert not fetch or (have + 1) % 3 not in (ly0 % 3, ly1 % 3)
                r_lo = max(0, cy * t + t // 2)
                r_hi = min(h, (cy + 1) * t + t // 2)
                if r_lo < r_hi:
                    runs += 1
                    outside += _cell_row(q, lut, out, covered, tf,
                                         (r_lo, r_hi, c_lo, c_hi),
                                         (ly0, ly1, lx0, lx1))
                if fetch:
                    have += 1
                    ring[have % 3] = have
    assert torch.equal(covered, torch.ones_like(covered)), "cells"
    return out, runs, outside


def _cell_row(q, lut, out, covered, tf, rect, luts):
    """One cell row of a block: its pixels' blend from the LUT rows ly0,
    ly1 over columns lx0 .. lx1 (the ring's slots) → pixels whose clamped
    indices fall outside them."""
    r_lo, r_hi, c_lo, c_hi = rect
    ly0, ly1, lx0, lx1 = luts
    gy, gx = lut.shape[1], lut.shape[2]
    shared = lut[:, [ly0, ly1], lx0:lx1 + 1]
    covered[r_lo:r_hi, c_lo:c_hi] += 1
    i = torch.arange(r_lo, r_hi, dtype=torch.float32)
    j = torch.arange(c_lo, c_hi, dtype=torch.float32)
    fy = (i + 0.5) / tf - 0.5
    fx = (j + 0.5) / tf - 0.5
    y0 = torch.floor(fy).long().clamp(0, gy - 1)
    x0 = torch.floor(fx).long().clamp(0, gx - 1)
    x1 = (x0 + 1).clamp_max(gx - 1)
    wy = torch.clamp(fy - y0.float(), 0.0, 1.0)[None, :, None]
    wx = torch.clamp(fx - x0.float(), 0.0, 1.0)[None, None, :]
    ins = ((y0 == ly0)[:, None] & (x0 >= lx0)[None, :]
           & (x1 <= lx1)[None, :])
    qb = q[:, r_lo:r_hi, c_lo:c_hi]

    def take(row, xi):
        tile = shared[:, row][:, (xi - lx0).clamp(0, lx1 - lx0)]
        tile = tile[:, None].expand(-1, qb.shape[1], -1, -1)
        return torch.gather(tile, 3, qb[..., None])[..., 0]

    v00, v01 = take(0, x0), take(0, x1)
    v10, v11 = take(1, x0), take(1, x1)
    owx = 1 - wx
    out[:, r_lo:r_hi, c_lo:c_hi] = ((1 - wy) * (owx * v00 + wx * v01)
                                    + wy * (owx * v10 + wx * v11))
    return int((~ins).sum())


def _wavy(seed, n, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    return np.clip(base[None] + rng.normal(0, 0.1, (n, h, w)),
                   0.0, 1.0).astype(np.float32)


def _adversarial(n, h, w):
    """Image 0: every pixel in one bin; 1: half the image below 0 and above
    1 (clipped), the rest noise; 2: flat at a bin edge with one bright
    tile-sized square."""
    x = _wavy(5, n, h, w)
    x[0] = 0.3
    if n > 1:
        x[1, : h // 2] = -0.5
        x[1, h // 2:, : w // 3] = 1.7
    if n > 2:
        x[2] = 128 / 256
        x[2, h // 3: h // 3 + 8, w // 3: w // 3 + 8] = 0.99
    return x


CASES = [  # (data, (n, h, w), t)
    ("wavy", (2, 96, 80), 16),
    ("wavy", (2, 64, 48), 8),
    ("wavy", (2, 128, 96), 32),
    ("wavy", (2, 72, 60), 12),       # t not a power of two
    ("wavy", (2, 60, 52), 16),       # extents not multiples of t
    ("wavy", (2, 37, 83), 8),
    ("wavy", (2, 5, 7), 16),         # a single tile, smaller than t
    ("wavy", (2, 16, 16), 16),       # a single whole tile
    ("wavy", (2, 1, 9), 4),
    ("adversarial", (3, 64, 64), 16),
    ("adversarial", (3, 50, 70), 12),
    ("adversarial", (3, 64, 96), 32),
]


def _input(data, shape):
    return torch.from_numpy(_wavy(3, *shape) if data == "wavy"
                            else _adversarial(*shape))


@pytest.mark.parametrize("data,shape,t", CASES)
def test_lut_stage_against_plain(data, shape, t):
    x = _input(data, shape)
    clip = torch.linspace(0.01, 0.05, shape[0])
    got = lut_stage(x, clip, t)
    n, h, w = shape
    xp = torch.clamp(x, 0.0, 1.0)
    xp = pad_axis(pad_axis(xp, 1, 0, (-h) % t, "reflect"), 2, 0, (-w) % t,
                  "reflect")
    want = TC.clahe_luts_plain(xp, clip, t)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= ATOL


@pytest.mark.parametrize("data,shape,t", CASES)
def test_remap_cells_against_plain_and_jax(data, shape, t):
    x = _input(data, shape)
    clip = torch.linspace(0.01, 0.05, shape[0])
    out, runs, outside = remap(x, lut_stage(x, clip, t), t)
    assert outside == 0 and runs > 0
    assert (out - TC.clahe_plain(x, clip, t)).abs().max() <= ATOL
    want = np.asarray(j_clahe(jnp.asarray(x.numpy()),
                              jnp.asarray(clip.numpy()), t))
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("ts", [range(1, 129), range(129, 257),
                                [300, 333, 500, 512, 777, 1000, 1024, 2048,
                                 4096]])
def test_float_cells_match_integer_cells(ts):
    """floor((i + 0.5) / t - 0.5) in float32, the remap's tile coordinate,
    equals the integer cell (i - t // 2) // t for every pixel index below
    65536: the blocks' integer cell bounds hold every pixel that finds its
    LUTs in shared memory, and the kernel's device-memory path for the
    others is never taken at these extents."""
    i = np.arange(1 << 16, dtype=np.int64)
    for t in ts:
        fy = (i.astype(np.float32) + np.float32(0.5)) / np.float32(t) \
            - np.float32(0.5)
        assert np.array_equal(np.floor(fy).astype(np.int64),
                              np.floor_divide(i - t // 2, t)), t


@pytest.mark.parametrize("t,k", [(1, 14), (3, 14), (4, 14), (8, 8),
                                 (12, 5), (16, 4), (32, 2), (64, 1),
                                 (100, 1)])
def test_cells_per_block(t, k):
    assert cells_per_block(t) == k


def test_remap_exact_when_luts_equal():
    # the remap alone, on the plain version's LUTs: the same expression on
    # the same values, so bit-equal to the plain remap
    x = _input("wavy", (2, 60, 52))
    clip = torch.tensor([0.02, 0.04])
    t = 16
    n, h, w = x.shape
    xp = torch.clamp(x, 0.0, 1.0)
    xp = pad_axis(pad_axis(xp, 1, 0, (-h) % t, "reflect"), 2, 0, (-w) % t,
                  "reflect")
    out, _, _ = remap(x, TC.clahe_luts_plain(xp, clip, t), t)
    assert torch.equal(out, TC.clahe_plain(x, clip, t))
