"""The schedule of the unsharp kernel (kernel U, ``csrc/unsharp.cu``),
modelled in PyTorch on the CPU and held to the plain version and to the JAX
package.

The CUDA kernel runs only on the card.  This file holds its design before
the card does, block by block:

* the support from the taps: R is the span of the image's non-zero taps
  (NaN counts as non-zero), and a block's loops run over 2R + 1 taps;
* the ring check: the ring between the tile's R-halo and its 12-halo, as
  the kernel's two band loops visit it, plus every value the row pass
  loads; where any is not finite the block runs at R = 12 (the model
  checks that the two cover the 12-halo exactly);
* the row pass: warps of 32 columns over strips of 16 rows, each lane's
  16 + 2R inputs of one column, taps ascending; interior blocks index
  without clamps (the model checks that they stay in the image);
* the column pass: a lane per row of 32 outputs from its 32 + 2R
  intermediate values, which the row pass must have written;
* the combine, with NaN through the clip as ``torch.clamp`` gives it.

The model's output is held to ``unsharp_mask_plain`` bit for bit (NaN in
the same places) and to JAX's ``mdx.ops.filters.unsharp_mask`` and
``unsharp_tpu(..., interpret=True)`` within the tolerance of
tests/test_torch_kernels.py.  Inputs: every r_eff from 0 to 12 (sigma
across ``PARAM_BOUNDS`` and below it) and one above, NaN and +inf pixels
at distances r_eff < dist <= 12 from a tile edge, images smaller than a
tile, 1 x 1, 1 x W, H x 1 and non-square shapes.  The card tests
(tests/test_torch_cuda.py) hold the kernel itself to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdx.ops import filters as JF
from mdx.ops import pallas_kernels as PK

from mdx_torch.ops import filters as TF

torch.set_num_threads(1)

UR, TH, TW, SH = 12, 64, 128, 16
CHUNKS, STRIPS = (TW + 2 * UR + 31) // 32, TH // SH


def _batch(seed, n, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    x = base[None] + rng.normal(0, 0.1, (n, h, w))
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def span(taps):
    """R of a block: the span of the non-zero taps (NaN counts)."""
    nz = [q for q in range(2 * UR + 1) if not taps[q] == 0.0]
    return max((abs(q - UR) for q in nz), default=0)


def _idx(i0, j0, rows, cols, h, w, clamp):
    rows, cols = torch.as_tensor(rows), torch.as_tensor(cols)
    if clamp:
        return rows.clamp(0, h - 1), cols.clamp(0, w - 1)
    assert 0 <= int(rows.min()) and int(rows.max()) < h
    assert 0 <= int(cols.min()) and int(cols.max()) < w
    return rows, cols


def ring_cells(i0, j0, r):
    """The (row, column) cells of the kernel's ring loops at radius r."""
    b, w12 = UR - r, TW + 2 * UR
    cells = []
    for k in range(2 * b * w12):
        bb, c = divmod(k, w12)
        i = i0 - UR + bb if bb < b else i0 + TH + r + (bb - b)
        cells.append((i, j0 - UR + c))
    for k in range((TH + 2 * r) * 2 * b):
        a, bb = divmod(k, 2 * b)
        j = j0 - UR + bb if bb < b else j0 + TW + r + (bb - b)
        cells.append((i0 - r + a, j))
    return cells


def rows_pass(x, i0, j0, tp, r, clamp):
    """The row pass at radius r → (intermediate [TH, TW + 2r], written mask,
    whether a loaded value is not finite, the cells it loaded)."""
    h, w = x.shape
    nc, nw = TW + 2 * r, SH + 2 * r
    out = torch.full((TH, TW + 2 * UR + 1), float("nan"))
    written = torch.zeros(TH, TW + 2 * UR + 1, dtype=torch.bool)
    bad, loaded = False, set()
    lane = torch.arange(32)
    for item in range(CHUNKS * STRIPS):
        c = (item % CHUNKS) * 32 + lane
        a0 = (item // CHUNKS) * SH
        c = c[c < nc]
        if not len(c):
            continue
        rows = (i0 + a0 - r + torch.arange(nw))[:, None].expand(nw, len(c))
        cols = (j0 - r + c)[None, :].expand(nw, len(c))
        loaded |= set(zip(rows.flatten().tolist(), cols.flatten().tolist()))
        gi, gj = _idx(i0, j0, rows, cols, h, w, clamp)
        win = x[gi, gj]                                  # [nw, lanes]
        bad |= not bool(torch.isfinite(win).all())
        acc = tp[UR - r] * win[0:SH]
        for q in range(1, 2 * r + 1):
            acc = acc + tp[UR - r + q] * win[q:q + SH]
        assert not written[a0:a0 + SH][:, c].any()
        out[a0:a0 + SH, c] = acc
        written[a0:a0 + SH, c] = True
    assert bool(written[:, :nc].all()) and not written[:, nc:].any()
    return out, written, bad, loaded


def cols_pass(inter, written, tp, r):
    """The column pass at radius r: lane a of warp w → row (w % 2)·32 + a,
    columns (w // 2)·32 … + 31 → the blur [TH, TW]."""
    nw = 32 + 2 * r
    blur = torch.empty(TH, TW)
    for warp in range(8):
        a = (warp % (TH // 32)) * 32 + torch.arange(32)
        c0 = (warp // (TH // 32)) * 32
        assert bool(written[a][:, c0:c0 + nw].all())
        win = inter[a][:, c0:c0 + nw]                     # [lanes, nw]
        acc = tp[UR - r] * win[:, 0:32]
        for q in range(1, 2 * r + 1):
            acc = acc + tp[UR - r + q] * win[:, q:q + 32]
        blur[a, c0:c0 + 32] = acc
    return blur


def unsharp_model(x, radius, amount):
    """The kernel's schedule on [N, H, W] with per-image radius and amount
    → (out, the R each block ran at)."""
    n, h, w = x.shape
    taps = TF._gauss_taps(torch.as_tensor(radius), torch.float32)
    out = torch.empty_like(x)
    ran = []
    for img in range(n):
        xi, tp = x[img], taps[img]
        r = span(tp.tolist())
        for i0 in range(0, h, TH):
            for j0 in range(0, w, TW):
                interior = (i0 >= UR and j0 >= UR and i0 + TH + UR <= h
                            and j0 + TW + UR <= w)
                ring = ring_cells(i0, j0, r)
                gi, gj = _idx(i0, j0, [p[0] for p in ring],
                              [p[1] for p in ring], h, w, True)
                ring_bad = bool(len(ring)) and not bool(
                    torch.isfinite(xi[gi, gj]).all())
                inter, written, bad, loaded = rows_pass(xi, i0, j0, tp, r,
                                                        not interior)
                cover = set(ring) | loaded
                assert len(cover) == len(ring) + len(loaded)
                assert cover == {(i, j)
                                 for i in range(i0 - UR, i0 + TH + UR)
                                 for j in range(j0 - UR, j0 + TW + UR)}
                rr = r
                if ring_bad or bad:
                    rr = UR
                    inter, written, _, _ = rows_pass(xi, i0, j0, tp, UR,
                                                     not interior)
                ran.append(rr)
                blur = cols_pass(inter, written, tp, rr)
                hh, ww = min(TH, h - i0), min(TW, w - j0)
                xv = xi[i0:i0 + hh, j0:j0 + ww]
                o = xv + (xv - blur[:hh, :ww]) * float(amount[img])
                out[img, i0:i0 + hh, j0:j0 + ww] = torch.where(
                    o != o, o, torch.clamp(o, 0.0, 1.0))
    return out, ran


def _equal_nan(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


# every r_eff = floor(4 sigma + 0.5) from 0 to 12, and one above 12
SIGMAS = [0.0, 0.1, 0.25, 0.5, 0.8, 1.0, 1.25, 1.5, 1.75, 2.0, 2.25, 2.5,
          2.75, 3.0, 3.5]


def test_sigmas_cover_every_support():
    reff = [span(TF._gauss_taps(torch.tensor(s)).tolist()) for s in SIGMAS]
    assert reff == [0] + list(range(13)) + [12]
    assert [int(np.floor(4 * s + 0.5)) for s in SIGMAS[:-1]] == \
        [0] + list(range(13))


@pytest.mark.parametrize("sigmas", [SIGMAS[:5], SIGMAS[5:10], SIGMAS[10:]])
def test_model_every_support(sigmas):
    n = len(sigmas)
    x = torch.from_numpy(_batch(1, n, 150, 300))
    rad = torch.tensor(sigmas, dtype=torch.float32)
    amt = torch.linspace(0.3, 1.5, n)
    got, ran = unsharp_model(x, rad, amt)
    want = TF.unsharp_mask_plain(x, rad, amt)
    assert torch.equal(got, want)
    spans = [span(t.tolist()) for t in TF._gauss_taps(rad)]
    assert sorted(set(ran)) == sorted(set(spans))


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 1, 200), (2, 150, 1),
                                   (2, 20, 30), (2, 70, 300), (2, 150, 140),
                                   (1, 64, 128), (1, 65, 129)])
def test_model_shapes(shape):
    n = shape[0]
    x = torch.from_numpy(_batch(2, *shape))
    rad = torch.tensor([1.0, 3.0][:n])
    amt = torch.tensor([0.6, 1.2][:n])
    got, _ = unsharp_model(x, rad, amt)
    assert torch.equal(got, TF.unsharp_mask_plain(x, rad, amt))


def _poisoned(value, cells):
    x = torch.from_numpy(_batch(3, 2, 150, 300))
    for img, i, j in cells:
        x[img, i, j] = value
    return x


# a tile edge at row 64 and at column 128: pixels 5 to 12 beyond it, past
# the block's R = 4 (radius 1.0) or R = 3 (0.8), inside its 12-halo; one
# inside a tile, 9 from its other pixels; one at the image's corner
CELLS = [(0, 30, 128 + 5), (0, 64 + 11, 200), (1, 100, 127 - 8),
         (1, 149, 299), (0, 10, 10)]


@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_model_non_finite_ring(value):
    x = _poisoned(value, CELLS)
    rad = torch.tensor([1.0, 0.8])
    amt = torch.tensor([0.6, 1.0])
    got, ran = unsharp_model(x, rad, amt)
    want = TF.unsharp_mask_plain(x, rad, amt)
    _equal_nan(got, want)
    assert bool(torch.isnan(want).any())
    assert UR in ran and 4 in ran and 3 in ran
    # skipping the zero taps alone would spread a NaN over R, not 12
    # (+inf: -inf, clipped to 0, within R of it)
    for img, i, j in CELLS[:3] if value != value else ():
        assert bool(torch.isnan(want[img, i, max(j - 12, 0):j + 13]).all())


def test_model_nan_taps():
    x = torch.from_numpy(_batch(4, 2, 40, 50))
    rad = torch.tensor([float("nan"), 1.0])
    amt = torch.tensor([0.6, 0.6])
    got, ran = unsharp_model(x, rad, amt)
    _equal_nan(got, TF.unsharp_mask_plain(x, rad, amt))
    assert ran[0] == UR


@pytest.mark.parametrize("h,w", [(64, 80), (33, 129), (1, 40), (40, 1)])
def test_model_vs_jax(h, w):
    x = _batch(5, 3, h, w)
    rad = np.array([0.6, 1.0, 3.0], np.float32)
    amt = np.array([0.3, 0.6, 1.5], np.float32)
    got, _ = unsharp_model(torch.from_numpy(x), torch.from_numpy(rad),
                           torch.from_numpy(amt))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JF.unsharp_mask(
            jnp.asarray(x), jnp.asarray(rad), jnp.asarray(amt))), atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(PK.unsharp_tpu(
            jnp.asarray(x), jnp.asarray(rad), jnp.asarray(amt),
            interpret=True)), atol=1e-6)


def test_model_non_finite_vs_jax():
    x = _poisoned(float("nan"), CELLS[:2]).numpy()[:, :80, :150]
    rad = np.array([1.0, 0.8], np.float32)
    amt = np.array([0.6, 1.0], np.float32)
    got, _ = unsharp_model(torch.from_numpy(x), torch.from_numpy(rad),
                           torch.from_numpy(amt))
    want = np.asarray(JF.unsharp_mask(jnp.asarray(x), jnp.asarray(rad),
                                      jnp.asarray(amt)))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
