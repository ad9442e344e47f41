"""The schedule of the bilateral kernel (kernel 5, ``csrc/bilateral.cu``),
modelled in PyTorch on the CPU and held to the plain version and to the JAX
package.

The CUDA kernel runs only on the card.  This file holds its design block by
block, for every d:

* one block per 32 x 32 output tile, with the tile's R-halo of the
  reflect-padded image in shared memory: interior tiles index without
  reflection (the model checks that their halo stays in the image), border
  tiles reflect (``refl_idx``, also for images of 1 and 2 rows or columns);
* the d^2 spatial weights computed once a block, then each pixel's d^2
  terms window-ascending, every range weight's exponential computed at the
  pixel, num and den rounded in the plain version's order;
* every pixel written by exactly one block, the ragged tiles cut to the
  image.

The model's output is held to ``bilateral_plain`` bit for bit (NaN in the
same places) and to JAX's ``mdx.ops.bilateral.bilateral`` and
``bilateral_tpu(..., interpret=True)`` within the tolerances of
tests/test_torch_kernels.py.  Inputs: d = 1, 3, 5, 7 and 9; heights and
widths of 1 and 2 (reflection with n = 1 and n = 2); per-image sigmas;
sigma_color 0; a NaN pixel.  The card tests (tests/test_torch_cuda.py)
hold the kernel itself to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdx.ops import pallas_kernels as PK
from mdx.ops.bilateral import bilateral as j_bilateral

from mdx_torch.ops import bilateral as TB
from mdx_torch.ops.filters import pad_axis

torch.set_num_threads(1)

BW = 32  # the tile's edge in csrc/bilateral.cu


def _batch(seed, n, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    x = base[None] + rng.normal(0, 0.1, (n, h, w))
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def _reflect(i, n):
    """``refl_idx`` of csrc/common.cuh (numpy "reflect", any pad width)."""
    if n == 1:
        return torch.zeros_like(i)
    p = 2 * n - 2
    i = torch.remainder(i, p)
    return torch.where(i < n, i, p - i)


def halo(xi, i0, j0, r):
    """The block's halo [BW + 2r, BW + 2r] of the padded image."""
    h, w = xi.shape
    rows = torch.arange(i0 - r, i0 + BW + r)
    cols = torch.arange(j0 - r, j0 + BW + r)
    interior = i0 >= r and j0 >= r and i0 + BW + r <= h and j0 + BW + r <= w
    if interior:
        assert 0 <= int(rows.min()) and int(rows.max()) < h
        assert 0 <= int(cols.min()) and int(cols.max()) < w
    else:
        rows, cols = _reflect(rows, h), _reflect(cols, w)
    return xi[rows[:, None], cols[None, :]]


def tile(s, sw, inv_c, r):
    """A block's [BW, BW] outputs from its halo ``s``."""
    d = 2 * r + 1
    a = torch.arange(BW)[:, None]
    col = torch.arange(BW)[None, :]
    xv = s[a + r, col + r]
    num = torch.zeros(BW, BW)
    den = torch.zeros(BW, BW)
    for pos in range(d * d):
        dy, dx = pos // d - r, pos % d - r
        sv = s[a + dy + r, col + dx + r]
        diff = xv - sv
        wgt = sw[pos] * torch.exp(-(diff * diff) * inv_c)
        num = num + wgt * sv
        den = den + wgt
    return num / (den + 1e-10)


def bilateral_model(x, d, sc, ss):
    """The kernel's blocks on [N, H, W] with per-image sigmas [N]; every
    pixel written once."""
    n, h, w = x.shape
    r = d // 2
    out = torch.empty_like(x)
    count = torch.zeros(x.shape, dtype=torch.int64)
    for img in range(n):
        scv, ssv = sc[img:img + 1], ss[img:img + 1]
        inv_s = 1.0 / (2.0 * ssv * ssv * float(d * d))
        inv_c = 1.0 / (2.0 * scv * scv)
        sw = torch.cat([torch.exp(-float(dx * dx + dy * dy) * inv_s)
                        for dy in range(-r, r + 1)
                        for dx in range(-r, r + 1)])
        for i0 in range(0, h, BW):
            for j0 in range(0, w, BW):
                o = tile(halo(x[img], i0, j0, r), sw, inv_c, r)
                hh, ww = min(BW, h - i0), min(BW, w - j0)
                out[img, i0:i0 + hh, j0:j0 + ww] = o[:hh, :ww]
                count[img, i0:i0 + hh, j0:j0 + ww] += 1
    assert bool((count == 1).all())
    return out


def _equal_nan(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_reflect_matches_the_plain_pad():
    for n in (1, 2, 3, 7):
        i = torch.arange(-9, n + 9)
        x = torch.arange(n, dtype=torch.float32)[None, None, :]
        want = pad_axis(x, 2, 9, 9, "reflect")[0, 0]
        assert torch.equal(x[0, 0, _reflect(i, n)], want)


@pytest.mark.parametrize("d", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("shape", [(2, 40, 56), (2, 70, 33), (1, 1, 40),
                                   (1, 40, 1), (1, 2, 37), (1, 37, 2),
                                   (1, 1, 1), (1, 2, 2), (1, 100, 70)])
def test_model_vs_plain(d, shape):
    n = shape[0]
    x = torch.from_numpy(_batch(7, *shape))
    sc = torch.tensor([0.05, 0.1][:n])
    ss = torch.tensor([0.05, 0.2][:n])
    _equal_nan(bilateral_model(x, d, sc, ss), TB.bilateral_plain(x, d, sc, ss))


@pytest.mark.parametrize("d", [1, 3, 5, 7, 9])
def test_model_sigma_color_zero_and_nan_pixel(d):
    x = torch.from_numpy(_batch(8, 3, 70, 80))
    x[2, 33, 40] = float("nan")
    x[2, 0, 0] = float("nan")
    sc = torch.tensor([0.0, 0.07, 0.05])
    ss = torch.tensor([0.05, 0.0, 0.3])
    want = TB.bilateral_plain(x, d, sc, ss)
    _equal_nan(bilateral_model(x, d, sc, ss), want)
    assert bool(torch.isnan(want[0]).all())
    assert bool(torch.isnan(want[2, 33 - d // 2:34 + d // 2,
                                 40 - d // 2:41 + d // 2]).all())


@pytest.mark.parametrize("d", [3, 5, 7])
def test_model_vs_jax(d):
    x = _batch(9, 2, 40, 56)
    sc = np.array([0.05, 0.1], np.float32)
    ss = np.array([0.05, 0.2], np.float32)
    got = bilateral_model(torch.from_numpy(x), d, torch.from_numpy(sc),
                          torch.from_numpy(ss)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_bilateral(
        jnp.asarray(x), d, jnp.asarray(sc), jnp.asarray(ss))), atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(PK.bilateral_tpu(
        jnp.asarray(x), d, jnp.asarray(sc), jnp.asarray(ss),
        interpret=True)), atol=1e-5)


def test_model_nan_pixel_vs_jax():
    x = _batch(10, 2, 40, 56)
    x[1, 20, 30] = np.nan
    sc = np.array([0.05, 0.1], np.float32)
    ss = np.array([0.05, 0.2], np.float32)
    got = bilateral_model(torch.from_numpy(x), 5, torch.from_numpy(sc),
                          torch.from_numpy(ss)).numpy()
    want = np.asarray(j_bilateral(jnp.asarray(x), 5, jnp.asarray(sc),
                                  jnp.asarray(ss)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-6)
