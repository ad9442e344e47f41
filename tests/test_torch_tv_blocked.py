"""The schedule of the blocked TV kernel (kernel T, ``csrc/tv.cu``), modelled
in PyTorch on the CPU and held to the plain version bit for bit.

The CUDA kernel runs only on the card.  This file holds its design before
the card does: a float32 model with float64 sums runs the kernel's
schedule — windows of the owned tile plus an s-cell halo, s steps a launch
on each window, each step's partial sums over the owned cells, the
finalize's walk over the launch's energies with the stop rule, a ping-pong
pair of dual buffers that a stopped image's blocks no longer write, the
base launch recorded per image and the rebuild of the output from that
launch's input dual.  Cells a step must not read are poisoned with NaN
(out outside its valid region, the dual outside the region still exact,
both buffers before their first write), so a read outside the shrinking
valid region shows in the result.

The model equals ``tv_chambolle_plain`` bit for bit in pixels and counts
(counts asserted first: the partials sum in another float64 order than the
plain version, which could move an energy by one float32 ulp; these inputs
do not stop on such an edge), and ``mdx.ops.tv.tv_chambolle_xla`` within
the 1e-6 of tests/test_torch_kernels.py.  The card tests
(tests/test_torch_cuda.py) hold the kernel itself to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mdx.ops import tv as JTV

from mdx_torch.ops import tv as TTV

torch.set_num_threads(1)

TAU = 0.25
CHECK_EVERY = 16          # iterations between the host's flag reads
NAN = float("nan")


def _batch(seed, n, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    x = base[None] + rng.normal(0, 0.1, (n, h, w))
    return np.clip(x, 0.0, 1.0).astype(np.float32)


class Windows:
    """The launch's windows of every image: [n, ty, tx, win, win] views of
    the image, with each cell's global row and column."""

    def __init__(self, h, w, s, win):
        self.h, self.w, self.s, self.win = h, w, s, win
        self.tile = win - 2 * s
        self.ty, self.tx = -(-h // self.tile), -(-w // self.tile)
        r = torch.arange(win)
        self.gi = (torch.arange(self.ty)[:, None, None, None] * self.tile
                   - s + r[None, None, :, None])          # [ty, 1, win, 1]
        self.gj = (torch.arange(self.tx)[None, :, None, None] * self.tile
                   - s + r[None, None, None, :])          # [1, tx, 1, win]
        self.inimg = ((self.gi >= 0) & (self.gi < h)
                      & (self.gj >= 0) & (self.gj < w))   # [ty, tx, win, win]
        own = (r >= s) & (r < win - s)
        self.owned = own[:, None] & own[None, :] & self.inimg
        rr, cc = r[:, None], r[None, :]
        # out valid after k steps: p, p above and p left valid; the dual
        # valid after step k: out, out below and out right valid
        self.out_ok = [(rr > k) & (rr < win - k) & (cc > k) & (cc < win - k)
                       for k in range(s)]
        self.p_ok = [(rr > k) & (rr < win - k - 1) & (cc > k)
                     & (cc < win - k - 1) for k in range(s)]

    def cut(self, a):
        """[n, h, w] → windows [n, ty, tx, win, win], zeros outside."""
        n = a.shape[0]
        s, t = self.s, self.tile
        pad = a.new_zeros((n, self.ty * t + 2 * s, self.tx * t + 2 * s))
        pad[:, s:s + self.h, s:s + self.w] = a
        return pad.unfold(1, self.win, t).unfold(2, self.win, t).clone()

    def paste(self, wins):
        """The owned tiles of windows [n, ty, tx, win, win] → [n, h, w]."""
        s, t = self.s, self.tile
        own = wins[..., s:s + t, s:s + t]                  # [n, ty, tx, t, t]
        full = own.permute(0, 1, 3, 2, 4).reshape(
            wins.shape[0], self.ty * t, self.tx * t)
        return full[:, :self.h, :self.w]


def _div(p0, p1):
    """d = -(p0 + p1) + (p0 above) + (p1 left), zeros past the window."""
    d = -(p0 + p1)
    d = d + F.pad(p0[..., :-1, :], (0, 0, 1, 0))
    d = d + F.pad(p1[..., :, :-1], (1, 0, 0, 0))
    return d


def _step(win: Windows, x, p0, p1, wgt, k, energy):
    """Step k of a launch on every window, as tv_blk_step: returns the new
    dual and, with ``energy``, the owned cells' (sum d^2, sum |grad out|)
    per image in float64."""
    d = _div(p0, p1)
    ok = win.out_ok[k]
    d = torch.where(ok, d, NAN)
    o = x + d
    gy = F.pad(o[..., 1:, :] - o[..., :-1, :], (0, 0, 0, 1), value=NAN)
    gx = F.pad(o[..., :, 1:] - o[..., :, :-1], (0, 1, 0, 0), value=NAN)
    gy = torch.where(win.gi < win.h - 1, gy, 0.0)
    gx = torch.where(win.gj < win.w - 1, gx, 0.0)
    norm = torch.sqrt(gy * gy + gx * gx)
    scale = norm * TAU / wgt + 1.0
    q0 = (p0 - TAU * gy) / scale
    q1 = (p1 - TAU * gx) / scale
    upd = win.p_ok[k] & win.inimg
    # the image's cells outside the region still exact are poisoned; the
    # cells outside the image keep their zeros
    keep = ~win.inimg
    p0 = torch.where(upd, q0, torch.where(keep, p0, NAN))
    p1 = torch.where(upd, q1, torch.where(keep, p1, NAN))
    sums = None
    if energy:
        dd = torch.where(win.owned, (d * d).double(), 0.0)
        nn = torch.where(win.owned, norm.double(), 0.0)
        sums = (dd.sum(dim=(1, 2, 3, 4)), nn.sum(dim=(1, 2, 3, 4)))
    return p0, p1, sums


def _load(win: Windows, x, p):
    xw = win.cut(x)
    if p is None:                                         # a = 0: p = 0
        return xw, torch.zeros_like(xw), torch.zeros_like(xw)
    return xw, win.cut(p[:, 0]), win.cut(p[:, 1])


def _launch(win: Windows, x, p, wgt, m):
    """One step launch: m steps from p_a (None at a = 0) → (p_{a+m}
    [n, 2, h, w], [(sum d^2, sum |grad out|) per step])."""
    xw, p0, p1 = _load(win, x, p)
    sums = []
    for k in range(m):
        p0, p1, e = _step(win, xw, p0, p1, wgt, k, energy=True)
        sums.append(e)
    return torch.stack([win.paste(p0), win.paste(p1)], dim=1), sums


def _rebuild(win: Windows, x, p, wgt, r):
    """r steps from p_a, then out = x + div p on the owned tiles."""
    xw, p0, p1 = _load(win, x, p)
    for k in range(r):
        p0, p1, _ = _step(win, xw, p0, p1, wgt, k, energy=False)
    return win.paste(xw + _div(p0, p1))


def tv_blocked_model(x, weight, eps=2e-4, max_iter=200, *, s=4, win=64):
    """The kernel's schedule on [n, h, w] float32 → (out, counts, launches
    in which each image stopped or reached the cap)."""
    n, h, w = x.shape
    geo = Windows(h, w, s, win)
    wgt = weight.reshape(n, 1, 1, 1, 1)
    size = np.float32(h * w)
    max_iter = max(int(max_iter), 1)
    bufs = [torch.full((n, 2, h, w), NAN), torch.full((n, 2, h, w), NAN)]
    active = [True] * n
    iters, base = [0] * n, [0] * n
    e0 = [np.float32(0)] * n
    e_prev = [np.float32(0)] * n
    a = launch = 0
    while a < max_iter:
        if a and a % CHECK_EVERY == 0 and not any(active):
            break
        m = min(s, max_iter - a)
        p_new, sums = _launch(geo, x, None if a == 0 else bufs[launch % 2],
                              wgt, m)
        for i in range(n):
            if not active[i]:
                continue                    # its blocks return at once
            bufs[(launch + 1) % 2][i] = p_new[i]
            base[i] = a
            for k in range(m):              # the finalize's walk
                sd, sn = (float(v[i]) for v in sums[k])
                e = ((np.float32(sd) + np.float32(weight[i])
                      * np.float32(sn)) / size)
                if a + k == 0:
                    e0[i] = e_prev[i] = e
                    iters[i] = 1
                    continue
                iters[i] += 1
                if abs(e_prev[i] - e) >= np.float32(eps) * e0[i]:
                    e_prev[i] = e
                else:
                    active[i] = False
                    break
        a += m
        launch += 1
    out = torch.empty_like(x)
    for i in range(n):
        r = iters[i] - 1 - base[i]
        assert 0 <= r < s, (i, iters[i], base[i])
        p = (None if base[i] == 0
             else bufs[(base[i] // s) % 2][i:i + 1])
        out[i] = _rebuild(geo, x[i:i + 1], p, wgt[i:i + 1], r)[0]
    return out, iters, [b // s for b in base]


def _plain(x, weight, eps, max_iter):
    out, iters = TTV.tv_chambolle_plain(x, weight, eps, max_iter)
    return out, iters.tolist()


def _assert_equal_to_plain(x, weight, eps, max_iter, s, win):
    got, it, stop_launch = tv_blocked_model(x, weight, eps, max_iter, s=s,
                                            win=win)
    want, it_p = _plain(x, weight, eps, max_iter)
    assert it == it_p                       # counts first
    assert not torch.isnan(got).any()
    assert torch.equal(got, want), float((got - want).abs().max())
    return it, stop_launch


WEIGHTS = torch.tensor([0.05, 0.1, 0.02])


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("h,w,win", [(5, 7, 16), (33, 129, 16),
                                     (64, 80, 16), (64, 80, 64)])
def test_blocked_model_equals_plain(h, w, win, s):
    x = torch.from_numpy(_batch(5, 3, h, w))
    it, _ = _assert_equal_to_plain(x, WEIGHTS, 2e-4, 200, s, win)
    assert all(1 < c < 200 for c in it), it


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("cap", range(1, 10))
def test_blocked_model_stops_at_every_offset(cap, s):
    # eps = 0 never stops early: every image runs to the cap, which ends
    # the last launch at offset (cap - 1) % s, and a cap that is not a
    # multiple of s makes the last launch short
    x = torch.from_numpy(_batch(6, 2, 33, 47))
    it, _ = _assert_equal_to_plain(x, WEIGHTS[:2], 0.0, cap, s, 4 * s + 4)
    assert it == [cap, cap]


@pytest.mark.parametrize("s", [2, 4, 8])
def test_blocked_model_mixed_stops(s):
    # images of one batch that stop in different launches: each keeps its
    # own base launch and reads its dual from that launch's buffer
    x = torch.from_numpy(_batch(7, 1, 40, 56)).repeat(3, 1, 1)
    weight = torch.tensor([0.01, 0.03, 0.5])           # 8, 17, 32 iterations
    it, stop_launch = _assert_equal_to_plain(x, weight, 2e-4, 200, s,
                                             4 * s + 4)
    assert len(set(stop_launch)) == 3, (it, stop_launch)
    assert len({sl % 2 for sl in stop_launch}) == 2, (it, stop_launch)
    assert len({(c - 1) % s for c in it}) > 1, it


@pytest.mark.parametrize("h,w,s", [(33, 129, 2), (64, 80, 4)])
def test_blocked_model_vs_jax(h, w, s):
    xn = _batch(5, 3, h, w)
    got, it, _ = tv_blocked_model(torch.from_numpy(xn), WEIGHTS, s=s,
                                  win=16)
    want = np.asarray(JTV.tv_chambolle_xla(jnp.asarray(xn),
                                           jnp.asarray(WEIGHTS.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert all(1 < c < 200 for c in it), it
