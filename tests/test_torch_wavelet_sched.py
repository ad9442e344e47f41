"""The schedule of the wavelet denoise kernel (kernel 10, ``csrc/wavelet.cu``),
modelled in PyTorch on the CPU and held to the plain version and to the JAX
package.

The CUDA kernel runs only on the card.  This file holds its design before
the card does: a float32 model with float64 sums runs the kernel's
schedule thread by thread — the stages of ``kernels.wavelet_stages``, each
block's 256 threads laid out by ``kernels.wavelet_geometry`` (a P x P patch
a thread, the lanes of a tile in Z order), levels 1 and 2 in registers,
the later levels on the lane groups' values exchanged by xor partners (a
shuffle) or, across the two warps of a 32 x 32 tile, through the four
shared-memory slots, each lane's float64 band sums (a shared coefficient
counted by its group's first lane), the warp reduce-scatter, the warps in
order, the last block's lane-strided sums and shuffle tree, the band means
rounded once; then the synthesis: thresholds from the means and sigma, the
forward levels again, the coarse stage's denoised LL put back, each lane's
own quadrant on the way back.

Every coefficient of the model equals ``wavedec2`` bit for bit, and its
finest HH equals ``dwt2``'s; with sigma = 0 (thresholds 0) its output
equals ``denoise_wavelet_plain`` bit for bit; otherwise it is held to the
plain version and to ``mdx.ops.pallas_kernels.wavelet_denoise_tpu(...,
interpret=True)`` within ``parity.KERNEL_TOL["wavelet_denoise"]`` (0,
2e-6): its band sums run in another float64 order, which can move a band
mean by one float32 ulp.  The host side of the wrapper (stages, workspace,
launch order and arguments) is checked against a recording library.  The
card tests (tests/test_torch_cuda.py) hold the kernel itself to the plain
version.
"""

import contextlib
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdx.ops import wavelet as JW
from mdx.ops.pallas_kernels import wavelet_denoise_tpu

from mdx_torch import kernels, parity
from mdx_torch.ops import wavelet as TW

torch.set_num_threads(1)

C = np.float32(0.70710677)
EPS = np.float32(np.finfo(np.float32).eps)
NT, NWARP = 256, 8
ATOL = parity.KERNEL_TOL["wavelet_denoise"][1]


def _noisy(seed, n, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    x = base[None] + rng.normal(0, 0.08, (n, h, w))
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def fwd(p00, p01, p10, p11):
    """``fwd`` of csrc/wavelet.cu: (ll, lh, hl, hh)."""
    a0, d0 = C * p00 + C * p10, C * p10 - C * p00
    a1, d1 = C * p01 + C * p11, C * p11 - C * p01
    return C * a0 + C * a1, C * a1 - C * a0, C * d0 + C * d1, C * d1 - C * d0


def inv_at(ll, lh, hl, hh, by, bx):
    """``inv_at``: the inverse at quadrant (by, bx) (bool tensors)."""
    a = torch.where(bx, C * ll + C * lh, C * ll - C * lh)
    d = torch.where(bx, C * hl + C * hh, C * hl - C * hh)
    return torch.where(by, C * a + C * d, C * a - C * d)


def shrink(v, t, soft):
    r = torch.clamp_min(v.abs() - t, 0.0)
    s = torch.where(v > 0, r, torch.where(v < 0, -r, torch.zeros_like(r)))
    return torch.where(soft, s, torch.where(v.abs() > t, v, 0.0))


def xor_lane(v, mask):
    """Each thread's partner's value, thread ^ mask, on the thread axis
    (axis 3 of [n, gy, gx, 256, ...])."""
    idx = torch.arange(NT) ^ mask
    return v.index_select(3, idx)


class Stage:
    """One stage of m levels on an [n, h, w] image: every thread's place in
    row ``it`` of the ``loop`` rows of tiles its block walks."""

    def __init__(self, n, h, w, m, loop=1, it=0):
        geo = kernels.wavelet_geometry(m)
        self.n, self.h, self.w, self.m = n, h, w, m
        self.R, self.P, self.G, self.T = geo["R"], geo["P"], geo["G"], geo["T"]
        self.TBX, self.TBY = geo["TBX"], geo["TBY"]
        self.tiles_x, self.tiles_y = w >> m, h >> m
        self.gx = -(-self.tiles_x // self.TBX)
        self.gy = -(-self.tiles_y // (self.TBY * loop))
        self.rows = self.gy * loop * self.TBY * self.T
        tid = torch.arange(NT)
        self.tb, self.g = tid // self.G, tid % self.G
        g = self.g
        px = (g & 1) | ((g >> 1) & 2) | ((g >> 2) & 4)
        py = ((g >> 1) & 1) | ((g >> 2) & 2) | ((g >> 3) & 4)
        by = torch.arange(self.gy)[:, None, None]
        bx = torch.arange(self.gx)[None, :, None]
        self.tx, self.ty = torch.broadcast_tensors(       # [gy, gx, 256]
            bx * self.TBX + self.tb % self.TBX,
            (by * loop + it) * self.TBY + self.tb // self.TBX)
        self.x0 = self.tx * self.T + px * self.P
        self.y0 = self.ty * self.T + py * self.P
        self.inside = (self.tx < self.tiles_x) & (self.ty < self.tiles_y)

    def load(self, img):
        """Each thread's patch [n, gy, gx, 256, P, P], zeros outside."""
        ph, pw = self.rows, self.gx * self.TBX * self.T
        pad = img.new_zeros((self.n, ph, pw))
        pad[:, :self.h, :self.w] = img
        r = torch.arange(self.P)
        rows = (self.y0[..., None, None] + r[:, None]).expand(
            *self.y0.shape, self.P, self.P)
        cols = (self.x0[..., None, None] + r[None, :]).expand_as(rows)
        return pad[:, rows, cols]

    def level_up(self, cur, j, groups_agree=True):
        """Level R + 1 + j of every thread: the 2 x 2 group's values by
        shuffle or, when the y partner is in the other warp, through the
        four shared-memory slots of the tile; the step, the same in every
        lane of the group (asserted)."""
        xm, ym = 1 << (2 * j), 1 << (2 * j + 1)
        bx, by = (self.g & xm) != 0, (self.g & ym) != 0
        if ym < 32:
            v, vx, vy, vxy = (cur, xor_lane(cur, xm), xor_lane(cur, ym),
                              xor_lane(cur, xm | ym))
            p00 = torch.where(bx, torch.where(by, vxy, vx),
                              torch.where(by, vy, v))
            p01 = torch.where(bx, torch.where(by, vy, v),
                              torch.where(by, vxy, vx))
            p10 = torch.where(bx, torch.where(by, vx, vxy),
                              torch.where(by, v, vy))
            p11 = torch.where(bx, torch.where(by, v, vy),
                              torch.where(by, vx, vxy))
        else:
            # the writers: the lanes whose bits below xm are 0; slot
            # (by ? 2 : 0) + (bx ? 1 : 0) of their tile
            slot = lambda s: (self.tb * self.G + (s & 1) * xm  # noqa: E731
                              + (s >> 1) * ym)
            p00, p01, p10, p11 = (cur.index_select(3, slot(s))
                                  for s in range(4))
        q = fwd(p00, p01, p10, p11)
        if groups_agree:
            size = 4 << (2 * j)
            lead = (torch.arange(NT) // size) * size
            for c in q:
                assert torch.equal(c, c.index_select(3, lead))
        return q


def warp_reduce_scatter(sums, nb2):
    """[..., 256, nb2] float64 → [..., 8 warps, 32 lanes]: lane l holds its
    warp's sum of slot l / (32 / nb2), in the kernel's order."""
    v = sums.reshape(*sums.shape[:-2], NWARP, 32, nb2)
    lane = torch.arange(32)
    o, half = 16, nb2 // 2
    while half >= 1:
        upper = ((lane & o) != 0)[:, None]
        send = torch.where(upper, v[..., :half], v[..., half:2 * half])
        keep = torch.where(upper, v[..., half:2 * half], v[..., :half])
        v = keep + send.index_select(-2, lane ^ o)
        o, half = o >> 1, half >> 1
    r = v[..., 0]
    o = 16 // nb2
    while o >= 1:
        r = r + r.index_select(-1, lane ^ o)
        o >>= 1
    return r


def analysis(n, h, w, m, img, want_hh=False):
    """The analysis launch of one stage → (band means [n, 3m] float32, the
    tiles' LL [n, h/2^m, w/2^m], the bands per level {k: (lh, hl, hh)
    images}, the finest HH or None, the blocks)."""
    loop = kernels.wavelet_geometry(m)["LOOP"]
    nb = 3 * m
    nb2 = 4 if nb <= 4 else (8 if nb <= 8 else 16)
    bands, sums, ll = {}, None, None
    for it in range(loop):          # the rows a block walks, in order
        st = Stage(n, h, w, m, loop, it)
        if sums is None:
            sums = torch.zeros(n, st.gy, st.gx, NT, nb2, dtype=torch.float64)
            ll = torch.full((n, st.tiles_y, st.tiles_x), float("nan"))
        hh = analyse_row(st, img, sums, bands, ll, want_hh)
    return (*reduce_blocks(st, sums, nb, nb2), ll, bands, hh,
            st.gy * st.gx)


def analyse_row(st: Stage, img, sums, bands, ll, want_hh):
    """``analyse_patch`` of every thread at one row of its block's walk:
    adds to ``sums`` [n, gy, gx, 256, nb2], fills the rows' coefficients
    into ``bands`` and their LL into ``ll``; returns the finest HH band
    (NaN where no row has written yet) when ``want_hh``."""
    n, m, R, P = st.n, st.m, st.R, st.P
    v = st.load(img)

    def place(k, coeffs):
        """Scatter each thread's level-k coefficients to their positions;
        lanes of one group write the same value (asserted by level_up)."""
        out = []
        for i, c in enumerate(coeffs):
            band = bands[k][i] if k in bands else torch.full(
                (n, st.h >> k, st.w >> k), float("nan"))
            ok = st.inside
            rows, cols = st.y0[ok] >> k, st.x0[ok] >> k
            band[:, rows, cols] = c[:, ok]
            out.append(band)
        bands[k] = tuple(out)

    q = P // 2
    l1 = [[None] * q for _ in range(q)]
    d1 = [[None] * q for _ in range(q)]
    for qr in range(q):
        for qc in range(q):
            c = fwd(v[..., 2 * qr, 2 * qc], v[..., 2 * qr, 2 * qc + 1],
                    v[..., 2 * qr + 1, 2 * qc], v[..., 2 * qr + 1, 2 * qc + 1])
            l1[qr][qc], d1[qr][qc] = c[0], c[1:]
            for b in range(3):
                sums[..., b] = sums[..., b] + (c[1 + b] * c[1 + b]).double()
    # level 1 bands: quad (qr, qc) of a patch at (y0/2 + qr, x0/2 + qc)
    lvl1 = []
    for b in range(3):
        band = bands[1][b] if 1 in bands else torch.full(
            (n, st.h >> 1, st.w >> 1), float("nan"))
        ok = st.inside
        for qr in range(q):
            for qc in range(q):
                band[:, (st.y0[ok] >> 1) + qr, (st.x0[ok] >> 1) + qc] = \
                    d1[qr][qc][b][:, ok]
        lvl1.append(band)
    bands[1] = tuple(lvl1)
    hh = lvl1[2] if want_hh else None
    cur = l1[0][0]
    if R == 2:
        c = fwd(l1[0][0], l1[0][1], l1[1][0], l1[1][1])
        cur = c[0]
        for b in range(3):
            sums[..., 3 + b] = sums[..., 3 + b] + (c[1 + b] * c[1 + b]).double()
        place(2, c[1:])
    for j in range(m - R):
        c = st.level_up(cur, j)
        cur = c[0]
        first = (st.g & ((4 << (2 * j)) - 1)) == 0
        b0 = 3 * (R + j)
        for b in range(3):
            sq = (c[1 + b] * c[1 + b]).double()
            sums[..., b0 + b] = torch.where(first, sums[..., b0 + b] + sq,
                                            sums[..., b0 + b])
        place(R + 1 + j, c[1:])
    lead = st.inside & (st.g == 0)
    ll[:, st.ty[lead], st.tx[lead]] = cur[:, lead]
    return hh


def reduce_blocks(st: Stage, sums, nb, nb2):
    """The block's sums (the warps' reduce-scatter, then the warps in
    order) and the last block's reduction → (band means [n, nb], the
    partials [n, blocks, nb])."""
    n = st.n
    r = warp_reduce_scatter(sums, nb2)                 # [n, gy, gx, 8, 32]
    span = 32 // nb2
    s_part = r[..., ::span][..., :nb]                  # [n, gy, gx, 8, nb]
    acc = torch.zeros(s_part.shape[:3] + (nb,), dtype=torch.float64)
    for k in range(NWARP):
        acc = acc + s_part[..., k, :]
    partials = acc.reshape(n, -1, nb)                  # block by*gx + bx
    # the last block: lane-strided sums in block order, a shuffle tree
    nblk = partials.shape[1]
    lane_acc = torch.zeros(n, 32, nb, dtype=torch.float64)
    for k in range(nblk):
        lane_acc[:, k % 32] = lane_acc[:, k % 32] + partials[:, k]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lane_acc = lane_acc + lane_acc.index_select(1, lanes ^ o)
    total = lane_acc[:, 0]
    count = torch.tensor([float((st.h >> (b // 3 + 1)) * (st.w >> (b // 3 + 1)))
                          for b in range(nb)], dtype=torch.float64)
    return (total / count).float(), partials


def synthesis(st: Stage, img, ll_new, dvar, sigma, soft):
    """The synthesis launch of one stage → its denoised image."""
    n, m, R, P = st.n, st.m, st.R, st.P
    nv = sigma * sigma
    diff = dvar - nv[:, None]
    thr = nv[:, None] / torch.sqrt(torch.where(diff < EPS, EPS, diff))
    t = thr[:, None, None, None, :]                      # [n, 1, 1, 1, nb]
    sft = soft[:, None, None, None]
    v = st.load(img)
    q = P // 2
    d1 = [[fwd(v[..., 2 * qr, 2 * qc], v[..., 2 * qr, 2 * qc + 1],
               v[..., 2 * qr + 1, 2 * qc], v[..., 2 * qr + 1, 2 * qc + 1])
           for qc in range(q)] for qr in range(q)]
    cur = d1[0][0][0]
    if R == 2:
        d2 = fwd(d1[0][0][0], d1[0][1][0], d1[1][0][0], d1[1][1][0])
        cur = d2[0]
    dj = []
    for j in range(m - R):
        dj.append(st.level_up(cur, j))
        cur = dj[-1][0]
    if ll_new is not None:
        ty, tx = (st.ty.clamp_max(st.tiles_y - 1),
                  st.tx.clamp_max(st.tiles_x - 1))
        cur = torch.where(st.inside, ll_new[:, ty, tx], cur)
    for j in range(m - R - 1, -1, -1):
        xm, b = 1 << (2 * j), 3 * (R + j)
        _, lh, hl, hh = dj[j]
        cur = inv_at(cur, shrink(lh, t[..., b], sft),
                     shrink(hl, t[..., b + 1], sft),
                     shrink(hh, t[..., b + 2], sft),
                     (st.g & (xm << 1)) != 0, (st.g & xm) != 0)
    if R == 2:
        _, lh, hl, hh = d2
        lh, hl, hh = (shrink(lh, t[..., 3], sft), shrink(hl, t[..., 4], sft),
                      shrink(hh, t[..., 5], sft))
        l1 = [[inv_at(cur, lh, hl, hh, torch.tensor(qr == 1),
                      torch.tensor(qc == 1)) for qc in range(q)]
              for qr in range(q)]
    else:
        l1 = [[cur]]
    out = torch.zeros(n, st.gy * st.TBY * st.T, st.gx * st.TBX * st.T)
    for qr in range(q):
        for qc in range(q):
            _, lh, hl, hh = d1[qr][qc]
            lh, hl, hh = (shrink(lh, t[..., 0], sft),
                          shrink(hl, t[..., 1], sft),
                          shrink(hh, t[..., 2], sft))
            for r in range(2):
                for c in range(2):
                    px = inv_at(l1[qr][qc], lh, hl, hh, torch.tensor(r == 1),
                                torch.tensor(c == 1))
                    ok = st.inside
                    out[:, st.y0[ok] + 2 * qr + r, st.x0[ok] + 2 * qc + c] = \
                        px[:, ok]
    return out[:, :st.h, :st.w]


def model(x, sigma, soft, levels):
    """The kernel's schedule for one call, as the wrapper orders it →
    (output, per-stage band means, all stages' bands by global level, the
    finest HH, the sigma used)."""
    n, h, w = x.shape
    stages, imgs, dvars, bands = [], [x], [], {}
    hh, done = None, 0
    for s, (ch, cw, m, blocks) in enumerate(kernels.wavelet_stages(h, w,
                                                                   levels)):
        st = Stage(n, ch, cw, m)
        dvar, _, ll, b, hh_s, nblk = analysis(n, ch, cw, m, imgs[-1],
                                              want_hh=(s == 0))
        assert nblk == blocks
        if s == 0:
            hh = hh_s
        bands.update({done + k: v for k, v in b.items()})
        done += m
        stages.append(st)
        dvars.append(dvar)
        imgs.append(ll)
    if sigma is None:
        sigma = TW.mad_sigma_from_hh(hh)
    den = None
    for s in range(len(stages) - 1, -1, -1):
        den = synthesis(stages[s], imgs[s], den, dvars[s], sigma, soft)
    return den, dvars, bands, hh, sigma


CASES = [              # (levels, (n, h, w)): stages of kernels.wavelet_stages
    (1, (2, 6, 10)),      # m = 1: 2 x 2 patches, 3 x 5 tiles
    (2, (2, 12, 20)),
    (3, (2, 24, 40)),
    (4, (3, 64, 48)),
    (5, (2, 64, 96)),
    (6, (2, 128, 64)),    # 5 + 1
    (7, (1, 128, 256)),   # 5 + 2
    (8, (1, 256, 512)),   # 5 + 3
    (9, (1, 512, 1024)),  # 5 + 4
    (5, (1, 512, 1088)),  # 36 blocks, 34 tiles across: the last block's
]                         # lane-strided sums wrap, ragged block columns
IDS = [f"L{lv}-{h}x{w}" for lv, (_, h, w) in CASES]


def _case(levels, shape, seed=1):
    x = torch.from_numpy(_noisy(seed + levels, *shape))
    soft = torch.tensor([True, False, True][:shape[0]])
    return x, soft


@pytest.mark.parametrize("levels,shape", CASES, ids=IDS)
def test_transform_bit_for_bit(levels, shape):
    """Every band of every level equals wavedec2, the finest HH equals
    dwt2's, and with thresholds 0 the output equals the plain version."""
    x, soft = _case(levels, shape)
    out, _, bands, hh, _ = model(x, torch.zeros(x.shape[0]), soft, levels)
    _, details, _ = TW.wavedec2(x, "db1", levels)
    for i, det in enumerate(details):
        k = levels - i
        for got, want in zip(bands[k], det):
            assert torch.equal(got, want), f"level {k}"
    assert torch.equal(hh, TW.dwt2(x, "db1")[1][2])
    plain = TW.denoise_wavelet_plain(x, torch.zeros(x.shape[0]),
                                     wavelet_levels=levels, soft_mask=soft)
    assert torch.equal(out, plain)


def _plain_dvar(x, levels):
    """The plain version's band means per level, finest first."""
    n = x.shape[0]
    _, details, _ = TW.wavedec2(x, "db1", levels)
    return [[((b.reshape(n, -1) ** 2).double().sum(-1) / b[0].numel())
             .float() for b in det] for det in details[::-1]]


@pytest.mark.parametrize("levels,shape", CASES, ids=IDS)
@pytest.mark.parametrize("given", [True, False])
def test_denoise_against_plain(levels, shape, given):
    """Mixed soft and hard images, sigma given or estimated: the band means
    within one float32 ulp of the plain version's, the output within
    KERNEL_TOL."""
    x, soft = _case(levels, shape, seed=11)
    n = x.shape[0]
    sigma = torch.linspace(0.03, 0.09, n) if given else None
    out, dvars, _, _, sig = model(x, sigma, soft, levels)
    want_dvar = _plain_dvar(x, levels)
    got_dvar = torch.cat(dvars, dim=1)
    for lvl, bands in enumerate(want_dvar):
        for b, want in enumerate(bands):
            got = got_dvar[:, 3 * lvl + b]
            assert torch.all((got - want).abs()
                             <= torch.finfo(torch.float32).eps * want.abs())
    if not given:
        assert torch.equal(sig, TW.mad_sigma_from_hh(TW.dwt2(x, "db1")[1][2]))
    plain = TW.denoise_wavelet_plain(x, sigma, wavelet_levels=levels,
                                     soft_mask=soft)
    assert (out - plain).abs().max() <= ATOL


def test_zero_sigma_and_flat_image():
    # sigma 0: thresholds 0, every coefficient kept; a flat image: band
    # means 0, below sigma^2, the eps clamp
    x = torch.from_numpy(_noisy(4, 3, 64, 64))
    x[1] = 0.5
    sigma = torch.tensor([0.0, 0.05, 0.05])
    soft = torch.tensor([True, False, True])
    out, _, _, _, _ = model(x, sigma, soft, 3)
    assert torch.equal(out[0], TW.denoise_wavelet_plain(
        x, sigma, wavelet_levels=3, soft_mask=soft)[0])
    assert (out - TW.denoise_wavelet_plain(
        x, sigma, wavelet_levels=3, soft_mask=soft)).abs().max() <= ATOL


@functools.cache
def _jax_case(case):
    x = _noisy(21, 2, 64, 64) if case != "mixed" else _noisy(22, 3, 64, 128)
    n = x.shape[0]
    mask = {"soft": np.ones(n, bool), "hard": np.zeros(n, bool),
            "mixed": np.arange(n) % 2 == 0, "none": np.ones(n, bool)}[case]
    lv = 6 if case == "mixed" else 3
    sig = (None if case == "none"
           else np.linspace(0.03, 0.08, n).astype(np.float32))
    j_sig = (JW.mad_sigma_from_hh(JW.dwt2(jnp.asarray(x), "db1")[1][2])
             if sig is None else jnp.asarray(sig))
    want = wavelet_denoise_tpu(jnp.asarray(x), j_sig, jnp.asarray(mask), lv,
                               interpret=True)
    return x, sig, mask, lv, np.asarray(want)


@pytest.mark.parametrize("case", ["soft", "hard", "mixed", "none"])
def test_against_the_jax_kernel(case):
    x, sig, mask, lv, want = _jax_case(case)
    out, _, _, _, _ = model(torch.from_numpy(x),
                            None if sig is None else torch.from_numpy(sig),
                            torch.from_numpy(mask), lv)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("nb2", [4, 8, 16])
def test_warp_reduce_scatter_slots(nb2):
    """Lane l ends with its warp's sum of slot l / (32 / nb2)."""
    g = torch.Generator().manual_seed(nb2)
    sums = torch.rand(2, 1, 1, NT, nb2, dtype=torch.float64, generator=g)
    r = warp_reduce_scatter(sums, nb2)                 # [2, 1, 1, 8, 32]
    want = sums.reshape(2, 1, 1, NWARP, 32, nb2).sum(-2)
    slot = torch.arange(32) // (32 // nb2)
    torch.testing.assert_close(r, want[..., slot], rtol=1e-14, atol=0)


# ------------------------------------------------- the wrapper's host side

class _Recorder:
    """A library whose entries record their arguments and return 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mdx_"):
            raise AttributeError(name)
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture()
def recorded(monkeypatch):
    """The wrapper on CPU tensors with a recording library; the MAD sigma of
    the (unwritten) HH region is a stub that records the view's shape."""
    lib = _Recorder()
    lib.hh_shapes = []

    def mad(hh):
        lib.hh_shapes.append(tuple(hh.shape))
        return torch.full(hh.shape[:1], 0.05)

    monkeypatch.setattr(TW, "mad_sigma_from_hh", mad)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "_check", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "_stream", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("shape,levels,stages", [
    ((32, 512, 512), 6, [(512, 512, 5, 16), (16, 16, 1, 2)]),
    ((2, 2048, 2048), 8, [(2048, 2048, 5, 256), (64, 64, 3, 2)]),
    ((2, 64, 128), 4, [(64, 128, 4, 2)]),
    ((1, 4096, 4096), 12, [(4096, 4096, 5, 1024), (128, 128, 5, 1),
                           (4, 4, 2, 1)]),
])
@pytest.mark.parametrize("given", [True, False])
def test_wrapper_launches_and_workspace(recorded, shape, levels, stages,
                                        given):
    """Two launches a stage (analysis down, synthesis up), the stages
    chained through the workspace, one ticket memset, the finest HH only
    when sigma is estimated; no region overlaps another."""
    n, h, w = shape
    assert kernels.wavelet_stages(h, w, levels) == stages
    x = torch.empty(shape, dtype=torch.float32)
    soft = torch.ones(n, dtype=torch.bool)
    sigma = torch.full((n,), 0.05) if given else None
    out = kernels.wavelet_denoise(x, sigma, soft, levels)
    calls = recorded.calls
    k = len(stages)
    assert [c[0] for c in calls] == (["mdx_wavelet_analysis"] * k
                                     + ["mdx_wavelet_synthesis"] * k)
    ana, syn = [c[1] for c in calls[:k]], [c[1] for c in calls[k:]][::-1]
    regions = []
    for s, ((ch, cw, m, blocks), a, y) in enumerate(zip(stages, ana, syn)):
        src, ll, part, dvar, ticket, zero, hh = a[:7]
        assert a[7:12] == (n, ch, cw, m, blocks)
        assert y[6:10] == (n, ch, cw, m)
        assert zero == (n * k if s == 0 else 0)
        assert (hh is not None) == (s == 0 and not given)
        assert src == (x.data_ptr() if s == 0 else ana[s - 1][1])
        assert y[0] == src and y[2] == dvar and y[4] == soft.data_ptr()
        assert y[5] == (out.data_ptr() if s == 0 else syn[s - 1][1])
        assert (ll is None) == (s == k - 1) == (y[1] is None)
        if s < k - 1:
            assert y[1] != ll and ana[s + 1][0] == ll
            lb = 4 * n * (ch >> m) * (cw >> m)
            regions += [(ll, lb), (y[1], lb)]
        regions += [(part, 8 * n * 3 * m * blocks), (dvar, 4 * n * 3 * m)]
        if hh is not None:
            regions.append((hh, 4 * n * (h // 2) * (w // 2)))
    regions.append((ana[0][4], 4 * n * k))
    regions.sort()
    for (a, la), (b, _) in zip(regions, regions[1:]):
        assert a + la <= b
    base = ana[0][2]                       # stage 0's partials: offset 0
    assert all((a - base) % 256 == 0 for a, _ in regions)
    assert recorded.hh_shapes == ([] if given else [(n, h // 2, w // 2)])
    assert out.shape == x.shape
