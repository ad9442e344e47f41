"""The CUDA kernels of mdx_torch against their plain PyTorch versions, on
the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports no JAX, but tests/conftest.py does, so on a machine
without JAX run it without the conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: ``mdx_torch.parity.KERNEL_TOL`` for each kernel against its
plain version, and ``mdx_torch.parity.breaches`` for the slice.
"""

import numpy as np
import pytest
import torch

from mdx_torch import kernels, parity
from mdx_torch.core import metrics as M
from mdx_torch.core import qa
from mdx_torch.ops import bilateral as B
from mdx_torch.ops import clahe as C
from mdx_torch.ops import filters as F
from mdx_torch.ops import tv as T
from mdx_torch.ops import wavelet as W
from mdx_torch.parallel import clahe_sp, launch, tv_sp
from mdx_torch.parallel.launch import Block
from mdx_torch.tools import spatial_check as SC

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _batch(seed, n, h, w, device):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    x = np.clip(base[None] + rng.normal(0, 0.1, (n, h, w)), 0.0, 1.0)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _assert_kernel_parity(name, got, want):
    torch.cuda.synchronize()
    err, ok = parity.kernel_parity(name, got, want)
    assert ok, f"{name}: max|d| {err} over {parity.KERNEL_TOL[name]}"


@pytest.mark.parametrize("shape", [(3, 64, 96), (2, 33, 129), (2, 5, 7),
                                   (1, 512, 512), (2, 1024, 1100)])
def test_box_stats_kernel(dev, shape):
    x = _batch(1, *shape, dev)
    _assert_kernel_parity("box_stats", kernels.box_stats(x),
                          M._lv_box_stats_plain(x))


@pytest.mark.parametrize("shape", [(2, 512, 512), (2, 33, 129)])
def test_box_stats_kernel_near_flat(dev, shape):
    # variances of a few float32 ulps: the one-pass float64 moments against
    # the plain version's float32 std
    x = 0.5 + 1e-3 * (_batch(27, *shape, dev) - 0.45)
    x[1] = 0.25
    _assert_kernel_parity("box_stats", kernels.box_stats(x),
                          M._lv_box_stats_plain(x))


@pytest.mark.parametrize("shape", [(3, 64, 80), (3, 33, 129), (2, 5, 7),
                                   (2, 512, 512), (2, 1, 1), (2, 1, 200),
                                   (2, 150, 1), (2, 20, 30), (2, 150, 300),
                                   (2, 150, 140), (2, 1024, 1100)])
def test_unsharp_kernel(dev, shape):
    x = _batch(2, *shape, dev)
    n = shape[0]
    rad = torch.linspace(0.6, 3.0, n, device=dev)
    amt = torch.linspace(0.3, 1.5, n, device=dev)
    _assert_kernel_parity("unsharp", kernels.unsharp(x, rad, amt),
                          F.unsharp_mask_plain(x, rad, amt))


def _equal_nan(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


# every r_eff = floor(4 sigma + 0.5) from 0 to 12, and one above 12
# (tests/test_torch_unsharp_sched.py)
UNSHARP_SIGMAS = [0.0, 0.1, 0.25, 0.5, 0.8, 1.0, 1.25, 1.5, 1.75, 2.0, 2.25,
                  2.5, 2.75, 3.0, 3.5]


@pytest.mark.parametrize("shape", [(150, 300), (512, 512), (1, 200),
                                   (150, 1)])
def test_unsharp_kernel_every_support(dev, shape):
    n = len(UNSHARP_SIGMAS)
    x = _batch(20, n, *shape, dev)
    rad = torch.tensor(UNSHARP_SIGMAS, device=dev)
    amt = torch.linspace(0.3, 1.5, n, device=dev)
    got = kernels.unsharp(x, rad, amt)
    assert torch.equal(got, F.unsharp_mask_plain(x, rad, amt))
    assert torch.equal(got, kernels.unsharp(x, rad, amt))


@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_unsharp_kernel_non_finite(dev, value):
    # pixels 5 to 12 beyond a tile edge (row 64, column 128), past the
    # support of radius 1.0 (r_eff 4) and 0.8 (3), and NaN taps (radius NaN)
    x = _batch(21, 3, 150, 300, "cpu")
    for img, i, j in ((0, 30, 133), (0, 75, 200), (1, 100, 119),
                      (1, 149, 299), (0, 10, 10), (2, 70, 70)):
        x[img, i, j] = value
    x = x.to(dev)
    rad = torch.tensor([1.0, 0.8, float("nan")], device=dev)
    amt = torch.tensor([0.6, 1.0, 0.6], device=dev)
    got = kernels.unsharp(x, rad, amt)
    want = F.unsharp_mask_plain(x, rad, amt)
    assert bool(torch.isnan(want).any())
    _equal_nan(got, want)
    _equal_nan(got, kernels.unsharp(x, rad, amt))


@pytest.mark.parametrize("shape,tile", [((2, 96, 80), 16), ((2, 64, 48), 8),
                                        ((2, 60, 52), 16), ((2, 5, 7), 16),
                                        ((2, 1, 9), 4), ((2, 512, 512), 16)])
def test_clahe_kernel(dev, shape, tile):
    x = _batch(3, *shape, dev)
    clip = torch.tensor([0.02, 0.05], device=dev)
    got = kernels.clahe(x, clip, tile)
    assert got.shape == x.shape
    _assert_kernel_parity("clahe", got, C.clahe_plain(x, clip, tile))


def _adversarial(n, h, w, device):
    """Image 0: every pixel in one bin; 1: half the image clipped below 0 and
    above 1; 2: flat at a bin edge with one bright square
    (tests/test_torch_clahe_sched.py)."""
    x = _batch(28, n, h, w, "cpu")
    x[0] = 0.3
    if n > 1:
        x[1, : h // 2] = -0.5
        x[1, h // 2:, : w // 3] = 1.7
    if n > 2:
        x[2] = 0.5
        x[2, h // 3: h // 3 + 8, w // 3: w // 3 + 8] = 0.99
    return x.to(device)


@pytest.mark.parametrize("shape,tile", [((3, 72, 60), 12), ((3, 128, 96), 32),
                                        ((3, 37, 83), 8), ((3, 16, 16), 16),
                                        ((3, 60, 52), 16), ((3, 4, 4), 16),
                                        ((3, 2048, 2048), 16)])
@pytest.mark.parametrize("data", ["wavy", "adversarial"])
def test_clahe_kernel_tiles_and_repeats(dev, shape, tile, data):
    # tile sizes 8, 12, 16, 32, extents that are not multiples of the tile,
    # single-tile images, adversarial histograms; the LUT stage and the
    # remap against their plain versions, and two runs bit-equal
    x = (_batch(29, *shape, dev) if data == "wavy"
         else _adversarial(*shape, dev))
    clip = torch.tensor([0.01, 0.02, 0.05], device=dev)
    got = kernels.clahe(x, clip, tile)
    assert torch.equal(got, kernels.clahe(x, clip, tile))
    _assert_kernel_parity("clahe", got, C.clahe_plain(x, clip, tile))
    n, h, w = shape
    if h % tile == 0 and w % tile == 0:
        luts = kernels.clahe_luts(x, clip, tile)
        assert torch.equal(luts, kernels.clahe_luts(x, clip, tile))
        _assert_kernel_parity("clahe", luts, C.clahe_luts_plain(
            torch.clamp(x, 0.0, 1.0), clip, tile))


@pytest.mark.parametrize("shape", [(3, 48, 64), (3, 100, 36), (3, 256, 256),
                                   (2, 5, 7), (3, 33, 129), (2, 1024, 1100)])
def test_tv_kernel_pixels_and_iterations(dev, shape):
    x = _batch(5, *shape, dev)
    w = torch.tensor([0.05, 0.1, 0.02], device=dev)[:shape[0]]
    got, it_k = kernels.tv_chambolle(x, w)
    want, it_p = T.tv_chambolle_plain(x, w)
    assert it_k.tolist() == it_p.tolist()
    _assert_kernel_parity("tv_chambolle", got, want)
    assert kernels.TV_LAST_SOLVE == _tv_schedule(it_p.tolist(),
                                                 kernels.tv_steps())


def _tv_schedule(counts, steps, max_iter=200):
    """The TV wrapper's loop for these counts: it reads the flags every 16
    iterations and stops at the first read after the last image stopped."""
    end = min(16 * -(-max(counts) // 16), max_iter)
    return {"steps": steps, "launches": -(-end // steps),
            "host_reads": len(range(16, min(end + 1, max_iter), 16))}


def test_tv_kernel_iteration_cap(dev):
    # eps = 0 never stops early: caps 1 .. 2s + 1 end the last launch at
    # every offset, and every cap that is not a multiple of s runs a short
    # last launch
    x = _batch(6, 2, 32, 32, dev)
    w = torch.full((2,), 0.05, device=dev)
    for cap in (*range(1, 2 * kernels.tv_steps() + 2), 17):
        got, it = kernels.tv_chambolle(x, w, 0.0, cap)
        want, it_p = T.tv_chambolle_plain(x, w, 0.0, cap)
        assert it.tolist() == [cap, cap] == it_p.tolist()
        _assert_kernel_parity("tv_chambolle", got, want)


def test_tv_kernel_mixed_stops(dev):
    # one batch whose images stop in different launches (8, 17 and 32
    # iterations, tests/test_torch_tv_blocked.py): each image's output comes
    # from the dual buffer of its own last launch
    x = _batch(7, 1, 40, 56, dev).repeat(3, 1, 1)
    w = torch.tensor([0.01, 0.03, 0.5], device=dev)
    got, it_k = kernels.tv_chambolle(x, w)
    want, it_p = T.tv_chambolle_plain(x, w)
    assert it_k.tolist() == it_p.tolist()
    s = kernels.tv_steps()
    assert len({(c - 1) // s for c in it_p.tolist()}) == 3
    _assert_kernel_parity("tv_chambolle", got, want)


@pytest.mark.parametrize("shape", [(2, 256, 256), (3, 129, 77), (1, 1, 40),
                                   (1, 40, 1), (1, 2, 37), (1, 37, 2),
                                   (1, 1, 1), (1, 2, 2), (2, 512, 512)])
@pytest.mark.parametrize("d", [3, 5, 9, 1, 7])
def test_bilateral_kernel(dev, shape, d):
    x = _batch(10, *shape, dev)
    n = shape[0]
    sc = torch.linspace(0.03, 0.2, n, device=dev)
    ss = torch.linspace(0.05, 0.5, n, device=dev)
    _assert_kernel_parity("bilateral", kernels.bilateral(x, d, sc, ss),
                          B.bilateral_plain(x, d, sc, ss))
    kernels.reset_launches()
    _assert_kernel_parity("bilateral", B.bilateral(x, d, sc, ss),
                          B.bilateral_plain(x, d, sc, ss))
    assert kernels.LAUNCHES["bilateral"] == 1


@pytest.mark.parametrize("d", [1, 3, 5, 7, 9])
def test_bilateral_kernel_exact(dev, d):
    # per-image sigmas, sigma_color 0 (NaN everywhere), sigma_space 0, NaN
    # pixels inside and at a corner; two runs bit-equal
    x = _batch(22, 4, 150, 140, "cpu")
    x[2, 33, 40] = float("nan")
    x[2, 0, 0] = float("nan")
    x = x.to(dev)
    sc = torch.tensor([0.0, 0.07, 0.05, 0.2], device=dev)
    ss = torch.tensor([0.05, 0.0, 0.3, 0.5], device=dev)
    got = kernels.bilateral(x, d, sc, ss)
    want = B.bilateral_plain(x, d, sc, ss)
    assert bool(torch.isnan(want[0]).all())
    _equal_nan(got, want)
    _equal_nan(got, kernels.bilateral(x, d, sc, ss))


@pytest.mark.parametrize("d", [0, -3])
def test_bilateral_d_off_returns_input(dev, d):
    x = _batch(11, 2, 32, 32, dev)
    kernels.reset_launches()
    assert B.bilateral(x, d, 0.05, 0.05) is x
    assert kernels.LAUNCHES["bilateral"] == 0


def test_bilateral_wrapper_refuses(dev):
    x = _batch(12, 2, 32, 32, dev)
    one = torch.full((2,), 0.05, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bilateral(x.cpu(), 5, one.cpu(), one.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.bilateral(x.transpose(1, 2), 5, one, one)
    with pytest.raises(ValueError, match="float32"):
        kernels.bilateral(x.double(), 5, one, one)
    with pytest.raises(ValueError, match="odd"):
        kernels.bilateral(x, 4, one, one)


@pytest.mark.parametrize("shape,levels", [((2, 512, 512), 6),
                                          ((1, 2048, 2048), 8),
                                          ((3, 64, 48), 4), ((2, 96, 96), 3)])
@pytest.mark.parametrize("soft", [[True], [False], [True, False]])
@pytest.mark.parametrize("given_sigma", [True, False])
def test_wavelet_kernel(dev, shape, levels, soft, given_sigma):
    x = _batch(13, *shape, dev)
    n = shape[0]
    mask = torch.tensor((soft * n)[:n], device=dev)
    sigma = (torch.linspace(0.02, 0.1, n, device=dev) if given_sigma
             else None)
    kernels.reset_launches()
    got = W.denoise_wavelet(x, sigma, wavelet_levels=levels, soft_mask=mask)
    assert kernels.LAUNCHES["wavelet_denoise"] == 1
    _assert_kernel_parity("wavelet_denoise", got, W.denoise_wavelet_plain(
        x, sigma, wavelet_levels=levels, soft_mask=mask))


@pytest.mark.parametrize("shape,levels", [((2, 512, 512), 6),
                                          ((1, 2048, 2048), 8),
                                          ((2, 256, 512), 7), ((2, 6, 10), 1),
                                          ((2, 24, 40), 3), ((2, 64, 128), 6)])
def test_wavelet_kernel_exact_transform_and_repeats(dev, shape, levels):
    # the coarse stages at 512^2 (16 x 16, one level) and 2048^2 (64 x 64,
    # three), a non-square 5 + 2, the 2 x 2 patches of a one-level stage:
    # with sigma 0 (thresholds 0) the kernel's transform pair equals the
    # plain version's bit for bit; sigma given and sigma None repeat
    # bit for bit and stay within KERNEL_TOL
    x = _batch(30, *shape, dev)
    n = shape[0]
    mask = torch.arange(n, device=dev) % 2 == 0
    zero = torch.zeros(n, device=dev)
    assert torch.equal(
        kernels.wavelet_denoise(x, zero, mask, levels),
        W.denoise_wavelet_plain(x, zero, wavelet_levels=levels,
                                soft_mask=mask))
    sigma = torch.linspace(0.03, 0.09, n, device=dev)
    got = kernels.wavelet_denoise(x, sigma, mask, levels)
    assert torch.equal(got, kernels.wavelet_denoise(x, sigma, mask, levels))
    _assert_kernel_parity("wavelet_denoise", got, W.denoise_wavelet_plain(
        x, sigma, wavelet_levels=levels, soft_mask=mask))
    got = W.denoise_wavelet(x, wavelet_levels=levels, soft_mask=mask)
    assert torch.equal(got, W.denoise_wavelet(x, wavelet_levels=levels,
                                              soft_mask=mask))
    _assert_kernel_parity("wavelet_denoise", got, W.denoise_wavelet_plain(
        x, wavelet_levels=levels, soft_mask=mask))


def test_wavelet_zero_sigma_and_flat_image(dev):
    x = _batch(14, 3, 64, 64, dev)
    x[1] = 0.5
    sigma = torch.tensor([0.0, 0.05, 0.05], device=dev)
    mask = torch.tensor([True, False, True], device=dev)
    _assert_kernel_parity(
        "wavelet_denoise", kernels.wavelet_denoise(x, sigma, mask, 3),
        W.denoise_wavelet_plain(x, sigma, wavelet_levels=3, soft_mask=mask))


def test_wavelet_gate_runs_plain_off_the_gate(dev):
    x = _batch(15, 2, 60, 64, dev)
    kernels.reset_launches()
    W.denoise_wavelet(x, wavelet_levels=3)              # 60 not / 8
    W.denoise_wavelet(x[:, :56], wavelet="db2", wavelet_levels=2)
    assert kernels.LAUNCHES["wavelet_denoise"] == 0


def test_wavelet_wrapper_refuses(dev):
    x = _batch(16, 2, 64, 64, dev)
    sig = torch.full((2,), 0.05, device=dev)
    soft = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.wavelet_denoise(x.cpu(), sig.cpu(), soft.cpu(), 3)
    with pytest.raises(ValueError, match="float32"):
        kernels.wavelet_denoise(x.double(), sig, soft, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.wavelet_denoise(x.transpose(1, 2), sig, soft, 3)
    with pytest.raises(ValueError, match="divisible"):
        kernels.wavelet_denoise(x[:, :60].contiguous(), sig, soft, 3)
    with pytest.raises(ValueError, match="bool"):
        kernels.wavelet_denoise(x, sig, soft.float(), 3)


def test_autotune_card_against_cpu(dev):
    from mdx_torch.core import tuning

    img = _batch(17, 1, 128, 128, "cpu")[0].numpy()
    kernels.reset_launches()
    plan, enh, recs = tuning.autotune(img, ["noise", "blur"], device=dev)
    for k in ("box_stats", "clahe", "unsharp", "wavelet_denoise"):
        assert kernels.LAUNCHES[k] > 0, kernels.LAUNCHES
    c_plan, c_enh, c_recs = tuning.autotune(img, ["noise", "blur"],
                                            device="cpu")
    assert len(recs) == 27 and sum(r.chosen for r in recs) == 1
    for a, b in zip(recs, c_recs):
        assert abs(a.score - b.score) <= 1e-4    # rounded to 4 places
    if plan.params != c_plan.params:             # a last-ulp tie
        i = next(r.iteration for r in recs if r.chosen) - 1
        j = next(r.iteration for r in c_recs if r.chosen) - 1
        assert abs(recs[i].score - recs[j].score) <= 1e-4
    else:
        np.testing.assert_allclose(enh, c_enh, rtol=0,
                                   atol=parity.PIXEL_ATOL)


def test_wrappers_check_their_inputs(dev):
    x = _batch(7, 2, 32, 32, dev)
    one = torch.ones(2, device=dev)
    with pytest.raises(ValueError, match="float32"):
        kernels.box_stats(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.unsharp(x.transpose(1, 2), one, one)
    with pytest.raises(ValueError, match="shape"):
        kernels.clahe(x, torch.ones(3, device=dev), 16)
    with pytest.raises(ValueError, match="nbins"):
        kernels.clahe(x, one, 16, nbins=128)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.tv_chambolle(x, torch.ones(2))


def test_launch_counters_count_wrapper_launches(dev):
    x = _batch(8, 2, 64, 64, dev)
    one = torch.ones(2, device=dev)
    kernels.reset_launches()
    kernels.box_stats(x)
    kernels.unsharp(x, one, one)
    kernels.clahe(x, one * 0.02, 16)
    kernels.tv_chambolle(x, one * 0.05)
    kernels.bilateral(x, 5, one * 0.05, one * 0.05)
    kernels.wavelet_denoise(x, one * 0.05, one.bool(), 3)
    kernels.clahe_remap_ext(x, _lut_ext(x, 16), 16)
    p = torch.zeros((2, 2, 64, 64), device=dev)
    kernels.tv_shard_step(x, p, torch.empty_like(p), one.int(), one * 0.05,
                          None, None, (64, 64, 0, 0, 4), 4)
    kernels.LAUNCHES["clahe"] -= 1      # _lut_ext's LUT stage
    assert kernels.LAUNCHES == {k: 1 for k in kernels.LAUNCHES}
    F.unsharp_mask_plain(x, one, one)
    assert kernels.LAUNCHES["unsharp"] == 1


def test_qa_slice_card_against_cpu(dev):
    x = _batch(9, 2, 96, 96, dev)
    from mdx_torch import OP_ORDER, plan_from_numpy

    static = {"ops": OP_ORDER, "bilateral_d": 5, "plan_order": OP_ORDER}
    dyn = {"clahe_clip_limit": 0.02, "gamma": 0.95, "unsharp_radius": 1.0,
           "unsharp_amount": 0.6, "tv_denoise_weight": 0.05}
    kernels.reset_launches()
    card = qa.qa_plan(x, *plan_from_numpy(static, dyn, dev))
    dense = {k: v for k, v in kernels.LAUNCHES.items()
             if k not in SC.SPATIAL_KERNELS}
    assert all(v > 0 for v in dense.values()), kernels.LAUNCHES
    cpu = qa.qa_plan(x.cpu(), *plan_from_numpy(static, dyn, "cpu"))
    bad = parity.breaches(parity.flatten_result(card, parity.QA_PLAN_FIELDS),
                          parity.flatten_result(cpu, parity.QA_PLAN_FIELDS),
                          tv_ran=True)
    assert not bad, "\n".join(bad)


def _lut_ext(x, tile):
    """The block's LUTs (kernel C's LUT stage) with halo rows taken from the
    opposite edge, so the interior and edge halos differ, and edge columns."""
    n = x.shape[0]
    lut = clahe_sp.clahe_luts(x, torch.linspace(0.01, 0.05, n,
                                                device=x.device), tile)
    lut = torch.cat([lut[:, -1:], lut, lut[:, :1]], dim=1)
    return torch.cat([lut[:, :, :1], lut, lut[:, :, -1:]], dim=2).contiguous()


@pytest.mark.parametrize("shape,tile", [((1, 512, 2048), 16),
                                        ((2, 48, 77), 16), ((2, 33, 129), 8),
                                        ((3, 64, 64), 32)])
def test_clahe_remap_ext_kernel(dev, shape, tile):
    x = _batch(20, *shape, dev)
    lut_ext = _lut_ext(x, tile)
    kernels.reset_launches()
    got = kernels.clahe_remap_ext(x, lut_ext, tile)
    assert kernels.LAUNCHES["clahe_remap_ext"] == 1
    _assert_kernel_parity("clahe_remap_ext", got,
                          clahe_sp.remap_ext_plain(x, lut_ext, tile))


@pytest.mark.parametrize("shape,tile", [((2, 512, 512), 16), ((1, 96, 64), 32)])
def test_clahe_lut_stage(dev, shape, tile):
    x = _batch(22, *shape, dev)
    clip = torch.full((shape[0],), 0.03, device=dev)
    _assert_kernel_parity("clahe", kernels.clahe_luts(x, clip, tile),
                          C.clahe_luts_plain(x, clip, tile))


def _shard_args(dev, shape, place, seed, hw=None, m=None, null=None):
    """Arguments of one blocked launch of kernel 12 on a block of ``shape``
    (its steps m and halo width hw default to the kernel's s): "whole" the
    image, "top"/"interior"/"bottom" the first, middle or last of three row
    blocks, "tile" the middle tile of a 3 x 3 grid (column slabs, corners
    included); ``null``: one slab left out (zeros), or "right" for a tile
    at the image's right edge.  Images 0 and 2 active, 1 stopped."""
    n, h, w = shape
    s = kernels.tv_steps()
    hw = s if hw is None else hw
    m = hw if m is None else m
    x = _batch(seed, n, h, w, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *sh: 0.05 * torch.randn(*sh, device=dev,  # noqa: E731
                                         generator=g)
    rows, cols = {"whole": (1, 1), "top": (3, 1), "interior": (3, 1),
                  "bottom": (3, 1), "tile": (3, 3)}[place]
    row0 = {"top": 0, "bottom": 2 * h}.get(place, h if rows > 1 else 0)
    col0 = (2 * w if null == "right" else w) if cols > 1 else 0
    geo = (rows * h, cols * w, row0, col0, hw)

    def slabs(planes, level):
        val = lambda *sh: level + rnd(n, planes, *sh)  # noqa: E731
        return {"up": None if row0 == 0 else val(hw, w),
                "dn": None if row0 + h == rows * h else val(hw, w),
                "lf": val(h + 2 * hw, hw) if col0 else None,
                "rt": val(h + 2 * hw, hw) if col0 + w < cols * w else None}

    xs, ps = slabs(1, 0.5), slabs(2, 0.0)
    for sl in (xs, ps):
        if null in sl:
            sl[null] = None
    active = torch.tensor([1, 0, 1][:n] if n > 1 else [1],
                          dtype=torch.int32, device=dev)
    weight = torch.linspace(0.03, 0.1, n, device=dev)
    p_in = rnd(n, 2, h, w)
    order = ("up", "dn", "lf", "rt")
    return (x, p_in, rnd(n, 2, h, w), active, weight,
            tuple(xs[k] for k in order), tuple(ps[k] for k in order), geo,
            m)


SHARD_SHAPES = [(1, 512, 2048), (1, 1024, 1024), (2, 48, 77), (3, 33, 129),
                (2, 5, 7)]


@pytest.mark.parametrize("shape", SHARD_SHAPES)
@pytest.mark.parametrize("place", ["whole", "top", "interior", "bottom",
                                   "tile"])
def test_tv_shard_step_kernel(dev, shape, place):
    # the blocked step (s iterations) against its plain version, and two
    # runs bit-equal
    args = _shard_args(dev, shape, place, 21)
    kernels.reset_launches()
    err, ok = SC.compare_call("tv_shard_step", args)
    assert kernels.LAUNCHES["tv_shard_step"] == 1
    assert ok, f"tv_shard_step: max|d| {err}"
    a, b = SC._clone(args), SC._clone(args)
    assert torch.equal(kernels.tv_shard_step(*a), kernels.tv_shard_step(*b))
    assert torch.equal(a[2], b[2])


# the step on an interior tile with every slab, or one of them null
# (zeros), or at the image's right edge; and launches shorter than the
# halo, thin halos of a block thinner than s
@pytest.mark.parametrize("null,hw,m", [
    (None, 4, 4), ("up", 4, 4), ("dn", 4, 4), ("lf", 4, 4), ("rt", 4, 4),
    ("right", 4, 4), (None, 4, 1), (None, 4, 3), (None, 3, 3), (None, 2, 1),
    (None, 1, 1)])
def test_tv_shard_step_column_halos(dev, null, hw, m):
    args = _shard_args(dev, (2, 64, 64), "tile", 25, hw=hw, m=m, null=null)
    kernels.reset_launches()
    err, ok = SC.compare_call("tv_shard_step", args)
    assert kernels.LAUNCHES["tv_shard_step"] == 1
    assert ok, f"tv_shard_step: max|d| {err}"


def _rebuild_args(dev, shape, place, seed):
    """A rebuild after a loop of s-iteration launches: image 0 stopped in
    the first launch (a = 0), 1 in an even one, 2 in an odd one, with r
    from 0 to s - 1; each buffer with its own slabs."""
    x, pe, po, _, weight, xs, se, geo, m = _shard_args(dev, shape, place,
                                                       seed)
    _, _, _, _, _, _, so, _, _ = _shard_args(dev, shape, place, seed + 1)
    n = shape[0]
    s = kernels.tv_steps()
    base = torch.tensor([0, 2 * s, 3 * s][:n], dtype=torch.int32, device=dev)
    iters = base + torch.tensor([2, s, 1][:n], dtype=torch.int32, device=dev)
    return x, pe, po, iters, base, weight, xs, se, so, geo, m


@pytest.mark.parametrize("shape", SHARD_SHAPES)
@pytest.mark.parametrize("place", ["whole", "top", "interior", "bottom",
                                   "tile"])
def test_tv_shard_rebuild_kernel(dev, shape, place):
    args = _rebuild_args(dev, shape, place, 31)
    kernels.reset_launches()
    err, ok = SC.compare_call("tv_shard_rebuild", args)
    assert kernels.LAUNCHES["tv_shard_step"] == 1
    assert ok, f"tv_shard_rebuild: max|d| {err}"
    assert torch.equal(kernels.tv_shard_rebuild(*args),
                       kernels.tv_shard_rebuild(*args))


def test_tv_shard_finalize_kernel(dev):
    # the stop rule over a launch's global sums against its plain version:
    # the first launch (E_0), then one in which image 1 stops at its third
    # iteration; e0, e_prev, active, iters and base all equal
    s = kernels.tv_steps()
    w = torch.tensor([0.05, 0.1, 0.02], device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    first = torch.rand(3, s, 2, dtype=torch.float64, device=dev,
                       generator=g) + 1.0
    later = first.flip(1) + 0.5       # no energy repeats the one before
    later[1, 2:] = later[1, 1]
    def state():
        i32 = dict(dtype=torch.int32, device=dev)
        return [torch.zeros(3, device=dev), torch.zeros(3, device=dev),
                torch.ones(3, **i32), torch.zeros(3, **i32),
                torch.zeros(3, **i32)]

    got, want = state(), state()
    for a, sums in ((0, first), (s, later)):
        kernels.tv_shard_finalize(sums, w, *got, a, 1e-6, 4096.0)
        tv_sp.tv_shard_finalize_plain(sums, w, *want, a, 1e-6, 4096.0)
        torch.cuda.synchronize()
        for u, v in zip(got, want):
            assert torch.equal(u, v), (a, u, v)
    assert got[2].tolist() == [1, 0, 1] and got[3].tolist()[1] == s + 3


def test_sharded_tv_solve_on_a_2x2_grid_over_gloo(dev):
    """Four ranks on the card (gloo), a 2 x 2 grid of tiles: the kernel
    solve equals the plain 2-D body and the dense kernel, with equal
    iteration counts."""
    x = _batch(26, 2, 128, 96, "cpu").numpy()
    w = torch.tensor([0.1, 0.02])
    res = launch.run(launch.call_each, x, n_space=(2, 2), device="cuda",
                     timeout_s=300, calls=[
                         (tv_sp.tv_sharded, (Block(0), w), {}),
                         (tv_sp.tv_sharded_plain, (Block(0), w), {})])
    tiles = lambda i: launch.assemble(  # noqa: E731
        [{"t": r[i][0]} for r in res.results], 1, (2, 2),
        block_keys=("t",))["t"]
    dense, it = kernels.tv_chambolle(torch.from_numpy(x).to(dev), w.to(dev))
    for r in res.results:
        assert r[0][1].tolist() == r[1][1].tolist() == it.tolist()
    np.testing.assert_array_equal(tiles(0), tiles(1))
    _assert_kernel_parity("tv_shard_step", torch.from_numpy(tiles(0)),
                          dense.cpu())


def test_probe_suite_all_ok(dev):
    """Kernel 13: the 18 capability probes build (one nvcc each) and equal
    their plain versions."""
    from mdx_torch.tools import probe_nvcc as PN

    res = PN.run_suite()
    assert set(res) == set(PN.PROBES)
    bad = {n: r for n, r in res.items()
           if r["result"] != "ok" or not r["library_equal"]}
    assert not bad, bad


def test_spatial_wrappers_refuse(dev):
    x = _batch(23, 2, 64, 64, dev)
    lut = _lut_ext(x, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.clahe_remap_ext(x.cpu(), lut.cpu(), 16)
    with pytest.raises(ValueError, match="lut_ext"):
        kernels.clahe_remap_ext(x, lut[:, 1:].contiguous(), 16)
    p = torch.zeros((2, 2, 64, 64), device=dev)
    one = torch.ones(2, device=dev)
    geo = (128, 64, 64, 0, 4)
    with pytest.raises(ValueError, match="int32"):
        kernels.tv_shard_step(x, p, p.clone(), one, one, None, None, geo, 4)
    with pytest.raises(ValueError, match="p_slabs.up"):
        kernels.tv_shard_step(x, p, p.clone(), one.int(), one, None,
                              (torch.zeros(2, 2, 3, 64, device=dev), None,
                               None, None), geo, 4)
    with pytest.raises(ValueError, match="halo"):
        kernels.tv_shard_step(x, p, p.clone(), one.int(), one, None, None,
                              (128, 64, 64, 0, 2), 4)
    with pytest.raises(ValueError, match="outside"):
        kernels.tv_shard_step(x, p, p.clone(), one.int(), one, None, None,
                              (100, 64, 64, 0, 4), 4)


def test_sharded_tv_solve_on_one_card_over_gloo(dev):
    """Two ranks on the card (gloo): the kernel solve equals the plain one
    and the dense kernel, with equal iteration counts."""
    x = _batch(24, 2, 128, 96, "cpu").numpy()
    w = torch.tensor([0.1, 0.02])
    res = launch.run(launch.call_each, x, n_space=2, device="cuda",
                     timeout_s=300, calls=[
                         (tv_sp.tv_sharded, (Block(0), w), {}),
                         (tv_sp.tv_sharded_plain, (Block(0), w), {})])
    assert res.backend == "gloo"
    assert all(t > 0 for t in res.host_round_trips)
    got = np.concatenate([r[0][0] for r in res.results], axis=1)
    plain = np.concatenate([r[1][0] for r in res.results], axis=1)
    dense, it = kernels.tv_chambolle(torch.from_numpy(x).to(dev), w.to(dev))
    for r in res.results:
        assert r[0][1].tolist() == r[1][1].tolist() == it.tolist()
    np.testing.assert_array_equal(got, plain)
    _assert_kernel_parity("tv_shard_step", torch.from_numpy(got), dense.cpu())


def test_sharded_tv_schedule_cases_over_gloo(dev):
    """Two ranks on the card (gloo), kernel solve against plain, bit for
    bit with equal counts: caps 1 .. 2s + 1 (eps = 0: the last launch ends
    at every offset, short last launches), images that stop in different
    launches, and 3-row blocks (3 iterations a launch, 3-row halos)."""
    s = kernels.tv_steps()
    x = _batch(27, 2, 128, 96, "cpu").numpy()
    mix = np.repeat(_batch(28, 1, 64, 96, "cpu").numpy(), 3, axis=0)
    thin = _batch(29, 2, 6, 40, "cpu").numpy()
    w, w_mix = torch.tensor([0.1, 0.02]), torch.tensor([0.01, 0.03, 0.5])
    cases = [((Block(0), w), dict(eps=0.0, max_iter=cap))
             for cap in range(1, 2 * s + 2)]
    cases += [((Block(1), w_mix), {}), ((Block(2), w), {})]
    calls = [c for args, kw in cases for c in (
        (tv_sp.tv_sharded, args, kw), (tv_sp.tv_sharded_plain, args, kw))]
    res = launch.run(launch.call_each, (x, mix, thin), n_space=2,
                     device="cuda", timeout_s=300, calls=calls)
    for r in res.results:
        for i in range(0, len(calls), 2):
            (got, it_k), (want, it_p) = r[i], r[i + 1]
            assert it_k.tolist() == it_p.tolist(), i
            np.testing.assert_array_equal(got, want)
        for i, cap in enumerate(range(1, 2 * s + 2)):
            assert r[2 * i][1].tolist() == [cap, cap]
        assert len({(c - 1) // s for c in r[-4][1].tolist()}) == 3


def test_select_matmul_probe_equals_plain(dev):
    """The redesigned iota_select_matmul_deinterleave probe (the two kept
    terms of each output) equals the plain version bit for bit, twice."""
    from mdx_torch.tools import probe_nvcc as PN

    name = "iota_select_matmul_deinterleave"
    built = PN.build([name])[name]
    x = PN.probe_input(name, dev)
    got = PN.launch(name, built, x)
    assert torch.equal(got, PN.plain_output(name, x))
    assert torch.equal(got, PN.launch(name, built, x))


def test_spatial_check_replays_every_recorded_wrapper(dev):
    """``spatial_check.rank_check`` on 2 ranks of the card: rank 0 records
    calls of kernels 11 and 12 and of CLAHE's LUT stage, and each replays
    within its tolerance."""
    from mdx_torch.tools import bench_plan, make_batch

    res = launch.run(SC.rank_check, make_batch(1, 256, seed=4),
                     *bench_plan("cpu"), n_space=2, device="cuda",
                     timeout_s=300, reps=1)
    replay = res.results[0]["replay"]
    assert set(replay) == set(SC.RECORDED)
    for name, (n_calls, err, ok) in replay.items():
        assert n_calls > 0 and ok, (name, err)


@pytest.mark.parametrize("kind", ["noisy", "low_contrast", "clipped"])
def test_run_pipeline_card_against_cpu(dev, tmp_path, monkeypatch, kind):
    """The single-image runner at 256^2, deterministic and autotune: the
    card's run against the CPU's by ``parity.compare_runs``, and the
    kernels of the path launched."""
    from mdx_torch.io import write_synthetic_dicom
    from mdx_torch.pipeline.runner import run_pipeline

    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    path = write_synthetic_dicom(str(tmp_path / f"{kind}.dcm"), kind=kind,
                                 size=256)
    for autotune in (False, True):
        kernels.reset_launches()
        got = run_pipeline(path, str(tmp_path / "card"), autotune=autotune,
                           device=dev)
        assert kernels.LAUNCHES["box_stats"] > 0
        want = run_pipeline(path, str(tmp_path / "cpu"), autotune=autotune,
                            device="cpu")
        bad, _reported = parity.compare_runs(got, want)
        assert not bad, (autotune, bad)


def test_run_pipeline_batch_card_against_cpu(dev, tmp_path, monkeypatch):
    """The batch runner on a 4-frame 256^2 12-bit series, raw and
    windowed: the card's records against the CPU's within
    ``mdx_torch.parity``; a resumed run skips every frame."""
    from mdx_torch.io import write_synthetic_dicom
    from mdx_torch.pipeline.batch_runner import run_pipeline_batch

    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    path = write_synthetic_dicom(str(tmp_path / "s.dcm"), kind="phantom",
                                 size=256, frames=4, window_center=40.0,
                                 window_width=400.0)
    for window in (False, True):
        got = run_pipeline_batch(path, str(tmp_path / "card"),
                                 window=window, device=dev)
        want = run_pipeline_batch(path, str(tmp_path / "cpu"),
                                  window=window, device="cpu",
                                  save_artifacts=False)
        assert [f["frame"] for f in got["frames"]] == [0, 1, 2, 3]
        assert not parity.breaches(parity.flatten_batch(got["frames"]),
                                   parity.flatten_batch(want["frames"]),
                                   hw=256 * 256)
    again = run_pipeline_batch(path, str(tmp_path / "card"), resume=True,
                               device=dev)
    assert again["skipped"] == 4 and again["frames"] == []


def test_stream_uploads_through_a_copy_stream(dev, tmp_path):
    """``stream_batches`` on the card: every batch equals its decoded
    frames, on the card, start indices in order; and the upload ring
    itself with frames of one value each, a consumer slower than the
    copies and every batch kept to the end: no pinned buffer or device
    block was reused before its copy or its consumer was done."""
    from mdx_torch.io import load_dicom, normalize_image, write_synthetic_dicom
    from mdx_torch.parallel import stream

    paths = [write_synthetic_dicom(str(tmp_path / f"{i}.dcm"), kind="noisy",
                                   size=64, seed=i) for i in range(7)]
    want = np.stack([normalize_image(load_dicom(p)[0]) for p in paths])
    got = list(stream.stream_batches(paths, 3, device=dev))
    assert [s for s, _ in got] == [0, 3, 6]
    for s, t in got:
        assert t.is_cuda and torch.equal(
            t.cpu(), torch.from_numpy(want[s:s + 3]))

    up = stream._Uploader(dev)
    frames = stream.DecodeStream(
        list(range(24)), lambda i: np.full((256, 1024), float(i)),
        batch_size=4, device_put=up.put)
    kept = []
    for s, item in frames:
        t = up.take(item)
        # a slow consumer on its stream: later batches are copied meanwhile
        for _ in range(20):
            t.add_(0.0)
        torch.cuda._sleep(1_000_000)
        expect = torch.arange(s, s + 4, device=dev, dtype=torch.float32)
        assert torch.equal(t[:, 0, 0], expect) and bool(
            (t == expect[:, None, None]).all())
        kept.append((s, t))
    torch.cuda.synchronize()
    for s, t in kept:
        assert bool((t == torch.arange(s, s + 4, device=dev)[:, None, None]
                     ).all()), s


def test_sharded_qa_two_ranks_equal_one_on_the_card(dev):
    """``qa_deterministic_sharded`` at n_data = 2 (two gloo ranks on the
    card) against n_data = 1 on the valid images: issue masks and flags
    equal, the rest within ``parity.breaches``.  Not bit for bit: torch's
    reductions over [N, H·W] on the card sum in an order that depends on N
    (ROADMAP Queue 3; ``tools/data_check.py --invariance``)."""
    from mdx_torch.parallel import batch
    from mdx_torch.tools import make_batch

    x = make_batch(5, 128, seed=2)
    one, n1 = batch.qa_deterministic_sharded(x, 1, dev)
    two, n2 = batch.qa_deterministic_sharded(x, 2, dev)
    assert n1 == n2 == 5 and batch.LAST_LAUNCH["n_data"] == 2
    a = parity.flatten_result(one, parity.QA_DETERMINISTIC_FIELDS)
    b = parity.flatten_result(two, parity.QA_DETERMINISTIC_FIELDS)
    assert a.keys() == b.keys()
    assert all(v.shape[0] == 6 for v in b.values())
    b = {k: v[:5] for k, v in b.items()}
    for k, v in a.items():
        if v.dtype == bool:
            assert np.array_equal(v, b[k]), k
    bad = parity.breaches(b, a, hw=128 * 128)
    assert not bad, bad


def test_run_pipeline_jpeg_lossless_equals_its_twin_on_the_card(
        dev, tmp_path, monkeypatch):
    """A 512^2 JPEG Lossless SV1 (``.4.70``) file through ``run_pipeline``
    on the card: the host C++ decode ran, and the run's records (issues,
    ops, status, flags, metrics, enhanced image) are equal to its
    explicit-LE twin's, bit for bit: the same pixels reach the card."""
    from mdx_torch.io import native, write_synthetic_dicom
    from mdx_torch.io.dicom import TS_JPEG_LL_SV1
    from mdx_torch.pipeline.runner import run_pipeline

    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    kw = dict(kind="phantom", size=512, seed=3)
    comp = write_synthetic_dicom(str(tmp_path / "ll.dcm"),
                                 transfer_syntax=TS_JPEG_LL_SV1, **kw)
    twin = write_synthetic_dicom(str(tmp_path / "le.dcm"), **kw)
    native.reset_calls()
    kernels.reset_launches()
    got = run_pipeline(comp, str(tmp_path / "o"), device=dev,
                       save_artifacts=False)
    assert native.CALLS["jpegll_diffs"] > 0
    assert kernels.LAUNCHES["box_stats"] > 0
    want = run_pipeline(twin, str(tmp_path / "o"), device=dev,
                        save_artifacts=False)
    assert got["issues"] == want["issues"]
    assert got["applied_ops"] == want["applied_ops"]
    assert got["validation"].status == want["validation"].status
    a, b = parity.flatten_run(got), parity.flatten_run(want)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k
