"""mdx_torch ops against the JAX ops of the same name, on the CPU.

The same numpy inputs (``np.random.default_rng``) go through ``mdx.ops``
and ``mdx_torch.ops``.  Tolerances are those of tests/test_ops_golden.py
(the float32 drift policy); where the port keeps the JAX accumulation
order the results are bit-equal, and percentiles and histogram counts are
held to bit-equality.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdx.ops as J
from mdx.core import enhance as JE
from mdx.core import metrics as JM
from mdx.ops import filters as JF
from mdx.ops import hist as JH
from mdx.ops import tv as JTV
from mdx.ops import wavelet as JW
from mdx.refimpl import wavelet_np as WNP

import mdx_torch
from mdx_torch.core import enhance as TE
from mdx_torch.core import metrics as TM
from mdx_torch.ops import filters as TF
from mdx_torch.ops import hist as TH
from mdx_torch.ops import quantile as TQ
from mdx_torch.ops import ssim as TS
from mdx_torch.ops import tv as TTV
from mdx_torch.ops import wavelet as TW

torch.set_num_threads(1)


def _imgs(seed=0, n=3, h=64, w=80):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.4 + 0.25 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
    x = base[None] + rng.normal(0, 0.08, (n, h, w))
    x[-1] = np.round(x[-1] * 20) / 20          # heavy ties
    return np.clip(x, 0.0, 1.0).astype(np.float32)


X = _imgs()


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=atol)


# ---------------------------------------------------------------- contracts

@pytest.mark.parametrize("name,ours,theirs", [
    ("THRESHOLDS", mdx_torch.THRESHOLDS, JM.THRESHOLDS),
    ("ISSUE_ORDER", mdx_torch.ISSUE_ORDER, JM.ISSUE_ORDER),
    ("METRIC_KEYS", mdx_torch.METRIC_KEYS, JM.METRIC_KEYS),
    ("OP_ORDER", mdx_torch.OP_ORDER, JE.OP_ORDER),
    ("DETERMINISTIC_DEFAULTS", mdx_torch.DETERMINISTIC_DEFAULTS,
     JE.DETERMINISTIC_DEFAULTS),
    ("TV_MODES", mdx_torch.TV_MODES, JTV.TV_MODES),
])
def test_contract_constants_equal(name, ours, theirs):
    assert ours == theirs, name


def test_plan_defaults_equal():
    assert dataclasses.asdict(TE.PlanStatic()) == dataclasses.asdict(
        JE.PlanStatic())
    assert TE.PlanDynamic()._asdict() == {
        k: v for k, v in JE.PlanDynamic()._asdict().items()}


@pytest.mark.parametrize("wavelet", ["db1", "db2"])
def test_wavelet_constants_equal_refimpl(wavelet):
    np.testing.assert_array_equal(TW.FILTERS[wavelet], WNP.FILTERS[wavelet])
    for a, b in zip(TW.qmf_pair(wavelet), WNP.qmf_pair(wavelet)):
        np.testing.assert_array_equal(a, b)
    for shape in [(64, 64), (33, 47), (512, 512), (3, 3), (1, 5)]:
        assert TW.max_level(shape, wavelet) == WNP.max_level(shape, wavelet)
    assert TW.MAD_TO_SIGMA == WNP.MAD_TO_SIGMA


def test_tv_mode_resolution():
    assert TTV.resolve_tv_mode(None) == "ref"
    assert TTV.resolve_tv_mode(" FAST ") == "fast"
    assert TTV.tv_mode_params("fast") == JTV.tv_mode_params("fast")
    with pytest.raises(ValueError):
        TTV.resolve_tv_mode("quick")


# ----------------------------------------------------------------- filters

@pytest.mark.parametrize("mode", ["symmetric", "reflect", "edge", "constant"])
@pytest.mark.parametrize("pad", [(1, 1), (3, 2), (8, 7), (0, 4)])
def test_pad_axis_matches_jnp_pad(mode, pad):
    x = X[:, :9, :11]
    want = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), pad, (0, 0)), mode=mode))
    got = TF.pad_axis(_t(x), 1, pad[0], pad[1], mode)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("fn", ["laplace", "sobel_h", "sobel_v",
                                "gradient_magnitude"])
def test_stencils(fn):
    _close(getattr(TF, fn)(_t(X)), getattr(JF, fn)(jnp.asarray(X)), 2e-6)


@pytest.mark.parametrize("size", [7, 16])
def test_box_filter_and_local_variance(size):
    _close(TF.box_filter(_t(X), size), JF.box_filter(jnp.asarray(X), size), 3e-6)
    _close(TF.local_variance(_t(X), size),
           JF.local_variance(jnp.asarray(X), size), 3e-6)


@pytest.mark.parametrize("sigma", [0.2, 0.8, 1.7, 3.0])
def test_gaussian_blur_scalar_sigma(sigma):
    _close(TF.gaussian_blur(_t(X), sigma), JF.gaussian_blur(jnp.asarray(X), sigma),
           1e-5)


def test_gaussian_taps_and_per_image_sigma():
    s = np.array([0.5, 1.0, 2.5], np.float32)
    _close(TF._gauss_taps(_t(s)), JF._gauss_taps(jnp.asarray(s), jnp.float32),
           1e-7)
    _close(TF.gaussian_blur(_t(X), _t(s)),
           JF.gaussian_blur(jnp.asarray(X), jnp.asarray(s)), 1e-5)


@pytest.mark.parametrize("radius,amount", [(0.8, 0.5), (1.0, 0.6), (3.0, 1.5)])
def test_unsharp_mask(radius, amount):
    _close(TF.unsharp_mask(_t(X), radius, amount),
           JF.unsharp_mask(jnp.asarray(X), radius, amount), 1e-5)


@pytest.mark.parametrize("gamma", [0.6, 0.95, 1.05, 1.5])
def test_adjust_gamma(gamma):
    _close(TF.adjust_gamma(_t(X), gamma), JF.adjust_gamma(jnp.asarray(X), gamma),
           1e-5)


# ------------------------------------------------------ hist and quantile

QS = [0.0, 5.0, 25.0, 50.0, 75.0, 90.0, 95.0, 100.0]


@pytest.mark.parametrize("shape", [(3, 64, 80), (2, 7, 5), (1, 1, 3)])
def test_percentiles_bit_equal(shape):
    x = _imgs(1, *shape) if shape[1] > 1 else np.array([[[0.3, 0.1, 0.2]]],
                                                       np.float32)
    np.testing.assert_array_equal(_np(TQ.percentiles_exact(_t(x), QS)),
                                  np.asarray(JH.percentiles(jnp.asarray(x), QS)))


def test_percentiles_of_gradient_and_median_bit_equal():
    g = np.asarray(JF.gradient_magnitude(jnp.asarray(X)))
    np.testing.assert_array_equal(_np(TQ.percentiles_exact(_t(g), [90.0])),
                                  np.asarray(JH.percentiles(jnp.asarray(g), [90.0])))
    flat = np.abs(X.reshape(3, -1) - 0.5)
    from mdx.ops.quantile import median_rows

    np.testing.assert_array_equal(_np(TQ.median_rows(_t(flat))),
                                  np.asarray(median_rows(jnp.asarray(flat))))


def test_bin_indices_and_histograms_bit_equal():
    bins = 256
    k = np.arange(1, bins, dtype=np.float32)
    edges = k / bins
    vals = np.concatenate([edges, np.nextafter(edges, 0.0),
                           np.nextafter(edges, 1.0), [0.0, 1.0]]
                          ).astype(np.float32)[None]
    np.testing.assert_array_equal(
        _np(TH.bin_indices(_t(vals), bins)),
        np.asarray(JH.bin_indices(jnp.asarray(vals), bins)))
    np.testing.assert_array_equal(
        _np(TH.histogram01(_t(X), bins)),
        np.asarray(JH.histogram01(jnp.asarray(X), bins)))
    g = np.asarray(JF.gradient_magnitude(jnp.asarray(X)))
    hi = g.reshape(3, -1).max(-1) + np.float32(1e-8)
    np.testing.assert_array_equal(
        _np(TH.histogram_scaled(_t(g), 128, _t(hi))),
        np.asarray(JH.histogram_scaled(jnp.asarray(g), 128, jnp.asarray(hi))))


def test_entropy_from_hist():
    h = np.asarray(JH.histogram01(jnp.asarray(X), 256))
    _close(TH.entropy_from_hist(_t(h)), JH.entropy_from_hist(jnp.asarray(h)),
           1e-5)


# ------------------------------------------------------------------ wavelet

@pytest.mark.parametrize("wavelet", ["db1", "db2"])
@pytest.mark.parametrize("shape", [(64, 80), (33, 47)])
def test_dwt2_and_reconstruction(wavelet, shape):
    x = _imgs(2, 2, *shape)
    ll, det = TW.dwt2(_t(x), wavelet)
    jll, jdet = JW.dwt2(jnp.asarray(x), wavelet)
    _close(ll, jll, 1e-5)
    for a, b in zip(det, jdet):
        _close(a, b, 1e-5)
    _close(TW.idwt2(ll, det, wavelet, shape),
           JW.idwt2(jll, jdet, wavelet, shape), 1e-5)
    _close(TW.idwt2(ll, det, wavelet, shape), x, 1e-5)


def test_wavedec_waverec_roundtrip():
    lvl = TW.default_levels(X.shape[-2:])
    assert lvl == JW.default_levels(X.shape[-2:])
    ll, det, shapes = TW.wavedec2(_t(X), "db1", lvl)
    jll, jdet, jshapes = JW.wavedec2(jnp.asarray(X), "db1", lvl)
    assert [tuple(s) for s in shapes] == [tuple(s) for s in jshapes]
    _close(ll, jll, 1e-5)
    _close(TW.waverec2(ll, det, shapes, "db1"), X, 1e-5)


def test_estimate_sigma():
    _close(TW.estimate_sigma(_t(X)), JW.estimate_sigma(jnp.asarray(X)), 2e-5)


@pytest.mark.parametrize("kw", [
    {}, {"sigma": 0.05, "mode": "hard"},
    {"soft_mask": np.array([True, False, True])},
])
def test_denoise_wavelet(kw):
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    _close(TW.denoise_wavelet(_t(X), **tkw),
           JW.denoise_wavelet(jnp.asarray(X), **jkw), 5e-5)


# -------------------------------------------------------------- ssim / psnr

def test_ssim_psnr():
    y = np.clip(X * 0.9 + 0.03, 0, 1).astype(np.float32)
    _close(TS.ssim(_t(X), _t(y)), J.ssim(jnp.asarray(X), jnp.asarray(y)), 1e-4)
    _close(TS.psnr(_t(X), _t(y)), J.psnr(jnp.asarray(X), jnp.asarray(y)), 1e-3)
    assert np.isinf(_np(TS.psnr(_t(X), _t(X)))).all()


# ----------------------------------------------------- metric primitives

def test_edge_ratio_and_niqe():
    _close(TM.compute_edge_ratio(_t(X)),
           JM.compute_edge_ratio(jnp.asarray(X)), 1e-5)
    _close(TM.compute_niqe(_t(X)), JM.compute_niqe(jnp.asarray(X)), 1e-4)
