"""The wavelet denoise of mdx_torch (TPU kernel 10's op) against the JAX
package on the CPU, and its dispatch seam.

``denoise_wavelet_plain`` and ``denoise_wavelet`` on CPU tensors are held
against both JAX forms: ``mdx.ops.wavelet.denoise_wavelet`` (the XLA
branch, which the CPU backend takes) and ``wavelet_denoise_tpu`` in
``interpret=True`` mode, as tests/test_pallas.py runs it.  Tolerance:
2e-6, the bar tests/test_pallas.py holds the TPU kernel to against its XLA
branch (the port's plain version sums each band's squares in float64, the
JAX package in float32: the thresholds differ in the last ulp at most).
The CUDA kernel itself is tested on the card (tests/test_torch_cuda.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdx.ops import wavelet as JW
from mdx.ops.pallas_kernels import wavelet_denoise_tpu

from mdx_torch import kernels
from mdx_torch.ops import wavelet as TW

torch.set_num_threads(1)

ATOL = 2e-6


def _noisy(seed, n, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    x = base[None] + rng.normal(0, 0.08, (n, h, w))
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def _j_sigma(x):
    return JW.mad_sigma_from_hh(JW.dwt2(jnp.asarray(x), "db1")[1][2])


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@functools.cache
def _jax_case(case: str):
    """(x, sigma, soft mask, levels, XLA branch's output, Pallas kernel's
    output in interpret mode) for one case, computed once per session."""
    if case in ("soft", "hard"):
        x = _noisy(1, 2, 64, 64)
        sig, mask, lv = np.asarray(_j_sigma(x)), np.full(2, case == "soft"), 3
    elif case == "mixed":
        x = _noisy(2, 3, 64, 48)
        sig = np.array([0.03, 0.08, 0.05], np.float32)
        mask, lv = np.array([True, False, True]), 4
    else:                                   # sigma None, default levels
        x = _noisy(3, 2, 64, 64)
        sig, mask, lv = None, np.ones(2, bool), 3
    xla = JW.denoise_wavelet(jnp.asarray(x), sigma=sig, wavelet_levels=lv,
                             soft_mask=jnp.asarray(mask))
    pallas = wavelet_denoise_tpu(
        jnp.asarray(x), _j_sigma(x) if sig is None else jnp.asarray(sig),
        jnp.asarray(mask), lv, interpret=True)
    return x, sig, mask, lv, np.asarray(xla), np.asarray(pallas)


@pytest.mark.parametrize("fn", [TW.denoise_wavelet_plain, TW.denoise_wavelet])
@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_levels3_vs_xla_and_pallas(fn, mode):
    x, sig, _, lv, xla, pallas = _jax_case(mode)
    got = fn(torch.from_numpy(x), torch.from_numpy(sig.copy()), mode=mode,
             wavelet_levels=lv)
    _close(got, xla)
    _close(got, pallas)


@pytest.mark.parametrize("fn", [TW.denoise_wavelet_plain, TW.denoise_wavelet])
def test_mixed_soft_mask_and_sigma_vector(fn):
    x, sig, mask, lv, xla, pallas = _jax_case("mixed")
    got = fn(torch.from_numpy(x), torch.from_numpy(sig), wavelet_levels=lv,
             soft_mask=torch.from_numpy(mask))
    _close(got, xla)
    _close(got, pallas)


@pytest.mark.parametrize("fn", [TW.denoise_wavelet_plain, TW.denoise_wavelet])
def test_sigma_none_estimates_mad(fn):
    x, _, _, _, xla, pallas = _jax_case("sigma_none")
    got = fn(torch.from_numpy(x))        # default levels 3, sigma from HH
    _close(got, xla)
    _close(got, pallas)


def test_zero_sigma_and_flat_band():
    # sigma 0 gives t = 0: both shrinks keep every coefficient; a flat image
    # has mean(band^2) = 0 below sigma^2, the eps clamp
    x = _noisy(4, 2, 32, 32)
    x[1] = 0.5
    sig = np.array([0.0, 0.05], np.float32)
    for mode in ("soft", "hard"):
        got = TW.denoise_wavelet_plain(torch.from_numpy(x),
                                       torch.from_numpy(sig), mode=mode,
                                       wavelet_levels=3)
        _close(got, JW.denoise_wavelet(jnp.asarray(x), sigma=jnp.asarray(sig),
                                       mode=mode, wavelet_levels=3))
        np.testing.assert_allclose(got[0].numpy(), x[0], rtol=0, atol=ATOL)


# ------------------------------------------------------- dispatch seam

def test_cpu_tensor_runs_the_plain_version_and_builds_nothing():
    kernels.reset_launches()
    x = torch.from_numpy(_noisy(5, 2, 64, 64))
    mask = torch.tensor([True, False])
    assert torch.equal(TW.denoise_wavelet(x, soft_mask=mask),
                       TW.denoise_wavelet_plain(x, soft_mask=mask))
    assert kernels.LAUNCHES["wavelet_denoise"] == 0
    assert kernels._lib is None


@pytest.fixture()
def seam(monkeypatch):
    """Every tensor counts as a CUDA tensor, and the kernel wrapper records
    its arguments instead of launching."""
    calls = []

    def fake(x, sigma, soft, levels):
        calls.append((x, sigma, soft, levels))
        return x

    monkeypatch.setattr(kernels, "use_kernel", lambda x: True)
    monkeypatch.setattr(kernels, "wavelet_denoise", fake)
    return calls


@pytest.mark.parametrize("kw,shape,launch", [
    ({}, (2, 64, 64), True),                          # db1, 64 / 2^3
    ({"wavelet_levels": 6}, (2, 64, 128), True),
    ({"wavelet": "db2"}, (2, 64, 64), False),
    ({"wavelet_levels": 3}, (2, 60, 64), False),      # 60 not / 8
    ({"wavelet_levels": 7}, (2, 64, 128), False),     # 64 not / 128
])
def test_dispatch_gate(seam, kw, shape, launch):
    x = torch.from_numpy(_noisy(6, *shape))
    out = TW.denoise_wavelet(x, **kw)
    assert bool(seam) == launch
    if launch:
        _, sigma, soft, levels = seam[0]
        assert sigma is None and soft.dtype == torch.bool
        assert soft.tolist() == [True, True]
        assert levels == kw.get("wavelet_levels",
                                TW.default_levels(shape[-2:]))
        assert out is x
    else:
        assert torch.equal(out, TW.denoise_wavelet_plain(x, **kw))


def test_dispatch_passes_sigma_and_mode_per_image(seam):
    x = torch.from_numpy(_noisy(7, 3, 32, 32))
    TW.denoise_wavelet(x, sigma=0.02, mode="hard", wavelet_levels=2)
    TW.denoise_wavelet(x, sigma=torch.tensor([0.1, 0.2, 0.3]),
                       soft_mask=torch.tensor([True, False, True]))
    (_, s0, m0, _), (_, s1, m1, _) = seam
    assert s0.tolist() == pytest.approx([0.02] * 3) and s0.is_contiguous()
    assert m0.tolist() == [False] * 3
    assert s1.tolist() == pytest.approx([0.1, 0.2, 0.3])
    assert m1.tolist() == [True, False, True]
