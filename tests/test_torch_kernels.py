"""The plain versions of the CUDA kernels (box stats, unsharp, CLAHE, TV,
bilateral), against the JAX package on the CPU (the wavelet denoise's:
tests/test_torch_wavelet.py).

Each plain version is held against both JAX forms the TPU path has: the
XLA lowering and the Pallas kernel in ``interpret=True`` mode, at small
sizes, as tests/test_pallas.py runs them.  Tolerances: the golden ones of
tests/test_ops_golden.py and tests/test_pallas.py.  The CUDA kernels
themselves are tested on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdx.core import metrics as JM
from mdx.ops import filters as JF
from mdx.ops import pallas_kernels as PK
from mdx.ops import tv as JTV
from mdx.ops.bilateral import bilateral as j_bilateral
from mdx.ops.clahe import clahe as j_clahe
from mdx.ops.clahe import clahe_xla

import mdx_torch
from mdx_torch import kernels
from mdx_torch.core import metrics as TM
from mdx_torch.core import qa
from mdx_torch.ops import bilateral as TB
from mdx_torch.ops import clahe as TC
from mdx_torch.ops import filters as TF
from mdx_torch.ops import tv as TTV

torch.set_num_threads(1)


def _batch(seed, n, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    x = base[None] + rng.normal(0, 0.1, (n, h, w))
    x[0] = 0.5 + 0.4 * (x[0] - 0.5)            # lower contrast
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, atol, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------ B: box stats

@pytest.mark.parametrize("shape", [(3, 64, 96), (2, 96, 64)])
def test_box_stats_plain_vs_xla_and_pallas(shape):
    x = _batch(1, *shape)
    got = TM._lv_box_stats_plain(_t(x))
    xla = JM._lv_box_stats(jnp.asarray(x))       # CPU backend → XLA path
    pallas = PK.box_stats_tpu(jnp.asarray(x), interpret=True)
    for g, a, b in zip(got, xla, pallas):
        _close(g, a, 1e-7, 1e-5)
        _close(g, b, 1e-7, 1e-5)


# -------------------------------------------------------------- U: unsharp

@pytest.mark.parametrize("h,w", [(64, 80), (33, 129)])
def test_unsharp_plain_vs_xla_and_pallas(h, w):
    x = _batch(2, 3, h, w)
    rad = np.array([0.6, 1.0, 3.0], np.float32)
    amt = np.array([0.3, 0.6, 1.5], np.float32)
    got = TF.unsharp_mask_plain(_t(x), _t(rad), _t(amt))
    _close(got, JF.unsharp_mask(jnp.asarray(x), jnp.asarray(rad),
                                jnp.asarray(amt)), 1e-6)
    _close(got, PK.unsharp_tpu(jnp.asarray(x), jnp.asarray(rad),
                               jnp.asarray(amt), interpret=True), 1e-6)


# ---------------------------------------------------------------- C: CLAHE

@pytest.mark.parametrize("h,w,tile", [(64, 64, 16), (96, 80, 16),
                                      (60, 52, 16), (64, 48, 8)])
def test_clahe_plain_vs_xla_and_pallas(h, w, tile):
    x = _batch(3, 2, h, w)
    clip = np.array([0.02, 0.05], np.float32)
    got = TC.clahe_plain(_t(x), _t(clip), tile)
    assert tuple(got.shape) == x.shape
    _close(got, clahe_xla(jnp.asarray(x), jnp.asarray(clip), tile), 5e-6)
    _close(got, PK.clahe_tpu(jnp.asarray(x), jnp.asarray(clip), tile,
                             interpret=True), 2e-5)


def test_clahe_scalar_clip_and_range():
    x = _batch(4, 2, 64, 64)
    out = TC.clahe(_t(x), 0.08, 16)
    _close(out, j_clahe(jnp.asarray(x), 0.08, 16), 5e-6)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0 + 1e-6


# ------------------------------------------------------------------- T: TV

def test_tv_plain_vs_xla_and_pallas_with_iteration_counts():
    x = _batch(5, 3, 48, 64)
    w = np.array([0.05, 0.1, 0.02], np.float32)
    got, iters = TTV.tv_chambolle_plain(_t(x), _t(w))
    full = np.asarray(JTV.tv_chambolle_xla(jnp.asarray(x), jnp.asarray(w)))
    _close(got, full, 1e-6)
    _close(got, PK.tv_chambolle_tpu(jnp.asarray(x), jnp.asarray(w),
                                    interpret=True), 1e-6)
    # per-image iteration counts: the JAX solve capped at an image's count
    # already gives that image's final pixels, capped one lower it does not
    iters = iters.tolist()
    assert all(1 < c < 200 for c in iters), iters
    for i, c in enumerate(iters):
        at_c = np.asarray(JTV.tv_chambolle_xla(
            jnp.asarray(x[i:i + 1]), jnp.asarray(w[i:i + 1]), max_iter=c))
        before = np.asarray(JTV.tv_chambolle_xla(
            jnp.asarray(x[i:i + 1]), jnp.asarray(w[i:i + 1]), max_iter=c - 1))
        np.testing.assert_array_equal(at_c[0], full[i])
        assert not np.array_equal(before[0], full[i]), (i, c)


@pytest.mark.parametrize("max_iter", [1, 5])
def test_tv_iteration_cap(max_iter):
    # eps = 0 never stops early, so every image runs to the cap
    x = _batch(6, 2, 32, 32)
    out, iters = TTV.tv_chambolle(_t(x), 0.05, 0.0, max_iter)
    assert iters.tolist() == [max_iter, max_iter]
    _close(out, JTV.tv_chambolle_xla(jnp.asarray(x), 0.05, 0.0, max_iter),
           1e-6)


# ------------------------------------------------------------ bilateral

@pytest.mark.parametrize("d", [3, 5, 8])
def test_bilateral_vs_xla_and_pallas(d):
    x = _batch(7, 2, 40, 56)
    sc = np.array([0.05, 0.1], np.float32)
    ss = np.array([0.05, 0.2], np.float32)
    got = TB.bilateral(_t(x), d, _t(sc), _t(ss))
    _close(got, j_bilateral(jnp.asarray(x), d, jnp.asarray(sc),
                             jnp.asarray(ss)), 1e-6)
    dn = TB._norm_d(d)
    _close(got, PK.bilateral_tpu(jnp.asarray(x), dn, jnp.asarray(sc),
                                 jnp.asarray(ss), interpret=True), 1e-5)


@pytest.mark.parametrize("d", [0, -1, 2, 12])
def test_bilateral_cpu_runs_the_plain_version(d):
    # CPU tensor → bilateral_plain (no launch); d ≤ 0 returns the input,
    # even d rounds up to odd, d > 9 clamps to 9
    x = _t(_batch(9, 2, 24, 20))
    kernels.reset_launches()
    got = TB.bilateral(x, d, 0.07, 0.1)
    assert kernels.LAUNCHES["bilateral"] == 0
    if d <= 0:
        assert got is x
    else:
        assert torch.equal(got, TB.bilateral_plain(x, TB._norm_d(d), 0.07,
                                                   0.1))


# ------------------------------------------------- dispatch and wrappers

def test_cpu_path_launches_and_builds_nothing():
    kernels.reset_launches()
    x = _t(_batch(8, 2, 32, 32))
    static, dyn = mdx_torch.plan_from_numpy(
        {"ops": mdx_torch.OP_ORDER, "bilateral_d": 5},
        {"tv_denoise_weight": 0.05}, device="cpu")
    qa.qa_plan(x, static, dyn)
    assert kernels.LAUNCHES == {k: 0 for k in kernels.LAUNCHES}
    assert kernels._lib is None


@pytest.mark.parametrize("call", [
    lambda x: kernels.box_stats(x),
    lambda x: kernels.unsharp(x, torch.ones(2), torch.ones(2)),
    lambda x: kernels.clahe(x, torch.ones(2), 16),
    lambda x: kernels.tv_chambolle(x, torch.ones(2)),
    lambda x: kernels.bilateral(x, 5, torch.ones(2), torch.ones(2)),
    lambda x: kernels.wavelet_denoise(x, torch.ones(2),
                                      torch.ones(2, dtype=torch.bool), 3),
    lambda x: kernels.clahe_luts(x, torch.ones(2), 16),
    lambda x: kernels.clahe_remap_ext(x, torch.zeros(2, 4, 4, 256), 16),
    lambda x: kernels.tv_shard_step(
        x, torch.zeros(2, 2, 32, 32), torch.zeros(2, 2, 32, 32),
        torch.ones(2, dtype=torch.int32), torch.ones(2), None, None,
        (32, 32, 0, 0, 4), 4),
    lambda x: kernels.tv_shard_finalize(
        torch.zeros(2, 4, 2, dtype=torch.float64), torch.ones(2),
        torch.zeros(2), torch.zeros(2), torch.ones(2, dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
        0, 2e-4, 1024.0),
    lambda x: kernels.tv_shard_rebuild(
        x, torch.zeros(2, 2, 32, 32), torch.zeros(2, 2, 32, 32),
        torch.ones(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
        torch.ones(2), None, None, None, (32, 32, 0, 0, 4), 4),
])
def test_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.zeros(2, 32, 32))


def test_use_kernel_devices():
    assert kernels.use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        kernels.use_kernel(torch.zeros(1, device="meta"))


def test_build_flags_and_library_name():
    from mdx_torch.kernels import _build

    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.library_path().parent == _build.BUILD_DIR
    assert _build.library_path() == _build.library_path()
    assert {s.name for s in _build._sources()} >= {
        "box_stats.cu", "unsharp.cu", "clahe.cu", "tv.cu", "bilateral.cu",
        "wavelet.cu", "common.cuh"}
    assert set(_build.SIGNATURES) == {
        "mdx_box_stats", "mdx_unsharp", "mdx_clahe", "mdx_tv_blocked_steps",
        "mdx_tv_blocked_step", "mdx_tv_blocked_rebuild", "mdx_bilateral",
        "mdx_wavelet_analysis", "mdx_wavelet_synthesis", "mdx_clahe_luts", "mdx_clahe_remap_ext",
        "mdx_tv_shard_blocked_step", "mdx_tv_shard_blocked_finalize",
        "mdx_tv_shard_blocked_rebuild"}


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
