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


@pytest.mark.parametrize("shape", [(3, 64, 80), (3, 33, 129), (2, 5, 7),
                                   (2, 512, 512)])
def test_unsharp_kernel(dev, shape):
    x = _batch(2, *shape, dev)
    n = shape[0]
    rad = torch.linspace(0.6, 3.0, n, device=dev)
    amt = torch.linspace(0.3, 1.5, n, device=dev)
    _assert_kernel_parity("unsharp", kernels.unsharp(x, rad, amt),
                          F.unsharp_mask_plain(x, rad, amt))


@pytest.mark.parametrize("shape,tile", [((2, 96, 80), 16), ((2, 64, 48), 8),
                                        ((2, 60, 52), 16), ((2, 5, 7), 16),
                                        ((2, 1, 9), 4), ((2, 512, 512), 16)])
def test_clahe_kernel(dev, shape, tile):
    x = _batch(3, *shape, dev)
    clip = torch.tensor([0.02, 0.05], device=dev)
    got = kernels.clahe(x, clip, tile)
    assert got.shape == x.shape
    _assert_kernel_parity("clahe", got, C.clahe_plain(x, clip, tile))


@pytest.mark.parametrize("shape", [(3, 48, 64), (3, 100, 36), (3, 256, 256)])
def test_tv_kernel_pixels_and_iterations(dev, shape):
    x = _batch(5, *shape, dev)
    w = torch.tensor([0.05, 0.1, 0.02], device=dev)
    got, it_k = kernels.tv_chambolle(x, w)
    want, it_p = T.tv_chambolle_plain(x, w)
    assert it_k.tolist() == it_p.tolist()
    _assert_kernel_parity("tv_chambolle", got, want)


def test_tv_kernel_iteration_cap(dev):
    x = _batch(6, 2, 32, 32, dev)
    w = torch.full((2,), 0.05, device=dev)
    for cap in (1, 5, 17):
        got, it = kernels.tv_chambolle(x, w, 0.0, cap)
        want, it_p = T.tv_chambolle_plain(x, w, 0.0, cap)
        assert it.tolist() == [cap, cap] == it_p.tolist()
        _assert_kernel_parity("tv_chambolle", got, want)


@pytest.mark.parametrize("shape", [(2, 256, 256), (3, 129, 77)])
@pytest.mark.parametrize("d", [3, 5, 9])
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
    assert all(v > 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    cpu = qa.qa_plan(x.cpu(), *plan_from_numpy(static, dyn, "cpu"))
    bad = parity.breaches(parity.flatten_result(card, parity.QA_PLAN_FIELDS),
                          parity.flatten_result(cpu, parity.QA_PLAN_FIELDS),
                          tv_ran=True)
    assert not bad, "\n".join(bad)
