"""The port's 2048² path (BASELINE config 2) against the JAX package, on
the CPU at small sizes.

* The plain versions of the unsharp, CLAHE, TV and bilateral kernels
  against the JAX package's banded TPU kernels (the ones that run past
  1024²: ``unsharp_banded_tpu``, ``_clahe_banded``, ``tv_chambolle_banded``
  / ``_tv_band_step``, ``bilateral_banded_tpu``) in ``interpret=True``
  mode, at a small band.  Tolerances: the ``tol`` of
  PARITY_SWEEP_r05.json for each kernel (1e-5; CLAHE 2e-5).
* Sub-batching (``mdx_torch.core.batching``): grouped results equal whole
  results exactly, and the port's grouped ``qa_plan`` agrees with JAX's
  within ``parity.breaches``.
* Config 2's ``apply_plan`` (``mdx_torch.tools.bench_config2``) against
  JAX's ``apply_plan`` with the same plan.
* The port's copies of the benchmark batch and plans equal ``bench.py``'s
  and ``examples/bench_config2.py``'s.
"""

import ast
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from mdx.core import enhance as JE
from mdx.core import qa as JQ
from mdx.ops import pallas_kernels as PK

from mdx_torch import parity, tools
from mdx_torch.core import batching
from mdx_torch.core import qa as TQ
from mdx_torch.ops import bilateral as TB
from mdx_torch.ops import clahe as TC
from mdx_torch.ops import filters as TF
from mdx_torch.ops import tv as TTV
from mdx_torch.tools import bench_config2

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _batch(seed, n, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.3 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
    x = base[None] + rng.normal(0, 0.1, (n, h, w))
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.0,
                               atol=atol)


# ------------------------------------ plain versions vs the banded kernels

@pytest.mark.parametrize("d", [3, 5, 9])
def test_bilateral_plain_vs_banded_kernel(d):
    x = _batch(21, 2, 128, 96)
    sc = np.array([0.05, 0.12], np.float32)
    ss = np.array([0.08, 0.3], np.float32)
    got = TB.bilateral_plain(_t(x), d, _t(sc), _t(ss))
    want = PK.bilateral_banded_tpu(jnp.asarray(x), d, jnp.asarray(sc),
                                   jnp.asarray(ss), band=32, interpret=True)
    _close(got, want, 1e-5)


def test_unsharp_plain_vs_banded_kernel():
    x = _batch(22, 2, 128, 96)
    rad = np.array([1.0, 2.5], np.float32)
    amt = np.array([0.6, 1.2], np.float32)
    got = TF.unsharp_mask_plain(_t(x), _t(rad), _t(amt))
    want = PK.unsharp_banded_tpu(jnp.asarray(x), jnp.asarray(rad),
                                 jnp.asarray(amt), band=32, interpret=True)
    _close(got, want, 1e-5)


def test_clahe_plain_vs_banded_kernel():
    x = _batch(23, 2, 128, 128)
    clip = np.array([0.02, 0.05], np.float32)
    got = TC.clahe_plain(_t(x), _t(clip), 16)
    want = PK._clahe_banded(jnp.clip(jnp.asarray(x), 0.0, 1.0),
                            jnp.asarray(clip), 16, 256, interpret=True)
    _close(got, want, 2e-5)


def test_tv_plain_vs_banded_kernel_at_fixed_trips():
    # eps = 0: both run 9 iterations, so the banded kernel's band-first
    # energy sums cannot move the stop (tests/test_pallas.py does the same)
    x = _batch(24, 2, 128, 128)
    w = np.array([0.1, 0.07], np.float32)
    got, iters = TTV.tv_chambolle_plain(_t(x), _t(w), eps=0.0, max_iter=9)
    assert iters.tolist() == [9, 9]
    want = PK.tv_chambolle_banded(jnp.asarray(x), jnp.asarray(w), eps=0.0,
                                  max_iter=9, band=64, interpret=True)
    _close(got, want, 1e-5)


# ------------------------------------------------------------ sub-batching

@pytest.mark.parametrize("n,groups,want", [
    (4, (2,), 2), (4, (4,), None), (6, (4, 3), 3), (7, (2,), None),
    (3, (2,), None)])
def test_group_size_with_pinned_groups(n, groups, want):
    assert batching.group_size(n, (n, 64, 64), groups) == want


def test_group_size_from_the_knee():
    hw = (2048, 2048)
    g = batching.group_limit((1, *hw))
    assert 1 <= g <= batching.MAX_GROUP
    assert batching.group_size(g, (g, *hw)) is None            # fits whole
    assert batching.group_size(4 * g, (4 * g, *hw)) == (g if g > 1 else None)
    assert batching.group_limit((1, 8, 8)) == batching.MAX_GROUP
    # a prime batch above the limit has no divisor ≥ 2: it runs whole
    big = 1021
    assert batching.group_size(big, (big, 512, 512)) is None


def test_map_subbatches_splits_per_image_args_only():
    seen = []

    def fn(x, per_image, shared, plan):
        seen.append((x.shape[0], per_image.shape[0], shared.shape[0]))
        return {"y": x[:, 0, 0] * per_image + shared[0], "n": (x[:, 0, 0],)}

    x = torch.arange(6.0)[:, None, None].expand(6, 2, 2).contiguous()
    per_image = torch.arange(6.0) * 10
    shared = torch.tensor([1.0, 2.0])
    out = batching.map_subbatches(fn, x, per_image, shared, "plan",
                                  groups=(3,))
    assert seen == [(3, 3, 2), (3, 3, 2)]
    assert torch.equal(out["y"], torch.arange(6.0) * torch.arange(6.0) * 10
                       + 1.0)
    assert torch.equal(out["n"][0], torch.arange(6.0))


def _bench_plans_jax():
    P = bench._PLAN_PARAMS
    static = JE.PlanStatic(ops=bench._PLAN_OPS, tile_size=P["clahe_tile_size"],
                           bilateral_d=P["bilateral_d"],
                           plan_order=bench._PLAN_OPS)
    dyn = JE.PlanDynamic(
        clahe_clip_limit=P["clahe_clip_limit"], gamma=P["gamma"],
        unsharp_radius=P["unsharp_radius"],
        unsharp_amount=P["unsharp_amount"],
        post_denoise_strength=P["post_denoise_strength"],
        bilateral_sigma_color=P["bilateral_sigma_color"],
        bilateral_sigma_space=P["bilateral_sigma_space"],
        tv_denoise_weight=P["tv_denoise_weight"], denoise_soft=True)
    return static, dyn


def test_qa_plan_grouped_equals_whole_and_jax():
    x = tools.make_batch(4, 64)
    static, dyn = tools.bench_plan("cpu")
    whole = parity.flatten_result(TQ.qa_plan(_t(x), static, dyn),
                                  parity.QA_PLAN_FIELDS)
    grouped = parity.flatten_result(
        TQ.qa_plan(_t(x), static, dyn, groups=(2,)), parity.QA_PLAN_FIELDS)
    assert whole.keys() == grouped.keys()
    for k in whole:
        np.testing.assert_array_equal(grouped[k], whole[k], err_msg=k)
    js, jd = _bench_plans_jax()
    want = parity.flatten_result(
        jax.tree_util.tree_map(np.asarray, JQ.qa_plan(jnp.asarray(x), js, jd)),
        parity.QA_PLAN_FIELDS)
    bad = parity.breaches(grouped, want, tv_ran=True)
    assert not bad, "\n".join(bad)


def test_detect_and_qa_deterministic_grouped_equal_whole():
    x = _t(tools.make_batch(4, 48, seed=3))
    for fn, fields in ((TQ.detect, ("stats", "issues")),
                       (TQ.qa_deterministic,
                        parity.QA_DETERMINISTIC_FIELDS)):
        whole = parity.flatten_result(fn(x), fields)
        grouped = parity.flatten_result(fn(x, groups=(2,)), fields)
        assert whole.keys() == grouped.keys()
        for k in whole:
            np.testing.assert_array_equal(grouped[k], whole[k], err_msg=k)


# ----------------------------------------------------------------- config 2

def _config2_from_example():
    """The PlanStatic / PlanDynamic keywords of examples/bench_config2.py,
    read from its source (the script needs a TPU to run)."""
    tree = ast.parse((ROOT / "examples" / "bench_config2.py").read_text())
    found = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("PlanStatic", "PlanDynamic")):
            found[node.func.attr] = {k.arg: ast.literal_eval(k.value)
                                     for k in node.keywords}
    return found["PlanStatic"], found["PlanDynamic"]


@pytest.mark.parametrize("bare", [False, True])
def test_config2_apply_plan_vs_jax(bare):
    x = tools.make_batch(2, 128, seed=5)
    static, dyn = tools.config2_plan("cpu")
    got = bench_config2.run_config2(_t(x), static, dyn, group=1, bare=bare)
    js = JE.PlanStatic(**tools.CONFIG2_STATIC)
    jd = JE.PlanDynamic(**tools.CONFIG2_DYN)
    if bare:
        masks = {op: jnp.ones((2,), bool) for op in js.ops}
        want = jax.jit(lambda v: JE._run_chain(
            v, js.order(), js, jd, masks,
            jnp.full((2,), jd.unsharp_amount, jnp.float32)))(jnp.asarray(x))
    else:
        want = JQ.enhance_only(jnp.asarray(x), js, jd)[0]   # apply_plan
    assert tuple(got.shape) == x.shape
    _close(got, want, parity.PIXEL_ATOL)


# ------------------------------------------------ the port's own constants

@pytest.mark.parametrize("n,hw", [(3, 64), (2, 512), (1, 100)])
def test_make_batch_bit_equal_to_bench(n, hw):
    got = tools.make_batch(n, hw)
    want = bench._make_batch(n, hw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_plan_constants_equal_bench_and_example():
    assert tools.PLAN_OPS == bench._PLAN_OPS
    assert tools.PLAN_PARAMS == bench._PLAN_PARAMS
    static, dyn = _config2_from_example()
    assert tools.CONFIG2_STATIC == static
    assert tools.CONFIG2_DYN == dyn
    # and they build the same plans as the JAX classes do
    ts, td = tools.config2_plan("cpu")
    assert dataclasses.asdict(ts) == dataclasses.asdict(JE.PlanStatic(**static))
    for k, v in JE.PlanDynamic(**dyn)._asdict().items():
        assert getattr(td, k).item() == np.float32(v), k


def test_port_imports_nothing_of_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(from|import) (mdx\b|mdx\.|bench|examples|jax)")
    for path in [ROOT / "chip_smoke.py", *(ROOT / "mdx_torch").rglob("*.py")]:
        for line in path.read_text().splitlines():
            assert not pattern.match(line), f"{path}: {line}"
