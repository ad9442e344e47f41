"""The port's row-sharded path (``mdx_torch.parallel``) against the JAX
package's 1-D spatial layer, on the CPU, with k = 4 row blocks.

The port runs as 4 gloo ranks in ONE ``launch.run`` (a module fixture, 120
s timeout): ``launch.call_each`` runs every case on every rank, and the
rank functions are the package's own, so no rank imports this module (or
JAX).  The JAX side runs in this process on the virtual 8-device CPU mesh
``make_mesh(n_data=1, n_space=4)``, as ``tests/test_spatial_*.py`` do.

Tolerances: halos, gathers and distributed percentiles are exact (bit for
bit, against JAX and against the whole-array port); the sharded ops and
the slice use ``mdx_torch.parity`` (reduction order; TV's allowance where
TV ran); the sharded CLAHE against the dense one
``parity.SHARDED_CLAHE_ATOL``.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mdx.core import enhance as JE
from mdx.ops.quantile import percentiles_multi_sharded as j_pq_multi
from mdx.parallel import make_mesh
from mdx.parallel import clahe_sp as JC
from mdx.parallel import spatial as JS
from mdx.parallel import tv_sp as JT
from mdx.parallel.plan_sp import qa_plan_spatial as j_qa_plan_spatial

import mdx_torch
from mdx_torch import parity, tools
from mdx_torch.core import qa as TQ
from mdx_torch.core.metrics import detect_issues
from mdx_torch.ops import clahe as TC
from mdx_torch.ops import tv as TTV
from mdx_torch.ops.quantile import percentiles_exact
from mdx_torch.parallel import clahe_sp, comm, launch, plan_sp, spatial, tv_sp
from mdx_torch.parallel.launch import Block

torch.set_num_threads(1)

K = 4


def _img(seed, n, h, w, noise=0.1):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.25 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
    return np.clip(base[None] + r.normal(0, noise, (n, h, w)), 0, 1
                   ).astype(np.float32)


def _weights(n, h, w):
    """0/1 masks with the same count of ones in every image (one global
    ``total`` per source)."""
    r = np.random.default_rng(5)
    flat = np.zeros(h * w, np.float32)
    flat[: h * w // 3] = 1.0
    return np.stack([r.permutation(flat).reshape(h, w) for _ in range(n)])


# the inputs, row-split over the ranks: index → array
XA = _img(0, 2, 128, 128)
XA[1] = np.clip(0.3 + 0.4 * XA[1], 0, 1)       # a low-contrast second image
XT = _img(1, 2, 256, 128)                       # TV: 64-row blocks
XB = _img(2, 1, 128, 128, noise=0.18)           # the halo-guard plan
V = np.random.default_rng(3).normal(0, 1, (2, 64, 96)).astype(np.float32)
W = _weights(2, 64, 96)
INPUTS = (XA, XT, XB, V, W)
QS = [0.0, 5.0, 25.0, 50.0, 75.0, 95.0, 100.0]
TV_W = np.array([0.06, 0.03], np.float32)
CLIP = np.array([0.02, 0.05], np.float32)
MODES = ("symmetric", "reflect", "edge")

# qa_spatial: denoise + CLAHE + TV + the noise guard
QA_KW = dict(gamma=0.95, unsharp_radius=1.0, unsharp_amount=0.6,
             bilateral_d=5, clahe_clip_limit=0.02, tv_weight=0.05,
             denoise=True, noise_guard=True)

HALO_STATIC = JE.PlanStatic(ops=("clahe", "gamma", "unsharp"), tile_size=16,
                            bilateral_d=0,
                            plan_order=("clahe", "gamma", "unsharp"))
HALO_DYN = JE.PlanDynamic(clahe_clip_limit=0.05, gamma=1.05,
                          unsharp_radius=1.5, unsharp_amount=2.2,
                          tv_denoise_weight=0.0)


def _plan_to_torch(static, dyn):
    return mdx_torch.plan_from_numpy(
        dataclasses.asdict(static),
        {k: np.asarray(v) for k, v in dyn._asdict().items()}, device="cpu")


def _qa_block_kw():
    kw = dict(QA_KW)
    guard = kw.pop("noise_guard")
    return dict(spatial.enhance_kwargs(
        gamma=kw["gamma"], unsharp_radius=kw["unsharp_radius"],
        unsharp_amount=kw["unsharp_amount"], bilateral_d=kw["bilateral_d"],
        bilateral_sigma_color=0.05, bilateral_sigma_space=0.05,
        clahe_clip_limit=kw["clahe_clip_limit"], clahe_tile_size=16,
        tv_weight=kw["tv_weight"], denoise=kw["denoise"],
        post_denoise_strength=None), use_noise_guard=guard)


CASES = {}
for m in MODES:
    CASES[f"halo_{m}"] = (spatial.halo_rows, (Block(0), 3, 2),
                          {"edge_mode": m})
CASES["gather"] = (comm.gather_tiles, (Block(0),), {})
CASES["psum_img"] = (spatial.psum_img, (Block(3),), {})
CASES["pmax_img"] = (spatial.pmax_img, (Block(3),), {})
CASES["pq"] = (spatial.pq, (Block(3), QS), {})
CASES["pq_multi"] = (spatial.pq_multi, ([
    (Block(3), [5.0, 50.0, 95.0], None, None),
    (Block(0), [90.0], None, None),
    (Block(3), [25.0, 50.0], int(W[0].sum()), Block(4))],), {})
for t in (16, 32):
    CASES[f"clahe_{t}"] = (clahe_sp.clahe_sharded,
                           (Block(0), torch.from_numpy(CLIP), t), {})
CASES["tv"] = (tv_sp.tv_sharded, (Block(1), torch.from_numpy(TV_W)), {})
CASES["tv_steps"] = (tv_sp.solve_steps, (
    Block(1), torch.from_numpy(TV_W), ), dict(
        eps=2e-4, max_iter=200, step=tv_sp.tv_shard_step_plain,
        finalize=tv_sp.tv_shard_finalize_plain,
        rebuild=tv_sp.tv_shard_rebuild_plain, steps=4))
CASES["tv_fixed"] = (tv_sp.tv_sharded, (Block(1), torch.from_numpy(TV_W)),
                     dict(eps=0.0, max_iter=9))
CASES["stats"] = (spatial.image_stats_block, (Block(0),), {})
CASES["qa"] = (spatial.qa_block, (Block(0),), _qa_block_kw())
CASES["plan"] = (plan_sp.qa_plan_block, (Block(0),
                                         *tools.bench_plan("cpu")), {})
CASES["plan_halo"] = (plan_sp.qa_plan_block,
                      (Block(2), *_plan_to_torch(HALO_STATIC, HALO_DYN)), {})


@pytest.fixture(scope="module")
def port():
    """Every case on 4 gloo ranks, one launch → {case: [per-rank result]}."""
    names = list(CASES)
    res = launch.run(launch.call_each, INPUTS, n_space=K, device="cpu",
                     timeout_s=120, calls=[CASES[n] for n in names])
    assert res.backend == "gloo" and res.devices == ["cpu"] * K
    assert res.host_round_trips == [0] * K
    return {n: [r[i] for r in res.results] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def mesh14():
    return make_mesh(n_data=1, n_space=K)


def _rows(per_rank):
    """Row blocks of the ranks → the whole array."""
    return np.concatenate(per_rank, axis=1)


def _smap(mesh, fn, out_specs=P(None, "space", None), n_in=1,
          in_specs=None):
    """The jitted shard_map of ``fn`` (row blocks in; jitting compiles the
    body once instead of dispatching it op by op)."""
    if in_specs is None:
        in_specs = (P(None, "space", None),) * n_in
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


# a row-split image and a replicated per-image vector
IMG_VEC = (P(None, "space", None), P())


# ------------------------------------------------------- halos and comm

@pytest.mark.parametrize("mode", MODES)
def test_halo_rows_bit_equal_to_jax(port, mesh14, mode):
    want = _smap(mesh14, partial(JS._halo_rows, up=3, down=2,
                                 edge_mode=mode))(jnp.asarray(XA))
    got = _rows(port[f"halo_{mode}"])
    np.testing.assert_array_equal(got, np.asarray(want))


def test_gather_psum_pmax(port):
    for r in port["gather"]:
        np.testing.assert_array_equal(r, XA)
    for r in port["pmax_img"]:
        np.testing.assert_array_equal(r, V.reshape(2, -1).max(axis=1))
    np.testing.assert_allclose(port["psum_img"][0],
                               V.reshape(2, -1).sum(axis=1), rtol=1e-5)


def test_percentiles_bit_equal_to_whole_array(port):
    whole = percentiles_exact(torch.from_numpy(V), QS).numpy()
    for r in port["pq"]:
        np.testing.assert_array_equal(r, whole)


def test_fused_weighted_percentiles(port, mesh14):
    total = int(W[0].sum())

    def body(v, x, w):
        return tuple(j_pq_multi([
            (v, [5.0, 50.0, 95.0], v[0].size * K, None),
            (x, [90.0], x[0].size * K, None),
            (v, [25.0, 50.0], total, w)], "space"))

    # op by op, not jitted: XLA's fused CPU program rounds one of the six
    # interpolated values here one ulp (1.2e-7) away from the op-by-op
    # result, which the port and percentiles_exact give bit for bit
    want = shard_map(body, mesh=mesh14, in_specs=(P(None, "space", None),) * 3,
                     out_specs=(P(), P(), P()), check_vma=False)(
        jnp.asarray(V), jnp.asarray(XA), jnp.asarray(W))
    sel = torch.from_numpy(V[W > 0].reshape(2, total))
    whole = (percentiles_exact(torch.from_numpy(V), [5.0, 50.0, 95.0]),
             percentiles_exact(torch.from_numpy(XA), [90.0]),
             percentiles_exact(sel, [25.0, 50.0]))
    for r in port["pq_multi"]:
        for got, w_jax, w_whole in zip(r, want, whole):
            np.testing.assert_array_equal(got, np.asarray(w_jax))
            np.testing.assert_array_equal(got, w_whole.numpy())


# ---------------------------------------------------- kernel 11's module

# JAX's XLA remap at one tile size, its Pallas remap (interpret mode) at
# the other
@pytest.mark.parametrize("tile,pallas", [(16, False), (32, True)])
def test_clahe_sharded_vs_jax(port, mesh14, tile, pallas):
    fn = _smap(mesh14, partial(JC.clahe_sharded, tile_size=tile,
                               row_axis="space", force_pallas=pallas,
                               interpret=pallas), in_specs=IMG_VEC)
    want = np.asarray(fn(jnp.asarray(XA), jnp.asarray(CLIP)))
    np.testing.assert_allclose(_rows(port[f"clahe_{tile}"]), want, rtol=0,
                               atol=parity.KERNEL_TOL["clahe_remap_ext"][1])


@pytest.mark.parametrize("tile", [16, 32])
def test_clahe_sharded_vs_dense_port(port, tile):
    dense = TC.clahe_plain(torch.from_numpy(XA), torch.from_numpy(CLIP),
                           tile).numpy()
    np.testing.assert_allclose(_rows(port[f"clahe_{tile}"]), dense, rtol=0,
                               atol=parity.SHARDED_CLAHE_ATOL)


# ---------------------------------------------------- kernel 12's module

def test_tv_sharded_vs_jax_and_dense(port, mesh14):
    fn = _smap(mesh14, partial(JT.tv_sharded, row_axis="space"),
               in_specs=IMG_VEC)
    want = np.asarray(fn(jnp.asarray(XT), jnp.asarray(TV_W)))
    got = _rows([r[0] for r in port["tv"]])
    bad = parity.breaches({"enhanced": got}, {"enhanced": want}, tv_ran=True)
    assert not bad, bad
    dense, it = TTV.tv_chambolle_plain(torch.from_numpy(XT),
                                       torch.from_numpy(TV_W))
    for r in port["tv"]:
        assert r[1].tolist() == it.tolist()
    np.testing.assert_allclose(got, dense.numpy(), rtol=0,
                               atol=parity.PIXEL_ATOL)


def test_tv_kernel_loop_with_plain_steps_equals_plain_solve(port):
    """The loop the kernel path runs (4 iterations a launch from 4-row
    halo slabs, one psum of the launch's sums, the stop rule walked over
    them, the flags every 8 iterations, the rebuild) with the plain blocked
    step: the same pixels and iteration counts as the plain sharded
    solve."""
    got = _rows([r[0] for r in port["tv_steps"]])
    want = _rows([r[0] for r in port["tv"]])
    np.testing.assert_array_equal(got, want)
    for a, b in zip(port["tv_steps"], port["tv"]):
        assert a[1].tolist() == b[1].tolist()


def test_tv_sharded_vs_jax_banded_kernel_interpret(port, mesh14):
    fn = _smap(mesh14, partial(JT.tv_sharded, row_axis="space", banded=True,
                               interpret=True, eps=0.0, max_iter=9),
               in_specs=IMG_VEC)
    want = np.asarray(fn(jnp.asarray(XT), jnp.asarray(TV_W)))
    assert [r[1].tolist() for r in port["tv_fixed"]] == [[9, 9]] * K
    np.testing.assert_allclose(_rows([r[0] for r in port["tv_fixed"]]), want,
                               rtol=0, atol=parity.KERNEL_TOL["tv_shard_step"][1])


# ------------------------------------------------------------- the slice

def test_image_stats_spatial(port, mesh14):
    want = jax.tree_util.tree_map(
        np.asarray, JS.image_stats_spatial(jnp.asarray(XA), mesh14))
    for r in port["stats"]:
        bad = parity.breaches(parity.flatten(r), parity.flatten(want),
                              hw=128 * 128)
        assert not bad, bad


def test_qa_spatial(port, mesh14):
    want = jax.tree_util.tree_map(
        np.asarray, JS.qa_spatial(jnp.asarray(XA), mesh14, **QA_KW))
    r0 = port["qa"][0]
    got = {k: r0[k] for k in ("stats_before", "stats_after", "ssim", "psnr",
                              "passes", "noise_amp_guard")}
    got["enhanced"] = _rows([r["enhanced"] for r in port["qa"]])
    got["issues"] = detect_issues(r0["stats_before"])
    # quality_improvement divides a sigma difference by sigma_before:
    # the validation tolerance rule (parity.tolerance) applies
    got["v.quality_improvement"] = r0["quality_improvement"]
    got["v.metrics_before.sigma"] = r0["stats_before"]["sigma"]
    want = dict(want)
    want["v.quality_improvement"] = want.pop("quality_improvement")
    want["v.metrics_before.sigma"] = want["stats_before"]["sigma"]
    bad = parity.breaches(parity.flatten(got), parity.flatten(want),
                          tv_ran=True)
    assert not bad, bad
    assert r0["noise_amp_guard"].dtype == np.bool_


def _plan_fields(per_rank):
    r0 = per_rank[0]
    return {"enhanced": _rows([r["enhanced"] for r in per_rank]),
            "flags": r0["flags"], "validation": r0["validation"],
            "score": r0["score"], "stats_before": r0["stats_before"]}


def test_qa_plan_spatial_bench_plan(port, mesh14):
    P_ = tools.PLAN_PARAMS
    static = JE.PlanStatic(ops=tools.PLAN_OPS, tile_size=16, bilateral_d=5,
                           plan_order=tools.PLAN_OPS)
    dyn = JE.PlanDynamic(
        clahe_clip_limit=P_["clahe_clip_limit"], gamma=P_["gamma"],
        unsharp_radius=P_["unsharp_radius"],
        unsharp_amount=P_["unsharp_amount"],
        post_denoise_strength=P_["post_denoise_strength"],
        bilateral_sigma_color=P_["bilateral_sigma_color"],
        bilateral_sigma_space=P_["bilateral_sigma_space"],
        tv_denoise_weight=P_["tv_denoise_weight"], denoise_soft=True)
    want = jax.tree_util.tree_map(np.asarray, j_qa_plan_spatial(
        jnp.asarray(XA), mesh14, static, dyn))
    got = _plan_fields(port["plan"])
    bad = parity.breaches(parity.flatten(got), parity.flatten(want),
                          tv_ran=True)
    assert not bad, bad
    # and against the port's dense qa_plan on the same input
    dense = parity.flatten_result(TQ.qa_plan(
        torch.from_numpy(XA), *tools.bench_plan("cpu")),
        parity.QA_PLAN_FIELDS)
    bad = parity.breaches(parity.flatten(got), dense, tv_ran=True)
    assert not bad, bad


def test_qa_plan_spatial_halo_guard_with_prefix(port, mesh14):
    want = jax.tree_util.tree_map(np.asarray, j_qa_plan_spatial(
        jnp.asarray(XB), mesh14, HALO_STATIC, HALO_DYN))
    got = _plan_fields(port["plan_halo"])
    assert got["flags"]["halo"].all(), "the plan must trip the halo guard"
    bad = parity.breaches(parity.flatten(got), parity.flatten(want))
    assert not bad, bad
