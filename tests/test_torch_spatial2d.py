"""The port's 2-D tile layout (``mdx_torch.parallel.spatial2d`` and the
``col_axis`` branches of the ``_sp`` modules) against the JAX package's
``mdx.parallel.spatial2d``, on the CPU.

The port runs as gloo ranks in three launches (module fixtures, each case
through ``launch.call_each``): ``(n_data, sy, sx) = (1, 2, 2)`` for every
case, ``(2, 1, 2)`` for the data axis and the column-only ring, and the 1-D
``k = 4`` row blocks for the 2-D-against-1-D check.  The JAX side runs in
this process on ``make_mesh2d(1, 2, 2)`` and ``make_mesh2d(2, 1, 2)`` of the
virtual 8-device CPU mesh.  Inputs are made with numpy from a seed.

Tolerances: the two-phase halos, the distributed percentiles, the
wavelet-MAD median and the plain blocked TV step and rebuild with null
column slabs against the row-block step they replace are exact (bit for
bit); the kernel loop with plain steps equals the plain 2-D solve bit for
bit; the sharded ops and the QA steps use ``mdx_torch.parity``
(reduction order; TV's allowance where TV ran), the 2-D CLAHE against the
dense one ``parity.SHARDED_CLAHE_ATOL``.
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
from mdx.parallel import make_mesh2d
from mdx.parallel import clahe_sp as JC
from mdx.parallel import spatial2d as J2
from mdx.parallel import tv_sp as JT
from mdx.parallel.plan_sp import qa_plan_spatial as j_qa_plan_spatial
from mdx.pipeline.spatial_runner import choose_layout as j_choose_layout

import mdx_torch
from mdx_torch import parity, tools
from mdx_torch.core import qa as TQ
from mdx_torch.core.metrics import detect_issues
from mdx_torch.ops import clahe as TC
from mdx_torch.ops import tv as TTV
from mdx_torch.ops.quantile import percentiles_exact
from mdx_torch.parallel import (clahe_sp, launch, mesh, plan_sp, spatial,
                                spatial2d, tv_sp)
from mdx_torch.parallel.launch import Block

torch.set_num_threads(1)

GRID = (2, 2)
GRID_D = (1, 2)          # with n_data = 2


def _img(seed, n, h, w, noise=0.1):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.25 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
    return np.clip(base[None] + r.normal(0, noise, (n, h, w)), 0, 1
                   ).astype(np.float32)


XA = _img(10, 2, 128, 128)
XA[1] = np.clip(0.3 + 0.4 * XA[1], 0, 1)       # a low-contrast second image
XT = _img(11, 2, 256, 128)                      # TV: 128×64 tiles
XB = _img(12, 1, 128, 128, noise=0.18)          # the halo-guard plan
V = np.random.default_rng(13).normal(0, 1, (2, 64, 96)).astype(np.float32)
INPUTS = (XA, XT, XB, V)
QS = [0.0, 5.0, 25.0, 50.0, 75.0, 95.0, 100.0]
TV_W = np.array([0.06, 0.03], np.float32)
CLIP = np.array([0.02, 0.05], np.float32)
MODES = ("symmetric", "reflect", "edge")

QA_KW = dict(gamma=0.95, unsharp_radius=1.0, unsharp_amount=0.6,
             bilateral_d=5, clahe_clip_limit=0.02, tv_weight=0.05,
             denoise=True, noise_guard=True)

HALO_STATIC = JE.PlanStatic(ops=("clahe", "gamma", "unsharp"), tile_size=16,
                            bilateral_d=0,
                            plan_order=("clahe", "gamma", "unsharp"))
HALO_DYN = JE.PlanDynamic(clahe_clip_limit=0.05, gamma=1.05,
                          unsharp_radius=1.5, unsharp_amount=2.2,
                          tv_denoise_weight=0.0)


def _bench_plan_jax():
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
    return static, dyn


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
    CASES[f"halo_{m}"] = (spatial.halo2, (Block(0), 3, 2, 4, 1),
                          {"edge_mode": m})
CASES["pq"] = (spatial.pq, (Block(3), QS), {})
CASES["sigma"] = (spatial2d.estimate_sigma_2d, (Block(0),), {})
CASES["clahe"] = (clahe_sp.clahe_sharded, (Block(0), torch.from_numpy(CLIP),
                                          16), {})
CASES["tv"] = (tv_sp.tv_sharded, (Block(1), torch.from_numpy(TV_W)), {})
CASES["tv_steps"] = (tv_sp.solve_steps, (Block(1), torch.from_numpy(TV_W)),
                     dict(eps=2e-4, max_iter=200,
                          step=tv_sp.tv_shard_step_plain,
                          finalize=tv_sp.tv_shard_finalize_plain,
                          rebuild=tv_sp.tv_shard_rebuild_plain, steps=4))
CASES["stats"] = (spatial.image_stats_block, (Block(0),), {})
CASES["qa"] = (spatial.qa_block, (Block(0),), _qa_block_kw())
CASES["plan"] = (plan_sp.qa_plan_block, (Block(0),
                                         *tools.bench_plan("cpu")), {})
CASES["plan_halo"] = (plan_sp.qa_plan_block,
                      (Block(2), *_plan_to_torch(HALO_STATIC, HALO_DYN)), {})
# a data row holds one image, so TV takes one weight for all
CASES_D = {"stats": CASES["stats"],
           "tv": (tv_sp.tv_sharded, (Block(0), 0.05), {}),
           "halo_symmetric": CASES["halo_symmetric"]}


def _run(cases, n_space, n_data=1, inputs=INPUTS):
    names = list(cases)
    res = launch.run(launch.call_each, inputs, n_space=n_space,
                     n_data=n_data, device="cpu", timeout_s=120,
                     calls=[cases[n] for n in names])
    assert res.backend == "gloo" and res.host_round_trips == [0] * len(
        res.results)
    return {n: [r[i] for r in res.results] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def port():
    """Every case on the (1, 2, 2) grid, one launch."""
    return _run(CASES, GRID)


@pytest.fixture(scope="module")
def port_d():
    """The data axis and the column-only ring: (n_data, sy, sx) = (2, 1, 2)."""
    return _run(CASES_D, GRID_D, n_data=2, inputs=(XA, XT))


@pytest.fixture(scope="module")
def port_1d():
    """The 1-D layer at k = 4 on the same input, for 2-D against 1-D."""
    return _run({"qa": CASES["qa"]}, 4)


@pytest.fixture(scope="module")
def mesh122():
    return make_mesh2d(n_data=1, n_sy=2, n_sx=2)


@pytest.fixture(scope="module")
def mesh212():
    return make_mesh2d(n_data=2, n_sy=1, n_sx=2)


def _tiles(per_rank, grid=GRID, n_data=1):
    """Tiles of the ranks → the whole array."""
    return launch.assemble([{"t": t} for t in per_rank], n_data, grid,
                           block_keys=("t",))["t"]


TILE = P(None, "sy", "sx")


def _smap(mesh, fn, in_specs=(TILE,), out_specs=TILE, jit=True):
    """The shard_map of ``fn`` on tiles, jitted (one compile instead of op
    by op dispatch) unless ``jit`` is False."""
    f = shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                  check_vma=False)
    return jax.jit(f) if jit else f


# ------------------------------------------------- halos and reductions

@pytest.mark.parametrize("mode", MODES)
def test_two_phase_halo_bit_equal_to_jax(port, mesh122, mode):
    want = _smap(mesh122, partial(J2._halo2, up=3, down=2, left=4, right=1,
                                  mode=mode))(jnp.asarray(XA))
    np.testing.assert_array_equal(_tiles(port[f"halo_{mode}"]),
                                  np.asarray(want))


def test_halo_over_the_data_axis_and_a_column_ring(port_d, mesh212):
    want = _smap(mesh212, partial(J2._halo2, up=3, down=2, left=4, right=1,
                                  mode="symmetric"),
                 in_specs=(P("data", "sy", "sx"),),
                 out_specs=P("data", "sy", "sx"))(jnp.asarray(XA))
    np.testing.assert_array_equal(
        _tiles(port_d["halo_symmetric"], GRID_D, n_data=2), np.asarray(want))


def test_percentiles_bit_equal_to_whole_array_and_jax(port, mesh122):
    whole = percentiles_exact(torch.from_numpy(V), QS).numpy()
    # op by op, not jitted: XLA's fused CPU program rounds an interpolated
    # value one ulp away from the op-by-op result, which the port and
    # percentiles_exact give bit for bit (as in tests/test_torch_spatial.py)
    want = _smap(mesh122, partial(J2._pq, qs=QS), out_specs=P(), jit=False)(
        jnp.asarray(V))
    for r in port["pq"]:
        np.testing.assert_array_equal(r, whole)
        np.testing.assert_array_equal(r, np.asarray(want))


def test_wavelet_mad_sigma_bit_equal_to_jax(port, mesh122):
    want = _smap(mesh122, J2.estimate_sigma_2d, out_specs=P(), jit=False)(
        jnp.asarray(XA))
    for r in port["sigma"]:
        np.testing.assert_array_equal(r, np.asarray(want))


# ---------------------------------------------------- kernel 11's module

def test_clahe_2d_vs_jax_and_dense(port, mesh122):
    fn = _smap(mesh122, partial(JC.clahe_sharded, tile_size=16,
                                row_axis="sy", col_axis="sx",
                                force_pallas=False), in_specs=(TILE, P()))
    want = np.asarray(fn(jnp.asarray(XA), jnp.asarray(CLIP)))
    got = _tiles(port["clahe"])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=parity.KERNEL_TOL["clahe_remap_ext"][1])
    dense = TC.clahe_plain(torch.from_numpy(XA), torch.from_numpy(CLIP),
                           16).numpy()
    np.testing.assert_allclose(got, dense, rtol=0,
                               atol=parity.SHARDED_CLAHE_ATOL)


# ---------------------------------------------------- kernel 12's module

# the plain step of the 1-D layer as it was before the column halos and
# the blocked step (its expressions verbatim): the blocked step and rebuild
# of one iteration on a row block with null column slabs must give its bits
def _step_1d(x, p_in, p_out, out, active, weight, up_p0, dn_x, dn_p0, dn_p1,
             glast):
    n, hs, w = x.shape
    p0, p1 = p_in[:, 0], p_in[:, 1]
    zrow = x.new_zeros((n, 1, w))
    zcol = x.new_zeros((n, hs, 1))

    def row(v):
        return zrow if v is None else v[:, None, :]

    d = -(p0 + p1)
    d = d + torch.cat([row(up_p0), p0[:, :-1]], dim=1)
    d = d + torch.cat([zcol, p1[:, :, :-1]], dim=2)
    o = x + d
    if glast:
        gy = torch.cat([o[:, 1:] - o[:, :-1], zrow], dim=1)
    else:
        dn1 = row(dn_p1)
        ddn = -(row(dn_p0) + dn1)
        ddn = ddn + p0[:, -1:]
        ddn = ddn + torch.cat([zrow[:, :, :1], dn1[:, :, :-1]], dim=2)
        gy = torch.cat([o[:, 1:], row(dn_x) + ddn], dim=1) - o
    gx = torch.cat([o[:, :, 1:] - o[:, :, :-1], zcol], dim=2)
    norm = torch.sqrt(gy * gy + gx * gx)
    scale = norm * 0.25 / weight[:, None, None] + 1.0
    a = active.bool()
    p_out[a] = torch.stack([(p0 - 0.25 * gy) / scale,
                            (p1 - 0.25 * gx) / scale], dim=1)[a]
    out[a] = o[a]
    sums = torch.stack([(d * d).sum(dim=(1, 2), dtype=torch.float64),
                        norm.sum(dim=(1, 2), dtype=torch.float64)], dim=1)
    return torch.where(a[:, None], sums, 0.0)


@pytest.mark.parametrize("glast,rows", [(True, False), (False, True)])
def test_plain_step_with_null_column_halos_is_the_1d_step(glast, rows):
    """One iteration (m = 1, one-row slabs) of the blocked step on a row
    block — the whole image, or the middle block of three — and the rebuild
    with r = 0: the dual, the sums and the output of the row-block step."""
    g = torch.Generator().manual_seed(7)
    n, h, w = 3, 40, 56
    rnd = lambda *s: 0.05 * torch.randn(*s, generator=g)  # noqa: E731
    x = torch.from_numpy(_img(14, n, h, w))
    p = rnd(n, 2, h, w)
    active = torch.tensor([1, 0, 1], dtype=torch.int32)
    weight = torch.tensor([0.03, 0.05, 0.1])
    if rows:
        up, dn, dn_x = rnd(n, 2, 1, w), rnd(n, 2, 1, w), x[:, :1].clone()
        x_slabs = (rnd(n, 1, 1, w), dn_x[:, None], None, None)
        p_slabs = (up, dn, None, None)
        halo = (up[:, 0, 0], dn_x[:, 0], dn[:, 0, 0], dn[:, 1, 0])
        geo = (3 * h, w, h, 0, 1)
    else:
        x_slabs = p_slabs = None
        halo = (None,) * 4
        geo = (h, w, 0, 0, 1)
    p_out = rnd(n, 2, h, w)
    want_p, want_out = p_out.clone(), rnd(n, h, w)
    want = _step_1d(x, p, want_p, want_out, active, weight, *halo, glast)
    got = tv_sp.tv_shard_step_plain(x, p, p_out, active, weight, x_slabs,
                                    p_slabs, geo, 1)
    np.testing.assert_array_equal(got[:, 0].numpy(), want.numpy())
    np.testing.assert_array_equal(p_out.numpy(), want_p.numpy())
    base = torch.full((n,), 5, dtype=torch.int32)         # odd: p_odd = p
    out = tv_sp.tv_shard_rebuild_plain(
        x, torch.full_like(p, float("nan")), p, base + 1, base, weight,
        x_slabs, None, p_slabs, geo, 1)
    a = active.bool()
    np.testing.assert_array_equal(out[a].numpy(), want_out[a].numpy())


def test_tv_2d_vs_jax_and_dense(port, mesh122):
    fn = _smap(mesh122, partial(JT.tv_sharded, row_axis="sy",
                                col_axis="sx"), in_specs=(TILE, P()))
    want = np.asarray(fn(jnp.asarray(XT), jnp.asarray(TV_W)))
    got = _tiles([r[0] for r in port["tv"]])
    bad = parity.breaches({"enhanced": got}, {"enhanced": want}, tv_ran=True)
    assert not bad, bad
    dense, it = TTV.tv_chambolle_plain(torch.from_numpy(XT),
                                       torch.from_numpy(TV_W))
    for r in port["tv"]:
        assert r[1].tolist() == it.tolist()
    np.testing.assert_allclose(got, dense.numpy(), rtol=0,
                               atol=parity.PIXEL_ATOL)


def test_tv_kernel_loop_with_plain_steps_equals_plain_2d_solve(port):
    """The loop the kernel path runs (halo rows, then the columns of the
    row-extended dual with its corners, the sums over the tile group) with
    the plain step: the same pixels and iteration counts as the plain 2-D
    body."""
    np.testing.assert_array_equal(_tiles([r[0] for r in port["tv_steps"]]),
                                  _tiles([r[0] for r in port["tv"]]))
    for a, b in zip(port["tv_steps"], port["tv"]):
        assert a[1].tolist() == b[1].tolist()


def test_tv_over_the_data_axis(port_d, mesh212):
    fn = _smap(mesh212, partial(JT.tv_sharded, row_axis="sy",
                                col_axis="sx"),
               in_specs=(P("data", "sy", "sx"), P()),
               out_specs=P("data", "sy", "sx"))
    want = np.asarray(fn(jnp.asarray(XA), jnp.float32(0.05)))
    got = _tiles([r[0] for r in port_d["tv"]], GRID_D, n_data=2)
    bad = parity.breaches({"enhanced": got}, {"enhanced": want}, tv_ran=True)
    assert not bad, bad
    _, it = TTV.tv_chambolle_plain(torch.from_numpy(XA),
                                   torch.full((2,), 0.05))
    assert it[0] != it[1], "the data rows must stop on different iterations"
    for rank, r in enumerate(port_d["tv"]):
        assert r[1].tolist() == [it[rank // 2].item()]


# ------------------------------------------------------------- the slice

def _stats_vs(per_rank, want, n_rows=1):
    for rank, r in enumerate(per_rank):
        d = rank // (len(per_rank) // n_rows)
        w = {k: v[d:d + 1] if n_rows > 1 else v for k, v in want.items()}
        bad = parity.breaches(parity.flatten(r), parity.flatten(w),
                              hw=128 * 128)
        assert not bad, bad


def test_image_stats_2d(port, mesh122):
    want = jax.tree_util.tree_map(
        np.asarray, J2.image_stats_spatial2d(jnp.asarray(XA), mesh122))
    _stats_vs(port["stats"], want)


def test_image_stats_over_the_data_axis(port_d, mesh212):
    want = jax.tree_util.tree_map(
        np.asarray, J2.image_stats_spatial2d(jnp.asarray(XA), mesh212))
    _stats_vs(port_d["stats"], want, n_rows=2)


def _qa_fields(per_rank):
    r0 = per_rank[0]
    got = {k: r0[k] for k in ("stats_before", "stats_after", "ssim", "psnr",
                              "passes", "noise_amp_guard")}
    got["enhanced"] = _tiles([r["enhanced"] for r in per_rank])
    got["issues"] = detect_issues(r0["stats_before"])
    # quality_improvement divides a sigma difference by sigma_before:
    # the validation tolerance rule (parity.tolerance) applies
    got["v.quality_improvement"] = r0["quality_improvement"]
    got["v.metrics_before.sigma"] = r0["stats_before"]["sigma"]
    return got


def test_qa_spatial2d(port, mesh122):
    want = dict(jax.tree_util.tree_map(
        np.asarray, J2.qa_spatial2d(jnp.asarray(XA), mesh122, **QA_KW)))
    want["v.quality_improvement"] = want.pop("quality_improvement")
    want["v.metrics_before.sigma"] = want["stats_before"]["sigma"]
    got = _qa_fields(port["qa"])
    bad = parity.breaches(parity.flatten(got), parity.flatten(want),
                          tv_ran=True)
    assert not bad, bad


def test_2d_matches_1d_row_blocks(port, port_1d):
    """2-D tiles and the port's own 1-D k = 4 row blocks on the same input
    (both hold the dense program; ``tests/test_spatial2d.py``
    ``test_matches_1d_row_blocks``)."""
    got = _qa_fields(port["qa"])
    r0 = port_1d["qa"][0]
    want = {k: r0[k] for k in ("stats_before", "stats_after", "ssim", "psnr",
                               "passes", "noise_amp_guard")}
    want["enhanced"] = np.concatenate([r["enhanced"] for r in port_1d["qa"]],
                                      axis=1)
    bad = parity.breaches(parity.flatten(got), parity.flatten(want),
                          tv_ran=True)
    assert not bad, bad


def _plan_fields(per_rank):
    r0 = per_rank[0]
    return {"enhanced": _tiles([r["enhanced"] for r in per_rank]),
            "flags": r0["flags"], "validation": r0["validation"],
            "score": r0["score"], "stats_before": r0["stats_before"]}


def test_qa_plan_spatial_2d_bench_plan(port, mesh122):
    want = jax.tree_util.tree_map(np.asarray, j_qa_plan_spatial(
        jnp.asarray(XA), mesh122, *_bench_plan_jax()))
    got = _plan_fields(port["plan"])
    bad = parity.breaches(parity.flatten(got), parity.flatten(want),
                          tv_ran=True)
    assert not bad, bad
    dense = parity.flatten_result(TQ.qa_plan(
        torch.from_numpy(XA), *tools.bench_plan("cpu")),
        parity.QA_PLAN_FIELDS)
    bad = parity.breaches(parity.flatten(got), dense, tv_ran=True)
    assert not bad, bad


def test_qa_plan_spatial_2d_halo_guard(port, mesh122):
    want = jax.tree_util.tree_map(np.asarray, j_qa_plan_spatial(
        jnp.asarray(XB), mesh122, HALO_STATIC, HALO_DYN))
    got = _plan_fields(port["plan_halo"])
    assert got["flags"]["halo"].all(), "the plan must trip the halo guard"
    bad = parity.breaches(parity.flatten(got), parity.flatten(want))
    assert not bad, bad


# --------------------------------------------- shape checks and layouts

def _same_message(port_call, jax_call):
    with pytest.raises(ValueError) as port_err:
        port_call()
    with pytest.raises(ValueError) as jax_err:
        jax_call()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("shape,grid", [
    ((1, 64, 60), (2, 4)),        # 15 columns a tile: odd
    ((1, 64, 32), (2, 4)),        # 8 columns a tile: fewer than 16
    ((1, 42, 64), (2, 4)),        # 21 rows a tile: odd
])
def test_tile_checks_raise_with_jax_messages(shape, grid):
    x = np.zeros(shape, np.float32)
    jmesh = make_mesh2d(n_data=1, n_sy=grid[0], n_sx=grid[1])
    _same_message(
        lambda: spatial2d.image_stats_spatial2d(x, grid, device="cpu"),
        lambda: J2.image_stats_spatial2d(jnp.asarray(x), jmesh))
    _same_message(lambda: spatial2d.enhance_spatial2d(x, grid, device="cpu"),
                  lambda: J2.enhance_spatial2d(jnp.asarray(x), jmesh))
    _same_message(lambda: spatial2d.qa_spatial2d(x, grid, device="cpu"),
                  lambda: J2.qa_spatial2d(jnp.asarray(x), jmesh))
    static, dyn = mdx_torch.plan_from_numpy({"ops": ("unsharp",)}, {},
                                            device="cpu")
    _same_message(
        lambda: plan_sp.qa_plan_spatial(x, grid, static, dyn, device="cpu"),
        lambda: j_qa_plan_spatial(jnp.asarray(x), jmesh,
                                  JE.PlanStatic(ops=("unsharp",)),
                                  JE.PlanDynamic()))


def test_misaligned_clahe_tiles_raise_with_jax_messages():
    x = np.zeros((1, 64, 96), np.float32)      # 32×48 tiles, CLAHE tile 32
    jmesh = make_mesh2d(n_data=1, n_sy=2, n_sx=2)
    _same_message(
        lambda: spatial.qa_spatial(x, (2, 2), clahe_clip_limit=0.02,
                                   clahe_tile_size=32, device="cpu"),
        lambda: J2.qa_spatial2d(jnp.asarray(x), jmesh, clahe_clip_limit=0.02,
                                clahe_tile_size=32))
    static, dyn = mdx_torch.plan_from_numpy(
        {"ops": ("clahe", "unsharp"), "tile_size": 32}, {}, device="cpu")
    _same_message(
        lambda: plan_sp.qa_plan_spatial(x, (2, 2), static, dyn, device="cpu"),
        lambda: j_qa_plan_spatial(
            jnp.asarray(x), jmesh,
            JE.PlanStatic(ops=("clahe", "unsharp"), tile_size=32),
            JE.PlanDynamic()))


def test_choose_layout_is_jax_copy():
    for h in (16, 48, 64, 96, 100, 512, 2048):
        for w in (16, 32, 60, 64, 128, 2048):
            for n in (1, 2, 3, 4, 6, 8):
                assert mesh.choose_layout(h, w, n) == j_choose_layout(h, w, n)
    assert mesh.choose_layout(2048, 2048, 4) == (2, 2)


def test_qa_plan_spatial_entry_point_on_a_grid():
    """The host entry point with ``n_space=(2, 2)``: four gloo ranks, the
    launch reported as a grid, the frame within ``parity.breaches`` of the
    dense ``qa_plan``."""
    x = tools.make_batch(1, 64, seed=6)
    got = plan_sp.qa_plan_spatial(x, (2, 2), *tools.bench_plan("cpu"),
                                  device="cpu", timeout_s=120)
    assert got["launch"] == {"backend": "gloo", "n_space": (2, 2),
                             "n_data": 1, "host_round_trips": 0}
    want = parity.flatten_result(
        TQ.qa_plan(torch.from_numpy(x.copy()), *tools.bench_plan("cpu")),
        parity.QA_PLAN_FIELDS)
    bad = parity.breaches(parity.flatten(
        {k: got[k] for k in parity.QA_PLAN_FIELDS}), want, tv_ran=True)
    assert not bad, bad
