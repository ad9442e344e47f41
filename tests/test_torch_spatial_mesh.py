"""The port's row-sharded path on a 2 × 2 grid of ranks (2 data rows, k = 2
row blocks each) against the JAX package on ``make_mesh(n_data=2,
n_space=2)``, on the CPU.

One ``launch.run`` (module fixture, 120 s timeout) runs every case on the
4 gloo ranks.  The two images differ (one smooth, one noisy), so each data
row's TV solve wants a different number of iterations: the stop flag is
reduced over all ranks, the run must finish, and every image must keep its
own iteration count.  Per-image plan masks differ between the data rows.
Tolerances as in ``tests/test_torch_spatial.py``.
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
from mdx.parallel import make_mesh
from mdx.parallel import spatial as JS
from mdx.parallel import tv_sp as JT
from mdx.parallel.plan_sp import qa_plan_spatial as j_qa_plan_spatial

import mdx_torch
from mdx_torch import parity
from mdx_torch.core import enhance as TE
from mdx_torch.ops import tv as TTV
from mdx_torch.ops.quantile import percentiles_exact
from mdx_torch.parallel import launch, plan_sp, spatial, tv_sp
from mdx_torch.parallel.launch import Block

torch.set_num_threads(1)

N_DATA, K = 2, 2
H = W = 128


def _inputs():
    r = np.random.default_rng(9)
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = 0.5 + 0.2 * np.sin(xx / 21.0)
    noisy = (0.45 + 0.25 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
             + r.normal(0, 0.15, (H, W)))
    return np.clip(np.stack([smooth, noisy]), 0, 1).astype(np.float32)


X = _inputs()
QS = [5.0, 50.0, 95.0]
MASKS = {"gamma": np.array([True, False])}
STATIC = JE.PlanStatic(ops=("clahe", "gamma", "unsharp"), tile_size=16,
                       bilateral_d=0, plan_order=("clahe", "gamma", "unsharp"))
DYN = JE.PlanDynamic(clahe_clip_limit=0.03, gamma=1.1, unsharp_amount=0.8,
                     unsharp_radius=1.0, tv_denoise_weight=0.0)
ENH_KW = dict(gamma=0.9, unsharp_radius=1.0, unsharp_amount=0.6,
              bilateral_d=5, clahe_clip_limit=0.02, tv_weight=0.05,
              denoise=True, post_denoise_strength=0.3)

_T_STATIC, _T_DYN = mdx_torch.plan_from_numpy(
    dataclasses.asdict(STATIC),
    {k: np.asarray(v) for k, v in DYN._asdict().items()}, device="cpu")
CASES = {
    "halo": (spatial.halo_rows, (Block(0), 2, 2), {}),
    "pq": (spatial.pq, (Block(0), QS), {}),
    "tv": (tv_sp.tv_sharded, (Block(0), 0.05), {}),
    "stats": (spatial.image_stats_block, (Block(0),), {}),
    "enhance": (spatial.enhance_block, (Block(0),),
                spatial.enhance_kwargs(
                    bilateral_sigma_color=0.05, bilateral_sigma_space=0.05,
                    clahe_tile_size=16, **ENH_KW)),
    "plan": (plan_sp.qa_plan_block, (Block(0), _T_STATIC, _T_DYN,
                                     {k: torch.from_numpy(v)
                                      for k, v in MASKS.items()}), {}),
}


@pytest.fixture(scope="module")
def port():
    names = list(CASES)
    res = launch.run(launch.call_each, X, n_space=K, n_data=N_DATA,
                     device="cpu", timeout_s=120,
                     calls=[CASES[n] for n in names])
    assert res.backend == "gloo"
    return {n: [r[i] for r in res.results] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def mesh22():
    return make_mesh(n_data=N_DATA, n_space=K)


BLOCKS = P("data", "space", None)


def _smap(mesh, fn, in_specs):
    """The jitted shard_map of ``fn`` (jitting compiles the body once
    instead of dispatching it op by op)."""
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=BLOCKS, check_vma=False))


def _whole(per_rank, block=True):
    """Per-rank results → the whole batch: row blocks joined within a data
    row, data rows stacked."""
    rows = []
    for d in range(N_DATA):
        mine = per_rank[d * K:(d + 1) * K]
        rows.append(np.concatenate(mine, axis=1) if block else mine[0])
    return np.concatenate(rows, axis=0)


def test_halo_rows_on_two_data_rows(port, mesh22):
    fn = _smap(mesh22, partial(JS._halo_rows, up=2, down=2),
               in_specs=BLOCKS)
    np.testing.assert_array_equal(_whole(port["halo"]),
                                  np.asarray(fn(jnp.asarray(X))))


def test_percentiles_k2_bit_equal_to_whole_array(port):
    got = np.concatenate([port["pq"][d * K] for d in range(N_DATA)], axis=1)
    np.testing.assert_array_equal(
        got, percentiles_exact(torch.from_numpy(X), QS).numpy())


def test_tv_divergent_trip_counts_finish_and_match(port, mesh22):
    got = _whole([r[0] for r in port["tv"]])
    iters = [port["tv"][d * K][1].tolist() for d in range(N_DATA)]
    dense, it = TTV.tv_chambolle_plain(torch.from_numpy(X), 0.05)
    assert sum(iters, []) == it.tolist()
    assert it[0] != it[1], "the images must stop on different iterations"
    np.testing.assert_allclose(got, dense.numpy(), rtol=0,
                               atol=parity.PIXEL_ATOL)
    fn = _smap(mesh22, partial(JT.tv_sharded, row_axis="space"),
               in_specs=(BLOCKS, P()))
    want = np.asarray(fn(jnp.asarray(X), jnp.float32(0.05)))
    bad = parity.breaches({"enhanced": got}, {"enhanced": want}, tv_ran=True)
    assert not bad, bad


def test_image_stats_k2(port, mesh22):
    want = jax.tree_util.tree_map(
        np.asarray, JS.image_stats_spatial(jnp.asarray(X), mesh22))
    got = {k: _whole([r[k] for r in port["stats"]], block=False)
           for k in want}
    bad = parity.breaches(parity.flatten(got), parity.flatten(want), hw=H * W)
    assert not bad, bad


def test_enhance_k2(port, mesh22):
    want = np.asarray(JS.enhance_spatial(jnp.asarray(X), mesh22, **ENH_KW))
    got = _whole([r for r in port["enhance"]])
    bad = parity.breaches({"enhanced": got}, {"enhanced": want}, tv_ran=True)
    assert not bad, bad


def test_qa_plan_masks_per_data_row(port, mesh22):
    want = jax.tree_util.tree_map(np.asarray, j_qa_plan_spatial(
        jnp.asarray(X), mesh22, STATIC, DYN,
        masks={k: jnp.asarray(v) for k, v in MASKS.items()}))
    per = port["plan"]
    got = {"enhanced": _whole([r["enhanced"] for r in per])}
    for key in ("flags", "validation", "score", "stats_before"):
        got[key] = jax.tree_util.tree_map(
            lambda *leaves: np.concatenate(leaves, axis=0),
            *[per[d * K][key] for d in range(N_DATA)])
    bad = parity.breaches(parity.flatten(got), parity.flatten(want))
    assert not bad, bad
    # the port's dense apply_plan with the same masks
    enh, flags = TE.apply_plan(torch.from_numpy(X), _T_STATIC, _T_DYN,
                               masks={k: torch.from_numpy(v)
                                      for k, v in MASKS.items()})
    bad = parity.breaches(parity.flatten({"enhanced": got["enhanced"],
                                          "flags": got["flags"]}),
                          parity.flatten({"enhanced": enh, "flags": flags}))
    assert not bad, bad
