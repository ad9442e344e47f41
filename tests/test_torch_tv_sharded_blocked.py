"""The schedule of the blocked sharded TV kernel (kernel 12, ``csrc/tv.cu``),
run on the CPU with the kernels' plain versions and held to the plain
sharded solve bit for bit.

The CUDA kernels run only on the card.  ``tv_sp.solve_steps`` is the loop
the card runs (s-wide halo slabs of x once a solve and of the dual once a
launch, one psum of the launch's per-iteration sums, the stop rule walked
over them, a ping-pong pair of dual buffers with a slab set each, the flags
read over all ranks every ``_CHECK_EVERY`` iterations, the rebuild from each
image's base launch), and ``tv_shard_step_plain`` /
``tv_shard_finalize_plain`` / ``tv_shard_rebuild_plain`` are the kernels'
plain versions.  The plain step poisons every cell that is no longer exact
with NaN, and the dual buffers start as NaN, so a read outside the
shrinking valid region, or of a buffer no launch wrote, shows in the
result.

The ranks run in two ``launch.run`` calls (k = 4 row blocks and a 2 × 2
grid, every case through ``launch.call_each``).  Tolerances: the loop
against ``tv_sharded_plain`` bit for bit in pixels and counts (both sum the
energies over the block in the same float64 order); against JAX's
``tv_sharded`` (its XLA body, and on the 1-D layout its banded Pallas
kernel in interpret mode) 1e-6, the bar of tests/test_torch_tv_blocked.py.
The card tests (tests/test_torch_cuda.py) hold the kernels themselves to
these plain versions.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mdx.parallel import make_mesh, make_mesh2d
from mdx.parallel import tv_sp as JT

from mdx_torch.ops import tv as TTV
from mdx_torch.parallel import launch, tv_sp
from mdx_torch.parallel.launch import Block

torch.set_num_threads(1)

S = 4                       # the kernel's iterations a launch (TV_S)
NAN = float("nan")


def _img(seed, n, h, w, noise=0.1):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.45 + 0.25 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
    return np.clip(base[None] + r.normal(0, noise, (n, h, w)), 0, 1
                   ).astype(np.float32)


XT = _img(21, 2, 256, 128)               # 64-row blocks, 128 × 64 tiles
XMIX = np.repeat(_img(22, 1, 64, 96), 3, axis=0)
XTHIN = _img(23, 2, 12, 6)               # 3-row blocks, 6 × 3 tiles
INPUTS = (XT, XMIX, XTHIN)
TV_W = torch.tensor([0.06, 0.03])
# images of one batch that stop in three different launches of both
# parities (asserted below)
MIX_W = torch.tensor([0.01, 0.03, 0.5])
CAPS = range(1, 2 * S + 2)


def _loop(block, weight, steps=S, **kw):
    return (tv_sp.solve_steps, (Block(block), weight), dict(
        eps=kw.get("eps", 2e-4), max_iter=kw.get("max_iter", 200),
        step=tv_sp.tv_shard_step_plain,
        finalize=tv_sp.tv_shard_finalize_plain,
        rebuild=tv_sp.tv_shard_rebuild_plain, steps=steps))


def _plain(block, weight, **kw):
    return (tv_sp.tv_sharded_plain, (Block(block), weight), kw)


CASES = {"plain": _plain(0, TV_W), "loop_s4": _loop(0, TV_W),
         "loop_s2": _loop(0, TV_W, steps=2),
         "mix_plain": _plain(1, MIX_W), "mix_loop": _loop(1, MIX_W),
         "thin_plain": _plain(2, TV_W), "thin_loop": _loop(2, TV_W),
         "fixed_loop": _loop(0, TV_W, eps=0.0, max_iter=9)}
for _cap in CAPS:
    CASES[f"cap{_cap}_plain"] = _plain(0, TV_W, eps=0.0, max_iter=_cap)
    CASES[f"cap{_cap}_loop"] = _loop(0, TV_W, eps=0.0, max_iter=_cap)

LAYOUTS = {"k4": 4, "2x2": (2, 2)}


@pytest.fixture(scope="module")
def port():
    """Every case on k = 4 row blocks and on a 2 × 2 grid, one launch each
    → {layout: {case: [per-rank (out, iterations)]}}."""
    names = list(CASES)
    got = {}
    for name, n_space in LAYOUTS.items():
        res = launch.run(launch.call_each, INPUTS, n_space=n_space,
                         device="cpu", timeout_s=120,
                         calls=[CASES[n] for n in names])
        assert res.backend == "gloo"
        got[name] = {n: [r[i] for r in res.results]
                     for i, n in enumerate(names)}
    return got


def _whole(per_rank, layout):
    return launch.assemble([{"t": r[0]} for r in per_rank], 1,
                           LAYOUTS[layout], block_keys=("t",))["t"]


def _assert_loop_equals_plain(port, layout, loop, plain):
    got, want = port[layout][loop], port[layout][plain]
    counts = [r[1].tolist() for r in want]
    assert [r[1].tolist() for r in got] == counts       # counts first
    out = _whole(got, layout)
    assert not np.isnan(out).any()
    np.testing.assert_array_equal(out, _whole(want, layout))
    return counts[0]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("steps", [2, 4])
def test_loop_with_plain_blocked_steps_equals_plain_solve(port, layout,
                                                          steps):
    counts = _assert_loop_equals_plain(port, layout, f"loop_s{steps}",
                                       "plain")
    assert all(1 < c < 200 for c in counts), counts


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("cap", list(CAPS))
def test_loop_stops_at_every_offset(port, layout, cap):
    # eps = 0 never stops early: every image runs to the cap, which ends
    # the last launch at offset (cap - 1) % s, and a cap that is not a
    # multiple of s makes the last launch short
    counts = _assert_loop_equals_plain(port, layout, f"cap{cap}_loop",
                                       f"cap{cap}_plain")
    assert counts == [cap, cap]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loop_mixed_stops(port, layout):
    # each image keeps its own base launch and reads its dual, and its
    # neighbours' slabs, from that launch's buffer
    counts = _assert_loop_equals_plain(port, layout, "mix_loop",
                                       "mix_plain")
    launches = [(c - 1) // S for c in counts]
    assert len(set(launches)) == 3, counts
    assert len({n % 2 for n in launches}) == 2, counts
    assert len({(c - 1) % S for c in counts}) > 1, counts


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_blocks_thinner_than_s(port, layout):
    # 3-row blocks (and 3-column tiles): m = 3 iterations a launch with
    # 3-wide halos, still the kernel's loop
    _assert_loop_equals_plain(port, layout, "thin_loop", "thin_plain")


def _smap(mesh, fn, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loop_vs_jax_xla_body(port, layout):
    if layout == "k4":
        mesh, axes = make_mesh(n_data=1, n_space=4), dict(row_axis="space")
        spec = P(None, "space", None)
    else:
        mesh = make_mesh2d(n_data=1, n_sy=2, n_sx=2)
        axes, spec = dict(row_axis="sy", col_axis="sx"), P(None, "sy", "sx")
    fn = _smap(mesh, partial(JT.tv_sharded, **axes), (spec, P()), spec)
    want = np.asarray(fn(jnp.asarray(XT), jnp.asarray(TV_W.numpy())))
    np.testing.assert_allclose(_whole(port[layout]["loop_s4"], layout), want,
                               rtol=0, atol=1e-6)


def test_loop_vs_jax_banded_kernel_interpret(port):
    mesh = make_mesh(n_data=1, n_space=4)
    spec = P(None, "space", None)
    fn = _smap(mesh, partial(JT.tv_sharded, row_axis="space", banded=True,
                             interpret=True, eps=0.0, max_iter=9),
               (spec, P()), spec)
    want = np.asarray(fn(jnp.asarray(XT), jnp.asarray(TV_W.numpy())))
    assert [r[1].tolist() for r in port["k4"]["fixed_loop"]] == [[9, 9]] * 4
    np.testing.assert_allclose(_whole(port["k4"]["fixed_loop"], "k4"), want,
                               rtol=0, atol=1e-6)


# ------------------------------------------- the step and rebuild alone

def _dense_blocked(x, weight, eps, max_iter, s):
    """The loop on one block that is the whole image (origin 0, no slabs),
    without collectives: the dense solve in the sharded step's form."""
    n, h, w = x.shape
    geo = (h, w, 0, 0, s)
    bufs = (torch.full((n, 2, h, w), NAN), torch.full((n, 2, h, w), NAN))
    e0, e_prev = torch.zeros(n), torch.zeros(n)
    active = torch.ones(n, dtype=torch.int32)
    iters = torch.zeros(n, dtype=torch.int32)
    base = torch.zeros(n, dtype=torch.int32)
    a = launches = 0
    while a < max_iter and bool(active.any()):
        m = min(s, max_iter - a)
        sums = tv_sp.tv_shard_step_plain(
            x, bufs[launches % 2] if a else None, bufs[1 - launches % 2],
            active, weight, None, None, geo, m)
        tv_sp.tv_shard_finalize_plain(sums, weight, e0, e_prev, active,
                                      iters, base, a, eps, float(h * w))
        a += m
        launches += 1
    return tv_sp.tv_shard_rebuild_plain(x, bufs[0], bufs[1], iters, base,
                                        weight, None, None, None, geo,
                                        s), iters


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("shape", [(3, 5, 7), (3, 33, 129), (3, 64, 80)])
def test_dense_blocked_step_equals_tv_chambolle_plain(shape, s):
    x = torch.from_numpy(_img(24, *shape))
    w = torch.tensor([0.05, 0.1, 0.02])
    got, it = _dense_blocked(x, w, 2e-4, 200, s)
    want, it_p = TTV.tv_chambolle_plain(x, w)
    assert it.tolist() == it_p.tolist()
    assert torch.equal(got, want)


def _interior(seed, n=2, h=10, w=12, hw=S, planes=2):
    """A block at (h, w) of a 3h × 3w image with random slabs of every
    side: (block, slabs, geo)."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: 0.05 * torch.randn(*s, generator=g)  # noqa: E731
    slabs = (rnd(n, planes, hw, w), rnd(n, planes, hw, w),
             rnd(n, planes, h + 2 * hw, hw), rnd(n, planes, h + 2 * hw, hw))
    return rnd(n, planes, h, w), slabs, (3 * h, 3 * w, h, w, hw)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_step_reads_only_m_cells_of_halo(m):
    # slab cells farther than m from the block poisoned with NaN change
    # nothing in m iterations; the cell at distance m is read
    x, xs, geo = _interior(1, planes=1)
    p, ps, _ = _interior(2)
    x = 0.5 + x[:, 0]

    def far(slabs, d):
        up, dn, lf, rt = (t.clone() for t in slabs)
        up[:, :, :S - d], dn[:, :, d:] = NAN, NAN
        lf[:, :, :, :S - d], rt[:, :, :, d:] = NAN, NAN
        lf[:, :, :S - d], lf[:, :, -(S - d):] = NAN, NAN
        rt[:, :, :S - d], rt[:, :, -(S - d):] = NAN, NAN
        return up, dn, lf, rt

    active = torch.ones(2, dtype=torch.int32)
    w = torch.tensor([0.05, 0.1])

    def run(xs_, ps_):
        out = torch.zeros_like(p)
        sums = tv_sp.tv_shard_step_plain(x, p, out, active, w, xs_, ps_,
                                         geo, m)
        return out, sums

    want = run(xs, ps)
    got = run(far(xs, m), far(ps, m))
    for u, v in zip(got, want):
        assert torch.equal(u, v)
    nan = run(far(xs, m - 1), far(ps, m - 1))
    assert bool(torch.isnan(nan[0]).any())


def test_rebuild_reads_the_slabs_of_its_buffer():
    # image 0 from p = 0 (a = 0), 1 from the even buffer, 2 from the odd
    # one: each as if both buffers and slab sets were its own, and not so
    # with the sets swapped
    n = 3
    x, xs, geo = _interior(3, n=n, planes=1)
    x = 0.5 + x[:, 0]
    pe, se, _ = _interior(4, n=n)
    po, so, _ = _interior(5, n=n)
    base = torch.tensor([0, 2 * S, 3 * S], dtype=torch.int32)
    iters = base + torch.tensor([2, S, 1], dtype=torch.int32)
    w = torch.tensor([0.05, 0.1, 0.02])
    got = tv_sp.tv_shard_rebuild_plain(x, pe, po, iters, base, w, xs, se, so,
                                       geo, S)
    assert not torch.isnan(got).any()
    for i, (p, sl) in enumerate(((pe, se), (pe, se), (po, so))):
        want = tv_sp.tv_shard_rebuild_plain(x, p, p, iters, base, w, xs, sl,
                                            sl, geo, S)
        assert torch.equal(got[i], want[i])
    swapped = tv_sp.tv_shard_rebuild_plain(x, pe, po, iters, base, w, xs, so,
                                           se, geo, S)
    assert torch.equal(swapped[0], got[0])
    assert not torch.equal(swapped[1], got[1])
    assert not torch.equal(swapped[2], got[2])
