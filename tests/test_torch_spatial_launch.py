"""The launch layer, the host entry points and the refusals of the port's
row-sharded path, on the CPU.

* The backend rule: NCCL only with one card per rank, gloo otherwise.
* The four host entry points (``image_stats_spatial``, ``enhance_spatial``,
  ``qa_spatial``, ``qa_plan_spatial``) end to end on [1,64,64] over 2
  ranks: against each other where they share a body, and ``qa_plan_spatial``
  against the port's dense ``qa_plan`` (``parity.breaches``).
* The shape checks raise with the JAX layer's messages; a rank that raises
  makes ``launch.run`` raise in the parent, well inside its timeout;
  ``device="cuda"`` without a card raises.
* The tolerances of kernels 11 and 12 and of the sharded CLAHE are pinned.
"""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdx.core import enhance as JE
from mdx.parallel import make_mesh
from mdx.parallel import spatial as JS
from mdx.parallel.plan_sp import qa_plan_spatial as j_qa_plan_spatial

import mdx_torch
from mdx_torch import parity, tools
from mdx_torch.core import qa as TQ
from mdx_torch.parallel import launch, plan_sp, spatial
from mdx_torch.parallel.launch import Block
from mdx_torch.parallel.mesh import choose_backend

torch.set_num_threads(1)

X = tools.make_batch(1, 64, seed=6)
KW = dict(gamma=0.95, unsharp_radius=1.0, unsharp_amount=0.6, bilateral_d=5,
          clahe_clip_limit=0.02, tv_weight=0.05, denoise=True)


@pytest.mark.parametrize("device,world,cards,backend,want", [
    ("cpu", 4, 0, None, "gloo"),
    ("cuda", 4, 1, None, "gloo"),     # ranks share a card: NCCL refuses
    ("cuda", 1, 1, None, "nccl"),
    ("cuda", 4, 4, None, "nccl"),
    ("cuda", 4, 4, "gloo", "gloo"),
])
def test_backend_rule(device, world, cards, backend, want):
    assert choose_backend(device, world, cards, backend) == want


@pytest.mark.parametrize("device,world,cards,backend", [
    ("cuda", 4, 1, "nccl"), ("cpu", 2, 0, "nccl"), ("cpu", 2, 0, "mpi")])
def test_backend_rule_refuses(device, world, cards, backend):
    with pytest.raises(ValueError):
        choose_backend(device, world, cards, backend)


def test_split_and_assemble_round_trip():
    x = np.arange(4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3)
    blocks = [launch.split(x, r, 2, 2) for r in range(4)]
    assert blocks[1].shape == (2, 4, 3)
    results = [{"enhanced": b, "score": b[:, 0, 0]} for b in blocks]
    out = launch.assemble(results, 2, 2)
    np.testing.assert_array_equal(out["enhanced"], x)
    np.testing.assert_array_equal(out["score"], x[:, 0, 0])


@pytest.fixture(scope="module")
def entry_points():
    static, dyn = tools.bench_plan("cpu")
    return {
        "stats": spatial.image_stats_spatial(X, 2, device="cpu",
                                             timeout_s=120),
        "enhance": spatial.enhance_spatial(X, 2, device="cpu",
                                           timeout_s=120, **KW),
        "qa": spatial.qa_spatial(X, 2, device="cpu", timeout_s=120, **KW),
        "plan": plan_sp.qa_plan_spatial(X, 2, static, dyn, device="cpu",
                                        timeout_s=120),
    }


def test_entry_points_agree(entry_points):
    e = entry_points
    for r in e.values():
        if isinstance(r, dict):
            assert r["launch"] == {"backend": "gloo", "n_space": 2,
                                   "n_data": 1, "host_round_trips": 0}
    np.testing.assert_array_equal(e["qa"]["enhanced"], e["enhance"])
    for k, v in e["stats"].items():
        if k != "launch":
            np.testing.assert_array_equal(e["qa"]["stats_before"][k], v)
    assert set(e["qa"]["issues"]) == set(mdx_torch.ISSUE_ORDER)
    assert e["qa"]["enhanced"].shape == X.shape


def test_qa_plan_spatial_entry_vs_dense(entry_points):
    got = {k: entry_points["plan"][k] for k in parity.QA_PLAN_FIELDS}
    want = parity.flatten_result(
        TQ.qa_plan(torch.from_numpy(X.copy()), *tools.bench_plan("cpu")),
        parity.QA_PLAN_FIELDS)
    bad = parity.breaches(parity.flatten(got), want, tv_ran=True)
    assert not bad, bad


def _same_message(port_call, jax_call):
    with pytest.raises(ValueError) as port_err:
        port_call()
    with pytest.raises(ValueError) as jax_err:
        jax_call()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("h", [100, 40])
def test_stats_shape_check_messages(h):
    x = np.zeros((1, h, 32), np.float32)
    _same_message(lambda: spatial.image_stats_spatial(x, 4, device="cpu"),
                  lambda: JS.image_stats_spatial(jnp.asarray(x),
                                                 make_mesh(1, 4)))
    _same_message(lambda: spatial.qa_spatial(x, 4, device="cpu"),
                  lambda: JS.qa_spatial(jnp.asarray(x), make_mesh(1, 4)))


def test_enhance_and_clahe_shape_check_messages():
    x = np.zeros((1, 48, 48), np.float32)
    _same_message(lambda: spatial.enhance_spatial(x, 4, device="cpu"),
                  lambda: JS.enhance_spatial(jnp.asarray(x), make_mesh(1, 4)))
    x = np.zeros((1, 64, 64), np.float32)
    _same_message(
        lambda: spatial.enhance_spatial(x, 2, clahe_clip_limit=0.02,
                                        clahe_tile_size=12, device="cpu"),
        lambda: JS.enhance_spatial(jnp.asarray(x), make_mesh(1, 2),
                                   clahe_clip_limit=0.02, clahe_tile_size=12))


@pytest.mark.parametrize("h", [36, 70])
def test_plan_shape_check_messages(h):
    x = np.zeros((1, h, 64), np.float32)
    jstatic = JE.PlanStatic(ops=("clahe", "unsharp"), tile_size=16)
    static, dyn = mdx_torch.plan_from_numpy({"ops": ("clahe", "unsharp")},
                                            {}, device="cpu")
    _same_message(
        lambda: plan_sp.qa_plan_spatial(x, 2, static, dyn, device="cpu"),
        lambda: j_qa_plan_spatial(jnp.asarray(x), make_mesh(1, 2), jstatic,
                                  JE.PlanDynamic()))


def test_a_raising_rank_raises_in_the_parent():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="unknown edge_mode"):
        launch.run(launch.call_each, X, n_space=2, device="cpu",
                   timeout_s=120, calls=[(spatial.halo_rows, (Block(0), 1, 1),
                                          {"edge_mode": "mirror"})])
    assert time.monotonic() - t0 < 60


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        launch.run(spatial.image_stats_block, X, n_space=2, device="cuda")


def test_mesh_from_env_one_rank():
    """A ``torchrun``-style rank (env:// rendezvous on localhost) joins,
    gets its mesh by the backend rule, and runs the sharded metric pass,
    which at k = 1 agrees with the dense one."""
    code = textwrap.dedent("""
        import os, socket
        import numpy as np, torch
        torch.set_num_threads(1)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        from mdx_torch import parity
        from mdx_torch.core import metrics
        from mdx_torch.parallel import mesh, spatial
        m = mesh.mesh_from_env(device="cpu")
        assert (m.backend, m.n_space, m.n_data, m.rank) == ("gloo", 1, 1, 0)
        x = torch.from_numpy(np.random.default_rng(0).random(
            (1, 32, 32), dtype=np.float32))
        got = spatial.image_stats_block(x, mesh=m)
        bad = parity.breaches(parity.flatten(got),
                              parity.flatten(metrics.image_stats(x)),
                              hw=32 * 32)
        assert not bad, bad
        print("OK")
    """)
    root = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stderr[-2000:]


def test_kernel_tolerances_pinned():
    assert parity.KERNEL_TOL["clahe_remap_ext"] == (0.0, 2e-5)
    assert parity.KERNEL_TOL["tv_shard_step"] == (0.0, 1e-5)
    assert parity.SHARDED_CLAHE_ATOL == 2e-6
    from mdx_torch import kernels

    assert set(parity.KERNEL_TOL) == set(kernels.LAUNCHES)
