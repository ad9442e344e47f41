"""The port's data axis against the JAX package's, on the CPU.

``mdx_torch.parallel.mesh.divisible_batch`` / ``data_axis``,
``mdx_torch.parallel.batch`` (``pad_batch`` and the three sharded entry
points) and ``run_pipeline_batch(n_data=...)`` against ``mdx.parallel``'s
and ``mdx.pipeline.batch_runner``'s on ``make_mesh(n_data=...)`` of the
virtual 8-device CPU mesh, on the same seeded numpy input.

Gloo launches, four in all: the three rank bodies at n_data = 4 in one
launch (``launch.call_each``), ``detect_sharded`` at n_data = 4 through its
entry point, and ``run_pipeline_batch`` at n_data = 2 on a series and on
a mixed directory (one launch a run, whatever its chunks and buckets).

Tolerances: ``pad_batch`` and ``divisible_batch`` equal JAX's bit for
bit; the sharded steps within ``parity.breaches`` of JAX's (as
``tests/test_torch_slice.py``; ``tv_ran`` for the bench plan, which runs
TV), and of the port's dense calls on the same padded batch, whose
threads differ from the ranks' (one each); padded lanes equal to the last
frame's bit for bit; the runner's records at n_data = 2 equal to n_data =
1's (``run_id`` aside) and within ``parity.breaches`` of JAX's on the
12-bit frames (the 8-bit frames: ``tests/test_torch_batch_8bit.py``).
"""

import numpy as np
import pytest
import torch

from mdx.parallel import batch as JB
from mdx.parallel import make_mesh
from mdx.parallel.mesh import divisible_batch as jax_divisible_batch
from mdx.pipeline import batch_runner as JR

from mdx_torch import parity, tools
from mdx_torch.core import qa
from mdx_torch.io import write_dicom, write_synthetic_dicom
from mdx_torch.parallel import batch as PB
from mdx_torch.parallel import launch
from mdx_torch.parallel.launch import Block
from mdx_torch.parallel.mesh import data_axis, divisible_batch
from mdx_torch.pipeline import batch_runner as PR

torch.set_num_threads(1)

N, H, W, D = 6, 80, 96, 4
FIELDS = {"qa_deterministic": PB.DETERMINISTIC_FIELDS,
          "qa_plan": PB.PLAN_FIELDS, "detect": PB.DETECT_FIELDS}


def _batch():
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 0.4 + 0.3 * np.sin(xx / 11.0) * np.cos(yy / 17.0)
    return np.stack([
        base + rng.normal(0, 0.12, (H, W)),
        0.5 + 0.05 * (xx / W) + rng.normal(0, 0.004, (H, W)),
        (xx - 20) / 50.0 + rng.normal(0, 0.02, (H, W)),
        base + rng.normal(0, 0.03, (H, W)),
        0.5 * base + rng.normal(0, 0.08, (H, W)),
        0.2 + 0.6 * (yy / H) + rng.normal(0, 0.01, (H, W)),
    ]).clip(0, 1).astype(np.float32)


X = _batch()


def _plans():
    """The bench plan in both packages, ``gamma`` per image ([N])."""
    import jax.numpy as jnp

    from mdx.core.enhance import PlanDynamic, PlanStatic

    import mdx_torch

    ops = tools.PLAN_OPS
    p = tools.PLAN_PARAMS
    static = dict(ops=ops, tile_size=p["clahe_tile_size"],
                  bilateral_d=p["bilateral_d"], plan_order=ops)
    dyn = {k: np.asarray(p[k], np.float32) for k in (
        "clahe_clip_limit", "unsharp_radius", "unsharp_amount",
        "post_denoise_strength", "bilateral_sigma_color",
        "bilateral_sigma_space", "tv_denoise_weight")}
    dyn["gamma"] = np.linspace(0.9, 1.1, N).astype(np.float32)
    t = mdx_torch.plan_from_numpy(static, dyn, device="cpu")
    gamma_pad = np.concatenate([dyn["gamma"], dyn["gamma"][-1:].repeat(
        divisible_batch(N, D) - N)])
    j = (PlanStatic(**static),
         PlanDynamic(**{k: jnp.asarray(gamma_pad if k == "gamma" else v)
                        for k, v in dyn.items()}))
    return t, j


def _jax_numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs():
    """The rank bodies at n_data = 4 in one launch, and JAX's sharded entry
    points on make_mesh(n_data=4), on X padded to 8."""
    (ts, td), (js, jd) = _plans()
    xp, n_valid = PB.pad_batch(X, D)
    # the per-image gamma padded as qa_plan_sharded pads it
    td = type(td)(*(PB.pad_batch(v, D)[0]
                    if torch.is_tensor(v) and v.ndim else v for v in td))
    res = launch.run(launch.call_each, xp, n_space=1, n_data=D,
                     device="cpu", calls=[
                         (PB.deterministic_block, (Block(0),), {}),
                         (PB.plan_block, (Block(0), ts, td), {}),
                         (PB.detect_block, (Block(0),), {})])
    port = {name: launch.assemble([r[i] for r in res.results], D, 1,
                                  block_keys=())
            for i, name in enumerate(FIELDS)}
    mesh = make_mesh(n_data=D)
    jdet, jn1 = JB.qa_deterministic_sharded(X, mesh)
    jplan, jn2 = JB.qa_plan_sharded(X, js, jd, mesh)
    *jdetect, jn3 = JB.detect_sharded(X, mesh)
    assert n_valid == jn1 == jn2 == jn3 == N
    jax = {"qa_deterministic": dict(zip(FIELDS["qa_deterministic"], jdet)),
           "qa_plan": dict(zip(FIELDS["qa_plan"], jplan)),
           "detect": dict(zip(FIELDS["detect"], jdetect))}
    return {"xp": xp, "port": port, "jax": _jax_numpy(jax),
            "plan": (ts, td)}


@pytest.mark.parametrize("n", [1, 3, 8, 9])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_pad_batch_and_divisible_batch_equal_jax(n, d):
    x = np.random.default_rng(n * 10 + d).random((n, 5, 7), np.float32)
    mesh = make_mesh(n_data=d)
    assert divisible_batch(n, d) == jax_divisible_batch(n, mesh)
    want, n_want = JB.pad_batch(x, mesh)
    got, n_got = PB.pad_batch(x, d)
    assert isinstance(got, np.ndarray) and n_got == n_want == n
    assert got.dtype == want.dtype and np.array_equal(got, np.asarray(want))
    got_t, n_t = PB.pad_batch(torch.from_numpy(x), d)
    assert n_t == n and torch.equal(got_t, torch.from_numpy(np.array(
        want)))


def test_data_axis():
    assert data_axis(None, "cpu") == 1 and data_axis(3, "cpu") == 3
    with pytest.raises(ValueError, match="at least one rank"):
        data_axis(0, "cpu")
    if not torch.cuda.is_available():
        # no card visible: the card's default is no rank, refused
        with pytest.raises(ValueError, match="at least one rank"):
            data_axis(None, "cuda")


def _flat(res: dict, n: int | None = None) -> dict:
    return {k: v[:n] for k, v in parity.flatten(res).items()
            if k != "rank_ms"}


@pytest.mark.parametrize("name", list(FIELDS))
def test_sharded_steps_match_jax(runs, name):
    got, want = _flat(runs["port"][name]), _flat(runs["jax"][name])
    assert got.keys() == want.keys()
    assert all(v.shape[0] == divisible_batch(N, D) for v in got.values())
    bad = parity.breaches(got, want, hw=H * W, tv_ran=name == "qa_plan")
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("name", list(FIELDS))
def test_sharded_steps_match_the_dense_calls(runs, name):
    x = torch.from_numpy(runs["xp"].copy())
    ts, td = runs["plan"]
    if name == "qa_plan":
        dense = qa.qa_plan(x, ts, td)
    else:
        dense = getattr(qa, name)(x)
    want = parity.flatten(dict(zip(FIELDS[name], dense)))
    bad = parity.breaches(_flat(runs["port"][name]), want, hw=H * W,
                          tv_ran=name == "qa_plan")
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("name", list(FIELDS))
def test_padded_lanes_equal_the_last_frame(runs, name):
    for k, v in _flat(runs["port"][name]).items():
        for lane in range(N, len(v)):
            assert np.array_equal(v[lane], v[N - 1], equal_nan=True), (k,
                                                                       lane)


def test_detect_sharded_entry_point_launches_once(runs, monkeypatch):
    made = []
    real = launch.run

    def counted(*a, **kw):
        made.append(kw["n_data"])
        return real(*a, **kw)

    monkeypatch.setattr(launch, "run", counted)
    stats, issues, n_valid = PB.detect_sharded(X, n_data=D, device="cpu")
    assert made == [D] and n_valid == N
    assert PB.LAST_LAUNCH["n_data"] == D and len(
        PB.LAST_LAUNCH["rank_ms"]) == D
    got = parity.flatten({"stats": stats, "issues": issues})
    want = _flat(runs["port"]["detect"])
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k], equal_nan=True), k


def test_one_rank_runs_in_process(monkeypatch, tmp_path):
    def refuse(*a, **kw):
        raise AssertionError("n_data = 1 must not launch ranks")

    monkeypatch.setattr(launch, "run", refuse)
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    (ts, td), _ = _plans()
    x = torch.from_numpy(X.copy())
    for n_data in (1, None):
        det, n1 = PB.qa_deterministic_sharded(X, n_data, device="cpu")
        plan, n2 = PB.qa_plan_sharded(X, ts, td, n_data, device="cpu")
        stats, issues, n3 = PB.detect_sharded(X, n_data, device="cpu")
        assert n1 == n2 == n3 == N and PB.LAST_LAUNCH == {}
        for got, want in ((det, qa.qa_deterministic(x)),
                          (plan, qa.qa_plan(x, ts, td)),
                          ((stats, issues), qa.detect(x))):
            a, b = parity.flatten(got), parity.flatten(want)
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k], equal_nan=True), k
    series = write_synthetic_dicom(str(tmp_path / "s.dcm"), kind="phantom",
                                   size=64, frames=3, seed=1)
    ctx = PR.run_pipeline_batch(series, str(tmp_path / "o"), device="cpu")
    assert ctx["mesh"] == {"data": 1, "space": 1} and ctx["launch"] is None


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for fn in (PB.qa_deterministic_sharded, PB.detect_sharded):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            fn(X)


# ---- run_pipeline_batch on the data axis ---------------------------------


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data_axis")
    series = write_synthetic_dicom(str(root / "series.dcm"), kind="phantom",
                                   size=64, frames=5, seed=1)
    mixed = root / "mixed"
    mixed.mkdir()
    rng = np.random.default_rng(5)
    for i, kind in enumerate(("noisy", "phantom", "noisy")):
        kw = ({"window_center": 30000.0 - 4000 * i, "window_width": 20000.0}
              if i < 2 else {})
        write_synthetic_dicom(str(mixed / f"ct{i}.dcm"), kind=kind, size=64,
                              seed=10 + i, **kw)
    for i in range(3):
        write_dicom(str(mixed / f"us{i}.dcm"),
                    rng.integers(0, 256, (48, 80)).astype(np.uint8),
                    modality="US",
                    photometric="MONOCHROME1" if i else "MONOCHROME2")
    return {"series": series, "mixed": str(mixed)}


def _strip(frames):
    return [{k: v for k, v in f.items() if k != "run_id"} for f in frames]


@pytest.mark.parametrize("which,window", [("series", False),
                                          ("mixed", True)])
def test_runner_two_ranks_matches_one_and_jax(tmp_path, monkeypatch, inputs,
                                              which, window):
    """One launch for every chunk and bucket (chunks of 2 frames, so the
    series runs 3 chunks, the last padded; the directory two buckets);
    the records equal n_data = 1's and JAX's on make_mesh(n_data=2); a
    resumed run skips every frame without a launch."""
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    monkeypatch.setattr(PR, "CHUNK", 2)
    path = inputs[which]
    one = PR.run_pipeline_batch(path, str(tmp_path / "one"), window=window,
                                device="cpu", n_data=1,
                                save_artifacts=False)
    made = []
    real = launch.run

    def counted(*a, **kw):
        made.append(kw["n_data"])
        return real(*a, **kw)

    monkeypatch.setattr(launch, "run", counted)
    two = PR.run_pipeline_batch(path, str(tmp_path / "two"), window=window,
                                device="cpu", n_data=2)
    assert made == [2]
    assert two["mesh"] == {"data": 2, "space": 1}
    assert two["launch"]["n_data"] == 2 and len(two["launch"]["rank_ms"]) == 2
    assert _strip(two["frames"]) == _strip(one["frames"])
    assert "Frames processed: **%d**" % len(two["frames"]) in (
        tmp_path / "two" / "batch_report.md").read_text()

    want = JR.run_pipeline_batch(path, str(tmp_path / "jax"), window=window,
                                 mesh=make_mesh(n_data=2),
                                 save_artifacts=False)
    assert want["mesh"] == two["mesh"]
    got12 = [f for f in two["frames"] if not f["source"].startswith("us")]
    want12 = [f for f in want["frames"] if not f["source"].startswith("us")]
    assert [(f["source"], f["frame"]) for f in got12] == [
        (f["source"], f["frame"]) for f in want12]
    bad = parity.breaches(parity.flatten_batch(got12),
                          parity.flatten_batch(want12), hw=64 * 64)
    assert not bad, bad

    again = PR.run_pipeline_batch(path, str(tmp_path / "two"), resume=True,
                                  device="cpu", n_data=2)
    assert made == [2] and again["frames"] == []
    assert again["skipped"] == len(two["frames"])
