"""The port's spatial runner (``python -m mdx_torch --spatial``:
``mdx_torch.pipeline.spatial_runner``, ``plan_sp.autotune_spatial_block``,
``comm.agree``) against the JAX package's ``mdx.pipeline.spatial_runner``,
on the CPU.

Inputs: 64² 16-bit synthetic slices written with the port's writer
(byte-equal to JAX's): ``noisy`` (denoise, the noise guard) and
``low_contrast``, which after min-max normalisation clips at both ends
(CLAHE, gamma, the denoise).  The port runs as gloo ranks in 9 launches:
six runs (module fixture), each kind deterministic in both layouts and one
``--autotune`` per layout, two of them through ``main([...,
"--spatial"])`` with the layout pinned; ``plan_sp.autotune_spatial`` on
its own; the agreement helper (2 ranks) and a run whose ranks raise.  The
JAX side runs the same files on ``make_mesh2d(1, 2, 2)`` (the port's
``n_space=(2, 2)``) and ``make_mesh(1, 2)`` (``n_space=2``) of the virtual
8-device CPU mesh.

Tolerances: issues, applied ops, guard and pass flags, the layout, the
sweep's record count and pick are equal; metrics, SSIM and PSNR within
``parity.breaches``; ``enhanced`` within ``parity.breaches`` (every pixel
within ``parity.PIXEL_ATOL``, as ``tests/test_torch_spatial2d.py`` holds
the QA step); the report equal line for line but the footnote, which names
the port's modules; the sweep's scores within 2e-3 (as
``tests/test_spatial_plan.py`` holds JAX's sweep to its dense one).

``std`` is held to the float64 std of JAX's own frame (its input, its
enhanced image), not to JAX's value.  Both packages take the sharded std
as sqrt(E[x²] − E[x]²) of float32 moments; with a mean near 0.5 that
difference cancels most of E[x²], and XLA's float32 summation order leaves
JAX's std of the enhanced noisy slice 9.47e-6 from its frame's exact std
(parity allows 7.1e-6 there), where PyTorch's lands within 2e-9 (ROADMAP
Queue 3).  :func:`test_sharded_std_against_exact` holds the port's std to
the exact one within ``parity``'s tolerance, and JAX's within the float32
cancellation bound sqrt(n)·eps·E[x²] / (2·std).
"""

import contextlib
import io
import itertools
import json
import time

import numpy as np
import pytest
import torch

from mdx.parallel import make_mesh, make_mesh2d
from mdx.pipeline import spatial_runner as JR

from mdx_torch import __main__ as cli
from mdx_torch import parity, tools
from mdx_torch.core.metrics import ISSUE_ORDER, METRIC_KEYS
from mdx_torch.io import load_dicom, normalize_image, write_synthetic_dicom
from mdx_torch.parallel import comm, launch
from mdx_torch.parallel.launch import Block
from mdx_torch.pipeline import spatial_runner as TR
from mdx_torch.pipeline import storage

torch.set_num_threads(1)

SIZE = 64
KINDS = ("noisy", "low_contrast")
LAYOUTS = {"2x2": (2, 2), "k2": 2}
# (kind, layout, autotune, CLI flags or None for run_pipeline_spatial)
RUNS = (
    ("noisy", "2x2", False, ["--spatial"]),
    ("low_contrast", "k2", False, ["--spatial", "--window"]),
    ("noisy", "k2", False, None),
    ("low_contrast", "2x2", False, None),
    ("low_contrast", "2x2", True, None),
    ("noisy", "k2", True, None),
)
SCORE_ATOL = 2e-3


def _jax_mesh(layout: str):
    if layout == "2x2":
        return make_mesh2d(n_data=1, n_sy=2, n_sx=2)
    return make_mesh(n_data=1, n_space=2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_runner")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MDX_DB_PATH", str(root / "runs.db"))
        mp.delenv("MDX_TV_MODE", raising=False)
        yield root, {k: write_synthetic_dicom(str(root / f"{k}.dcm"),
                                              kind=k, size=SIZE)
                     for k in KINDS}


@pytest.fixture(scope="module")
def runs(files):
    """Each of ``RUNS`` by the port and by JAX → {run: {...}}: the port's
    context, the launches it made, the CLI's rc and output; JAX's
    context."""
    root, paths = files
    real_run, real_spr = launch.run, TR.run_pipeline_spatial
    out = {}
    for kind, layout, auto, argv in RUNS:
        n_launch, ctxs = [0], []

        def counted(*a, **kw):
            n_launch[0] += 1
            return real_run(*a, **kw)

        def spy(*a, **kw):
            ctxs.append(real_spr(*a, **kw))
            return ctxs[-1]

        window = argv is not None and "--window" in argv
        port_out = str(root / f"port_{kind}_{layout}_{auto}")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(launch, "run", counted)
            if argv is None:
                ctxs.append(TR.run_pipeline_spatial(
                    paths[kind], port_out, n_space=LAYOUTS[layout],
                    autotune=auto, device="cpu", timeout_s=120))
                rc, text = None, ""
            else:
                mp.setattr(TR, "spatial_layout",
                           lambda h, w, n=None: LAYOUTS[layout])
                mp.setattr(TR, "run_pipeline_spatial", spy)
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(["--input", paths[kind], "--output",
                                   port_out, *argv], device="cpu")
                text = buf.getvalue()
        want = JR.run_pipeline_spatial(
            paths[kind], str(root / f"jax_{kind}_{layout}_{auto}"),
            mesh=_jax_mesh(layout), window=window, autotune=auto)
        img, _ = load_dicom(paths[kind], window=window)
        frame = np.asarray(img, np.float32) if window else normalize_image(
            img)
        out[(kind, layout, auto)] = {"port": ctxs[0], "launches": n_launch[0],
                                     "rc": rc, "text": text, "jax": want,
                                     "frame": frame}
    return out


def _flat(ctx) -> dict:
    """A run's numbers under ``parity``'s names."""
    mb = {k: np.float32([ctx["metrics"][k]]) for k in METRIC_KEYS}
    ma = {k: np.float32([ctx["metrics_after"][k]]) for k in METRIC_KEYS}
    v = ctx["validation"]
    return parity.flatten({
        "stats": mb, "enhanced": np.asarray(ctx["enhanced"])[None],
        "validation": {"metrics_before": mb, "metrics_after": ma,
                       **{k: np.float32([v[k]]) for k in
                          ("ssim", "psnr", "quality_improvement")},
                       "passes": np.array([v["passes"]])}})


def _exact_std(img) -> np.ndarray:
    return np.float32([np.asarray(img, np.float64).std()])


def _std_names(r) -> dict:
    """The std fields → the frame each describes (the input, the image
    JAX enhanced)."""
    return {"stats.std": r["frame"],
            "validation.metrics_before.std": r["frame"],
            "validation.metrics_after.std": r["jax"]["enhanced"]}


RUN_IDS = [f"{k}-{lay}-{'autotune' if a else 'det'}" for k, lay, a, _ in RUNS]


@pytest.mark.parametrize("run", [r[:3] for r in RUNS], ids=RUN_IDS)
def test_run_matches_jax(runs, run):
    """(c), (d): decisions equal, numbers within ``parity.breaches``."""
    got, want = runs[run]["port"], runs[run]["jax"]
    for key in ("shape", "mesh", "issues", "applied_ops", "noise_amp_guard"):
        assert got[key] == want[key], key
    assert got["validation"]["passes"] == want["validation"]["passes"]
    flat = _flat(want)
    for name, img in _std_names(runs[run]).items():
        flat[name] = _exact_std(img)
    bad = parity.breaches(_flat(got), flat)
    assert not bad, bad


@pytest.mark.parametrize("run", [r[:3] for r in RUNS], ids=RUN_IDS)
def test_sharded_std_against_exact(runs, run):
    """The port's sharded std within ``parity``'s tolerance of the float64
    std of the frame it describes; JAX's within the float32 cancellation
    bound of sqrt(E[x²] − E[x]²) over n = H·W pixels."""
    r = runs[run]
    got = _flat(r["port"])
    want = _flat(r["jax"])
    port_frames = dict(_std_names(r),
                       **{"validation.metrics_after.std":
                          r["port"]["enhanced"]})
    exact = {n: _exact_std(img) for n, img in port_frames.items()}
    assert not parity.breaches(got, exact, list(exact))
    for name, img in _std_names(r).items():
        x = np.asarray(img, np.float64)
        bound = (np.sqrt(x.size) * np.finfo(np.float32).eps
                 * np.mean(x * x) / (2 * x.std()))
        assert abs(float(want[name][0]) - x.std()) <= bound, name


@pytest.mark.parametrize("run", [r[:3] for r in RUNS], ids=RUN_IDS)
def test_report_matches_jax(runs, run):
    """JAX's report line for line, the footnote naming the port's modules;
    a metric row may differ only in its numbers, which are the run's own
    (held to JAX by ``test_run_matches_jax``)."""
    got, want = runs[run]["port"], runs[run]["jax"]
    g, w = got["report_md"].splitlines(), want["report_md"].splitlines()
    assert len(g) == len(w)
    rows = {f"| {k} | {got['metrics'][k]:.5f} | "
            f"{got['metrics_after'][k]:.5f} |" for k in METRIC_KEYS}
    for a, b in zip(g[:-1], w[:-1]):
        if a != b:
            assert a in rows, (a, b)
            assert parity._NUMBER.sub("#", a) == parity._NUMBER.sub("#", b)
    assert g[-1] == w[-1].replace("(mdx/parallel/", "(mdx_torch/parallel/")
    with open(got["report_path"], encoding="utf-8") as f:
        assert f.read() == got["report_md"]


@pytest.mark.parametrize("run", [r[:3] for r in RUNS if r[2]],
                         ids=[i for i, r in zip(RUN_IDS, RUNS) if r[2]])
def test_autotune_matches_jax(runs, run):
    """(d): the sweep's records, pick and plan, and the DB row's plan."""
    got, want = runs[run]["port"], runs[run]["jax"]
    g, w = got["iterations"], want["iterations"]
    assert len(g) == len(w) == 9
    assert [r.chosen for r in g] == [r.chosen for r in w]
    np.testing.assert_allclose([r.score for r in g], [r.score for r in w],
                               rtol=0, atol=SCORE_ATOL)
    assert got["plan"].params.model_dump() == want["plan"].params.model_dump()
    row = storage.get_run(got["run_id"])
    assert json.loads(row["plan_json"]) == json.loads(
        want["plan"].model_dump_json())
    assert "autotune sweep" in got["report_md"]
    assert got["rank_ms"]["per_candidate"] > 0


@pytest.mark.parametrize("run", [r[:3] for r in RUNS], ids=RUN_IDS)
def test_one_launch_per_run(runs, run):
    """(e): the whole device part in one launch of gloo ranks."""
    r = runs[run]
    assert r["launches"] == 1
    assert r["port"]["launch"] == {"backend": "gloo",
                                   "n_space": LAYOUTS[run[1]],
                                   "n_data": 1, "host_round_trips": 0}
    assert set(r["port"]["phase_ms"]) == {"decode", "normalize", "launch",
                                          "compute", "report", "db"}
    assert 0 < r["port"]["phase_ms"]["compute"] < r["port"]["phase_ms"][
        "launch"]


@pytest.mark.parametrize("run", [r[:3] for r in RUNS if r[3]],
                         ids=[i for i, r in zip(RUN_IDS, RUNS) if r[3]])
def test_cli_spatial(runs, run):
    """(f): ``main([... "--spatial"])``: rc 0, the report printed, its DB
    row read back."""
    r = runs[run]
    ctx = r["port"]
    assert r["rc"] == 0
    assert r["text"].strip() == ctx["report_md"].strip()
    assert r["text"].startswith("# mdx spatial QA report")
    row = storage.get_run(ctx["run_id"])
    assert row["status"] == "completed" and row["plan_json"] == ""
    assert row["issues"] == ctx["issues"]
    assert row["applied_ops"] == ctx["applied_ops"]
    assert row["metrics_before"] == ctx["metrics"]
    assert row["validation"] == ctx["validation"]


# ------------------------------------------------------ pure host functions

SHAPES = [(64, 64, 2, 2), (128, 96, 4, 1),      # whole CLAHE tiles
          (96, 72, 2, 3), (72, 64, 1, 1)]       # not
FLAGS = list(itertools.product((False, True), repeat=len(ISSUE_ORDER)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("bits", FLAGS,
                         ids=lambda b: "".join(str(int(v)) for v in b))
def test_issue_driven_kwargs_equal_jax(bits, shape):
    """(a): all 32 flag combinations, CLAHE-aligned and not."""
    flags = dict(zip(ISSUE_ORDER, bits))
    assert TR.issue_driven_kwargs(flags, *shape) == \
        JR.issue_driven_kwargs(flags, *shape)


@pytest.mark.parametrize("h,w,n", [(128, 128, 8), (256, 32, 8), (16, 16, 8),
                                   (34, 128, 2), (2048, 2048, 1),
                                   (2048, 2048, 4), (64, 64, 2)])
def test_spatial_layout_equals_jax_mesh(h, w, n):
    """(b): the shapes of ``tests/test_spatial_runner.py``'s
    ``TestChooseLayout``, and four and two devices."""
    shape = JR.build_spatial_mesh(h, w, n).shape
    want = ((shape["sy"], shape["sx"]) if "sx" in shape
            else shape["space"])
    assert TR.spatial_layout(h, w, n) == want


def test_autotune_spatial_matches_jax():
    """``plan_sp.autotune_spatial`` (one launch) against JAX's on the same
    slice and grid: the same records, pick, plan and rationale, scores
    within 2e-3, the winner's frame within ``parity.breaches``."""
    from mdx.parallel.plan_sp import autotune_spatial as j_autotune_spatial

    from mdx_torch.parallel import plan_sp

    img = tools.make_batch(1, SIZE, seed=8)[0]
    issues = ["noise", "low_contrast"]
    plan, enh, recs = plan_sp.autotune_spatial(img, issues, (2, 2),
                                               device="cpu", timeout_s=120)
    jplan, jenh, jrecs = j_autotune_spatial(img, issues,
                                            _jax_mesh("2x2"))
    assert len(recs) == len(jrecs) == 9
    assert [r.chosen for r in recs] == [r.chosen for r in jrecs]
    np.testing.assert_allclose([r.score for r in recs],
                               [r.score for r in jrecs], rtol=0,
                               atol=SCORE_ATOL)
    assert plan.model_dump() == jplan.model_dump()
    bad = parity.breaches({"enhanced": enh[None]},
                          {"enhanced": np.asarray(jenh)[None]})
    assert not bad, bad


# ------------------------------------------------- agreement and failures

def test_agree_returns_rank_0s_value():
    """Two ranks with different local values both return rank 0's."""
    x = np.array([[[7.0], [3.0]]], np.float32)
    res = launch.run(launch.call_each, x, n_space=2, device="cpu",
                     timeout_s=120,
                     calls=[(comm.agree, (Block(0),), {})] * 2)
    assert [r for r in res.results] == [[7, 7], [7, 7]]


def test_a_raising_rank_makes_the_run_raise(files):
    """A rank that raises inside the run body (an unknown TV mode, met
    where the sweep builds its plan) makes ``run_pipeline_spatial`` raise
    in the parent, well inside the launch timeout."""
    root, paths = files
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match=r"(?s)rank \d of 2 raised.*tv_mode"):
        TR.run_pipeline_spatial(paths["noisy"], str(root / "raise"),
                                n_space=2, autotune=True, tv_mode="nope",
                                device="cpu", timeout_s=60)
    assert time.monotonic() - t0 < 30
