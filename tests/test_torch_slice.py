"""The QA slice of mdx_torch against the JAX package, on the CPU.

``image_stats``, ``apply_plan`` (the bench plan and halo-tripping plans),
``apply_issue_driven``, ``qa_plan`` and ``qa_deterministic`` run on the same
numpy batch in both packages.  Issue masks, op masks and guard flags must
be equal; pixels, stats, validation fields and the score are held to the
tolerances of ``mdx_torch.parity``, whose docstring gives the reason for
each.  The batch trips every issue and every guard on some image.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from mdx.core import enhance as JE
from mdx.core import qa as JQ

import mdx_torch
from mdx_torch import parity
from mdx_torch.core import enhance as TE
from mdx_torch.core import metrics as TM
from mdx_torch.core import qa as TQ

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _batch():
    rng = np.random.default_rng(11)
    h = w = 96
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.4 + 0.3 * np.sin(xx / 11.0) * np.cos(yy / 17.0)
    return np.stack([
        base + rng.normal(0, 0.12, (h, w)),            # noise, clipping_low
        0.5 + 0.05 * (xx / w) + 0.02 * np.sin(yy / 30.0)
        + rng.normal(0, 0.004, (h, w)),                # blur, low contrast
        (xx - 20) / 50.0 + rng.normal(0, 0.02, (h, w)),  # clipping low+high
    ]).clip(0, 1).astype(np.float32)


X = _batch()


def _xt():
    return torch.from_numpy(X.copy())


def _bench_plans():
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


def _to_torch(static, dyn):
    return mdx_torch.plan_from_numpy(
        dataclasses.asdict(static),
        {k: np.asarray(v) for k, v in dyn._asdict().items()}, device="cpu")


# halo-tripping plans: one whose re-run order differs from the fixed order
# (full re-run from x), one that resumes from the cached prefix
HALO_PLANS = {
    "rerun_from_x": (
        JE.PlanStatic(ops=("clahe", "unsharp", "bilateral"), bilateral_d=5,
                      plan_order=("unsharp", "clahe", "bilateral")),
        JE.PlanDynamic(unsharp_radius=3.0, unsharp_amount=2.0)),
    "prefix_reuse": (
        JE.PlanStatic(ops=("gamma", "unsharp", "tv_denoise")),
        JE.PlanDynamic(gamma=jnp.asarray([0.9, 1.0, 1.2]), unsharp_radius=3.0,
                       unsharp_amount=jnp.asarray([1.5, 2.0, 1.0]),
                       tv_denoise_weight=jnp.asarray([0.05, 0.0, 0.1]))),
}


@pytest.fixture(scope="module")
def jax_results():
    """Every JAX run of this file, compiled once."""
    xj = jnp.asarray(X)
    static, dyn = _bench_plans()
    out = {
        "qa_plan": JQ.qa_plan(xj, static, dyn),
        "qa_deterministic": JQ.qa_deterministic(xj),
    }
    # qa_deterministic's stats are image_stats(x); every image of X has an
    # issue, so its enhanced image is apply_issue_driven's output
    enhanced, stats, _, flags = out["qa_deterministic"][:4]
    out["stats"] = stats
    out["issue_driven"] = (enhanced, flags)
    for name, (s, d) in HALO_PLANS.items():
        out[name] = JQ.enhance_only(xj, s, d)
    return jax.tree_util.tree_map(np.asarray, out)


def _assert_parity(got, want, **kw):
    bad = parity.breaches(parity.flatten(got), parity.flatten(want), **kw)
    assert not bad, "\n".join(bad)


def test_image_stats(jax_results):
    got = TM.image_stats(_xt())
    assert set(got) == set(jax_results["stats"])
    _assert_parity(got, jax_results["stats"], hw=X.shape[1] * X.shape[2])


def test_detect_issues_trips_every_issue(jax_results):
    issues = TM.detect_issues(TM.image_stats(_xt()))
    want = jax_results["qa_deterministic"][2]
    for k in mdx_torch.ISSUE_ORDER:
        np.testing.assert_array_equal(issues[k].numpy(), np.asarray(want[k]))
        assert issues[k].any(), k


def test_qa_plan_bench_plan(jax_results):
    got = TQ.qa_plan(_xt(), *_to_torch(*_bench_plans()))
    bad = parity.breaches(
        parity.flatten_result(got, parity.QA_PLAN_FIELDS),
        parity.flatten_result(jax_results["qa_plan"], parity.QA_PLAN_FIELDS),
        tv_ran=True)
    assert not bad, "\n".join(bad)
    # at 96^2 the TV solve is short: the pixels agree far inside the bound
    np.testing.assert_allclose(got[0].numpy(), jax_results["qa_plan"][0],
                               atol=parity.PIXEL_ATOL, rtol=0)


def test_qa_deterministic(jax_results):
    got = TQ.qa_deterministic(_xt())
    bad = parity.breaches(
        parity.flatten_result(got, parity.QA_DETERMINISTIC_FIELDS),
        parity.flatten_result(jax_results["qa_deterministic"],
                              parity.QA_DETERMINISTIC_FIELDS))
    assert not bad, "\n".join(bad)


def test_apply_issue_driven(jax_results):
    x = _xt()
    out, flags = TE.apply_issue_driven(x, TM.detect_issues(TM.image_stats(x)))
    want_out, want_flags = jax_results["issue_driven"]
    _assert_parity({"enhanced": out, "flags": flags},
                   {"enhanced": want_out, "flags": want_flags})
    assert flags["noise_amp"].any()


@pytest.mark.parametrize("name", sorted(HALO_PLANS))
def test_apply_plan_halo_plans(jax_results, name):
    static, dyn = HALO_PLANS[name]
    out, flags = TQ.enhance_only(_xt(), *_to_torch(static, dyn))
    want_out, want_flags = jax_results[name]
    assert flags["halo"].any(), "the plan must trip the halo guard"
    _assert_parity({"enhanced": out, "flags": flags},
                   {"enhanced": want_out, "flags": want_flags},
                   tv_ran="tv_denoise" in static.ops)
    np.testing.assert_allclose(out.numpy(), want_out,
                               atol=parity.PIXEL_ATOL, rtol=0)


def test_plan_from_numpy_round_trip():
    static, dyn = HALO_PLANS["prefix_reuse"]
    sfields = dataclasses.asdict(static)
    dfields = {k: np.asarray(v) for k, v in dyn._asdict().items()}
    ts, td = mdx_torch.plan_from_numpy(sfields, dfields, device="cpu")
    assert dataclasses.asdict(ts) == sfields
    assert ts.order() == static.order()
    for k, v in td._asdict().items():
        dtype = np.bool_ if k == "denoise_soft" else np.float32
        assert v.numpy().dtype == dtype
        np.testing.assert_array_equal(v.numpy(), dfields[k].astype(dtype))
    with pytest.raises(ValueError):
        mdx_torch.plan_from_numpy({"tv_mode": "quick"}, {}, device="cpu")
    with pytest.raises(TypeError):
        mdx_torch.plan_from_numpy({}, {"no_such_param": 1.0},
                                  device="cpu")


@pytest.mark.parametrize("tv_ran,off,breach", [
    (False, 5e-6, False), (False, 1e-4, True),  # one pixel, no TV: PIXEL_ATOL
    (True, 1e-4, False), (True, 3e-3, True),    # TV: PIXEL_FRACTION, PIXEL_MAX
])
def test_parity_pixel_rule(tv_ran, off, breach):
    want = {"enhanced": np.zeros((1, 64, 64), np.float32)}
    got = {"enhanced": want["enhanced"].copy()}
    got["enhanced"][0, 3, 5] = off
    assert bool(parity.breaches(got, want, tv_ran=tv_ran)) == breach


@pytest.mark.parametrize("hw", [96 * 96, 512 * 512])
@pytest.mark.parametrize("pixels,breach", [(1, False), (3, True)])
def test_parity_fraction_rule_counts_pixels(hw, pixels, breach):
    want = {"stats.edge_density": np.array([0.25])}
    got = {"stats.edge_density": want["stats.edge_density"] + pixels / hw}
    assert bool(parity.breaches(got, want, hw=hw)) == breach
    with pytest.raises(ValueError, match="hw"):
        parity.breaches(got, want)


def test_kernel_parity_box_stats_is_relative():
    plain = (np.array([3.4e-3, 3e-4]),)
    # 1e-9 + 1e-6 * |plain|: 4.4e-9 and 1.3e-9
    assert parity.kernel_parity("box_stats", (plain[0] + 1.2e-9,), plain)[1]
    assert not parity.kernel_parity("box_stats",
                                    (plain[0] + [0, 2e-9],), plain)[1]
    err, ok = parity.kernel_parity("clahe", np.ones(3) + 1e-5, np.ones(3))
    assert ok and err == pytest.approx(1e-5)


def _run(code: str, cwd=ROOT, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_runs_with_jax_pydantic_matplotlib_blocked():
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "pydantic",
                                          "matplotlib"):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import mdx_torch
        from mdx_torch.core import qa
        x = torch.from_numpy(np.random.default_rng(0).random(
            (2, 48, 48), dtype=np.float32))
        static, dyn = mdx_torch.plan_from_numpy(
            {"ops": mdx_torch.OP_ORDER, "bilateral_d": 5},
            {"tv_denoise_weight": 0.05}, device="cpu")
        enh, flags, val, score = qa.qa_plan(x, static, dyn)
        assert enh.shape == x.shape and bool(torch.isfinite(score).all())
        qa.qa_deterministic(x)
        from mdx_torch.core import schemas, tuning
        from mdx_torch.ops import ingest
        plan, best, recs = tuning.autotune(x[0, :32, :32].numpy(),
                                           ["noise"], device="cpu")
        assert isinstance(plan, schemas.EnhancementPlan)
        assert sum(r.chosen for r in recs) == 1 and best.shape == (32, 32)
        one = torch.ones(2)
        raw = torch.arange(2 * 8 * 8, dtype=torch.int16).reshape(2, 8, 8)
        frames = ingest.normalize_ingest(raw, one, 0 * one, 0 * one, one,
                                         0 * one, 0 * one, one, 0 * one, one,
                                         per_frame_minmax=True)
        assert float(frames.max()) == 1.0
        from mdx_torch.parallel import (batch, clahe_sp, comm, launch, mesh,
                                        plan_sp, spatial, stream, tv_sp,
                                        wavelet_sp)
        from mdx_torch import kernels
        from mdx_torch.tools import data_check, spatial_check, time_tv_shard
        det, n_valid = batch.qa_deterministic_sharded(x.numpy(), 1, "cpu")
        stats, issues, _ = batch.detect_sharded(x.numpy(), 1, "cpu")
        assert n_valid == 2 and det[0].shape == (2, 48, 48)
        assert batch.pad_batch(x, 4)[0].shape == (4, 48, 48)
        got = list(stream.DecodeStream(range(3), lambda i: x[0].numpy(), 2))
        assert [s for s, _ in got] == [0, 2]
        assert all(callable(getattr(kernels, k)) for k in (
            "tv_shard_step", "tv_shard_finalize", "tv_shard_rebuild"))
        xb = x[:, :8, :8].contiguous()
        w = 0.05 * one
        p_out = torch.zeros(2, 2, 8, 8)
        act = torch.ones(2, dtype=torch.int32)
        it, base = torch.zeros(2, dtype=torch.int32), 0 * act
        e0, e_prev = 0 * one, 0 * one
        geo = (8, 8, 0, 0, 4)
        sums = tv_sp.tv_shard_step_plain(xb, None, p_out, act, w, None,
                                         None, geo, 4)
        tv_sp.tv_shard_finalize_plain(sums, w, e0, e_prev, act, it, base,
                                      0, 0.0, 64.0)
        out = tv_sp.tv_shard_rebuild_plain(xb, p_out, p_out, it, base, w,
                                           None, None, None, geo, 4)
        assert it.tolist() == [4, 4] and bool(torch.isfinite(out).all())
        import tempfile
        from mdx_torch.io import load_dicom, native, write_synthetic_dicom
        from mdx_torch.io.dicom import TS_J2K_LOSSLESS, TS_JPEG_LL_SV1
        with tempfile.TemporaryDirectory() as tmp:
            ll = write_synthetic_dicom(tmp + "/ll.dcm", kind="phantom",
                                       size=48, transfer_syntax=TS_JPEG_LL_SV1)
            img, _ = load_dicom(ll)
            j2k = write_synthetic_dicom(tmp + "/j2k.dcm", kind="phantom",
                                        size=48, transfer_syntax=TS_J2K_LOSSLESS)
            assert np.array_equal(load_dicom(j2k)[0], img)
            rle = mdx_torch.io.transcode(j2k, tmp + "/rle.dcm", "rle")
            assert np.array_equal(load_dicom(rle)[0], img)
        from mdx_torch.io import jpegdct
        dct, p = jpegdct.decode(open(
            "tests/torch_fixtures/jpegdct/ct512_prog.jpg", "rb").read())
        assert dct.shape == (512, 512) and p == 8
        assert native.CALLS["jpegll_pack"] == native.CALLS["jpegll_diffs"] == 1
        assert native.CALLS["jpeg2k_t1_encode"] > 0
        assert native.CALLS["jpeg2k_t1_block"] > 0
        # one PackBits call a byte plane: two planes of uint16
        assert native.CALLS["packbits_encode"] == 2
        assert native.CALLS["packbits_decode"] == 2
        assert native.CALLS["jpegdct_prog_segment"] > 0
        det = qa.qa_deterministic(torch.from_numpy(
            mdx_torch.io.normalize_image(img))[None])
        assert det[0].shape == (1, 48, 48)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "pydantic",
                                      "matplotlib", "mdx")]
        assert not bad, bad
        print("OK")
    """)
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stderr[-2000:]


def test_chip_smoke_fails_without_a_card(tmp_path):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    # alone in a directory, without the repository around it
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_plan_is_the_bench_plan():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ts, td = chip_smoke._bench_plan("cpu")
    want_s, want_d = _to_torch(*_bench_plans())
    assert ts == want_s
    for a, b in zip(td, want_d):
        assert torch.equal(a, b)
