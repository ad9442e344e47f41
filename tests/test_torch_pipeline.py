"""The port's single-image runner, records and DB against the JAX
package's, on the CPU.

* ``run_pipeline(device="cpu")`` against ``mdx.pipeline.runner.
  run_pipeline`` on the same 64^2 files, deterministic and autotune:
  ``parity.compare_runs`` (metrics within ``mdx_torch.parity``; issues,
  ops, status and notes equal, the notes' numbers to 1e-3), and the DB
  rows' ``plan_json`` parsed equal;
* the dataclass records' ``model_dump_json`` string-equal to pydantic's on
  the plans of a real sweep, and their clamps;
* the storage schema equal, and one DB file written and read by both.

The autotune sweep's rationale names its pass: "one compiled program" in
the JAX package, "one batched pass" in the port (no program is compiled);
the plan comparison maps the one phrase to the other.
"""

import json

import numpy as np
import pytest

from mdx.pipeline import runner as JR
from mdx.pipeline import schemas as JS
from mdx.pipeline import storage as JST
from mdx_torch import parity
from mdx_torch.core import schemas as PS
from mdx_torch.core import tuning as PT
from mdx_torch.io import write_synthetic_dicom
from mdx_torch.pipeline import runner as PR
from mdx_torch.pipeline import storage as PST

KINDS = ("noisy", "low_contrast", "clipped", "phantom", "clean")


@pytest.fixture
def db(tmp_path, monkeypatch):
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    return tmp_path / "runs.db"


def _plan_dict(plan_json: str) -> dict:
    d = json.loads(plan_json)
    d["rationale"] = d["rationale"].replace("one compiled program",
                                            "one batched pass")
    return d


@pytest.mark.parametrize("autotune", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_run_pipeline_matches_jax(tmp_path, db, kind, autotune):
    path = write_synthetic_dicom(str(tmp_path / f"{kind}.dcm"), kind=kind,
                                 size=64)
    want = JR.run_pipeline(path, str(tmp_path / "jax"), autotune=autotune)
    got = PR.run_pipeline(path, str(tmp_path / "port"), autotune=autotune,
                          device="cpu")
    bad, reported = parity.compare_runs(got, want)
    assert not bad, bad
    if kind == "clipped" and autotune:
        # the clipped ramp has sigma ~4e-10 (a rounding residue): the
        # sweep's objective divides by it, so its pick is not determined
        assert any(r.startswith("enhanced") for r in reported), reported
    else:
        assert not reported, reported
    assert set(got["phase_ms"]) == {"decode", "normalize", "device_qa",
                                    "png", "report", "db"}
    assert got["report_md"].count("\n") == want["report_md"].count("\n")
    rows = {r["run_id"]: r for r in (PST.get_run(got["run_id"]),
                                     JST.get_run(want["run_id"]))}
    g, w = rows[got["run_id"]], rows[want["run_id"]]
    assert g["status"] == w["status"] == got["validation"].status
    assert g["issues"] == w["issues"] and g["applied_ops"] == w["applied_ops"]
    assert g["genai_model"] == w["genai_model"]
    assert g["report_path"].endswith(f"port/{kind}_report.md")
    assert g["before_after_path"].endswith(f"port/{kind}_before_after.png")
    if not autotune:
        assert g["plan_json"] == w["plan_json"] == ""
    elif not reported:
        assert _plan_dict(g["plan_json"]) == _plan_dict(w["plan_json"])
        assert [r.plan.params for r in got["genai_iterations"]] == [
            PS.EnhancementParams(**r.plan.params.model_dump())
            for r in want["genai_iterations"]]


def test_model_dump_json_equals_pydantic_on_a_sweep():
    img = np.random.default_rng(0).random((32, 32)).astype(np.float32)
    plan, _best, records = PT.autotune(img, ["noise", "blur"], device="cpu")
    plans = [r.plan for r in records] + [
        PS.EnhancementPlan(recommended_ops=["clahe", "Gamma ", "bogus"]),
        PS.EnhancementPlan(recommended_ops=[], stop_reason="clean image",
                           risk_warnings=["é halo"],
                           params=PS.EnhancementParams(gamma=1e-5,
                                                       unsharp_amount=1e20))]
    assert len(plans) == 29 and plan.model_dump() == records[
        [r.chosen for r in records].index(True)].plan.model_dump()
    for p in plans:
        j = JS.EnhancementPlan(**p.model_dump())
        assert p.model_dump() == j.model_dump()
        for indent in (None, 2):
            assert p.model_dump_json(indent=indent) == \
                j.model_dump_json(indent=indent)
        assert p.normalized_ops() == j.normalized_ops()
    for r in records:
        j = JS.IterationRecord(**r.model_dump())
        assert r.model_dump_json(indent=2) == j.model_dump_json(indent=2)


@pytest.mark.parametrize("seed", range(4))
def test_clamped_equals_jax(seed):
    rng = np.random.default_rng(seed)
    kw = {k: float(rng.uniform(lo - 1, hi + 1))
          for k, (lo, hi) in PS.PARAM_BOUNDS.items()}
    kw["clahe_tile_size"] = int(kw["clahe_tile_size"] * 10)
    kw["bilateral_d"] = int(kw["bilateral_d"])
    kw["denoise_mode"] = ("soft", "hard", "bogus", "")[seed]
    got = PS.EnhancementParams(**kw).clamped()
    want = JS.EnhancementParams(**kw).clamped()
    assert got.model_dump() == want.model_dump()
    assert got.model_dump_json() == want.model_dump_json()
    assert PS.PARAM_BOUNDS == JS.PARAM_BOUNDS
    assert PS.VALID_OPS == JS.VALID_OPS


def test_storage_schema_and_one_db_for_both(db):
    assert PST._SCHEMA_SQL == JST._SCHEMA_SQL
    assert PST.db_path() == JST.db_path() == str(db)
    PST.init_db()
    JST.init_db()
    row = dict(input_filename="a.dcm", metadata_summary={"Modality": "CT"},
               issues=["noise"], metrics_before={"sigma": 0.5},
               metrics_after={"sigma": 0.25}, plan_json="{}",
               validation={"ssim": 0.9, "passes": True},
               applied_ops=["Wavelet denoise (pre)"], explainability={},
               report_path="r.md", before_after_path="b.png",
               agent_logs=[{"phase": "decode"}], status="PASS")
    PST.save_run(run_id="port0001", **row)
    JST.save_run(run_id="jax00001", **row)
    a, b = JST.get_run("port0001"), PST.get_run("jax00001")
    a.pop("created_at"), b.pop("created_at")
    assert {**a, "run_id": "x"} == {**b, "run_id": "x"}
    PST.save_runs_bulk([{**row, "run_id": "bulk0001",
                         "input_filename": "s.dcm#frame0",
                         "status": "completed"}])
    listed = {r["run_id"]: r for r in JST.list_runs()}
    assert listed.keys() == {"port0001", "jax00001", "bulk0001"}
    assert listed == {r["run_id"]: r for r in PST.list_runs()}
    assert PST.mark_orphaned_runs() == 0
    PST.insert_pending_run("pend0001", "p.dcm")
    assert JST.mark_orphaned_runs() == 1
    assert PST.get_run_status("pend0001")["status"] == "error"


def _nudged(ctx: dict, **changes) -> dict:
    """A copy of a run's context with some fields changed."""
    import copy

    out = copy.deepcopy(ctx)
    for key, value in changes.items():
        if key in ("metrics_before", "metrics_after"):
            out[key] = {**out[key], **value}
        else:
            out[key] = value
    return out


def test_compare_runs_rules(tmp_path, db):
    """``parity.compare_runs``: what breaches and what is only reported."""
    path = write_synthetic_dicom(str(tmp_path / "n.dcm"), kind="noisy",
                                 size=64)
    want = PR.run_pipeline(path, str(tmp_path / "o"), device="cpu",
                           save_artifacts=False)
    assert parity.compare_runs(want, want) == ([], [])
    mb, ma = want["metrics_before"], want["metrics_after"]
    # a detection metric off its tolerance breaches
    bad, soft = parity.compare_runs(
        _nudged(want, metrics_before={"std": mb["std"] * 1.01}), want)
    assert bad and not soft
    # an issue that flips with its metric far from the threshold breaches;
    # near the threshold it is reported
    flip = _nudged(want, issues=[])
    bad, soft = parity.compare_runs(flip, want)
    assert bad == [bad[0]] and bad[0].startswith("issue noise") and not soft
    near = _nudged(want, metrics_before={"sigma": 0.08 + 1e-6})
    bad, soft = parity.compare_runs(_nudged(near, issues=[]), near)
    assert not bad and soft[0].startswith("issue noise")
    # the two ill-conditioned metrics of agreeing enhanced images are
    # reported; with the images apart, or another metric, they breach
    gs = {"gradient_strength": ma["gradient_strength"] * 1.01}
    bad, soft = parity.compare_runs(_nudged(want, metrics_after=gs), want)
    assert not bad and "ill-conditioned" in soft[0]
    apart = _nudged(want, metrics_after=gs,
                    enhanced_image=want["enhanced_image"] + 1e-3)
    bad, _ = parity.compare_runs(apart, want)
    assert any(b.startswith("validation.metrics_after.gradient_strength")
               for b in bad)
    bad, soft = parity.compare_runs(
        _nudged(want, metrics_after={"std": ma["std"] * 1.01}), want)
    assert bad and not soft
