"""The port's GenAI runner path against the JAX package's, on the CPU:
part (vi) of ``tests/test_torch_genai.py``'s list.

* The card's script (``chip_smoke.py`` phase 17's shape: two plans
  applied, validated and scored, a final plan with bilateral d = 5 and
  TV) through both orchestrators, held as the scenarios of
  ``tests/test_torch_genai_runs.py`` are.
* ``run_pipeline(genai=True)`` with that script and with the happy path's,
  with ``plan_only``, and the no-key fallback: the rows within
  ``parity.compare_rows``, the reports line for line with numbers and ids
  masked, the DB rows' ``genai_model``, ``genai_llm_calls`` and
  ``plan_json`` equal, and ``genai_error`` equal to JAX's text.
"""

from __future__ import annotations

import pytest

from mdx.pipeline import runner as JR
from mdx.pipeline import storage as JST
from test_torch_genai import _clean  # noqa: F401 (autouse: CPU context)
from test_torch_genai import PKG, Scripted
from test_torch_genai_runs import _dump, _masked, _scenario, check_orchestration

from mdx_torch import parity
from mdx_torch.io import write_synthetic_dicom
from mdx_torch.pipeline import runner as PR
from mdx_torch.pipeline import storage as PST


def test_card_script_orchestration_equals_jax(noisy_image):
    check_orchestration("full_chain", noisy_image)


# -------------------------------------------------------------- (vi) runner


@pytest.fixture
def db(tmp_path, monkeypatch):
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "runs.db"))
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    monkeypatch.delenv("MDX_TV_MODE", raising=False)
    return tmp_path / "runs.db"


def _runs(tmp_path, steps_name, **kw):
    path = write_synthetic_dicom(str(tmp_path / "noisy.dcm"), kind="noisy",
                                 size=64)
    out = {}
    for pkg, (llm, _, _, _) in PKG.items():
        if steps_name is not None:
            llm.set_transport(Scripted(llm, _scenario(steps_name, llm)))
        run = JR.run_pipeline if pkg == "jax" else PR.run_pipeline
        extra = {"device": "cpu"} if pkg == "port" else {}
        # one output directory: the reports name their PNG's path
        out[pkg] = run(path, str(tmp_path / "out"), genai=True,
                       model="gpt-5-mini", **kw, **extra)
        llm.set_transport(None)
    return out


@pytest.mark.parametrize("script", ["full_chain", "happy_path"])
def test_genai_run_equals_jax(tmp_path, db, script):
    out = _runs(tmp_path, script, max_iters=2)
    j, p = out["jax"], out["port"]
    assert not j.get("genai_fell_back") and not p.get("genai_fell_back")
    assert p["applied_ops"] == j["applied_ops"]
    assert _dump(p["genai_plan"]) == _dump(j["genai_plan"])
    assert p["genai_llm_calls"] == j["genai_llm_calls"]
    assert [_dump(r.plan) for r in p["genai_iterations"]] == [
        _dump(r.plan) for r in j["genai_iterations"]]
    assert [r.chosen for r in p["genai_iterations"]] == [
        r.chosen for r in j["genai_iterations"]]
    bad, reported = parity.compare_runs(p, j)
    assert not bad and not reported, (bad, reported)
    assert {"detect", "genai", "validate", "png", "report", "db"} <= set(
        p["phase_ms"])
    assert (_masked(p["report_md"]).splitlines()
            == _masked(j["report_md"]).splitlines())
    g, w = PST.get_run(p["run_id"]), JST.get_run(j["run_id"])
    bad, reported = parity.compare_rows(g, w, (64, 64))
    assert not bad and not reported, (bad, reported)
    for key in ("genai_model", "genai_llm_calls", "plan_json",
                "explainability", "applied_ops", "issues"):
        assert g[key] == w[key], key
    assert any(e.get("phase") == "planner" for e in g["agent_logs"])


def test_plan_only_run_equals_jax(tmp_path, db, capsys):
    out = _runs(tmp_path, "plan_only", plan_only=True)
    j, p = out["jax"], out["port"]
    assert p.keys() == j.keys() == {"run_id", "plan_only", "plan",
                                    "stop_reason"}
    assert p["plan_only"] and _dump(p["plan"]) == _dump(j["plan"])
    assert p["stop_reason"] == j["stop_reason"] is None
    assert not PST.list_runs() and not JST.list_runs()


def test_no_key_run_falls_back_as_jax_s(tmp_path, db, monkeypatch):
    """No key and no transport: the planner's model call fails on both
    models and the run takes the deterministic path with JAX's text."""
    def refuse(*a, **kw):
        raise AssertionError("no test reaches a network")

    import http.client

    monkeypatch.setattr(http.client, "HTTPSConnection", refuse)
    out = _runs(tmp_path, None)
    j, p = out["jax"], out["port"]
    assert j["genai_fell_back"] and p["genai_fell_back"]
    assert p["genai_error"] == j["genai_error"] == (
        "planner failed: OPENAI_API_KEY not set; fallback: OPENAI_API_KEY "
        "not set")
    bad, reported = parity.compare_runs(p, j)
    assert not bad and not reported, (bad, reported)
    assert (_masked(p["report_md"]).splitlines()
            == _masked(j["report_md"]).splitlines())
    g, w = PST.get_run(p["run_id"]), JST.get_run(j["run_id"])
    for key in ("genai_model", "genai_llm_calls", "plan_json"):
        assert g[key] == w[key], key
