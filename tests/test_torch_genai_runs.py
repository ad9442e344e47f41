"""The port's GenAI orchestration against the JAX package's, on the CPU:
part (iv) of ``tests/test_torch_genai.py``'s list, in a file of its own
so that the parts run in separate workers (part (vi), the runner, is in
``tests/test_torch_genai_runner.py``).

* (iv) every orchestration scenario of ``tests/test_genai.py`` (happy
  path, planner failure, model fallback, ``stop_reason``, ``plan_only``,
  tuning failure, iterations, out-of-order scoring, malformed tool
  result, cost guard, scored-best fallback) through both orchestrators
  with the same script: each package has its own transport instance, and
  a step that names an enhanced image reads it from the messages it is
  sent (the ids are random).  The best plan's
  JSON, applied ops, LLM call count, the iteration records' plans and
  ``chosen``, the scores within ``parity.SCORE_ATOL``, the fallback flag,
  the error text and the trace (numbers and ids masked) agree.
"""

from __future__ import annotations

import json
import re

import numpy as np
import pytest

from test_torch_genai import _clean  # noqa: F401 (autouse: CPU context)
from test_torch_genai import (EXPLANATION, FIXED_VALIDATION, FULL_PLAN, HW,
                              PKG, Scripted, _call, _flat, _msg, _plan_json,
                              _score_last, _tool_outputs, _validate_last)

from mdx_torch import parity
from mdx_torch.genai import orchestrator as PO

_ID = re.compile(r"(enhanced|img)_[0-9a-f]{6,8}")


def _masked(text: str) -> str:
    return parity._NUMBER.sub("#", _ID.sub("<id>", text))


# ------------------------------------------------------ (iv) orchestration


def _scenario(name: str, llm):
    """The steps of one scenario of tests/test_genai.py for ``llm``'s
    package (a fresh list per call: the functions keep no state)."""
    E = llm.LLMError
    if name == "happy_path":
        return [_msg(_plan_json()),
                _msg(_plan_json(recommended_ops=["denoise"])),
                _msg(EXPLANATION)]
    if name == "planner_failure":
        return [E("boom"), E("boom2")]
    if name == "model_fallback":
        return [E("primary down"),
                _msg(_plan_json(stop_reason="image is fine",
                                recommended_ops=[]))]
    if name == "stop_reason":
        return [_msg(_plan_json(stop_reason="already good",
                                recommended_ops=[]))]
    if name == "plan_only":
        return [_msg(_plan_json())]
    if name == "tuning_failure":
        return [_msg(_plan_json()), E("tuning down"),
                E("tuning fallback down"), E("expl down"),
                E("expl fallback down")]
    if name == "iterations":
        return [_msg(_plan_json()),
                _msg(None, [_call("c1", "tool_apply_enhancement",
                                  image_id="original",
                                  plan_json=_plan_json())]),
                _msg(None, [_call("c2", "tool_score_plan",
                                  validation_json=json.dumps(
                                      FIXED_VALIDATION))]),
                _msg(_plan_json()), E("no expl"), E("no expl fb")]
    if name == "out_of_order":
        plan_a = _plan_json(recommended_ops=["clahe"],
                            params={"clahe_clip_limit": 0.01})
        plan_b = _plan_json(recommended_ops=["clahe", "unsharp"],
                            params={"clahe_clip_limit": 0.04,
                                    "unsharp_amount": 2.5,
                                    "unsharp_radius": 2.0})

        def validate_b_then_a(messages):
            a, b = _tool_outputs(messages)[:2]
            return _msg(None, [
                _call("v1", "tool_validate", original_id="original",
                      enhanced_id=b["enhanced_image_id"]),
                _call("v2", "tool_validate", original_id="original",
                      enhanced_id=a["enhanced_image_id"])])

        def score_both(messages):
            val_b, val_a = _tool_outputs(messages)[2:4]
            return _msg(None, [
                _call("s1", "tool_score_plan",
                      validation_json=json.dumps(val_b)),
                _call("s2", "tool_score_plan",
                      validation_json=json.dumps(val_a))])

        return [_msg(plan_a),
                _msg(None, [_call("a1", "tool_apply_enhancement",
                                  image_id="original", plan_json=plan_a),
                            _call("a2", "tool_apply_enhancement",
                                  image_id="original", plan_json=plan_b)]),
                validate_b_then_a, score_both, _msg(plan_b),
                E("no explainability"), E("no explainability")]
    if name == "malformed_tool_result":
        return [_msg(_plan_json()),
                _msg(None, [_call("b1", "tool_score_plan",
                                  validation_json="{not json")]),
                _msg(_plan_json()), E("no expl"), E("no expl fb")]
    if name == "cost_guard":
        return [_msg(None, [_call("c", "tool_get_metrics",
                                  image_id="original")])] * 50
    if name == "scored_best_fallback":
        plan_good = _plan_json(recommended_ops=["clahe"],
                               params={"clahe_clip_limit": 0.02})
        val = {**FIXED_VALIDATION, "contrast_gain": 0.2,
               "sharpness_gain": 0.2}
        return [_msg(_plan_json()),
                _msg(None, [_call("a1", "tool_apply_enhancement",
                                  image_id="original", plan_json=plan_good)]),
                _msg(None, [_call("s1", "tool_score_plan",
                                  validation_json=json.dumps(val))]),
                _msg("thanks, that went well!"), E("no expl"),
                E("no expl fb")]
    if name == "full_chain":
        # the card's script: two plans applied, validated and scored, the
        # final plan with bilateral d = 5 and TV
        second = _plan_json(params={"clahe_clip_limit": 0.03})
        return [_msg(_plan_json()),
                _msg(None, [_call("a1", "tool_apply_enhancement",
                                  image_id="original", plan_json=second)]),
                _validate_last, _score_last,
                _msg(None, [_call("a2", "tool_apply_enhancement",
                                  image_id="original", plan_json=FULL_PLAN)]),
                _validate_last, _score_last, _msg(FULL_PLAN),
                _msg(EXPLANATION)]
    raise KeyError(name)


# tests/test_genai.py's scenarios; the card's script ("full_chain") runs
# through both orchestrators in tests/test_torch_genai_runner.py
SCENARIOS = ("happy_path", "planner_failure", "model_fallback", "stop_reason",
             "plan_only", "tuning_failure", "iterations", "out_of_order",
             "malformed_tool_result", "cost_guard", "scored_best_fallback")


def _run_both(name: str, image, **kw):
    out = {}
    for pkg, (llm, _, orch, _) in PKG.items():
        tr = Scripted(llm, _scenario(name, llm))
        llm.set_transport(tr)
        extra = {"device": "cpu"} if pkg == "port" else {}
        out[pkg] = (orch.run_genai_pipeline(
            image=image, metadata={"Modality": "CT"}, issues=["noise"],
            metrics={"sigma": 0.12, "std": 0.2}, model="gpt-5-mini",
            plan_only=name == "plan_only", **kw, **extra), tr)
        llm.set_transport(None)
    return out


def _dump(plan):
    return None if plan is None else plan.model_dump_json()


@pytest.mark.parametrize("name", SCENARIOS)
def test_orchestration_equals_jax(noisy_image, name):
    check_orchestration(name, noisy_image)


def check_orchestration(name: str, image) -> None:
    """One scenario through both orchestrators: the fields that must
    agree (module doc)."""
    out = _run_both(name, image)
    (j, tj), (p, tp) = out["jax"], out["port"]
    assert p.fell_back_to_deterministic == j.fell_back_to_deterministic
    assert p.error == j.error
    assert p.plan_only == j.plan_only
    assert _dump(p.plan) == _dump(j.plan)
    assert _dump(p.best_plan) == _dump(j.best_plan)
    assert p.applied_ops == j.applied_ops
    assert p.llm_call_count == j.llm_call_count
    assert p.model_name == j.model_name
    assert [m for m, _ in tp.requests] == [m for m, _ in tj.requests]
    assert len(tp.requests) <= PO._MAX_LLM_CALLS
    assert p.prompts_used.keys() == j.prompts_used.keys()
    assert [_dump(r.plan) for r in p.iterations] == [
        _dump(r.plan) for r in j.iterations]
    assert [r.chosen for r in p.iterations] == [r.chosen for r in j.iterations]
    assert [r.iteration for r in p.iterations] == [
        r.iteration for r in j.iterations]
    for rp, rj in zip(p.iterations, j.iterations):
        assert abs(rp.score - rj.score) <= parity.SCORE_ATOL
        assert list(rp.metrics) == list(rj.metrics)
    assert _dump(p.explainability) == _dump(j.explainability) or (
        parity._NUMBER.sub("#", _dump(p.explainability))
        == parity._NUMBER.sub("#", _dump(j.explainability)))
    assert ([(t["phase"], t["event"]) for t in p.agent_traces]
            == [(t["phase"], t["event"]) for t in j.agent_traces])
    masked = [[_masked(t["detail"]) for t in r.agent_traces] for r in (p, j)]
    assert masked[0] == masked[1]
    if j.enhanced_image is None:
        assert p.enhanced_image is None
    else:
        assert p.enhanced_image.dtype == np.float32
        assert not parity.breaches(
            {"enhanced": p.enhanced_image[None]},
            {"enhanced": np.asarray(j.enhanced_image, np.float32)[None]},
            tv_ran="tv_denoise" in p.applied_ops)
        assert not parity.breaches(_flat("stats", p.enhanced_metrics),
                                   _flat("stats", j.enhanced_metrics), hw=HW)
    if name == "malformed_tool_result":
        drops = [t for t in p.agent_traces if "dropped iteration record"
                 in t["detail"]]
        assert len(drops) == 1 and "JSONDecodeError" in drops[0]["detail"]
    if name == "full_chain":
        assert [r.chosen for r in p.iterations].count(True) == 1
        assert len(p.iterations) == 2 and p.llm_call_count == 9
        assert p.applied_ops[:5] == ["denoise", "clahe", "unsharp",
                                     "bilateral", "tv_denoise"]
