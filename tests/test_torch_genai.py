"""The port's GenAI mode (``mdx_torch.genai``: tools, agents, orchestrator;
``mdx_torch.core.schemas``' validation and lowering) against the JAX
package's, on the CPU.

Each case does the same thing in both packages on the same numpy inputs:

* (i) ``model_validate`` / ``model_validate_json`` on a corpus of plans a
  model could send (a missing ``recommended_ops``, ``params`` that is not
  an object, ``8.0`` against ``8.5`` for an int, numeric strings, ``true``
  for a float, ``null`` for a field that is not optional, unknown keys,
  malformed JSON text): the port raises exactly where pydantic raises,
  with the same error types and locations, and otherwise writes the same
  ``model_dump_json``; the same for ``ExplainabilityReport`` and
  ``GenAIContext``, and ``to_static_dynamic``'s lowering;
* (ii) the three prompts byte-equal on the same inputs, ``TOOL_SCHEMAS``
  equal;
* (iii) each tool's JSON on the same image within ``mdx_torch.parity``
  (the plan with bilateral d = 5 and a TV weight among them), their error
  JSON equal, ``clamp_plan`` equal;
* (v) the image store and the tool context are per thread, and the
  port's GenAI modules import with JAX and pydantic blocked.

(iv), every orchestration scenario, and (vi), the runner's GenAI path,
are in ``tests/test_torch_genai_runs.py``, which shares this file's
scripted transport.  JAX compiles a program per plan structure and image
shape, so the cases share a few plans and one image size (64^2).
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pydantic
import pytest
import torch

from mdx.genai import agents as JA
from mdx.genai import client as JL
from mdx.genai import orchestrator as JO
from mdx.genai import tools as JT
from mdx.pipeline import schemas as JS

from mdx_torch import parity
from mdx_torch.core import schemas as PS
from mdx_torch.genai import agents as PA
from mdx_torch.genai import client as PL
from mdx_torch.genai import orchestrator as PO
from mdx_torch.genai import tools as PT

torch.set_num_threads(1)

PKG = {"jax": (JL, JT, JO, JS), "port": (PL, PT, PO, PS)}
HW = 64 * 64


@pytest.fixture(autouse=True)
def _clean():
    PT.set_context("cpu")
    yield
    for llm, tools, _, _ in PKG.values():
        llm.set_transport(None)
        tools.clear_image_store()


def _msg(content=None, tool_calls=None):
    return {"choices": [{"message": {"content": content,
                                     "tool_calls": tool_calls or []}}]}


def _call(cid, name, **args):
    return {"id": cid, "function": {"name": name,
                                    "arguments": json.dumps(args)}}


def _plan_json(**over):
    plan = {
        "recommended_ops": ["denoise", "clahe"],
        "params": {"clahe_clip_limit": 0.02, "denoise_mode": "soft"},
        "risk_warnings": [], "rationale": "test", "safety": "",
        "stop_reason": None,
    }
    plan.update(over)
    return json.dumps(plan)


# the plan the card's phase runs: bilateral d = 5 and a TV weight
FULL_PLAN = _plan_json(
    recommended_ops=["denoise", "clahe", "unsharp", "bilateral",
                     "tv_denoise"],
    params={"clahe_clip_limit": 0.02, "unsharp_amount": 0.6,
            "unsharp_radius": 1.0, "bilateral_d": 5,
            "tv_denoise_weight": 0.05})

EXPLANATION = json.dumps({
    "detected_issues": "noise found", "corrective_measures": "denoise",
    "enhancement_applied": "wavelet", "validation_outcome": "ok",
    "limitations": "not for diagnosis", "image_summary": "CT with noise",
    "actionable_suggestions": ["a"], "next_steps": ["b"]})

FIXED_VALIDATION = {
    "contrast_gain": 0.1, "sharpness_gain": 0.1, "noise_change": -0.1,
    "niqe_after": 1.0, "niqe_before": 1.2, "passes": True,
    "edge_ratio": 0.9, "entropy_change": 0.0, "snr_change": 0.5,
    "histogram_spread_change": 0.0, "local_contrast_change": 0.0,
    "gradient_strength_change": 0.0, "gradient_entropy_change": 0.0}


class Scripted:
    """A transport that plays back ``steps``: a response, an exception to
    raise, or a function of the messages sent that returns a response."""

    def __init__(self, llm, steps):
        self.llm, self.steps, self.requests = llm, list(steps), []

    def __call__(self, model, payload):
        self.requests.append((model, payload))
        if not self.steps:
            raise self.llm.LLMError("script exhausted")
        step = self.steps.pop(0)
        if isinstance(step, Exception):
            raise step
        return step(payload["messages"]) if callable(step) else step


def _tool_outputs(messages) -> list[dict]:
    return [json.loads(m["content"]) for m in messages
            if m.get("role") == "tool"]


def _validate_last(messages):
    """Validate the enhanced image of the last apply."""
    enh = [o for o in _tool_outputs(messages) if "enhanced_image_id" in o]
    return _msg(None, [_call("v", "tool_validate", original_id="original",
                             enhanced_id=enh[-1]["enhanced_image_id"])])


def _score_last(messages):
    """Score the last validation."""
    return _msg(None, [_call("s", "tool_score_plan", validation_json=json
                             .dumps(_tool_outputs(messages)[-1]))])


# ------------------------------------------------------------ (i) schemas

PLAN_CORPUS = {
    "missing recommended_ops": {"params": {}},
    "params not an object": {"recommended_ops": [], "params": [1, 2]},
    "params null": {"recommended_ops": [], "params": None},
    "tile 8.0": {"recommended_ops": ["clahe"],
                 "params": {"clahe_tile_size": 8.0}},
    "tile 8.5": {"recommended_ops": ["clahe"],
                 "params": {"clahe_tile_size": 8.5}},
    "tile '8.0' and ' 8 '": {"recommended_ops": ["clahe"],
                             "params": {"clahe_tile_size": "8.0",
                                        "bilateral_d": " 5 "}},
    "tile '8.5'": {"recommended_ops": [], "params": {"clahe_tile_size": "8.5"}},
    "numeric strings": {"recommended_ops": ["clahe"],
                        "params": {"clahe_clip_limit": "0.02",
                                   "gamma": " 1e0 ", "unsharp_amount": "1_0"}},
    "bad numeric string": {"recommended_ops": [],
                           "params": {"gamma": "0x10"}},
    "true for a float": {"recommended_ops": [],
                         "params": {"gamma": True, "bilateral_d": False}},
    "null for a float": {"recommended_ops": [], "params": {"gamma": None}},
    "null for a string": {"recommended_ops": [], "rationale": None},
    "null stop_reason": {"recommended_ops": [], "stop_reason": None},
    "number for a string": {"recommended_ops": [], "stop_reason": 3},
    "unknown keys": {"recommended_ops": ["denoise"], "colour": "red",
                     "params": {"gamma": 0.9, "zzz": {"a": 1}}},
    "ops not a list": {"recommended_ops": "denoise"},
    "ops with a number": {"recommended_ops": ["denoise", 7, None]},
    "int too large": {"recommended_ops": [], "params": {"bilateral_d": 1e20}},
    "int inf": {"recommended_ops": [], "params": {"bilateral_d": float("inf")}},
    "float inf and nan": {"recommended_ops": [],
                          "params": {"gamma": float("inf"),
                                     "unsharp_amount": float("nan")}},
    "string inf": {"recommended_ops": [], "params": {"gamma": "-Infinity"}},
    "non-ASCII digit": {"recommended_ops": [], "params": {"gamma": "١"}},
    "big int for a float": {"recommended_ops": [], "params": {"gamma": 10**30}},
    "mode bytes-like": {"recommended_ops": [],
                        "params": {"denoise_mode": ["soft"]}},
    "several errors": {"params": {"gamma": "x", "bilateral_d": 2.5},
                       "risk_warnings": [1, "a", None]},
    "not an object": [1, 2],
    "a string": "plan",
    "null": None,
    "full plan": json.loads(FULL_PLAN),
}

JSON_TEXTS = {
    "truncated": '{"recommended_ops": []',
    "trailing text": '{"recommended_ops": []} and more',
    "empty": "",
    "array": "[]",
    "null": "null",
    "byte order mark": "﻿{}",
    "NaN literal": '{"recommended_ops": [], "params": {"gamma": NaN}}',
    "huge integer": '{"recommended_ops": [], "params": {"gamma": 1'
                    + "0" * 400 + "}}",
    "duplicate key": '{"recommended_ops": ["clahe"], '
                     '"recommended_ops": ["gamma"]}',
    "whitespace around": '  {"recommended_ops": ["gamma"]}\n',
    "unicode text": '{"recommended_ops": [], "rationale": "f\\u00fcr \\u2713"}',
}


@pytest.mark.parametrize("label", sorted(PLAN_CORPUS))
def test_model_validate_raises_where_pydantic_raises(label):
    obj = PLAN_CORPUS[label]
    for name in ("EnhancementPlan", "EnhancementParams"):
        if name == "EnhancementParams" and not isinstance(obj, dict):
            continue
        arg = obj if name == "EnhancementPlan" else obj.get("params", {})
        want = _validated(getattr(JS, name), arg, json_text=False)
        got = _validated(getattr(PS, name), arg, json_text=False)
        assert got == want, (name, got, want)
        try:
            text = json.dumps(arg)
        except ValueError:
            continue
        assert (_validated(getattr(PS, name), text, json_text=True)
                == _validated(getattr(JS, name), text, json_text=True))


def _validated(model, arg, json_text: bool):
    try:
        out = (model.model_validate_json(arg) if json_text
               else model.model_validate(arg))
        return "ok", out.model_dump_json()
    except (pydantic.ValidationError, PS.ValidationError) as e:
        return "raised", [(x["type"], tuple(x["loc"])) for x in e.errors()]


@pytest.mark.parametrize("label", sorted(JSON_TEXTS))
def test_model_validate_json_raises_where_pydantic_raises(label):
    text = JSON_TEXTS[label]
    want = _validated(JS.EnhancementPlan, text, json_text=True)
    got = _validated(PS.EnhancementPlan, text, json_text=True)
    assert got[0] == want[0], (got, want)
    if want[0] == "ok":
        assert got == want
    else:
        # the JSON parsers word their errors differently; the kind agrees
        assert [t for t, _ in got[1]] == [t for t, _ in want[1]]


REPORTS = {
    "full": json.loads(EXPLANATION),
    "required only": {k: "x" for k in (
        "detected_issues", "corrective_measures", "enhancement_applied",
        "validation_outcome", "limitations")},
    "missing fields": {"detected_issues": "x"},
    "list of numbers": {**json.loads(EXPLANATION),
                        "next_steps": ["a", 2]},
    "list as a string": {**json.loads(EXPLANATION), "next_steps": "a"},
    "null summary": {**json.loads(EXPLANATION), "image_summary": None},
}


@pytest.mark.parametrize("label", sorted(REPORTS))
def test_report_and_context_validate_as_pydantic(label):
    obj = REPORTS[label]
    for name in ("ExplainabilityReport", "GenAIContext"):
        arg = obj if name == "ExplainabilityReport" else {
            "metrics": {"sigma": "0.1", "std": True}, "issues": obj.get(
                "next_steps", []), "metadata": {"Modality": "CT"}}
        assert (_validated(getattr(PS, name), arg, False)
                == _validated(getattr(JS, name), arg, False)), name


@pytest.mark.parametrize("plan", [
    FULL_PLAN, _plan_json(),
    _plan_json(recommended_ops=["Clahe ", "bilateral", "GAMMA", "blur"],
               params={"bilateral_d": 99, "clahe_tile_size": 2,
                       "gamma": 9.0, "denoise_mode": "hard"}),
    _plan_json(recommended_ops=["unsharp", "denoise"],
               params={"bilateral_d": 7, "tv_denoise_weight": -1.0})])
def test_lowering_equals_jax(plan):
    """``to_static_dynamic``: the same ops, tile, bilateral diameter (0
    unless bilateral runs), order and clamped parameters as JAX's."""
    import dataclasses

    j_static, j_dyn = JS.EnhancementPlan.model_validate_json(
        plan).to_static_dynamic(tv_mode="ref")
    p_static, p_dyn = PS.EnhancementPlan.model_validate_json(
        plan).to_static_dynamic(device="cpu")
    assert dataclasses.asdict(p_static) == dataclasses.asdict(j_static)
    for k, v in j_dyn._asdict().items():
        got = getattr(p_dyn, k)
        assert got.device.type == "cpu" and got.shape == ()
        assert got.item() == pytest.approx(float(v), rel=1e-7), k


# ----------------------------------------------------- (ii) prompts, schemas


def test_prompts_and_tool_schemas_equal_jax(noisy_image):
    """Byte-equal prompts on the same inputs: metrics from a float32 metric
    pass, issues, and metadata as the orchestrator sanitises it."""
    from mdx_torch.core.metrics import image_stats

    stats = image_stats(torch.from_numpy(noisy_image)[None])
    metrics = {k: float(v[0]) for k, v in stats.items()}
    meta = {"Modality": "CT", "BodyPartExamined": "CHEST",
            "StudyDescription": "café \x01 study"}
    assert PO.sanitise_metadata(meta) == JO.sanitise_metadata(meta)
    meta = PO.sanitise_metadata(meta)
    issues = ["noise", "low_contrast"]
    assert (PA.planner_prompt(meta, issues, metrics)
            == JA.planner_prompt(meta, issues, metrics))
    seed = PS.EnhancementPlan.model_validate_json(FULL_PLAN).model_dump_json()
    assert seed == JS.EnhancementPlan.model_validate_json(
        FULL_PLAN).model_dump_json()
    assert (PA.tuning_prompt(3, seed, "original", metrics)
            == JA.tuning_prompt(3, seed, "original", metrics))
    assert PA.explainability_prompt() == JA.explainability_prompt()
    assert PT.TOOL_SCHEMAS == JT.TOOL_SCHEMAS
    assert list(PT.TOOL_IMPLS) == list(JT.TOOL_IMPLS)
    import inspect

    for name, fn in PT.TOOL_IMPLS.items():
        assert (list(inspect.signature(fn).parameters)
                == list(inspect.signature(JT.TOOL_IMPLS[name]).parameters))
    assert PA.FALLBACK_MODEL == JA.FALLBACK_MODEL
    assert PO._MAX_LLM_CALLS == JO._MAX_LLM_CALLS


# ------------------------------------------------------------- (iii) tools


def _flat(prefix: str, d: dict) -> dict[str, np.ndarray]:
    return {f"{prefix}.{k}": np.array([v]) for k, v in d.items()}


@pytest.mark.parametrize("plan", [FULL_PLAN, _plan_json()],
                         ids=["bilateral_tv", "denoise_clahe"])
def test_tools_equal_jax_within_parity(noisy_image, plan):
    out = {}
    for pkg, (_, tools, _, _) in PKG.items():
        tools.register_image(noisy_image, "original")
        metrics = json.loads(tools.tool_get_metrics("original"))
        applied = json.loads(tools.tool_apply_enhancement("original", plan))
        val_text = tools.tool_validate("original",
                                       applied["enhanced_image_id"])
        out[pkg] = {"metrics": metrics, "applied": applied,
                    "validation": json.loads(val_text),
                    "image": tools.get_image(applied["enhanced_image_id"]),
                    "score": json.loads(tools.tool_score_plan(val_text))}
    j, p = out["jax"], out["port"]
    assert list(p["metrics"]) == list(j["metrics"])
    assert not parity.breaches(_flat("stats", p["metrics"]),
                               _flat("stats", j["metrics"]), hw=HW)
    assert p["applied"]["applied_ops"] == j["applied"]["applied_ops"]
    assert not parity.breaches(_flat("stats", p["applied"]["metrics"]),
                               _flat("stats", j["applied"]["metrics"]),
                               hw=HW)
    assert p["image"].dtype == np.float32
    tv_ran = "tv_denoise" in p["applied"]["applied_ops"]
    assert not parity.breaches({"enhanced": p["image"][None]},
                               {"enhanced": j["image"][None]}, tv_ran=tv_ran)
    assert list(p["validation"]) == list(j["validation"])
    sigmas = {**_flat("validation.metrics_before", j["metrics"]),
              **_flat("validation.metrics_after", j["applied"]["metrics"])}
    val = {k: v for k, v in _flat("validation", j["validation"]).items()}
    got = {k: v for k, v in _flat("validation", p["validation"]).items()}
    assert not parity.breaches({**got, **sigmas}, {**val, **sigmas},
                               names=sorted(val), hw=HW)
    assert list(p["score"]["breakdown"]) == list(j["score"]["breakdown"])
    assert abs(p["score"]["score"] - j["score"]["score"]) <= parity.SCORE_ATOL
    # the same validation JSON scores alike
    same = {pkg: json.loads(PKG[pkg][1].tool_score_plan(
        json.dumps(j["validation"]))) for pkg in PKG}
    assert abs(same["port"]["score"] - same["jax"]["score"]) <= 1e-4
    for k, v in same["jax"]["breakdown"].items():
        assert abs(same["port"]["breakdown"][k] - v) <= 1e-4, k


@pytest.mark.parametrize("call", [
    ("tool_get_metrics", ("nope",)),
    ("tool_validate", ("original", "nope")),
    ("tool_score_plan", ("{not json",)),
    ("tool_score_plan", ('{"error": "upstream"}',)),
    ("tool_score_plan", ("[1, 2]",)),
    ("tool_score_plan", ('"error text"',)),
    ("tool_score_plan", ("7",)),
    ("tool_score_plan", ('{"contrast_gain": 1.0}',)),
    ("tool_score_plan", (json.dumps({**FIXED_VALIDATION,
                                     "contrast_gain": "abc"}),)),
    ("tool_score_plan", (json.dumps({**FIXED_VALIDATION,
                                     "passes": 1.0, "gamma": None}),)),
    ("tool_score_plan", (json.dumps(FIXED_VALIDATION),)),
], ids=lambda c: c[0] if isinstance(c, str) else None)
def test_tool_results_on_odd_arguments_equal_jax(noisy_image, call):
    name, args = call
    got = {}
    for pkg, (_, tools, _, _) in PKG.items():
        tools.register_image(noisy_image, "original")
        got[pkg] = tools.TOOL_IMPLS[name](*args)
    assert got["port"] == got["jax"]


def test_bad_plan_json_is_an_error_result(noisy_image):
    for text in ("{not json", '{"params": {}}',
                 _plan_json(params={"clahe_tile_size": 8.5})):
        for pkg, (_, tools, _, _) in PKG.items():
            tools.register_image(noisy_image, "original")
            out = json.loads(tools.tool_apply_enhancement("original", text))
            assert list(out) == ["error"] and "validation error" in (
                out["error"]), (pkg, out)


@pytest.mark.parametrize("plan", [
    FULL_PLAN,
    _plan_json(params={"clahe_clip_limit": 99.0, "gamma": -5.0,
                       "unsharp_amount": 1e9, "denoise_mode": "bogus",
                       "bilateral_d": 40, "clahe_tile_size": "2",
                       "tv_denoise_weight": float("nan")})])
def test_clamp_plan_equals_jax(plan):
    j = JT.clamp_plan(JS.EnhancementPlan.model_validate_json(plan))
    p = PT.clamp_plan(PS.EnhancementPlan.model_validate_json(plan))
    assert p.model_dump_json() == j.model_dump_json()


# ------------------------------------------------------------ (v) threads


def test_store_and_context_are_per_thread(noisy_image, clean_image):
    """Two threads register "original" at once: each sees its own pixels
    and its own device, and one thread's clear leaves the other's store."""
    errors, barrier = [], threading.Barrier(2)

    def work(img, marker):
        try:
            PT.set_context("cpu", tv_mode="fast" if marker == "A" else None)
            PT.register_image(img, "original")
            barrier.wait(timeout=10)
            np.testing.assert_array_equal(PT.get_image("original"), img,
                                          err_msg=marker)
            assert PT.get_context() == (torch.device("cpu"),
                                        "fast" if marker == "A" else None)
            PT.clear_image_store()
            barrier.wait(timeout=10)
            with pytest.raises(KeyError):
                PT.get_image("original")
        except Exception as exc:                          # noqa: BLE001
            errors.append((marker, exc))

    threads = [threading.Thread(target=work, args=(img, m))
               for img, m in ((noisy_image, "A"), (clean_image, "B"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    # a thread that never set a context works on the card
    seen = []
    t = threading.Thread(target=lambda: seen.append(PT.get_context()))
    t.start()
    t.join()
    assert seen == [(torch.device("cuda"), None)]
    # the orchestrator restores the caller's context
    PT.set_context("cpu", "fast")
    PL.set_transport(Scripted(PL, [PL.LLMError("down")] * 2))
    PO.run_genai_pipeline(image=noisy_image, metadata={}, issues=[],
                          metrics={}, device="cpu")
    assert PT.get_context() == (torch.device("cpu"), "fast")


def test_genai_modules_run_with_jax_and_pydantic_blocked():
    """With ``sys.modules["jax"] = sys.modules["pydantic"] = None`` the
    orchestrator, the runner and the CLI import, and a scripted GenAI run
    (validation, lowering, tools, explainability) completes on the CPU."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = textwrap.dedent("""
        import json, sys
        sys.modules["jax"] = sys.modules["pydantic"] = None
        import numpy as np
        import mdx_torch.__main__
        import mdx_torch.pipeline.runner
        from mdx_torch.genai import client, orchestrator
        plan = json.dumps({"recommended_ops": ["denoise", "bilateral"],
                           "params": {"bilateral_d": "5"}})
        replies = [plan, plan, '{"detected_issues": "a"}']
        client.set_transport(lambda model, payload: {"choices": [{
            "message": {"content": replies.pop(0), "tool_calls": []}}]})
        image = np.random.default_rng(0).random((32, 32), np.float32)
        r = orchestrator.run_genai_pipeline(
            image=image, metadata={}, issues=["noise"], metrics={},
            device="cpu")
        assert not r.fell_back_to_deterministic, r.error
        assert r.applied_ops[:2] == ["denoise", "bilateral"], r.applied_ops
        assert r.best_plan.params.bilateral_d == 5
        assert "diagnosis" in r.explainability.limitations
        bad = [m for m, v in sys.modules.items() if v is not None
               and m.split(".")[0] in ("mdx", "jax", "pydantic")]
        assert not bad, bad
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root)
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stderr[-3000:]
