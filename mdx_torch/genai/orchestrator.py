"""5-phase GenAI orchestration (ref pipeline/genai_agents.py:334-582).

The port's copy of ``mdx/genai/orchestrator.py``.  Phases: Planner →
(plan-only early return) → Tuning → Execute → Validate + Explainability,
with the reference's layered degradation chain: model fallback
(agents.py) → phase-local fallbacks (planner fail ⇒ deterministic flag;
tuning fail ⇒ the scored-best iteration's plan, else the seed plan;
explainability fail ⇒ template) → runner-level deterministic fallback
(:mod:`mdx_torch.pipeline.runner`).  Every tool call observed during tuning
becomes an ``IterationRecord``, paired through the ``enhanced_image_id``
chain, and the cost guard (``MDX_MAX_LLM_CALLS``, read at import) caps the
model calls of a run.

The tools run on ``device`` (the card unless the caller passes another):
:func:`run_genai_pipeline` sets it, with ``tv_mode``, as the calling
thread's tool context (:func:`mdx_torch.genai.tools.set_context`) and
restores the previous context when it returns.
"""

from __future__ import annotations

import json
import logging
import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from mdx_torch.core.schemas import (
    EnhancementPlan,
    ExplainabilityReport,
    IterationRecord,
)
from mdx_torch.genai import client as llm
from mdx_torch.genai import tools as T
from mdx_torch.genai.agents import (
    explainability_prompt,
    planner_prompt,
    run_agent,
    tuning_prompt,
)
from mdx_torch.pipeline.trace import AgentTraceLogger

logger = logging.getLogger(__name__)

# Cost guard (ref genai_agents.py:56: default 10 calls; env-overridable).
_MAX_LLM_CALLS = int(os.environ.get("MDX_MAX_LLM_CALLS",
                                    os.environ.get("MDIMG_MAX_LLM_CALLS",
                                                   "10")))

_CTRL = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f]")
_META_WHITELIST = ("Modality", "BodyPartExamined", "StudyDescription")


def sanitise_metadata(metadata: dict[str, Any]) -> dict[str, str]:
    """Whitelist + control-char strip + 100-char cap
    (ref genai_agents.py:81-92)."""
    if os.environ.get("MDX_NO_REDACT"):
        # Bypass skips the whitelist only; control chars are stripped
        # unconditionally (they can break the prompt / smuggle directives).
        return {k: _CTRL.sub("", str(v))[:100] for k, v in metadata.items()}
    out = {}
    for key in _META_WHITELIST:
        val = metadata.get(key)
        if val:
            out[key] = _CTRL.sub("", str(val))[:100]
    return out


def _validations_match(stored: dict, scored: dict) -> bool:
    """True when the validation dict the model passed to tool_score_plan is
    the one tool_validate returned for a recorded enhanced image.  The
    model echoes the JSON back, possibly re-serialised — compare parsed
    values (floats within 1e-6) rather than strings."""
    if set(stored) != set(scored):
        return False
    for k, a in stored.items():
        b = scored[k]
        if isinstance(a, bool) or isinstance(b, bool):
            if bool(a) != bool(b):
                return False
        elif isinstance(a, (int, float)) and isinstance(b, (int, float)):
            if abs(float(a) - float(b)) > 1e-6:
                return False
        elif a != b:
            return False
    return True


@dataclass
class GenAIPipelineResult:
    """Mirror of ref genai_agents.py:308-326."""

    plan: Optional[EnhancementPlan] = None
    best_plan: Optional[EnhancementPlan] = None
    enhanced_image: Optional[np.ndarray] = None
    enhanced_metrics: Optional[dict] = None
    applied_ops: list[str] = field(default_factory=list)
    iterations: list[IterationRecord] = field(default_factory=list)
    explainability: Optional[ExplainabilityReport] = None
    model_name: str = ""
    llm_call_count: int = 0
    prompts_used: dict[str, str] = field(default_factory=dict)
    agent_traces: list[dict] = field(default_factory=list)
    plan_only: bool = False
    fell_back_to_deterministic: bool = False
    error: str | None = None


def run_genai_pipeline(
    *,
    image: np.ndarray,
    metadata: dict[str, Any],
    issues: list[str],
    metrics: dict[str, float],
    model: str | None = None,
    max_iters: int = 4,
    plan_only: bool = False,
    trace_logger: AgentTraceLogger | None = None,
    device="cuda",
    tv_mode: str | None = None,
) -> GenAIPipelineResult:
    model = model or os.environ.get("OPENAI_MODEL", "gpt-5-mini")
    trace = trace_logger or AgentTraceLogger()
    result = GenAIPipelineResult(model_name=model)
    meta = sanitise_metadata(metadata)

    calls = {"n": 0}

    def _allow_call() -> bool:
        if calls["n"] >= _MAX_LLM_CALLS:
            trace.log_info("cost_guard",
                           f"LLM call limit {_MAX_LLM_CALLS} reached")
            return False
        calls["n"] += 1
        return True

    saved_context = T.get_context()
    T.set_context(device, tv_mode)
    original_id = T.register_image(image, "original")
    try:
        # ---- Phase 1: Planner ------------------------------------------
        trace.log_phase_start("planner", f"model={model}")
        p_prompt = planner_prompt(meta, issues, metrics)
        result.prompts_used["planner"] = p_prompt
        trace.log_prompt("planner", p_prompt)
        r = run_agent(
            model=model, system_prompt=p_prompt,
            user_message="Produce the EnhancementPlan JSON now.",
            tools=["tool_get_metrics"], max_turns=5,
            on_tool_call=lambda t, a: trace.log_tool_call("planner", t, a),
            on_llm_call=_allow_call)
        result.llm_call_count = calls["n"]
        if r.error or not r.final_text:
            trace.log_phase_end("planner", f"failed: {r.error}")
            result.fell_back_to_deterministic = True
            result.error = f"planner failed: {r.error}"
            return result
        try:
            plan = EnhancementPlan.model_validate(
                llm.extract_json(r.final_text))
        except Exception as exc:
            trace.log_phase_end("planner", f"bad plan JSON: {exc}")
            result.fell_back_to_deterministic = True
            result.error = f"planner returned invalid plan: {exc}"
            return result
        plan = T.clamp_plan(plan)
        result.plan = plan
        result.model_name = r.model_used
        trace.log_phase_end("planner", f"ops={plan.normalized_ops()}")

        # stop_reason short-circuit (ref genai_agents.py:402-436)
        if plan.stop_reason:
            trace.log_info("planner", f"stop_reason: {plan.stop_reason}")
            result.best_plan = plan
            result.enhanced_image = np.array(image, copy=True)
            result.enhanced_metrics = dict(metrics)
            result.explainability = _template_explainability(
                issues, metrics, plan, None,
                note=f"No enhancement: {plan.stop_reason}")
            return result

        # ---- Phase 2: plan-only early return ---------------------------
        if plan_only:
            result.plan_only = True
            return result

        # ---- Phase 3: Tuning -------------------------------------------
        trace.log_phase_start("tuning", f"max_iters={max_iters}")
        t_prompt = tuning_prompt(max_iters, plan.model_dump_json(),
                                 original_id, metrics)
        result.prompts_used["tuning"] = t_prompt
        trace.log_prompt("tuning", t_prompt)

        # Per-iteration records keyed through the enhanced_image_id chain
        # (apply → validate → score all reference it), NOT by call order:
        # a model that applies two plans before scoring either would
        # misattribute scores under a positional zip.
        iteration_records: list[dict] = []

        def _observe_result(tool: str, args_json: str,
                            result_json: str) -> None:
            try:
                args = json.loads(args_json)
                out = json.loads(result_json)
                if tool == "tool_apply_enhancement":
                    p = T.clamp_plan(EnhancementPlan.model_validate_json(
                        args.get("plan_json", "{}")))
                    iteration_records.append({
                        "plan": p,
                        "enh_id": out.get("enhanced_image_id"),
                        "validation": None, "score": None,
                        "metrics": out.get("metrics") or {}})
                elif tool == "tool_validate":
                    if "error" in out:
                        return
                    enh = args.get("enhanced_id")
                    for rec in iteration_records:
                        if rec["enh_id"] == enh and rec["validation"] is None:
                            rec["validation"] = out
                            break
                elif tool == "tool_score_plan":
                    s = float(out.get("score", 0.0))
                    v = json.loads(args.get("validation_json", "{}"))
                    # match the scored validation back to the apply whose
                    # enhanced image it validated; positional fallback only
                    # when the model scored a validation it never obtained
                    # from tool_validate
                    rec = next(
                        (r for r in iteration_records
                         if r["score"] is None and r["validation"] is not None
                         and _validations_match(r["validation"], v)), None)
                    if rec is None:
                        rec = next((r for r in iteration_records
                                    if r["score"] is None), None)
                    if rec is not None:
                        rec["score"] = s
                    trace.log_iteration(
                        "tuning",
                        sum(r["score"] is not None
                            for r in iteration_records),
                        f"score={s}")
            except Exception as exc:
                # A malformed tool result must not kill the tuning run, but
                # silently dropping the IterationRecord hides the exact
                # fix-forward data this observer exists to capture — leave a
                # trace entry so the loss shows up in agent_logs.
                trace.log_info(
                    "tuning",
                    f"dropped iteration record for {tool}: "
                    f"{type(exc).__name__}: {exc}")

        best_plan = plan
        r2 = run_agent(
            model=model, system_prompt=t_prompt,
            user_message="Begin tuning.",
            tools=["tool_apply_enhancement", "tool_validate",
                   "tool_score_plan"],
            max_turns=max_iters * 4 + 2,
            on_tool_call=lambda t, a: trace.log_tool_call("tuning", t, a),
            on_tool_result=_observe_result, on_llm_call=_allow_call)
        result.llm_call_count = calls["n"]
        def _scored_best_fallback(reason: str) -> None:
            nonlocal best_plan
            scored = [r for r in iteration_records
                      if r["score"] is not None]
            if scored:
                best_plan = max(scored, key=lambda r: r["score"])["plan"]
                trace.log_info("tuning", f"{reason}; using scored-best "
                               "iteration plan")
            else:
                trace.log_info("tuning", f"{reason}; keeping seed plan")

        if r2.error is None and r2.final_text:
            try:
                best_plan = T.clamp_plan(EnhancementPlan.model_validate(
                    llm.extract_json(r2.final_text)))
            except Exception as exc:
                _scored_best_fallback(f"final plan unparseable ({exc})")
        else:
            _scored_best_fallback(f"tuning failed ({r2.error})")
        result.best_plan = best_plan

        # populate IterationRecords (fix-forward, SURVEY.md §2.3):
        # ``chosen`` marks the scored best, not JSON equality with the
        # final text (the model may restate its winner with reordered keys)
        best_i, best_s = -1, float("-inf")
        for i, rec in enumerate(iteration_records):
            if rec["score"] is not None and rec["score"] > best_s:
                best_i, best_s = i, rec["score"]
        for i, rec in enumerate(iteration_records):
            result.iterations.append(IterationRecord(
                iteration=i + 1, plan=rec["plan"],
                metrics={k: v for k, v in rec["metrics"].items()
                         if isinstance(v, (int, float))},
                score=rec["score"] if rec["score"] is not None else 0.0,
                chosen=(i == best_i) if best_i >= 0 else
                       (rec["plan"].model_dump_json()
                        == best_plan.model_dump_json())))
        trace.log_phase_end("tuning",
                            f"{len(result.iterations)} iterations")

        # ---- Phase 4: execute best plan --------------------------------
        trace.log_phase_start("execute", "running best plan on device")
        out = json.loads(T.tool_apply_enhancement(
            original_id, best_plan.model_dump_json()))
        if "error" in out:
            trace.log_phase_end("execute", f"failed: {out['error']}")
            result.fell_back_to_deterministic = True
            result.error = f"plan execution failed: {out['error']}"
            return result
        result.enhanced_image = T.get_image(out["enhanced_image_id"])
        result.enhanced_metrics = out["metrics"]
        result.applied_ops = out["applied_ops"]
        trace.log_phase_end("execute", f"ops={out['applied_ops']}")

        # ---- Phase 5: validation + explainability ----------------------
        trace.log_phase_start("explainability", "")
        validation = json.loads(T.tool_validate(
            original_id, out["enhanced_image_id"]))
        e_prompt = explainability_prompt()
        result.prompts_used["explainability"] = e_prompt
        summary = {
            "issues": issues, "metadata": meta,
            "plan": best_plan.model_dump(),
            "applied_ops": out["applied_ops"],
            "validation": validation,
        }
        r3 = run_agent(
            model=model, system_prompt=e_prompt,
            user_message=json.dumps(summary), max_turns=3,
            on_llm_call=_allow_call)
        result.llm_call_count = calls["n"]
        expl = None
        if r3.error is None and r3.final_text:
            try:
                expl = ExplainabilityReport.model_validate(
                    llm.extract_json(r3.final_text))
            except Exception as exc:
                trace.log_info("explainability", f"invalid report: {exc}")
        if expl is None:
            expl = _template_explainability(issues, metrics, best_plan,
                                            validation)
        result.explainability = expl
        trace.log_phase_end("explainability", "")
        return result
    finally:
        result.agent_traces = trace.to_list()
        T.clear_image_store()
        T.set_context(*saved_context)


def _template_explainability(
    issues: list[str],
    metrics: dict[str, float],
    plan: EnhancementPlan | None,
    validation: dict | None,
    note: str = "",
) -> ExplainabilityReport:
    """Hand-built fallback report (ref genai_agents.py:563-578)."""
    issue_txt = ", ".join(issues) if issues else "none"
    ops = ", ".join(plan.normalized_ops()) if plan else "none"
    val_txt = "Validation was not run."
    if validation and "ssim" in validation:
        val_txt = (f"SSIM {validation.get('ssim', 0):.3f}, "
                   f"PSNR {validation.get('psnr', 0):.1f} dB, "
                   f"quality improvement "
                   f"{validation.get('quality_improvement', 0):.3f}; "
                   f"{'passed' if validation.get('passes') else 'did not pass'}"
                   f" the three-way validation rule.")
    return ExplainabilityReport(
        detected_issues=(f"Automated detection flagged: {issue_txt}. "
                         f"{note}").strip(),
        corrective_measures=(
            "The pipeline selected conservative, anatomy-preserving "
            "corrections mapped from the detected issues."),
        enhancement_applied=f"Operations executed: {ops}.",
        validation_outcome=val_txt,
        limitations=("Automated enhancement is a visualisation aid only and "
                     "is NOT validated for clinical diagnosis; always "
                     "review the original series."),
        image_summary=(f"Issues detected: {issue_txt}. Noise sigma "
                       f"{metrics.get('sigma', 0):.4f}, contrast std "
                       f"{metrics.get('std', 0):.4f}."),
        actionable_suggestions=[
            "Re-run with GenAI tuning for parameter refinement.",
            "Review the before/after comparison for anatomical fidelity.",
        ],
        next_steps=[
            "Inspect the markdown report and per-metric deltas.",
            "Archive the run record for QA traceability.",
        ],
    )
