"""Agent definitions and the tool-calling agent loop.

The port's copy of ``mdx/genai/agents.py`` (ref pipeline/genai_agents.py:
Planner :222-239, Tuning :242-259, Explainability :262-275): each agent is
a system prompt, a tool set, and a turn-capped loop that dispatches JSON
tool calls into :mod:`mdx_torch.genai.tools` and retries once on the
fallback model (ref genai_agents.py:283-300).  The prompts are byte-equal
to the JAX package's on the same inputs (they embed the port's copies of
``PARAM_BOUNDS`` and ``THRESHOLDS``); ``FALLBACK_MODEL`` is read from
``MDX_FALLBACK_MODEL`` at import, as there.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Callable

from mdx_torch.core.metrics import THRESHOLDS
from mdx_torch.core.schemas import PARAM_BOUNDS
from mdx_torch.genai import client as llm
from mdx_torch.genai.tools import TOOL_IMPLS, TOOL_SCHEMAS

logger = logging.getLogger(__name__)

FALLBACK_MODEL = os.environ.get("MDX_FALLBACK_MODEL", "o4-mini")


# ---------------------------------------------------------------------------
# Prompts (behavioural contract mirrors ref genai_agents.py:99-204)
# ---------------------------------------------------------------------------

def planner_prompt(metadata: dict, issues: list[str],
                   metrics: dict[str, float]) -> str:
    return f"""You are the planning agent of a medical-imaging QA pipeline.
Given the detected quality issues and numeric metrics of a DICOM image,
emit ONE EnhancementPlan as a JSON object for a deterministic executor.

Hard rules:
- Preserve anatomy; choose conservative over aggressive settings.
- Avoid over-sharpening halos.
- Only these operations exist, and they always run in this order:
  "denoise" (wavelet), "clahe", "gamma", "unsharp", "post_denoise",
  "bilateral" (optional), "tv_denoise" (optional).
- Numeric parameters are clamped to these bounds:
{json.dumps(PARAM_BOUNDS)}
- Detection thresholds for context: {json.dumps(THRESHOLDS)}

Image context (PHI-sanitised):
<metadata>{json.dumps(metadata)}</metadata>
Detected issues: {issues}
Current metrics: {json.dumps(metrics)}

You may call tool_get_metrics to re-read metrics of the stored image
(id "original").

Output: ONLY an EnhancementPlan JSON object with keys recommended_ops,
params, risk_warnings, rationale, safety, stop_reason.  If the image needs
no work, set stop_reason to a short sentence and recommended_ops to []."""


def tuning_prompt(max_iters: int, seed_plan_json: str, original_id: str,
                  metrics: dict[str, float]) -> str:
    return f"""You are the tuning agent of a medical-imaging QA pipeline.
Iterate on enhancement parameters to maximise the objective score
(0.35*contrast_gain + 0.35*sharpness_gain - 0.30*noise_penalty
 - 5*niqe_degradation - 10*(not passes) - halo/entropy penalties
 + capped snr/histogram-spread/local-contrast/gradient rewards).

The pipeline auto-applies three safeguards (halo re-run at edge_ratio>1.5,
corrective denoise at sigma_after>1.3*sigma_before, 40% blend-back on NIQE
degradation >0.5) — do not fight them.

Per iteration (max {max_iters}):
1. Build an EnhancementPlan JSON.
2. tool_apply_enhancement(image_id, plan_json) → enhanced id + metrics.
3. tool_validate(original_id, enhanced_id) → validation JSON.
4. tool_score_plan(validation_json) → score.
Try 2-3 meaningfully different parameter sets, never repeat one, prefer
plans that pass validation, and back off to smaller clip_limit /
unsharp_amount when in doubt.  Consider bilateral or tv_denoise when noise
is high.

Parameter bounds: {json.dumps(PARAM_BOUNDS)}
Seed plan: {seed_plan_json}
Original image id: {original_id}
Original metrics: {json.dumps(metrics)}

Finish by responding with your best EnhancementPlan as a JSON object."""


def explainability_prompt() -> str:
    return """You write concise, clinician-friendly explanations of medical
image QA results.  Respond with a JSON object with exactly these fields:
detected_issues, corrective_measures, enhancement_applied,
validation_outcome, limitations, image_summary (all 2-3 sentence strings),
actionable_suggestions (list of 2-4 strings), next_steps (list of 2-3
strings).  State clearly in limitations that this is not for clinical
diagnosis.  No raw JSON dumps, no code, no pixel values, no PHI."""


# ---------------------------------------------------------------------------
# The agent loop
# ---------------------------------------------------------------------------


@dataclass
class AgentResult:
    final_text: str = ""
    tool_calls_made: int = 0
    llm_calls_made: int = 0
    model_used: str = ""
    error: str | None = None


def run_agent(
    *,
    model: str,
    system_prompt: str,
    user_message: str,
    tools: list[str] | None = None,
    max_turns: int = 5,
    on_tool_call: Callable[[str, str], None] | None = None,
    on_tool_result: Callable[[str, str, str], None] | None = None,
    on_llm_call: Callable[[], bool] | None = None,
) -> AgentResult:
    """Turn-capped tool-calling loop with single fallback-model retry.

    ``on_llm_call`` is the cost guard hook: return False to deny the call
    (ref genai_agents.py:380-387).  ``on_tool_result`` observes
    ``(tool_name, args_json, result_json)`` after each tool executes —
    the orchestrator uses it to pair tuning iterations through the
    ``enhanced_image_id`` chain instead of by call order.
    """
    result = AgentResult(model_used=model)
    tool_schemas = [TOOL_SCHEMAS[t] for t in (tools or [])]
    messages: list[dict] = [
        {"role": "system", "content": system_prompt},
        {"role": "user", "content": user_message},
    ]

    def _one_pass(use_model: str) -> AgentResult:
        res = AgentResult(model_used=use_model)
        for _turn in range(max_turns):
            if on_llm_call is not None and not on_llm_call():
                res.error = "LLM call budget exhausted"
                return res
            msg = llm.chat_completion(use_model, messages,
                                      tools=tool_schemas or None)
            res.llm_calls_made += 1
            calls = msg.get("tool_calls") or []
            if not calls:
                res.final_text = msg.get("content") or ""
                return res
            messages.append({"role": "assistant",
                             "content": msg.get("content"),
                             "tool_calls": calls})
            for call in calls:
                fn_name = call.get("function", {}).get("name", "")
                raw_args = call.get("function", {}).get("arguments", "{}")
                try:
                    args = json.loads(raw_args)
                except json.JSONDecodeError:
                    args = {}
                impl = TOOL_IMPLS.get(fn_name)
                if impl is None:
                    out = json.dumps({"error": f"unknown tool {fn_name}"})
                else:
                    try:
                        out = impl(**args)
                    except TypeError as exc:
                        # malformed/missing arguments from the model — feed
                        # the error back as the tool result so the agent can
                        # self-correct instead of aborting the whole pass
                        out = json.dumps({"error": f"bad arguments for "
                                                   f"{fn_name}: {exc}"})
                res.tool_calls_made += 1
                if on_tool_call is not None:
                    on_tool_call(fn_name, json.dumps(args))
                if on_tool_result is not None:
                    on_tool_result(fn_name, json.dumps(args), out)
                messages.append({
                    "role": "tool",
                    "tool_call_id": call.get("id", ""),
                    "content": out,
                })
        res.error = f"agent exceeded max_turns={max_turns}"
        return res

    try:
        r = _one_pass(model)
        if r.error is None or "budget" in (r.error or ""):
            return r
        raise llm.LLMError(r.error)
    except Exception as exc:
        logger.warning("Agent failed on %s (%s); retrying on %s",
                       model, exc, FALLBACK_MODEL)
        if model == FALLBACK_MODEL:
            result.error = str(exc)
            return result
        try:
            # reset the conversation for the fallback attempt
            del messages[2:]
            return _one_pass(FALLBACK_MODEL)
        except Exception as exc2:
            result.error = f"{exc}; fallback: {exc2}"
            result.model_used = FALLBACK_MODEL
            return result
