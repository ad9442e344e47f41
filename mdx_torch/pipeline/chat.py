"""Run-scoped chat assistant (ref pipeline/chat.py): the port's copy of
``mdx/pipeline/chat.py``, on the port's storage and LLM client.

Answers questions about ONE stored run using only its persisted record
(metrics, plan, validation, report text — never pixels, never PHI), with a
10-message history window and a graceful error reply.  Uses the
from-scratch LLM client (:mod:`mdx_torch.genai.client`); without an API key
(and without a test transport) the handler returns the stored-data summary
instead of raising, as JAX's does.  Nothing here touches the card.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any

from mdx_torch.pipeline import storage

logger = logging.getLogger(__name__)

CHAT_SYSTEM_PROMPT = """You are the QA-run assistant of a medical-imaging
quality-assurance pipeline.  You answer questions about one specific
completed run using ONLY the structured run context provided below — do
not invent measurements, do not speculate about diagnoses, and say so when
the answer is not in the context.  Keep replies short and clinician-
friendly.  This tool is not for clinical diagnosis.

<run_context>
{context}
</run_context>"""

_HISTORY_WINDOW = 10
_MAX_TURNS = 3


def _build_run_context(run: dict[str, Any]) -> str:
    """Context from stored run data only (ref pipeline/chat.py:42-87)."""
    ctx: dict[str, Any] = {
        "run_id": run.get("run_id"),
        "status": run.get("status"),
        "input_filename": run.get("input_filename"),
        "issues": run.get("issues", []),
        "applied_ops": run.get("applied_ops", []),
        "metrics_before": run.get("metrics_before", {}),
        "metrics_after": run.get("metrics_after", {}),
        "validation": run.get("validation", {}),
        "metadata": run.get("metadata_summary", {}),
        "genai_model": run.get("genai_model", ""),
    }
    expl = run.get("explainability")
    if expl:
        ctx["explainability"] = expl
    return json.dumps(ctx, default=str)


def _fallback_reply(run: dict[str, Any]) -> str:
    issues = ", ".join(run.get("issues", [])) or "no issues"
    val = run.get("validation", {}) or {}
    extra = ""
    if isinstance(val, dict) and "ssim" in val:
        try:
            extra = (f" Validation: SSIM {float(val['ssim']):.3f}, "
                     f"PSNR {float(val.get('psnr', 0)):.1f} dB.")
        except (TypeError, ValueError):
            pass
    return (f"This run ({run.get('run_id')}) detected {issues} and applied "
            f"{', '.join(run.get('applied_ops', [])) or 'no operations'}."
            f"{extra} (LLM chat is unavailable; this is a stored-data "
            f"summary.)")


def handle_chat(run_id: str, message: str, model: str | None = None) -> str:
    """Answer *message* in the context of run *run_id*."""
    run = storage.get_run(run_id)
    if run is None:
        raise KeyError(f"Run {run_id} not found")

    history = storage.get_chat_history(run_id)
    storage.save_chat_message(run_id, "user", message)

    if not os.environ.get("OPENAI_API_KEY") and not _has_test_transport():
        reply = _fallback_reply(run)
        storage.save_chat_message(run_id, "assistant", reply)
        return reply

    from mdx_torch.genai import client as llm

    model = model or os.environ.get("OPENAI_MODEL", "gpt-5-mini")
    messages = [{"role": "system", "content": CHAT_SYSTEM_PROMPT.format(
        context=_build_run_context(run))}]
    for m in history[-_HISTORY_WINDOW:]:
        role = m.get("role", "user")
        messages.append({"role": role if role in ("user", "assistant")
                         else "user", "content": m.get("content", "")})
    messages.append({"role": "user", "content": message})

    try:
        reply = ""
        for _ in range(_MAX_TURNS):
            msg = llm.chat_completion(model, messages)
            reply = (msg.get("content") or "").strip()
            if reply:
                break
        if not reply:
            reply = _fallback_reply(run)
    except Exception as exc:
        logger.exception("Chat failed for run %s: %s", run_id, exc)
        reply = ("Sorry — I could not process that question right now. "
                 "Please try again, or consult the run report directly.")
    storage.save_chat_message(run_id, "assistant", reply)
    return reply


def _has_test_transport() -> bool:
    from mdx_torch.genai import client as llm

    return llm._transport is not None
