"""Single-image pipeline runner: one DICOM file → load → QA → PNG →
report → DB.

Counterpart of ``mdx/pipeline/runner.py`` (ref pipeline/runner.py:33-117)
with the same context keys, report, artifacts and DB row.  Detection,
enhancement and validation run as one fused QA step on the card
(:func:`mdx_torch.core.qa.qa_deterministic`), or, with ``autotune=True``,
as detect → the on-device candidate sweep → validate.  The results come to
the host in one copy per dtype.

The run happens on ``device`` (the card by default).  Without a card a
``device="cuda"`` run raises before it reads the file; nothing falls back
to the CPU.  The JAX package's GenAI mode (an LLM loop that calls a
remote model) is not part of the port, and nor is its compile cache, which
is JAX's alone.  As in JAX, ``autotune=True`` takes the sweep whatever
``genai`` says; ``genai=True`` alone ends as JAX's run does when its model
call fails (no key, no network): a warning, the deterministic path, and
``genai_error`` and ``genai_fell_back`` in the context.  Each phase's wall
time (decode, normalize, device_qa, png, report, db; ``device_qa`` ends
with the results on the host) is logged in the run's trace and returned
as ``context["phase_ms"]``.
"""

from __future__ import annotations

import logging
import os
from typing import Any

import numpy as np
import torch

from mdx_torch.core import qa
from mdx_torch.core.metrics import METRIC_KEYS
from mdx_torch.io import (build_markdown_report, load_dicom, normalize_image,
                          save_visuals)
from mdx_torch.pipeline import storage
from mdx_torch.pipeline.agents import (
    DetectionResult,
    RecommendationAgent,
    _metrics_dict,
    build_validation_result,
    issue_list,
    issue_op_labels,
    to_host,
)
from mdx_torch.pipeline.profiler import maybe_profile, phase_timer
from mdx_torch.pipeline.trace import AgentTraceLogger

logger = logging.getLogger(__name__)

# why a genai=True run falls back: JAX's run falls back when its model
# call fails; the port has no planner to call
GENAI_ERROR = "GenAI planning is not part of mdx_torch"


def resolve_device(device) -> torch.device:
    """The run's device; a CUDA device without a card raises (no CPU
    fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"mdx_torch runs on device {str(device)!r}, but "
            "torch.cuda.is_available() is False (no CUDA card, or a "
            "CPU-only PyTorch); pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"mdx_torch runs on cuda or cpu, got {device!r}")
    return dev


def run_pipeline(
    input_path: str,
    output_dir: str = "outputs",
    *,
    genai: bool = False,
    model: str | None = None,
    max_iters: int = 4,
    plan_only: bool = False,
    save_artifacts: bool = True,
    no_show: bool = True,
    run_id: str | None = None,
    autotune: bool = False,
    device="cuda",
    tv_mode: str | None = None,
) -> dict[str, Any]:
    """Run the QA pipeline on one DICOM file.

    The JAX package's signature plus ``device`` and ``tv_mode`` (the
    autotune sweep's TV mode, which the JAX package reads from
    ``MDX_TV_MODE``; None is "ref").  ``model``, ``max_iters``,
    ``plan_only`` and ``no_show`` are accepted for that signature and
    unused: the port has no GenAI planner and never opens a window."""
    dev = resolve_device(device)
    storage.init_db()
    run_id = run_id or storage.generate_run_id()
    base_name = os.path.splitext(os.path.basename(input_path))[0]
    trace = AgentTraceLogger()
    times: dict[str, float] = {}

    with phase_timer(trace, "decode", times=times):
        image_raw, metadata = load_dicom(input_path)
    with phase_timer(trace, "normalize", times=times):
        image = normalize_image(image_raw)

    fell_back = genai and not autotune
    if fell_back:
        logger.warning("GenAI pipeline failed (%s) — deterministic fallback.",
                       GENAI_ERROR)
    run = _run_autotune_path if autotune else _run_deterministic_path
    context = run(image=image, dev=dev, trace=trace, times=times,
                  tv_mode=tv_mode)
    context.update(run_id=run_id, input_path=input_path, metadata=metadata,
                   original_image=image)
    _finish(context, trace, times, output_dir=output_dir,
            base_name=base_name, save_artifacts=save_artifacts)
    if fell_back:
        context.update(genai_error=GENAI_ERROR, genai_fell_back=True)
    return context


def _sync(dev: torch.device):
    return torch.cuda.synchronize if dev.type == "cuda" else None


def _run_deterministic_path(*, image, dev, trace, times, tv_mode
                            ) -> dict[str, Any]:
    del tv_mode  # the issue-driven chain runs no TV
    x = torch.from_numpy(image)[None].to(dev)
    with maybe_profile("qa_deterministic"), \
            phase_timer(trace, "device_qa", _sync(dev), times):
        enhanced_dev, stats, issue_masks, flags, validation_dev, _score = (
            qa.qa_deterministic(x))
        host = to_host({"stats": stats, "issues": issue_masks,
                        "flags": flags, "validation": validation_dev})
        issues = issue_list(host["issues"])
        enhanced_image = enhanced_dev[0].cpu().numpy() if issues else image

    metrics_before = _metrics_dict(host["stats"])
    recommendations = RecommendationAgent().run(
        DetectionResult(issues=issues, metrics=metrics_before))
    if issues:
        applied_ops = issue_op_labels(issues, host["flags"])
        metrics_after = {k: float(np.asarray(
            host["validation"]["metrics_after"][k])[0]) for k in METRIC_KEYS}
    else:
        applied_ops = []
        metrics_after = metrics_before
    validation = build_validation_result(host["validation"], issues)
    return {
        "issues": issues,
        "recommendations": recommendations.recommendations,
        "applied_ops": applied_ops,
        "metrics_before": metrics_before,
        "metrics_after": metrics_after,
        "validation": validation,
        "notes": validation.notes,
        "enhanced_image": enhanced_image,
        "plan_json": "",
    }


def _run_autotune_path(*, image, dev, trace, times, tv_mode
                       ) -> dict[str, Any]:
    """LLM-free tuning: detect → the candidate sweep → validate."""
    from mdx_torch.core.tuning import autotune
    from mdx_torch.core.validate import validate

    x = torch.from_numpy(image)[None].to(dev)
    with phase_timer(trace, "device_qa", _sync(dev), times):
        stats, issue_masks = qa.detect(x)
        host = to_host({"stats": stats, "issues": issue_masks})
        issues = issue_list(host["issues"])
        best_plan, enhanced_image, records = autotune(
            image, issues, device=dev, tv_mode=tv_mode)
        vhost = to_host(validate(x, torch.from_numpy(enhanced_image)[None]
                                 .to(dev)))
    trace.log_info("autotune",
                   f"{len(records)} candidates in one batched pass; "
                   f"best score {max(r.score for r in records):.4f}")

    validation = build_validation_result(vhost, issues)
    return {
        "issues": issues,
        "recommendations": [best_plan.rationale],
        "applied_ops": best_plan.normalized_ops(),
        "metrics_before": _metrics_dict(host["stats"]),
        "metrics_after": {k: float(np.asarray(vhost["metrics_after"][k])[0])
                          for k in METRIC_KEYS},
        "validation": validation,
        "notes": validation.notes,
        "enhanced_image": enhanced_image,
        "genai_plan": best_plan,
        "genai_iterations": records,
        "genai_model": "on-device autotune",
        "autotune": True,
        "plan_json": best_plan.model_dump_json(indent=2),
    }


def _finish(context: dict, trace, times, *, output_dir, base_name,
            save_artifacts) -> None:
    """PNG, report and DB row of a run (the context gains ``visuals``,
    ``report_md``, ``report_path`` and ``phase_ms``)."""
    visuals: dict[str, str] = {}
    if save_artifacts:
        with phase_timer(trace, "png", times=times):
            os.makedirs(output_dir, exist_ok=True)
            visuals = save_visuals(context["original_image"],
                                   context["enhanced_image"], output_dir,
                                   base_name)
    context["visuals"] = visuals
    with phase_timer(trace, "report", times=times):
        context["report_md"] = build_markdown_report(context)
        if save_artifacts:
            report_path = os.path.join(output_dir, f"{base_name}_report.md")
            with open(report_path, "w", encoding="utf-8") as f:
                f.write(context["report_md"])
            context["report_path"] = report_path
    plan_json = context.pop("plan_json")
    if save_artifacts:
        with phase_timer(None, "db", times=times):
            _persist_run(
                run_id=context["run_id"],
                input_filename=os.path.basename(context["input_path"]),
                metadata=context["metadata"], issues=context["issues"],
                metrics_before=context["metrics_before"],
                metrics_after=context["metrics_after"], plan_json=plan_json,
                validation=context["validation"],
                applied_ops=context["applied_ops"], explainability={},
                report_path=context["report_path"],
                before_after_path=visuals.get("before_after", ""),
                agent_logs=trace.to_list(),
                status=context["validation"].status,
                genai_model=context.get("genai_model", ""))
    context["phase_ms"] = dict(times)


def _persist_run(*, run_id, input_filename, metadata, issues, metrics_before,
                 metrics_after, plan_json, validation, applied_ops,
                 explainability, report_path, before_after_path, agent_logs,
                 status="completed", genai_model="", genai_llm_calls=0) -> None:
    val_dict: dict[str, Any] = {}
    if hasattr(validation, "__dict__"):
        val_dict = {k: v for k, v in validation.__dict__.items()
                    if not k.startswith("_")}
    elif isinstance(validation, dict):
        val_dict = validation
    try:
        storage.save_run(
            run_id=run_id, input_filename=input_filename,
            metadata_summary=metadata, issues=issues,
            metrics_before=metrics_before, metrics_after=metrics_after,
            plan_json=plan_json, validation=val_dict, applied_ops=applied_ops,
            explainability=(explainability if isinstance(explainability, dict)
                            else {"text": str(explainability)}),
            report_path=report_path, before_after_path=before_after_path,
            agent_logs=agent_logs, status=status, genai_model=genai_model,
            genai_llm_calls=genai_llm_calls)
        logger.info("Run %s persisted to DB.", run_id)
    except Exception as exc:
        logger.error("Failed to persist run %s: %s", run_id, exc)
