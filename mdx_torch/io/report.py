"""Markdown QA report builder.

The port's copy of ``mdx/io/report.py`` (a CPU test holds the two
string-equal on the same contexts).  It reproduces the reference report
layout section-for-section (ref pipeline/dicom_io.py:154-445): status
header, non-PHI metadata, issues, recommendations, applied ops, 12-row
metric table, validation block, gains table, NIQE block, interpretation
notes, visuals, notes, and the plan sections (plan JSON, iteration table,
model/settings, prompts, explainability, safety statement), which the
port's autotune path fills.
"""

from __future__ import annotations

import json as _json
import math
from typing import Dict

from mdx_torch.core.metrics import THRESHOLDS


def _fmt_psnr(p: float) -> str:
    return "inf" if math.isinf(p) else f"{p:.2f} dB"


def build_markdown_report(context: Dict[str, object]) -> str:
    issues = context.get("issues", [])
    recommendations = context.get("recommendations", [])
    applied_ops = context.get("applied_ops", [])
    mb = context.get("metrics_before", {})
    ma = context.get("metrics_after", {})
    v = context.get("validation")
    visuals = context.get("visuals", {})
    notes = context.get("notes", [])

    status = getattr(v, "status", "PASS")
    emoji = {"PASS": "✅", "WARN": "⚠️", "FAIL": "❌"}.get(status, "⚠️")

    L: list[str] = []
    L.append("# 🧪 Multi-Agent Medical Imaging QA Report")
    L.append("")
    L.append(f"**Input:** `{context.get('input_path', '')}`")
    L.append(f"**Status:** {emoji} {status}")
    L.append("")

    metadata = context.get("metadata", {})
    if metadata:
        L.append("## 🗂️ DICOM Metadata (Non-PHI)")
        L.extend(f"- **{k}:** {val}" for k, val in metadata.items())
        L.append("")

    L.append("## 🔍 Detected Issues")
    L.extend(f"- {i}" for i in issues) if issues else L.append("No issues detected.")
    L.append("")

    L.append("## 💡 Recommendations")
    L.extend(f"- {r}" for r in recommendations)
    L.append("")

    L.append("## 🛠️ Applied Enhancements")
    if applied_ops:
        L.extend(f"- {op}" for op in applied_ops)
    else:
        L.append("No enhancements applied.")
    L.append("")

    L.append("## 📊 Quality Metrics")
    L.append("| Metric | Before | After |")
    L.append("| --- | --- | --- |")
    rows = [
        ("Noise σ", "sigma", "{:.4f}"),
        ("Laplacian Var", "lap_var", "{:.6f}"),
        ("Contrast (std)", "std", "{:.4f}"),
        ("Clip Low (%)", "pct_low", None),
        ("Clip High (%)", "pct_high", None),
        ("Entropy", "entropy", "{:.3f}"),
        ("Edge Density", "edge_density", "{:.4f}"),
        ("Grad. Mag Mean", "gradient_mag_mean", "{:.4f}"),
        ("SNR Proxy", "snr_proxy", "{:.2f}"),
        ("CNR Proxy", "cnr_proxy", "{:.2f}"),
        ("Laplacian Energy", "laplacian_energy", "{:.6f}"),
        ("Histogram Spread", "histogram_spread", "{:.4f}"),
    ]
    for label, key, fmt in rows:
        b, a = float(mb.get(key, 0.0)), float(ma.get(key, 0.0))
        if fmt is None:  # percentage rows
            L.append(f"| {label} | {b * 100:.2f} | {a * 100:.2f} |")
        else:
            L.append(f"| {label} | {fmt.format(b)} | {fmt.format(a)} |")
    L.append("")

    L.append("## ✅ Validation")
    L.append(f"- SSIM: {getattr(v, 'ssim', 0.0):.3f} (>= {THRESHOLDS['ssim']})")
    L.append(f"- PSNR: {_fmt_psnr(getattr(v, 'psnr', 0.0))} (>= {THRESHOLDS['psnr']} dB)")
    L.append(f"- Quality Improvement: {getattr(v, 'quality_improvement', 0.0):.2f} "
             f"(>= {THRESHOLDS['quality_improvement']})")
    L.append("")

    L.append("### 📈 Enhancement Gains")
    L.append("| Component | Change |")
    L.append("| --- | --- |")
    for label, attr in (("Contrast", "contrast_gain"), ("Sharpness", "sharpness_gain"),
                        ("Noise", "noise_change")):
        pct = getattr(v, attr, 0.0) * 100
        L.append(f"| {label} | {'+' if pct >= 0 else ''}{pct:.1f}% |")
    L.append("")

    nb = getattr(v, "niqe_before", 0.0)
    na = getattr(v, "niqe_after", 0.0)
    L.append("### 🎯 No-Reference Quality (NIQE-approx)")
    L.append(f"- Before: {nb:.3f}")
    L.append(f"- After: {na:.3f}")
    L.append(f"- Naturalness: {'✅' if getattr(v, 'niqe_improved', True) else '⚠️'} "
             f"{'Preserved' if na <= nb else 'Degraded'}")
    L.append("")

    L.append("### ℹ️ Metrics Interpretation")
    L.append(
        "> **Note:** Full-reference metrics (SSIM, PSNR) compare enhanced image to "
        "original. For enhancement tasks, these metrics are *expected* to be lower "
        "than typical compression/reconstruction thresholds because enhancement "
        "intentionally modifies pixel values to improve visibility. The thresholds "
        "above are calibrated for *conservative enhancement* that preserves "
        "anatomical fidelity while allowing clinically meaningful improvements in "
        "contrast and sharpness."
    )
    L.append("")
    L.append(
        "> **NIQE-approx** is a no-reference metric estimating image naturalness. "
        "Lower values indicate more natural-looking images. An increase may "
        "suggest over-processing (halos, artifacts, or unnatural textures)."
    )
    L.append("")

    if visuals.get("before_after"):
        L.append("## 🖼️ Before vs After")
        L.append(f"![Before vs After]({visuals['before_after']})")
        L.append("")

    if notes:
        L.append("## 📝 Notes")
        L.extend(f"- {n}" for n in notes)
        L.append("")

    _genai_sections(L, context)
    return "\n".join(L)


def _genai_sections(L: list[str], context: Dict[str, object]) -> None:
    plan = context.get("genai_plan")
    if plan is not None:
        L.append("## 🤖 GenAI Plan (JSON)")
        L.append("")
        L.append("```json")
        if hasattr(plan, "model_dump_json"):
            L.append(plan.model_dump_json(indent=2))
        else:
            L.append(_json.dumps(plan, indent=2, default=str))
        L.append("```")
        L.append("")

    iterations = context.get("genai_iterations", [])
    if iterations:
        L.append("## 🔄 Agentic Iterations")
        L.append("")
        L.append("| Iteration | Score | SSIM | PSNR | Quality Improvement | Chosen |")
        L.append("| --- | --- | --- | --- | --- | --- |")
        for rec in iterations:
            g = (lambda k, d=0: getattr(rec, k, None) if hasattr(rec, k)
                 else rec.get(k, d))
            m = g("metrics", {}) or {}
            L.append(
                f"| {g('iteration', '?')} | {g('score', 0):.4f} "
                f"| {m.get('ssim', 0):.3f} | {m.get('psnr', 0):.2f} dB "
                f"| {m.get('quality_improvement', 0):.3f} "
                f"| {'✅' if g('chosen', False) else '—'} |")
        L.append("")

    model = context.get("genai_model")
    if model:
        L.append("## ⚙️ Model & Settings")
        L.append(f"- **Model:** {model}")
        L.append(f"- **Max iterations:** {context.get('genai_max_iters', 'N/A')}")
        L.append(f"- **LLM calls:** {context.get('genai_llm_calls', 'N/A')}")
        L.append("")

    prompts = context.get("genai_prompts", [])
    if prompts:
        L.append("## 📜 Prompts Used")
        L.extend(f"{i}. {p}" for i, p in enumerate(prompts, 1))
        L.append("")

    expl = context.get("genai_explainability")
    if expl is not None:
        L.append("## 🧠 Explainability (GenAI)")
        L.append("")
        if hasattr(expl, "detected_issues"):
            for label, attr in (
                ("Detected Issues", "detected_issues"),
                ("Corrective Measures", "corrective_measures"),
                ("Enhancement Applied", "enhancement_applied"),
                ("Validation Outcome", "validation_outcome"),
                ("Limitations", "limitations"),
            ):
                L.append(f"**{label}:** {getattr(expl, attr)}")
                L.append("")
            if getattr(expl, "image_summary", ""):
                L.append(f"**Image Summary:** {expl.image_summary}")
                L.append("")
            if getattr(expl, "actionable_suggestions", []):
                L.append("**Actionable Suggestions:**")
                L.extend(f"- {s}" for s in expl.actionable_suggestions)
                L.append("")
            if getattr(expl, "next_steps", []):
                L.append("**Next Steps:**")
                L.extend(f"- {s}" for s in expl.next_steps)
                L.append("")
        else:
            L.append(str(expl))
        L.append("")

    if plan is not None or model:
        L.append("## 🔒 Safety / Privacy")
        L.append("")
        L.append(
            "> **No raw images or PHI were sent to the LLM.** Only numeric "
            "quality metrics (σ, Laplacian variance, contrast std, clipping "
            "percentages) and non-PHI DICOM metadata (Modality, "
            "BodyPartExamined, StudyDescription) were transmitted to the "
            "language model. All image processing was executed locally."
        )
        L.append("")
