"""Deterministic (non-LLM) agents — ref pipeline/core_agents.py.

Counterpart of ``mdx/pipeline/agents.py``: the result dataclasses,
``issue_op_labels``, ``RecommendationAgent``, ``build_validation_result``
and the detection, enhancement and validation agents, on tensors.  The
numeric work runs as the fused QA steps of :mod:`mdx_torch.core.qa` on the
agent's device (the card unless a caller passes ``device="cpu"``); the
results come to the host with :func:`to_host`, one copy per dtype, and
every reported scalar is ``float(np.asarray(v)...)`` of a float32 value, as
in the JAX package, so the report prints the same digits from the same
float32 values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from mdx_torch.core import qa
from mdx_torch.core.metrics import ISSUE_ORDER, METRIC_KEYS
from mdx_torch.io.report import build_markdown_report


@dataclass
class DetectionResult:
    metrics: Dict[str, float]
    issues: List[str]


@dataclass
class RecommendationResult:
    recommendations: List[str]
    mapping: Dict[str, str]


@dataclass
class EnhancementResult:
    image: np.ndarray
    applied_ops: List[str]
    metrics: Dict[str, float]


@dataclass
class ValidationResult:
    ssim: float
    psnr: float
    quality_improvement: float
    meets_ssim: bool
    meets_psnr: bool
    meets_improvement: bool
    passes: bool
    status: str
    notes: List[str]
    niqe_before: float = 0.0
    niqe_after: float = 0.0
    niqe_improved: bool = True
    contrast_gain: float = 0.0
    sharpness_gain: float = 0.0
    noise_change: float = 0.0


def to_host(tree: dict) -> dict:
    """A nested dict of tensors → the same dict of numpy arrays, with one
    device-to-host copy per (dtype, shape) group of leaves."""
    leaves: list = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            leaves.append((path, t))

    walk(tree, ())
    groups: dict = {}
    for i, (_, t) in enumerate(leaves):
        groups.setdefault((t.dtype, tuple(t.shape)), []).append(i)
    host: list = [None] * len(leaves)
    for idx in groups.values():
        stacked = torch.stack([leaves[i][1] for i in idx]).cpu().numpy()
        for j, i in enumerate(idx):
            host[i] = stacked[j]
    out: dict = {}
    for (path, _), v in zip(leaves, host):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _scalar(v) -> float:
    return float(np.asarray(v).reshape(-1)[0])


def _metrics_dict(stats: dict, i: int = 0) -> Dict[str, float]:
    return {k: _scalar(stats[k][i]) for k in METRIC_KEYS}


def issue_list(issue_masks: dict, i: int = 0) -> List[str]:
    """Host issue masks → the issues of image ``i`` in ``ISSUE_ORDER``."""
    return [k for k in ISSUE_ORDER if bool(issue_masks[k][i])]


# Human-readable op labels for the issue-driven chain, mirroring the
# reference's applied_ops strings (pipeline/enhancement.py:151-227).
def issue_op_labels(issues: List[str], flags: dict, i: int = 0) -> List[str]:
    from mdx_torch.core.enhance import DETERMINISTIC_DEFAULTS as P
    ops: List[str] = []
    if "noise" in issues:
        ops.append("Wavelet denoise (pre)")
    if any(k in issues for k in ("low_contrast", "clipping_low", "clipping_high")):
        ops.append(f"CLAHE (clip={P['clahe_clip_limit']}, tile={P['clahe_tile_size']})")
    if "clipping_low" in issues and "clipping_high" not in issues:
        ops.append(f"Gamma brighten ({P['gamma_brighten']})")
    elif "clipping_high" in issues and "clipping_low" not in issues:
        ops.append(f"Gamma darken ({P['gamma_darken']})")
    if "blur" in issues:
        ops.append(f"Unsharp mask (r={P['unsharp_radius']}, a={P['unsharp_amount']})")
        ops.append(f"Light denoise (post, s={P['post_denoise_strength']})")
    if bool(np.asarray(flags.get("noise_amp", False)).reshape(-1)[i]):
        ops.append("Auto-corrective denoise (noise guard)")
    return ops


def _batch(image: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(image, np.float32), device=device)[None]


class QualityDetectionAgent:
    """Fused 16-metric pass + threshold detection (ref core_agents.py:61-65)."""

    def __init__(self, device="cuda"):
        self.device = device

    def run(self, image: np.ndarray) -> DetectionResult:
        stats, issues = qa.detect(_batch(image, self.device))
        host = to_host({"stats": stats, "issues": issues})
        return DetectionResult(metrics=_metrics_dict(host["stats"]),
                               issues=issue_list(host["issues"]))


class RecommendationAgent:
    """Issue → textual action map (ref core_agents.py:68-89)."""

    ISSUE_TO_ACTION = {
        "noise": "Apply wavelet denoising to reduce noise.",
        "low_contrast": "Apply CLAHE to improve contrast.",
        "blur": "Apply unsharp masking to improve sharpness.",
        "clipping_low": "Apply CLAHE and mild gamma correction to lift shadows.",
        "clipping_high": "Apply CLAHE and mild gamma correction to reduce highlights.",
    }

    def run(self, detection: DetectionResult) -> RecommendationResult:
        if not detection.issues:
            return RecommendationResult(
                recommendations=["No issues detected. Enhancement not required."],
                mapping={})
        mapping = {i: self.ISSUE_TO_ACTION.get(i, "Review manually.")
                   for i in detection.issues}
        return RecommendationResult(recommendations=list(mapping.values()),
                                    mapping=mapping)


class EnhancementAgent:
    """Issue-driven enhancement on the device (ref core_agents.py:92-102)."""

    def __init__(self, device="cuda"):
        self.device = device

    def run(self, image: np.ndarray,
            recommendations: RecommendationResult) -> EnhancementResult:
        from mdx_torch.core.enhance import apply_issue_driven
        from mdx_torch.core.metrics import image_stats

        issues = list(recommendations.mapping.keys())
        x = _batch(image, self.device)
        _stats, issue_masks = qa.detect(x)
        out, flags = apply_issue_driven(x, issue_masks)
        host = to_host({"after": image_stats(out), "flags": flags})
        return EnhancementResult(
            image=out[0].cpu().numpy(),
            applied_ops=issue_op_labels(issues, host["flags"]),
            metrics=_metrics_dict(host["after"]))


def build_validation_result(v: dict, issues: List[str], i: int = 0) -> ValidationResult:
    """Host validation dict → per-image ValidationResult with the
    reference's PASS/WARN/FAIL + notes logic (core_agents.py:105-161)."""
    g = lambda k: _scalar(np.asarray(v[k]).reshape(-1)[i])  # noqa: E731
    b = lambda k: bool(np.asarray(v[k]).reshape(-1)[i])  # noqa: E731

    notes: List[str] = []
    passes = b("passes")
    meets_improvement = b("meets_improvement")
    if not issues:
        notes.append("No issues detected; enhancement not required.")
        passes = b("meets_ssim") and b("meets_psnr")
        meets_improvement = True
    status = "PASS" if passes else "FAIL"
    if status == "FAIL" and g("quality_improvement") > 0:
        status = "WARN"
        notes.append("Some improvement observed, but thresholds not fully met.")
    if b("niqe_improved"):
        notes.append("Naturalness preserved (NIQE-approx stable or improved).")
    else:
        notes.append("Warning: Naturalness may be degraded (possible over-processing).")
    if g("noise_change") > 0.5:
        notes.append(f"Note: Noise increased by {g('noise_change') * 100:.1f}% "
                     f"(sharpening side-effect).")
    return ValidationResult(
        ssim=g("ssim"), psnr=g("psnr"),
        quality_improvement=g("quality_improvement"),
        meets_ssim=b("meets_ssim"), meets_psnr=b("meets_psnr"),
        meets_improvement=meets_improvement, passes=passes, status=status,
        notes=notes, niqe_before=g("niqe_before"), niqe_after=g("niqe_after"),
        niqe_improved=b("niqe_improved"), contrast_gain=g("contrast_gain"),
        sharpness_gain=g("sharpness_gain"), noise_change=g("noise_change"))


class ValidationAgent:
    """Full-reference validation on the device (ref core_agents.py:105-161)."""

    def __init__(self, device="cuda"):
        self.device = device

    def run(self, original: np.ndarray, enhanced: np.ndarray,
            detection: DetectionResult) -> ValidationResult:
        from mdx_torch.core.validate import validate
        v = validate(_batch(original, self.device),
                     _batch(enhanced, self.device))
        return build_validation_result(to_host(v), detection.issues)


class ReportAgent:
    def run(self, context: Dict[str, object]) -> str:
        return build_markdown_report(context)
