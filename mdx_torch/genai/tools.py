"""LLM function tools and the opaque-ID image store (ref pipeline/tools.py).

The port's copy of ``mdx/genai/tools.py``: the same four tools, the same
JSON keys and rounding, the same ``TOOL_SCHEMAS`` and argument names (the
model supplies them), and the same store contract.  The LLM only ever
receives string image handles and numeric metric summaries; pixels never
leave the process.

The store and the run's device are THREAD-LOCAL: the server's worker
threads (:mod:`mdx_torch.serve.executor`) each run a GenAI pipeline and
each registers its image under the key "original".  The tools' signatures
are fixed by the model's tool calls, so the device (and the TV mode of the
plans they lower) is not an argument: :func:`set_context` sets it for the
calling thread, and :func:`mdx_torch.genai.orchestrator.run_genai_pipeline`
calls it (the card unless a caller sets another device).

The stored images are float32 tensors on that device, so a tuning
iteration uploads nothing: ``tool_apply_enhancement`` is one plan-driven
chain with its safeguards (:func:`mdx_torch.core.qa.enhance_only`) and one
metric pass on the enhanced image, ``tool_validate`` one before/after
validation, ``tool_score_plan`` the objective on the validation's numbers;
each result comes to the host in one copy per dtype.  :func:`get_image`
hands a caller the stored image as a numpy array.
"""

from __future__ import annotations

import json
import logging
import threading
import uuid
from typing import Any

import numpy as np
import torch

from mdx_torch.core.schemas import PARAM_BOUNDS, EnhancementPlan

logger = logging.getLogger(__name__)

_TLS = threading.local()


def set_context(device="cuda", tv_mode: str | None = None) -> None:
    """The calling thread's device for stored images and tool work, and
    the TV mode the plans it applies lower to (None is "ref")."""
    _TLS.device = torch.device(device)
    _TLS.tv_mode = tv_mode


def get_context() -> tuple[torch.device, str | None]:
    """(device, tv_mode) of the calling thread (the card and None until
    :func:`set_context` is called)."""
    return (getattr(_TLS, "device", None) or torch.device("cuda"),
            getattr(_TLS, "tv_mode", None))


def _store() -> dict[str, torch.Tensor]:
    store = getattr(_TLS, "images", None)
    if store is None:
        store = {}
        _TLS.images = store
    return store


def register_image(image, name: str | None = None) -> str:
    """Store a copy of ``image`` (numpy or tensor, [H, W]) as float32 on
    the thread's device; returns its key."""
    key = name or f"img_{uuid.uuid4().hex[:8]}"
    device = get_context()[0]
    if torch.is_tensor(image):
        t = image.detach().to(device=device, dtype=torch.float32, copy=True)
    else:
        t = torch.tensor(np.asarray(image), dtype=torch.float32,
                         device=device)
    _store()[key] = t
    return key


def _tensor(image_id: str) -> torch.Tensor:
    store = _store()
    if image_id not in store:
        raise KeyError(f"Image '{image_id}' not found in store.")
    return store[image_id]


def get_image(image_id: str) -> np.ndarray:
    """The stored image as a float32 numpy array."""
    return _tensor(image_id).cpu().numpy()


def clear_image_store() -> None:
    _store().clear()


def clamp_plan(plan: EnhancementPlan) -> EnhancementPlan:
    """Clamp every numeric parameter to PARAM_BOUNDS and normalise the
    denoise mode — never trust the LLM (ref pipeline/tools.py:56-69; the
    same clamp runs again in the lowering,
    ``EnhancementPlan.to_static_dynamic``: clamp twice by design)."""
    p = plan.params.model_copy()
    for field_name, (lo, hi) in PARAM_BOUNDS.items():
        val = getattr(p, field_name, None)
        if isinstance(val, (int, float)):
            setattr(p, field_name, type(val)(max(lo, min(hi, val))))
    if p.denoise_mode not in ("soft", "hard"):
        p.denoise_mode = "soft"
    return plan.model_copy(update={"params": p})


def _to_float_dict(d: dict[str, Any], i: int = 0) -> dict[str, float]:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            continue
        arr = np.asarray(v)
        val = arr.reshape(-1)[i] if arr.ndim else arr[()]
        out[k] = bool(val) if arr.dtype == np.bool_ else round(float(val), 6)
    return out


def _metrics_json(stats: dict) -> dict[str, float]:
    from mdx_torch.core.metrics import METRIC_KEYS

    return {k: round(float(np.asarray(stats[k])[0]), 6) for k in METRIC_KEYS}


# ---------------------------------------------------------------------------
# The four tools.  Each returns a JSON string (the LLM-facing contract).
# ---------------------------------------------------------------------------


def tool_get_metrics(image_id: str) -> str:
    """Compute the 16 quality metrics for a stored image → JSON."""
    try:
        from mdx_torch.core.metrics import METRIC_KEYS, image_stats
        from mdx_torch.pipeline.agents import to_host

        stats = image_stats(_tensor(image_id)[None])
        return json.dumps(_metrics_json(to_host(
            {k: stats[k] for k in METRIC_KEYS})))
    except Exception as exc:
        return json.dumps({"error": str(exc)})


def tool_apply_enhancement(image_id: str, plan_json: str) -> str:
    """Apply a (clamped) plan on the device; store result → JSON with
    enhanced_image_id, applied_ops, metrics."""
    try:
        from mdx_torch.core.metrics import METRIC_KEYS, image_stats
        from mdx_torch.core.qa import enhance_only
        from mdx_torch.pipeline.agents import to_host

        image = _tensor(image_id)
        plan = clamp_plan(EnhancementPlan.model_validate_json(plan_json))
        static, dyn = plan.to_static_dynamic(tv_mode=get_context()[1],
                                             device=image.device)
        enhanced, flags = enhance_only(image[None], static, dyn)
        enhanced_id = register_image(enhanced[0],
                                     f"enhanced_{uuid.uuid4().hex[:6]}")
        stats = image_stats(enhanced)
        host = to_host({"flags": flags,
                        "metrics": {k: stats[k] for k in METRIC_KEYS}})
        applied = list(static.ops)
        for guard in ("halo", "noise_amp", "over_processed"):
            if bool(host["flags"][guard][0]):
                applied.append(f"[safeguard] {guard}")
        return json.dumps({
            "enhanced_image_id": enhanced_id,
            "applied_ops": applied,
            "metrics": _metrics_json(host["metrics"]),
        })
    except Exception as exc:
        logger.exception("tool_apply_enhancement failed")
        return json.dumps({"error": str(exc)})


def tool_validate(original_id: str, enhanced_id: str) -> str:
    """Fused before/after validation → JSON (nested metric dicts stripped,
    ref pipeline/tools.py:140-146)."""
    try:
        from mdx_torch.core.validate import validate
        from mdx_torch.pipeline.agents import to_host

        original = _tensor(original_id)
        enhanced = _tensor(enhanced_id)
        v = validate(original[None], enhanced[None])
        return json.dumps(_to_float_dict(to_host(
            {k: x for k, x in v.items() if not isinstance(x, dict)})))
    except Exception as exc:
        logger.exception("tool_validate failed")
        return json.dumps({"error": str(exc)})


def tool_score_plan(validation_json: str) -> str:
    """Scalar objective score from a validation dict → JSON."""
    try:
        from mdx_torch.core.score import objective_score
        from mdx_torch.pipeline.agents import to_host

        v = json.loads(validation_json)
        if "error" in v:
            return json.dumps({"score": -100.0, "breakdown": {},
                               "error": v["error"]})
        score, breakdown = objective_score(_on_device(
            {k: np.float32(val) if not isinstance(val, bool)
             else np.bool_(val) for k, val in v.items()}))
        host = to_host({"score": score, "breakdown": breakdown})
        return json.dumps({
            "score": round(float(np.asarray(host["score"])), 4),
            "breakdown": {k: round(float(np.asarray(b)), 4)
                          for k, b in host["breakdown"].items()},
        })
    except Exception as exc:
        return json.dumps({"score": -100.0, "error": str(exc)})


def _on_device(values: dict) -> dict[str, torch.Tensor]:
    """numpy scalars → tensors on the thread's device, one upload per
    dtype (the float values and the flags)."""
    device = get_context()[0]
    out: dict[str, torch.Tensor] = {}
    for dtype in (np.float32, np.bool_):
        keys = [k for k, x in values.items() if np.asarray(x).dtype == dtype]
        if keys:
            t = torch.from_numpy(np.stack([np.asarray(values[k])
                                           for k in keys])).to(device)
            out.update({k: t[i] for i, k in enumerate(keys)})
    return out


# OpenAI tool schemas for the agent loop ------------------------------------

TOOL_SCHEMAS = {
    "tool_get_metrics": {
        "type": "function",
        "function": {
            "name": "tool_get_metrics",
            "description": "Compute quality metrics for a stored image.",
            "parameters": {
                "type": "object",
                "properties": {"image_id": {"type": "string"}},
                "required": ["image_id"],
            },
        },
    },
    "tool_apply_enhancement": {
        "type": "function",
        "function": {
            "name": "tool_apply_enhancement",
            "description": "Apply an EnhancementPlan JSON to a stored image;"
                           " returns the enhanced image id and its metrics.",
            "parameters": {
                "type": "object",
                "properties": {
                    "image_id": {"type": "string"},
                    "plan_json": {"type": "string"},
                },
                "required": ["image_id", "plan_json"],
            },
        },
    },
    "tool_validate": {
        "type": "function",
        "function": {
            "name": "tool_validate",
            "description": "Validate an enhanced image against the original"
                           " (SSIM, PSNR, NIQE, quality gains).",
            "parameters": {
                "type": "object",
                "properties": {
                    "original_id": {"type": "string"},
                    "enhanced_id": {"type": "string"},
                },
                "required": ["original_id", "enhanced_id"],
            },
        },
    },
    "tool_score_plan": {
        "type": "function",
        "function": {
            "name": "tool_score_plan",
            "description": "Scalar objective score (higher = better) from a"
                           " validation JSON.",
            "parameters": {
                "type": "object",
                "properties": {"validation_json": {"type": "string"}},
                "required": ["validation_json"],
            },
        },
    },
}

TOOL_IMPLS = {
    "tool_get_metrics": tool_get_metrics,
    "tool_apply_enhancement": tool_apply_enhancement,
    "tool_validate": tool_validate,
    "tool_score_plan": tool_score_plan,
}
