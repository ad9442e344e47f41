"""On-device plan autotuning: a candidate sweep as one batched ``qa_plan``.

Counterpart of ``mdx/core/tuning.py`` (BASELINE config 4, CLI
``--autotune``).  The enhancement chain takes per-image parameter vectors
(``PlanDynamic``), so K candidate plans run at once: the image is repeated
over K lanes, every lane gets its own continuous parameters, and one
``qa_plan`` call returns K objective scores.  ``qa_plan`` groups the lanes
at the card's knee (``core/batching.py``): at 2048^2 the 27 lanes of a full
grid run as 3 groups of 9.

Inputs are numpy, as in the JAX package; outputs are numpy arrays and the
records of ``mdx_torch.core.schemas``.  The default device is the card.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mdx_torch.core.schemas import (
    EnhancementParams,
    EnhancementPlan,
    IterationRecord,
)
from mdx_torch.ops.tv import resolve_tv_mode

DEFAULT_OPS = ("denoise", "clahe", "gamma", "unsharp", "post_denoise")

# Conservative-to-assertive grid over the parameters that move the
# objective most (clip limit, sharpening, gamma); denoise/post-denoise
# strengths ride along per issue profile.
_CLIP_GRID = (0.005, 0.015, 0.03)
_UNSHARP_GRID = (0.3, 0.6, 1.0)
_GAMMA_GRID = (0.9, 1.0, 1.1)


def candidate_grid(issues: list[str]) -> list[dict[str, Any]]:
    """Issue-aware candidate parameter sets (≤27 lanes)."""
    noisy = "noise" in issues
    blur = "blur" in issues
    dark = "clipping_low" in issues and "clipping_high" not in issues
    bright = "clipping_high" in issues and "clipping_low" not in issues

    gammas = _GAMMA_GRID
    if dark:
        gammas = (0.85, 0.95, 1.0)
    elif bright:
        gammas = (1.0, 1.05, 1.15)

    out = []
    for clip in _CLIP_GRID:
        for amount in _UNSHARP_GRID if blur else (_UNSHARP_GRID[0],):
            for gamma in gammas:
                out.append(dict(
                    clahe_clip_limit=clip,
                    gamma=gamma,
                    unsharp_radius=1.0 if blur else 0.8,
                    unsharp_amount=amount,
                    post_denoise_strength=0.4 if noisy else 0.2,
                    bilateral_sigma_color=0.05,
                    bilateral_sigma_space=0.05,
                    tv_denoise_weight=0.0,
                    denoise_soft=True,
                ))
    return out


def _sweep(x: torch.Tensor, cands: list[dict], reps: int, ops, tile_size,
           tv_mode: str | None):
    """``qa_plan`` over ``x`` [N*K, H, W] with candidate ``cands`` repeated
    ``reps`` times as the lanes' parameters; ``tv_mode`` as
    :func:`mdx_torch.ops.tv.resolve_tv_mode` takes it."""
    from mdx_torch.core import qa
    from mdx_torch.core.enhance import PlanDynamic, PlanStatic

    def vec(key, dtype=torch.float32):
        per = torch.tensor([c[key] for c in cands], dtype=dtype)
        return per.repeat(reps).to(x.device)

    static = PlanStatic(ops=tuple(ops), tile_size=tile_size, bilateral_d=0,
                        tv_mode=resolve_tv_mode(tv_mode),
                        plan_order=tuple(ops))
    dyn = PlanDynamic(
        clahe_clip_limit=vec("clahe_clip_limit"),
        gamma=vec("gamma"),
        unsharp_radius=vec("unsharp_radius"),
        unsharp_amount=vec("unsharp_amount"),
        post_denoise_strength=vec("post_denoise_strength"),
        bilateral_sigma_color=vec("bilateral_sigma_color"),
        bilateral_sigma_space=vec("bilateral_sigma_space"),
        tv_denoise_weight=vec("tv_denoise_weight"),
        denoise_soft=vec("denoise_soft", torch.bool),
    )
    return qa.qa_plan(x, static, dyn)


def _plan(c: dict, ops, tile_size: int, rationale: str) -> EnhancementPlan:
    return EnhancementPlan(
        recommended_ops=list(ops),
        params=EnhancementParams(
            clahe_clip_limit=float(c["clahe_clip_limit"]),
            clahe_tile_size=tile_size,
            gamma=float(c["gamma"]),
            unsharp_radius=float(c["unsharp_radius"]),
            unsharp_amount=float(c["unsharp_amount"]),
            post_denoise_strength=float(c["post_denoise_strength"]),
            denoise_mode="soft"),
        rationale=rationale)


def autotune(
    image: np.ndarray,
    issues: list[str],
    *,
    ops: tuple[str, ...] = DEFAULT_OPS,
    tile_size: int = 16,
    device: torch.device | str = "cuda",
    tv_mode: str | None = None,
) -> tuple[EnhancementPlan, np.ndarray, list[IterationRecord]]:
    """Sweep the candidate grid in one batched pass; return the best plan,
    its enhanced image and per-candidate IterationRecords.

    ``image``: [H, W] float32 in [0,1].  ``tv_mode``: "ref" (None) or
    "fast", the TV cap of a sweep whose ``ops`` hold ``tv_denoise`` (the JAX
    package reads it from ``MDX_TV_MODE``; the port takes it as an
    argument)."""
    cands = candidate_grid(issues)
    k = len(cands)
    x = torch.as_tensor(np.asarray(image, np.float32), device=device)
    x = x[None].expand((k,) + tuple(x.shape)).contiguous()
    enhanced, _flags, validation, score = _sweep(x, cands, 1, ops, tile_size,
                                                 tv_mode)
    plans, records, best = plan_records(
        cands, ops, tile_size, score.cpu().numpy(),
        validation["ssim"].cpu().numpy(), validation["psnr"].cpu().numpy(),
        validation["quality_improvement"].cpu().numpy(),
        best_rationale=("best of on-device autotune sweep "
                        f"({k} candidates, one batched pass)"))
    return plans[best], enhanced[best].cpu().numpy(), records


def plan_records(cands, ops, tile_size, scores, ssim, psnr, qi,
                 best_rationale: str):
    """Candidate dicts + per-candidate metrics → (EnhancementPlans,
    IterationRecords, best index)."""
    best = int(np.argmax(scores))
    records = []
    plans = []
    for i, c in enumerate(cands):
        plan = _plan(c, ops, tile_size,
                     "on-device autotune sweep candidate"
                     if i != best else best_rationale)
        plans.append(plan)
        records.append(IterationRecord(
            iteration=i + 1, plan=plan, score=round(float(scores[i]), 4),
            metrics={"ssim": round(float(ssim[i]), 4),
                     "psnr": round(float(psnr[i]), 2),
                     "quality_improvement": round(float(qi[i]), 4)},
            chosen=(i == best)))
    return plans, records, best


def autotune_batch(
    images: np.ndarray,
    issues_per_image: list[list[str]],
    *,
    ops: tuple[str, ...] = DEFAULT_OPS,
    tile_size: int = 16,
    device: torch.device | str = "cuda",
    tv_mode: str | None = None,
) -> tuple[list[EnhancementPlan], np.ndarray, np.ndarray]:
    """Per-frame autotune over a whole [N,H,W] stack in one batched pass.

    Every frame is repeated across the same K-candidate grid (the union
    grid of the batch's issues) as an [N·K] lane stack; a per-frame argmax
    picks each frame's best plan; ``tv_mode`` as in :func:`autotune`.
    Returns (best plan per frame, enhanced [N,H,W], scores [N,K])."""
    union_issues = sorted({i for iss in issues_per_image for i in iss})
    cands = candidate_grid(union_issues)
    k = len(cands)
    n = images.shape[0]
    x = torch.as_tensor(np.asarray(images, np.float32), device=device)
    x = x.repeat_interleave(k, dim=0)                       # [N·K,H,W]
    enhanced, _flags, _validation, score = _sweep(x, cands, n, ops,
                                                  tile_size, tv_mode)
    scores = score.cpu().numpy().reshape(n, k)
    best = np.argmax(scores, axis=1)                        # [N]
    rows = torch.as_tensor(np.arange(n) * k + best, device=enhanced.device)
    picked = enhanced[rows].cpu().numpy()
    plans = [_plan(cands[int(best[i])], ops, tile_size,
                   f"best of per-frame autotune sweep ({k} candidates, "
                   "one batched pass for the whole stack)")
             for i in range(n)]
    return plans, picked, scores
