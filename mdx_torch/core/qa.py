"""End-to-end QA steps on a batched ``[N, H, W]`` float32 tensor.

Counterpart of ``mdx/core/qa.py``, with the same return tuples:

* :func:`detect` — 16-metric pass + threshold issue masks.
* :func:`qa_deterministic` — detect → issue-driven enhance → validate →
  objective (the reference's 5-agent numeric flow, core_agents.py:61-161).
* :func:`qa_plan` — plan-driven enhance → validate → objective: one tuning
  iteration.
* :func:`enhance_only` — plan-driven enhancement without validation.

``detect``, ``qa_deterministic`` and ``qa_plan`` run through
:func:`mdx_torch.core.batching.map_subbatches`, as their JAX counterparts
do: a batch larger than the group limit for its image size (the knee
measured on the card) runs as equal row groups, one after another, with
the same results as whole.  ``groups`` pins the candidate group sizes
(tests and sweeps).  ``enhance_only`` runs whole, as in JAX.
"""

from __future__ import annotations

import torch

from mdx_torch.core import enhance as E
from mdx_torch.core import metrics as M
from mdx_torch.core.batching import map_subbatches
from mdx_torch.core.score import objective_score
from mdx_torch.core.validate import validate as _validate


def _detect_body(x: torch.Tensor):
    stats = M.image_stats(x)
    return stats, M.detect_issues(stats)


def detect(x: torch.Tensor, groups=None):
    """[N,H,W] → (stats dict incl. 16 metrics, issue masks)."""
    return map_subbatches(_detect_body, x, groups=groups)


def _qa_deterministic_body(x: torch.Tensor):
    stats = M.image_stats(x)
    issues = M.detect_issues(stats)
    enhanced, flags = E.apply_issue_driven(x, issues)
    any_issue = torch.stack([issues[k] for k in M.ISSUE_ORDER]).any(dim=0)
    # reference semantics: no issues → image passes through unchanged
    enhanced = torch.where(any_issue[:, None, None], enhanced, x)
    validation = _validate(x, enhanced, stats_before=stats)
    score, _ = objective_score(validation)
    return enhanced, stats, issues, flags, validation, score


def qa_deterministic(x: torch.Tensor, groups=None):
    """Full deterministic QA.

    Returns (enhanced, stats_before, issues, flags, validation, score)."""
    return map_subbatches(_qa_deterministic_body, x, groups=groups)


def _qa_plan_body(x: torch.Tensor, dyn: E.PlanDynamic, static: E.PlanStatic):
    # one metric pass on x, shared by the over-processing guard and the
    # validation before-stats
    stats = M.image_stats(x)
    enhanced, flags = E.apply_plan(x, static, dyn, niqe_before=stats["niqe"])
    validation = _validate(x, enhanced, stats_before=stats)
    score, _ = objective_score(validation)
    return enhanced, flags, validation, score


def qa_plan(x: torch.Tensor, static: E.PlanStatic, dyn: E.PlanDynamic,
            groups=None):
    """One plan-driven tuning iteration.

    Returns (enhanced, guard flags, validation, score)."""
    return map_subbatches(_qa_plan_body, x, dyn, static, groups=groups)


def enhance_only(x: torch.Tensor, static: E.PlanStatic, dyn: E.PlanDynamic):
    """Plan-driven enhancement without validation (apply-tool path)."""
    return E.apply_plan(x, static, dyn)
