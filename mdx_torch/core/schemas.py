"""The tuning sweep's records as plain dataclasses.

Counterpart of the data fields of ``EnhancementParams``, ``EnhancementPlan``
and ``IterationRecord`` in ``mdx/pipeline/schemas.py`` (pydantic models
there): the same field names, types and defaults, without pydantic, which
the card's machine does not have.  The clamping and the lowering to a
device plan stay with the JAX package's models; a CPU test holds the
fields and defaults equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class EnhancementParams:
    """Tunable enhancement parameters (ref pipeline/schemas.py:36-84)."""
    clahe_clip_limit: float = 0.015
    clahe_tile_size: int = 16
    gamma: float = 1.0
    unsharp_radius: float = 0.8
    unsharp_amount: float = 0.5
    denoise_mode: str = "soft"
    post_denoise_strength: float = 0.3
    bilateral_d: int = 0
    bilateral_sigma_color: float = 0.05
    bilateral_sigma_space: float = 0.05
    tv_denoise_weight: float = 0.0


@dataclass
class EnhancementPlan:
    """An ordered op list with its parameters (ref pipeline/schemas.py:87-116)."""
    recommended_ops: list[str]
    params: EnhancementParams = field(default_factory=EnhancementParams)
    risk_warnings: list[str] = field(default_factory=list)
    rationale: str = ""
    safety: str = ""
    stop_reason: Optional[str] = None


@dataclass
class IterationRecord:
    """One candidate of a tuning sweep (ref pipeline/schemas.py:119-127)."""
    iteration: int
    plan: EnhancementPlan
    metrics: dict[str, float] = field(default_factory=dict)
    score: float = 0.0
    chosen: bool = False
