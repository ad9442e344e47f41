"""The tuning sweep's records as plain dataclasses.

Counterpart of ``EnhancementParams``, ``EnhancementPlan`` and
``IterationRecord`` in ``mdx/pipeline/schemas.py`` (pydantic models there):
the same field names, types and defaults, the clamp to ``PARAM_BOUNDS``,
``normalized_ops``, and ``model_dump`` / ``model_dump_json``, without
pydantic, which the card's machine does not have.  ``model_dump_json``
writes the text pydantic writes (the report embeds it and the DB stores
it): fields in declared order, ``ensure_ascii`` off, ``null`` for None and
for a non-finite float, and floats in pydantic's shortest round-trip form
(``0.00001`` and ``1e20`` where Python would write ``1e-05`` and
``1e+20``).  A CPU test holds the fields, defaults, clamps and JSON text
equal to the JAX package's on the plans of a real sweep.  The lowering to
a device plan stays with the JAX package's models.
"""

from __future__ import annotations

import dataclasses
import decimal
import json
import math
from dataclasses import dataclass, field
from typing import Any, Optional

# Safety clamps applied before execution (ref pipeline/schemas.py:16-28)
PARAM_BOUNDS: dict[str, tuple[float, float]] = {
    "clahe_clip_limit": (0.002, 0.08),
    "clahe_tile_size": (4, 48),
    "gamma": (0.6, 1.5),
    "unsharp_radius": (0.2, 3.0),
    "unsharp_amount": (0.03, 2.5),
    "post_denoise_strength": (0.0, 0.8),
    "bilateral_d": (0, 13),
    "bilateral_sigma_color": (0.005, 0.20),
    "bilateral_sigma_space": (0.005, 0.20),
    "tv_denoise_weight": (0.0, 0.15),
}

VALID_OPS = ("denoise", "clahe", "gamma", "unsharp", "post_denoise",
             "bilateral", "tv_denoise")


def clamp(value: float, key: str) -> float:
    lo, hi = PARAM_BOUNDS.get(key, (value, value))
    return max(lo, min(hi, value))


def _json_float(v: float) -> str:
    """A float as pydantic's JSON writes it: the shortest round-trip
    digits, in positional form for a decimal exponent from -5 to 16 and in
    exponent form outside it; ``null`` for inf and NaN."""
    if not math.isfinite(v):
        return "null"
    # repr's digits (shortest round trip), without trailing zeros
    sign, digits, exp = decimal.Decimal(repr(v)).normalize().as_tuple()
    digits = "".join(map(str, digits))
    if digits == "0":
        return "-0.0" if sign else "0.0"
    n = len(digits)
    kk = n + exp            # 10^(kk-1) <= |v| < 10^kk
    if 0 <= exp and kk <= 16:
        text = digits + "0" * exp + ".0"
    elif 0 < kk <= 16:
        text = digits[:kk] + "." + digits[kk:]
    elif -5 < kk <= 0:
        text = "0." + "0" * -kk + digits
    elif n == 1:
        text = f"{digits}e{kk - 1}"
    else:
        text = f"{digits[0]}.{digits[1:]}e{kk - 1}"
    return ("-" if sign else "") + text


def _to_json(v: Any, indent: int | None, level: int) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _json_float(v)
    if isinstance(v, str):
        return json.dumps(v, ensure_ascii=False)
    if isinstance(v, dict):
        items = [(json.dumps(str(k), ensure_ascii=False), x)
                 for k, x in v.items()]
        open_, close = "{", "}"
    elif isinstance(v, (list, tuple)):
        items = [(None, x) for x in v]
        open_, close = "[", "]"
    else:
        raise TypeError(f"not JSON-serialisable: {type(v).__name__}")
    if not items:
        return open_ + close
    if indent is None:
        inner, sep, kv = "", ",", ":"
        end = ""
    else:
        inner = "\n" + " " * (indent * (level + 1))
        sep, kv = ",", ": "
        end = "\n" + " " * (indent * level)
    parts = [inner + (f"{k}{kv}" if k is not None else "")
             + _to_json(x, indent, level + 1) for k, x in items]
    return open_ + sep.join(parts) + end + close


class _Model:
    """``model_dump`` / ``model_dump_json`` of a pydantic model, for a
    dataclass."""

    def model_dump(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def model_dump_json(self, indent: int | None = None) -> str:
        return _to_json(self.model_dump(), indent, 0)


@dataclass
class EnhancementParams(_Model):
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

    def clamped(self) -> "EnhancementParams":
        """A copy with every numeric field clamped to PARAM_BOUNDS and the
        denoise mode coerced to soft on invalid input (the reference's
        double-clamp policy: enhancement.py:249-263 + tools.py:56-69)."""
        out = {k: clamp(getattr(self, k), k) for k in PARAM_BOUNDS}
        out["clahe_tile_size"] = int(out["clahe_tile_size"])
        out["bilateral_d"] = int(out["bilateral_d"])
        out["denoise_mode"] = (self.denoise_mode
                               if self.denoise_mode in ("soft", "hard")
                               else "soft")
        return EnhancementParams(**out)


@dataclass
class EnhancementPlan(_Model):
    """An ordered op list with its parameters (ref pipeline/schemas.py:87-116)."""
    recommended_ops: list[str]
    params: EnhancementParams = field(default_factory=EnhancementParams)
    risk_warnings: list[str] = field(default_factory=list)
    rationale: str = ""
    safety: str = ""
    stop_reason: Optional[str] = None

    def normalized_ops(self) -> list[str]:
        return [o.lower().strip() for o in self.recommended_ops
                if o.lower().strip() in VALID_OPS]


@dataclass
class IterationRecord(_Model):
    """One candidate of a tuning sweep (ref pipeline/schemas.py:119-127)."""
    iteration: int
    plan: EnhancementPlan
    metrics: dict[str, float] = field(default_factory=dict)
    score: float = 0.0
    chosen: bool = False
