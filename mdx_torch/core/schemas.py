"""The plan, record and report contracts as plain dataclasses.

Counterpart of ``mdx/pipeline/schemas.py`` (pydantic models there):
``EnhancementParams``, ``EnhancementPlan``, ``IterationRecord``,
``ExplainabilityReport`` and ``GenAIContext`` with the same field names,
types and defaults, the clamp to ``PARAM_BOUNDS``, ``normalized_ops``,
``model_dump`` / ``model_dump_json`` / ``model_copy``, and
``model_validate`` / ``model_validate_json``, without pydantic, which the
card's machine does not have.

``model_dump_json`` writes the text pydantic writes (the report embeds it
and the DB stores it): fields in declared order, ``ensure_ascii`` off,
``null`` for None and for a non-finite float, and floats in pydantic's
shortest round-trip form (``0.00001`` and ``1e20`` where Python would write
``1e-05`` and ``1e+20``).

``model_validate`` follows pydantic v2's lax mode on the values a model
sends (a dict from a JSON object): it raises :class:`ValidationError`
where pydantic raises and coerces where it coerces.  A float field takes a
float, an int or a bool, or a string that parses as a float (whitespace
stripped, ASCII only: ``"0.02"``, ``"inf"``, ``"1_000"``); an int field
takes an int or a bool, a float with no fractional part (``8.0``, not
``8.5``) below 2**63 in magnitude, or a string of digits with an optional
``.0``; a string field takes only a string; a list field a list (or tuple
or set) of valid items; a nested model a dict; ``None`` only an
``Optional`` field; unknown keys are ignored, and a missing field without
a default is an error.  ``model_validate_json`` parses the text first
(malformed JSON raises ``ValidationError`` too).  A CPU test holds both to
pydantic case by case, and the JSON text of what they accept.

:meth:`EnhancementPlan.to_static_dynamic` lowers a plan to the port's
``(PlanStatic, PlanDynamic)`` on a device, clamped, as the JAX package's
lowering does.
"""

from __future__ import annotations

import dataclasses
import decimal
import json
import math
import re
import typing
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


class ValidationError(ValueError):
    """What pydantic's ``ValidationError`` reports: one entry per bad
    field, ``{"type", "loc", "msg", "input"}``, in declared field order."""

    def __init__(self, title: str, errors: list[dict]):
        self.title = title
        self._errors = errors
        n = len(errors)
        lines = [f"{n} validation error{'s' if n != 1 else ''} for {title}"]
        for e in errors:
            lines.append(".".join(map(str, e["loc"])) or title)
            lines.append(f"  {e['msg']} [type={e['type']}, input_value="
                         f"{e['input']!r}, input_type="
                         f"{type(e['input']).__name__}]")
        super().__init__("\n".join(lines))

    def errors(self) -> list[dict]:
        return [dict(e) for e in self._errors]


class _Invalid(Exception):
    def __init__(self, kind: str, msg: str):
        self.kind, self.msg = kind, msg


_MSG = {
    "float_type": "Input should be a valid number",
    "float_parsing": "Input should be a valid number, unable to parse "
                     "string as a number",
    "int_type": "Input should be a valid integer",
    "int_parsing": "Input should be a valid integer, unable to parse string "
                   "as an integer",
    "int_from_float": "Input should be a valid integer, got a number with a "
                      "fractional part",
    "int_parsing_size": "Unable to parse input string as an integer, "
                        "exceeded maximum size",
    "finite_number": "Input should be a finite number",
    "string_type": "Input should be a valid string",
    "list_type": "Input should be a valid list",
    "dict_type": "Input should be a valid dictionary",
    "missing": "Field required",
}

# an int field's string: digits (single underscores between them) and an
# optional fraction of zeros ("8", "+8", "1_6", "8.00"; not "8.", "1e1")
_INT_TEXT = re.compile(r"[+-]?[0-9](?:_?[0-9])*(?:\.0+)?")


def _fail(kind: str):
    raise _Invalid(kind, _MSG[kind])


def _as_float(v, json_mode: bool) -> float:
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, int):
        try:
            return float(v)
        except OverflowError:
            # JSON text parses a huge integer to inf; a Python int refuses
            if json_mode:
                return math.inf if v > 0 else -math.inf
            _fail("float_type")
    if isinstance(v, float):
        return v
    if isinstance(v, str):
        text = v.strip()
        if not text.isascii():
            _fail("float_parsing")
        try:
            return float(text)
        except ValueError:
            _fail("float_parsing")
    _fail("float_type")


def _as_int(v) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if not math.isfinite(v):
            _fail("finite_number")
        if v != int(v):
            _fail("int_from_float")
        if not -2.0 ** 63 <= v < 2.0 ** 63:
            _fail("int_parsing_size")
        return int(v)
    if isinstance(v, str):
        text = v.strip()
        if not (text.isascii() and _INT_TEXT.fullmatch(text)):
            _fail("int_parsing")
        return int(text.split(".")[0])
    _fail("int_type")


def _validate(tp, v, loc: tuple, errors: list, json_mode: bool):
    """``v`` as type ``tp`` (float, int, str, Optional[...], list[...],
    dict[str, ...] or a model class); appends to ``errors`` and returns
    None where it is invalid."""
    origin = typing.get_origin(tp)
    try:
        if origin is typing.Union:
            args = [a for a in typing.get_args(tp) if a is not type(None)]
            return None if v is None else _validate(args[0], v, loc,
                                                    errors, json_mode)
        if origin is list:
            if not isinstance(v, (list, tuple, set, frozenset)):
                _fail("list_type")
            (item,) = typing.get_args(tp)
            return [_validate(item, x, loc + (i,), errors, json_mode)
                    for i, x in enumerate(v)]
        if origin is dict:
            if not isinstance(v, dict):
                _fail("dict_type")
            kt, vt = typing.get_args(tp)
            return {_validate(kt, k, loc + (k, "[key]"), errors, json_mode):
                    _validate(vt, x, loc + (k,), errors, json_mode)
                    for k, x in v.items()}
        if isinstance(tp, type) and issubclass(tp, _Model):
            return tp._from(v, loc, errors, json_mode)
        if tp is float:
            return _as_float(v, json_mode)
        if tp is int:
            return _as_int(v)
        if tp is str:
            if isinstance(v, str):
                return v
            if isinstance(v, (bytes, bytearray)) and not json_mode:
                return bytes(v).decode()
            _fail("string_type")
    except _Invalid as e:
        errors.append({"type": e.kind, "loc": loc, "msg": e.msg, "input": v})
        return None
    raise TypeError(f"no validator for {tp!r}")


class _Model:
    """``model_dump``, ``model_dump_json``, ``model_copy``,
    ``model_validate`` and ``model_validate_json`` of a pydantic model, for
    a dataclass."""

    def model_dump(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def model_dump_json(self, indent: int | None = None) -> str:
        return _to_json(self.model_dump(), indent, 0)

    def model_copy(self, update: dict[str, Any] | None = None):
        """A shallow copy, with the fields of ``update`` replaced."""
        return dataclasses.replace(self, **(update or {}))

    @classmethod
    def _from(cls, v, loc: tuple, errors: list, json_mode: bool):
        if isinstance(v, cls):
            return v
        if not isinstance(v, dict):
            raise _Invalid("model_type", "Input should be a valid dictionary "
                           f"or instance of {cls.__name__}")
        hints = typing.get_type_hints(cls)
        kw, n_errors = {}, len(errors)
        for f in dataclasses.fields(cls):
            if f.name in v:
                kw[f.name] = _validate(hints[f.name], v[f.name],
                                       loc + (f.name,), errors, json_mode)
            elif (f.default is dataclasses.MISSING
                  and f.default_factory is dataclasses.MISSING):
                errors.append({"type": "missing", "loc": loc + (f.name,),
                               "msg": _MSG["missing"], "input": v})
        return None if len(errors) > n_errors else cls(**kw)

    @classmethod
    def model_validate(cls, obj, *, _json_mode: bool = False):
        """``obj`` (a dict, or an instance) as this model; raises
        :class:`ValidationError` where pydantic's lax mode raises."""
        errors: list[dict] = []
        try:
            out = cls._from(obj, (), errors, _json_mode)
        except _Invalid as e:
            errors.append({"type": e.kind, "loc": (), "msg": e.msg,
                           "input": obj})
        if errors:
            raise ValidationError(cls.__name__, errors)
        return out

    @classmethod
    def model_validate_json(cls, text):
        """JSON text (str or bytes) as this model; malformed JSON raises
        :class:`ValidationError`, as in pydantic."""
        if not isinstance(text, (str, bytes, bytearray)):
            raise ValidationError(cls.__name__, [{
                "type": "json_type", "loc": (), "input": text,
                "msg": "JSON input should be string, bytes or bytearray"}])
        try:
            obj = json.loads(text)
        except ValueError as e:
            raise ValidationError(cls.__name__, [{
                "type": "json_invalid", "loc": (), "input": text,
                "msg": f"Invalid JSON: {e}"}]) from None
        return cls.model_validate(obj, _json_mode=True)


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

    def to_static_dynamic(self, tv_mode: str | None = None,
                          device="cuda"):
        """Lower to the port's ``(PlanStatic, PlanDynamic)`` on ``device``
        (mdx/pipeline/schemas.py ``to_static_dynamic``): which ops run, the
        CLAHE tile size, the bilateral diameter (0 unless ``bilateral``
        runs), the op order for the halo re-run and the TV mode (None is
        "ref"; an unknown name raises); every continuous parameter
        clamped."""
        from mdx_torch.core.enhance import plan_from_numpy

        p = self.params.clamped()
        ops = tuple(self.normalized_ops())
        static = {"ops": ops, "tile_size": p.clahe_tile_size,
                  "bilateral_d": p.bilateral_d if "bilateral" in ops else 0,
                  "plan_order": ops, "tv_mode": tv_mode}
        dyn = {k: getattr(p, k) for k in (
            "clahe_clip_limit", "gamma", "unsharp_radius", "unsharp_amount",
            "post_denoise_strength", "bilateral_sigma_color",
            "bilateral_sigma_space", "tv_denoise_weight")}
        dyn["denoise_soft"] = p.denoise_mode == "soft"
        return plan_from_numpy(static, dyn, device)


@dataclass
class IterationRecord(_Model):
    """One candidate of a tuning sweep (ref pipeline/schemas.py:119-127)."""
    iteration: int
    plan: EnhancementPlan
    metrics: dict[str, float] = field(default_factory=dict)
    score: float = 0.0
    chosen: bool = False


@dataclass
class ExplainabilityReport(_Model):
    """Clinician-friendly explanation (ref pipeline/schemas.py:129-168)."""
    detected_issues: str
    corrective_measures: str
    enhancement_applied: str
    validation_outcome: str
    limitations: str
    image_summary: str = ""
    actionable_suggestions: list[str] = field(default_factory=list)
    next_steps: list[str] = field(default_factory=list)


@dataclass
class GenAIContext(_Model):
    """Non-PHI context of the LLM agents (ref pipeline/schemas.py:171-181);
    ``image_id`` is the image store's key, never sent to the model."""
    metrics: dict[str, float] = field(default_factory=dict)
    issues: list[str] = field(default_factory=list)
    thresholds: dict[str, float] = field(default_factory=dict)
    metadata: dict[str, str] = field(default_factory=dict)
    image_id: str = "original"
