"""How ``correct`` is decided: the program's answers for a sample of the
files the window ran, against the plain reference's, recomputed from the
same DICOM files.  What an answer holds, and how the reference makes its
own, is the entry kind's (``entries/<entry>.py``); the comparison is here.

An answer is, per frame: the issues found, the pass flag, and numbers
(``values``: the metrics before and after, SSIM, PSNR, quality
improvement, the objective), with an enhanced image (``image``) and a
chosen tuning candidate (``plan``) where the entry returns them.  The gap
of a frame's field is ``|p - r| / s``, where ``s`` is the largest of
``|r|``, the median ``|r|`` of that field over the sample and the field's
floor (:data:`FIELD_FLOORS`).  These
numbers judge a run, each beside its limit (:data:`LIMITS`):

* ``frames_off`` — frames with a field whose gap is over that field's
  limit (:data:`FIELD_LIMITS`): every frame of the sample is held.  Fields
  that are ratios over quantities at the level of rounding on some frames
  (a noise estimate of a smooth image, the local variance of a flat
  region), where a change in the last bit of a pixel moves them by a per
  cent, have limits of their own.
* ``gap`` — per field, the median gap over the sample; the widest
  field's: a shift of every frame that is under each field's limit.
* ``pixel`` — the widest gap of an enhanced pixel.
* ``plan`` — how far the reference's score of the candidate the program
  chose lies below the reference's best, over the same scale.
* ``mismatch`` — frames whose issues or pass flag differ, or where one
  side's number is finite and the other's not.

A frame whose branch (an issue, a guard, the pass rule, the chosen plan)
is decided by a quantity within ``MARGIN`` of its threshold in the
reference is left out: rounding may flip it either way.  How many were
left out is printed beside the numbers, with the widest gap over its
field's limit.
"""

from __future__ import annotations

import math

import numpy as np

from reference import qa as RQ

MARGIN = 1e-4
# Limits, each between the widest reading of sound runs and the narrowest
# of the lower-precision control (PERF.md gives both readings).
LIMITS = {"gap": 1e-3, "frames_off": 0, "pixel": 1e-3, "plan": 1e-3,
          "mismatch": 0}
# The widest gap one frame's field may read before the frame counts in
# ``frames_off``: by name, else by prefix (``"after.*"``), else ``"*"``.
# Each is 6 to 500 times the widest gap of that field in sound runs
# (PERF.md gives the readings).
FIELD_LIMITS = {"*": 1e-3, "after.*": 3e-3,
                "before.local_contrast_std": 3e-3,
                "after.snr_proxy": 0.2, "after.cnr_proxy": 0.2,
                "quality_improvement": 0.1, "objective_score": 0.1}
# A share of pixels is measured against the share that raises its issue:
# a pixel on the clipping level moves it by one pixel's share, which next
# to a share near 0 would read as a gap of 100 %.
FIELD_FLOORS = {"pct_low": RQ.THRESHOLDS["clip_pct"],
                "pct_high": RQ.THRESHOLDS["clip_pct"]}


def field_limit(key: str) -> float:
    prefix = key.split(".", 1)[0] + ".*"
    return FIELD_LIMITS.get(key, FIELD_LIMITS.get(prefix, FIELD_LIMITS["*"]))


def metric_values(prefix: str, d: dict) -> dict:
    return {f"{prefix}.{k}": float(d[k]) for k in RQ.METRIC_KEYS}


def issues(masks: dict, i: int) -> set:
    return {k for k in RQ.ISSUE_ORDER if bool(masks[k][i])}


def as_program(ref: dict) -> dict:
    """A reference answer in the program's form (the control)."""
    out = {k: ref[k] for k in ("issues", "passed", "values") if k in ref}
    if "image" in ref:
        out["image"] = ref["image"]
    if "grid" in ref:
        out["plan"] = ref["grid"][ref["plan"]]
    return out


def compare(prog: list[dict], ref: list[dict], rows: list | None = None
            ) -> tuple[dict, int, str]:
    """({name: reading}, frames left out, the widest gap against its
    field's limit and where it is) of ``prog`` against ``ref``.  Each
    compared frame's gaps by field are appended to ``rows`` if given."""
    keep = [i for i, r in enumerate(ref) if r["margin"] >= MARGIN]
    out = {"gap": 0.0, "frames_off": 0, "mismatch": 0}
    if "image" in ref[0]:
        out["pixel"] = 0.0
    if "grid" in ref[0]:
        out["plan"] = 0.0
    scale = {}
    for key in ref[0]["values"]:
        vals = [abs(r["values"][key]) for r in ref
                if math.isfinite(r["values"][key])]
        scale[key] = max(float(np.median(vals)) if vals else 0.0,
                         FIELD_FLOORS.get(key.rsplit(".", 1)[-1], 0.0))
    gaps: dict[str, list[float]] = {key: [] for key in scale}
    widest, where = 0.0, "none"
    for i in keep:
        p, r = prog[i], ref[i]
        finite = [(k, p["values"][k], rv) for k, rv in r["values"].items()]
        if (p["issues"] != r["issues"] or p["passed"] != r["passed"]
                or any(math.isfinite(pv) != math.isfinite(rv)
                       for _, pv, rv in finite)):
            out["mismatch"] += 1
            continue
        frame = {}
        for key, pv, rv in finite:
            g = (abs(pv - rv) / max(abs(rv), scale[key], 1e-12)
                 if math.isfinite(rv) else float(pv != rv))
            frame[key] = g
            gaps[key].append(g)
            if g / field_limit(key) > widest:
                widest = g / field_limit(key)
                where = (f"{key} of answer {i}: {pv!r} against {rv!r}, gap "
                         f"{g!r}, limit {field_limit(key)}")
        out["frames_off"] += any(g > field_limit(k) for k, g in frame.items())
        if rows is not None:
            rows.append(frame)
        if "image" in r:
            d = float(np.abs(p["image"] - r["image"]).max())
            out["pixel"] = max(out["pixel"], d)
        if "grid" in r:
            s = r["scores"]
            j = _plan_index(p["plan"], r["grid"])
            s_scale = max(abs(s.max()), float(np.median(np.abs(s))), 1e-12)
            g = math.inf if j is None else (s.max() - s[j]) / s_scale
            out["plan"] = max(out["plan"], float(g))
    out["gap"] = max((float(np.median(v)) for v in gaps.values() if v),
                     default=0.0)
    return out, len(ref) - len(keep), f"{widest!r} of its limit ({where})"


def _plan_index(plan, grid) -> int | None:
    for j, c in enumerate(grid):
        if all(abs(a - b) < 1e-9 for a, b in zip(plan, c)):
            return j
    return None


def verdict(readings: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: [reading, limit]})."""
    checks = {k: [v, LIMITS[k]] for k, v in readings.items()}
    ok = all(v <= lim for v, lim in checks.values())
    return ok, checks
