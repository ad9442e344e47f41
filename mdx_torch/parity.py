"""Tolerances for comparing two runs of the QA slice, with their reasons.

Used by the CPU tests (the port against the JAX package) and by
``chip_smoke.py`` (the port on the card against the port on the CPU).
Both sides are flattened by :func:`flatten` into ``name → numpy array``
and compared by :func:`breaches`.  ``KERNEL_TOL`` (at the end) holds each
CUDA kernel to its plain version.

* Bool outputs (issue masks, guard flags, op masks, pass flags) are
  discrete decisions and must be equal.
* Enhanced pixels: ``PIXEL_ATOL`` on every pixel.  The two runs differ
  only in the order of float32 sums (means, Gaussian tap normalisation,
  CLAHE excess and CDF) and in the last ulp of exp/pow/hypot/div; each op
  alone keeps that below 3e-6 per pixel (measured card against CPU per op
  at 2x512^2 with ``mdx_torch/tools/op_diff.py``; ``qa_deterministic``,
  which runs no TV, 3.9e-6).
* Enhanced pixels of a plan that ran ``tv_denoise`` (``tv_ran=True``):
  ``PIXEL_ATOL`` for all but ``PIXEL_FRACTION`` of the pixels, and
  ``PIXEL_MAX`` for every pixel.  Chambolle's ascent amplifies a one-ulp
  difference about tenfold every ten iterations (measured on the CPU:
  PyTorch against a numpy float32 loop of the same formula, 1.2e-7 after
  5 iterations, 7.4e-5 after 88), so after the ~85 iterations the bench
  plan's TV takes at 512^2 a few hundred pixels near edges differ by up to
  6e-4 (measured card against CPU: 423 of 524288 pixels above 1e-5, max
  6.05e-4).  No other op gets this allowance.
* Stats and validation fields: ``RTOL`` relative plus ``ATOL``, the same
  float32 reduction-order argument on quantities of order 1e-3 to 1e2.
* ``sigma`` of an enhanced image is small (about 1e-5 after TV) and is a
  median of |HH| wavelet coefficients, which move by about the pixel
  difference: it gets ``SIGMA_ATOL``.  ``snr_proxy``/``cnr_proxy`` divide
  by that sigma, so their bound is the propagated relative error
  ``RTOL + SIGMA_ATOL / sigma``; so are the validation fields built on them,
  and the noise change and quality improvement, which divide the sigma
  difference by the input's sigma.
* ``local_contrast_std`` is the std of sqrt(lv7).  Where a 7x7 window is
  flat, lv7 = E[x^2] - E[x]^2 is a cancellation residue of about one
  float32 ulp of E[x^2] (up to 6e-8) and its square root is up to 2.4e-4,
  so a change in how that difference rounds (XLA's fused jit form against
  separate ops: measured 5.2e-5 on a half-clipped image) moves the std:
  ``LCS_ATOL``.
* Pixel fractions (``edge_density``, ``pct_low``, ``pct_high``) count
  pixels against a threshold; a pixel at the threshold can flip:
  ``FRACTION_PIXELS`` pixels of the H*W (one pixel flipped card against
  CPU at 512^2).
* Entropies count pixels per histogram bin; a pixel on a bin edge can move
  one bin, which changes the entropy by about log2(HW)/HW: ``ENTROPY_ATOL``.
* The score sums the above with weights up to 10: ``SCORE_ATOL``.
"""

from __future__ import annotations

import math
import re

import numpy as np

PIXEL_ATOL = 1e-5
PIXEL_FRACTION = 1e-2
PIXEL_MAX = 2e-3
RTOL = 1e-4
ATOL = 1e-6
SIGMA_ATOL = 1e-5
ENTROPY_ATOL = 1e-3
LCS_ATOL = 2e-4
FRACTION_PIXELS = 2
SCORE_ATOL = 1e-3

_SNR_KEYS = ("snr_proxy", "cnr_proxy")
_ENTROPY_KEYS = ("entropy", "gradient_entropy")


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu()
    return np.asarray(v)


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/tuples of arrays or tensors → {dotted name: array}."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
    else:
        out[prefix.rstrip(".")] = _np(tree)
    return out


QA_PLAN_FIELDS = ("enhanced", "flags", "validation", "score")
QA_DETERMINISTIC_FIELDS = ("enhanced", "stats", "issues", "flags",
                           "validation", "score")


def flatten_result(result, fields) -> dict[str, np.ndarray]:
    """A qa_plan / qa_deterministic return tuple → {dotted name: array}."""
    return flatten(dict(zip(fields, result)))


_VALIDATION_FLOATS = ("ssim", "psnr", "quality_improvement", "niqe_before",
                      "niqe_after", "contrast_gain", "sharpness_gain",
                      "noise_change")
_VALIDATION_BOOLS = ("meets_ssim", "meets_psnr", "meets_improvement",
                     "passes", "niqe_improved")


def flatten_run(ctx: dict) -> dict[str, np.ndarray]:
    """A single-image pipeline run's context (either package's) → the
    names of :func:`flatten_result`: ``stats.*`` (metrics before),
    ``validation.*`` (the ValidationResult's numbers and flags, the
    metrics after and before) and ``enhanced`` [1, H, W]."""
    v = ctx["validation"]
    val = {k: np.float32(getattr(v, k)) for k in _VALIDATION_FLOATS}
    val.update({k: np.bool_(getattr(v, k)) for k in _VALIDATION_BOOLS})
    val["metrics_before"] = ctx["metrics_before"]
    val["metrics_after"] = ctx["metrics_after"]
    tree = {"stats": ctx["metrics_before"], "validation": val,
            "enhanced": np.asarray(ctx["enhanced_image"], np.float32)[None]}
    return {k: np.asarray(a).reshape(-1) if k != "enhanced" else a
            for k, a in flatten(tree).items()}


# issue → (metric, threshold key) of ``core.metrics.detect_issues``
_ISSUE_METRIC = {"noise": ("sigma", "noise_sigma"),
                 "blur": ("lap_var", "blur_lap_var"),
                 "low_contrast": ("std", "low_contrast_std"),
                 "clipping_low": ("pct_low", "clip_pct"),
                 "clipping_high": ("pct_high", "clip_pct")}
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?")


def compare_runs(got: dict, want: dict) -> tuple[list[str], list[str]]:
    """Two single-image runs of one file (contexts of either package, or
    the port on two devices) → (breaches, reported).

    Breaches: the metrics before outside :func:`breaches`; an issue that
    differs although its metric sits further than its tolerance from the
    threshold; and, once the issues agree, any difference in applied ops,
    status, notes (their numbers within 1e-3 relative), the validation
    fields or the enhanced image.  Reported instead of breached: an issue
    whose metric lies within its tolerance of the threshold (one ulp can
    flip it), and, on an input whose quality-improvement tolerance reaches
    the pass threshold (sigma below about 1e-4: the noise term divides by
    a sigma that is a rounding residue on a noiseless image), the pass
    rule's outcome (status, notes, pass flags) and, for an autotune run,
    the sweep's pick and all that follows from it; and, where the enhanced
    images agree within ``PIXEL_ATOL``, a difference in the two
    ill-conditioned metrics of the enhanced image
    (``ILL_CONDITIONED_AFTER``)."""
    from mdx_torch.core.metrics import THRESHOLDS

    g, w = flatten_run(got), flatten_run(want)
    hw = int(np.prod(w["enhanced"].shape[-2:]))
    stats = [n for n in w if n.startswith("stats.")]
    bad = breaches(g, w, stats, hw=hw)
    soft: list[str] = []
    for issue, (metric, th) in _ISSUE_METRIC.items():
        if (issue in got["issues"]) == (issue in want["issues"]):
            continue
        name = f"stats.{metric}"
        margin = abs(float(w[name][0]) - THRESHOLDS[th])
        line = (f"issue {issue}: {issue in got['issues']} vs "
                f"{issue in want['issues']} ({metric} {float(g[name][0])!r}"
                f" vs {float(w[name][0])!r}, threshold {THRESHOLDS[th]})")
        near = margin <= np.max(tolerance(name, w, hw))
        (soft if near else bad).append(line)
    if got["issues"] != want["issues"]:
        return bad, soft
    # quality improvement's tolerance grows as SIGMA_ATOL / sigma; once it
    # reaches the pass threshold, the pass rule and a sweep's pick are not
    # determined by the input
    qi_tol = np.max(tolerance("validation.quality_improvement", w, hw))
    decided = qi_tol < THRESHOLDS["quality_improvement"]
    by_qi = bad if decided else soft
    chain = bad if decided or not got.get("autotune") else soft
    if got["applied_ops"] != want["applied_ops"]:
        chain.append(f"applied_ops: {got['applied_ops']} vs "
                     f"{want['applied_ops']}")
    if got["validation"].status != want["validation"].status:
        by_qi.append(f"status: {got['validation'].status} vs "
                     f"{want['validation'].status}")
    if not _same_text(got["notes"], want["notes"]):
        by_qi.append(f"notes: {got['notes']} vs {want['notes']}")
    qi_names = ("validation.meets_improvement", "validation.passes")
    by_qi += breaches(g, w, qi_names, hw=hw)
    rest = [n for n in w if n not in stats and n not in qi_names]
    off = breaches(g, w, rest, hw=hw)
    images_agree = not breaches(g, w, ["enhanced"], hw=hw)
    for line in off:
        if images_agree and line.split(":", 1)[0] in ILL_CONDITIONED_AFTER:
            soft.append(f"{line} (an ill-conditioned metric of enhanced "
                        f"images that agree within {PIXEL_ATOL})")
        else:
            chain.append(line)
    return bad, soft


# Two metrics of an enhanced image that one ulp of its pixels moves by more
# than RTOL (measured on the CPU on the enhanced 512^2 low-contrast slice:
# a one-ulp nudge of 30 % of the pixels moves them 1.3e-4 to 2.1e-4 and
# 5e-4 to 1.6e-3): ``gradient_strength`` is the mean of the gradients at or
# above their 90th percentile, and a CLAHE-quantised image has thousands of
# gradients tied there (13668 of 262144), so an ulp moves a whole tie group
# in or out; ``niqe`` divides the std of the 16 x 16 local variance by its
# mean, and on a flat enhanced image that mean (~1e-5) is a few hundred
# times the float32 cancellation residue of E[x^2] - E[x]^2 (up to 6e-8, as
# for ``LCS_ATOL``).  The detection metrics (before) keep their bounds.
ILL_CONDITIONED_AFTER = ("validation.metrics_after.gradient_strength",
                         "validation.niqe_after")


def _same_text(a: list[str], b: list[str], rtol: float = 1e-3) -> bool:
    """Lines equal with their numbers masked, the numbers within ``rtol``."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if _NUMBER.sub("#", x) != _NUMBER.sub("#", y):
            return False
        for u, v in zip(_NUMBER.findall(x), _NUMBER.findall(y)):
            if abs(float(u) - float(v)) > rtol * max(abs(float(v)), 1.0):
                return False
    return True


def flatten_batch(frames: list[dict]) -> dict[str, np.ndarray]:
    """A batch run's per-frame records (either package's, in the order
    given) → ``stats.*``, ``issues.*``, ``validation.*`` and ``score``
    as [N] arrays."""
    from mdx_torch.core.metrics import ISSUE_ORDER

    metrics = {k: np.array([f["metrics"][k] for f in frames], np.float32)
               for k in frames[0]["metrics"]}
    tree = {
        "stats": metrics,
        "issues": {k: np.array([k in f["issues"] for f in frames])
                   for k in ISSUE_ORDER},
        "validation": {
            **{k: np.array([f[k] for f in frames], np.float32)
               for k in ("ssim", "psnr", "quality_improvement")},
            "passes": np.array([f["passed"] for f in frames]),
            "metrics_before": metrics},
        "score": np.array([f["objective_score"] for f in frames],
                          np.float32)}
    return flatten(tree)


def _sigma_for(name: str, flat: dict[str, np.ndarray]) -> np.ndarray | None:
    """The sigma a snr/cnr-derived field divides by, or None."""
    leaf = name.rsplit(".", 1)[-1]
    base = name.rsplit(".", 1)[0] + "." if "." in name else ""
    if leaf in _SNR_KEYS:
        return flat.get(base + "sigma")
    for key in ("snr", "cnr"):
        if leaf in (f"{key}_after", f"{key}_change"):
            return flat.get(base + "metrics_after.sigma")
        if leaf == f"{key}_before":
            return flat.get(base + "metrics_before.sigma")
    return None


def tolerance(name: str, want: dict[str, np.ndarray],
              hw: int | None = None) -> np.ndarray | float:
    """Absolute tolerance for one flattened field (see the module doc);
    ``hw`` is the pixel count of one image, needed by the pixel fractions."""
    leaf = name.rsplit(".", 1)[-1]
    w = np.abs(want[name].astype(np.float64))
    if leaf == "score":
        return SCORE_ATOL
    if leaf == "sigma":
        return SIGMA_ATOL
    if any(leaf.startswith(k) for k in _ENTROPY_KEYS):
        return ENTROPY_ATOL
    if leaf.startswith("local_contrast"):
        return LCS_ATOL
    if leaf.startswith(("edge_density", "pct_low", "pct_high")):
        if not hw:
            raise ValueError(f"{name}: a pixel fraction needs the image's "
                             f"pixel count hw")
        return FRACTION_PIXELS / hw
    if leaf in ("noise_change", "quality_improvement"):
        # (sigma_before - sigma_after) / sigma_before
        sigma = want.get(name.rsplit(".", 1)[0] + ".metrics_before.sigma")
        return ATOL + RTOL * w + SIGMA_ATOL / np.maximum(sigma, 1e-8)
    sigma = _sigma_for(name, want)
    if sigma is not None:
        return ATOL + w * (RTOL + SIGMA_ATOL / np.maximum(sigma, 1e-8))
    return ATOL + RTOL * w


def breaches(got: dict[str, np.ndarray], want: dict[str, np.ndarray],
             names=None, *, tv_ran: bool = False,
             hw: int | None = None) -> list[str]:
    """One line per field of ``want`` that ``got`` misses or breaks.

    ``tv_ran`` grants the enhanced pixels TV's allowance (module doc); set it
    only for a plan that ran ``tv_denoise``.  ``hw`` defaults to the pixel
    count of ``want["enhanced"]``'s images."""
    if hw is None and "enhanced" in want:
        hw = int(np.prod(want["enhanced"].shape[-2:]))
    out = []
    for name in names or sorted(want):
        if name not in got:
            out.append(f"{name}: missing")
            continue
        a, b = got[name], want[name]
        if a.shape != b.shape:
            out.append(f"{name}: shape {a.shape} vs {b.shape}")
        elif b.dtype == np.bool_ or a.dtype == np.bool_:
            if not np.array_equal(a, b):
                out.append(f"{name}: {a.tolist()} vs {b.tolist()}")
        else:
            a, b = a.astype(np.float64), b.astype(np.float64)
            # equal values (psnr of an unchanged image is inf on both sides)
            err = np.where(a == b, 0.0, np.abs(a - b))
            if name.rsplit(".", 1)[-1] == "enhanced":
                frac = float(np.mean(err > PIXEL_ATOL))
                ok = (frac <= PIXEL_FRACTION and float(err.max()) <= PIXEL_MAX
                      if tv_ran else frac == 0.0)
                if not ok:
                    out.append(f"{name}: max|d| {float(err.max()):.3g}, "
                               f"{frac:.3g} of pixels above {PIXEL_ATOL}")
                continue
            tol = tolerance(name, want, hw)
            if not np.all(err <= tol):
                out.append(f"{name}: max|d| {float(err.max()):.3g} "
                           f"over tolerance")
    return out


def max_abs(got: dict[str, np.ndarray], want: dict[str, np.ndarray],
            name: str) -> float:
    a = got[name].astype(np.float64)
    b = want[name].astype(np.float64)
    return float(np.max(np.where(a == b, 0.0, np.abs(a - b))))


# A CUDA kernel against its plain PyTorch version, on the same card and the
# same inputs: {name: (rtol, atol)}, every element within
# atol + rtol * |plain|.  Unsharp, CLAHE, TV and bilateral take the ``tol``
# of PARITY_SWEEP_r05.json for the TPU kernel each replaces (1e-5, 2e-5,
# 1e-5, 1e-5; measured on an H100 at [4,512,512] for the first three: 0.0,
# 4.7e-6, 0.0).  The sweep's box
# stats tol (1e-4) is about 30 % of mean(lv16) on bench data (3.4e-3) and
# would pass a wrong window or pad; the kernel builds the local-variance
# maps in the plain version's float32 order and differs only in how it sums
# them, so it gets a relative bound (measured 4.7e-10 absolute, 2 ulp of
# mean(lv16)).  The wavelet denoise takes 2e-6, the bar the JAX package
# holds its own fused kernel to against its XLA branch
# (tests/test_pallas.py TestWaveletDenoisePallas); the CUDA kernel runs the
# plain version's taps and product-then-sum order under --fmad=false and
# both sum each band's squares in float64, so the thresholds and every
# coefficient agree and it is in fact exact (measured 0.0 on an H100 at
# 512^2 and 2048^2).  The sharded path's two kernels take the bars of their
# dense siblings: the CLAHE remap against a halo-extended LUT grid (kernel
# 11) the CLAHE kernel's 2e-5, and one sharded TV iteration (kernel 12, its
# p, out and float64 energy sums) TV's 1e-5.  Both compute the plain
# version's expressions in its order under --fmad=false (the remap's gathers
# and blend; the step's divergence, differences, norm and update), so their
# pixels are expected to be exact; kernel 12's energy sums differ only in
# float64 summation order, about 1e-12 of sums below 1e5.
KERNEL_TOL = {
    "box_stats": (1e-6, 1e-9),
    "unsharp": (0.0, 1e-5),
    "clahe": (0.0, 2e-5),
    "tv_chambolle": (0.0, 1e-5),
    "bilateral": (0.0, 1e-5),
    "wavelet_denoise": (0.0, 2e-6),
    "clahe_remap_ext": (0.0, 2e-5),
    "tv_shard_step": (0.0, 1e-5),
}

# The sharded CLAHE (mdx_torch.parallel.clahe_sp) against the dense one on
# the same input.  The LUTs are equal (the same LUT stage, and a block's
# tiles are the image's tiles); the remaps differ only in the first and
# last half-tile of each axis, where the dense remap clamps the weight to
# put all of it on the border LUT and the sharded one blends two equal
# halo LUT values, (1 - w)·v + w·v, which can round one ulp away from v.
# The JAX package holds its own sharded CLAHE to its dense one at 2e-6
# (tests/test_spatial_clahe.py:56).
SHARDED_CLAHE_ATOL = 2e-6


def kernel_parity(name: str, got, want) -> tuple[float, bool]:
    """(max|got - want|, within ``KERNEL_TOL[name]``) for one kernel's
    outputs — a tensor or a tuple of tensors — against its plain version's."""
    rtol, atol = KERNEL_TOL[name]
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    err, ok = 0.0, True
    for a, b in zip(got, want, strict=True):
        if hasattr(a, "detach") and hasattr(b, "detach"):
            # tensors: the same float64 arithmetic where they lie (on the
            # card, no copy of the outputs to the host)
            if a.shape != b.shape:
                return math.inf, False
            a, b = a.detach().double(), b.detach().to(a.device).double()
            d = (a - b).abs()
            if d.numel():
                err = max(err, float(d.max()))
            ok = ok and bool((d <= atol + rtol * b.abs()).all())
            continue
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        if a.shape != b.shape:
            return math.inf, False
        d = np.abs(a - b)
        err = max(err, float(d.max(initial=0.0)))
        ok = ok and bool(np.all(d <= atol + rtol * np.abs(b)))
    return err, ok
