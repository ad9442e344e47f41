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
# mean(lv16)).
KERNEL_TOL = {
    "box_stats": (1e-6, 1e-9),
    "unsharp": (0.0, 1e-5),
    "clahe": (0.0, 2e-5),
    "tv_chambolle": (0.0, 1e-5),
    "bilateral": (0.0, 1e-5),
}


def kernel_parity(name: str, got, want) -> tuple[float, bool]:
    """(max|got - want|, within ``KERNEL_TOL[name]``) for one kernel's
    outputs — a tensor or a tuple of tensors — against its plain version's."""
    rtol, atol = KERNEL_TOL[name]
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    err, ok = 0.0, True
    for a, b in zip(got, want, strict=True):
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        if a.shape != b.shape:
            return math.inf, False
        d = np.abs(a - b)
        err = max(err, float(d.max(initial=0.0)))
        ok = ok and bool(np.all(d <= atol + rtol * np.abs(b)))
    return err, ok
