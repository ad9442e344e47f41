"""Batched quality metrics (PyTorch) — the fused 16-metric pass.

Counterpart of ``mdx/core/metrics.py`` (reference contract:
``pipeline/metrics.py:42-217``).  The three local-variance reductions come
from the box-statistics CUDA kernel on a CUDA tensor.
"""

from __future__ import annotations

import torch

from mdx_torch import kernels
from mdx_torch.ops import filters as _f
from mdx_torch.ops import hist as _h
from mdx_torch.ops import wavelet as _w
from mdx_torch.ops.quantile import percentiles_exact as _percentiles

# Detection thresholds (ref pipeline/metrics.py:25-34)
THRESHOLDS = {
    "noise_sigma": 0.08,
    "blur_lap_var": 0.001,
    "low_contrast_std": 0.12,
    "clip_pct": 0.01,
    "ssim": 0.70,
    "psnr": 22.0,
    "quality_improvement": 0.10,
}

ISSUE_ORDER = ("noise", "blur", "low_contrast", "clipping_low", "clipping_high")

METRIC_KEYS = (
    "sigma", "lap_var", "std", "pct_low", "pct_high",
    "entropy", "edge_density", "gradient_mag_mean", "gradient_mag_std",
    "snr_proxy", "cnr_proxy", "laplacian_energy", "histogram_spread",
    "local_contrast_std", "gradient_strength", "gradient_entropy",
)


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1)


def _std(a: torch.Tensor) -> torch.Tensor:
    return torch.std(a, dim=-1, correction=0)


def compute_edge_ratio(x: torch.Tensor) -> torch.Tensor:
    """mean(|laplace|)/mean(grad_mag) per image → [N]
    (ref pipeline/metrics.py:213-217; halo-safeguard input)."""
    lap = _flat(_f.laplace(x)).abs().mean(dim=-1)
    grd = _flat(_f.gradient_magnitude(x)).mean(dim=-1)
    return lap / (grd + 1e-8)


def compute_niqe(x: torch.Tensor) -> torch.Tensor:
    """NIQE approximation: CoV of 16×16 local variance + 10·max(0,
    edge_ratio−1) per image → [N] (ref pipeline/metrics.py:187-210)."""
    _, m16, s16 = _lv_box_stats(x)
    cov = s16 / (m16 + 1e-8)
    return cov + torch.clamp_min(compute_edge_ratio(x) - 1.0, 0.0) * 10.0


def _lv_box_stats_plain(x: torch.Tensor):
    """(std(sqrt(lv7)), mean(lv16), std(lv16)) per image — the plain
    PyTorch version of the box-statistics kernel."""
    lv7s = _flat(torch.sqrt(_f.local_variance(x, 7)))
    lv16 = _flat(_f.local_variance(x, 16))
    return _std(lv7s), lv16.mean(dim=-1), _std(lv16)


def _lv_box_stats(x: torch.Tensor):
    """(std(sqrt(lv7)), mean(lv16), std(lv16)): the box-statistics kernel
    on a CUDA tensor, :func:`_lv_box_stats_plain` on a CPU tensor."""
    if kernels.use_kernel(x):
        return kernels.box_stats(x.contiguous())
    return _lv_box_stats_plain(x)


def image_stats(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """All 16 metrics + ``niqe`` + ``edge_ratio`` per image: [N,H,W] → {[N]}.

    Formulas: ref pipeline/metrics.py:42-158 (metrics), :187-210 (NIQE),
    :213-217 (edge ratio)."""
    sigma = _w.estimate_sigma(x)
    lap = _f.laplace(x)
    grad = _f.gradient_magnitude(x)

    lap_var = torch.var(_flat(lap), dim=-1, correction=0)
    lap_energy = _flat(lap * lap).mean(dim=-1)
    mean = _flat(x).mean(dim=-1)
    std = _std(_flat(x))
    pct_low = _flat(x <= 0.01).to(x.dtype).mean(dim=-1)
    pct_high = _flat(x >= 0.99).to(x.dtype).mean(dim=-1)

    p05, p25, p75, p95 = _percentiles(x, [5.0, 25.0, 75.0, 95.0])
    entropy = _h.entropy_from_hist(_h.histogram01(x, 256))

    gflat = _flat(grad)
    gmax = gflat.amax(dim=-1)
    edge_thr = torch.where(gmax > 0, 0.1 * gmax, 0.0)
    edge_density = (gflat > edge_thr[:, None]).to(x.dtype).mean(dim=-1)
    gmean = gflat.mean(dim=-1)
    gstd = _std(gflat)

    sigma_safe = torch.clamp_min(sigma, 1e-8)
    snr = mean / sigma_safe
    cnr = (p95 - p05) / sigma_safe

    local_contrast_std, lv16_mean, lv16_std = _lv_box_stats(x)

    # gradient strength: mean of grad values ≥ per-image p90
    g90 = _percentiles(grad, [90.0])[0]
    strong_mask = gflat >= g90[:, None]
    cnt = strong_mask.to(x.dtype).sum(dim=-1)
    gradient_strength = torch.where(
        cnt > 0, (gflat * strong_mask).sum(dim=-1) / torch.clamp_min(cnt, 1.0),
        0.0)

    gradient_entropy = _h.entropy_from_hist(
        _h.histogram_scaled(grad, 128, gmax + 1e-8))

    # NIQE-approx: CoV of 16×16 local variance + halo penalty
    var_of_var = lv16_std / (lv16_mean + 1e-8)
    edge_ratio = _flat(lap.abs()).mean(dim=-1) / (gmean + 1e-8)
    niqe = var_of_var + torch.clamp_min(edge_ratio - 1.0, 0.0) * 10.0

    return {
        "sigma": sigma,
        "lap_var": lap_var,
        "std": std,
        "pct_low": pct_low,
        "pct_high": pct_high,
        "entropy": entropy,
        "edge_density": edge_density,
        "gradient_mag_mean": gmean,
        "gradient_mag_std": gstd,
        "snr_proxy": snr,
        "cnr_proxy": cnr,
        "laplacian_energy": lap_energy,
        "histogram_spread": p75 - p25,
        "local_contrast_std": local_contrast_std,
        "gradient_strength": gradient_strength,
        "gradient_entropy": gradient_entropy,
        "niqe": niqe,
        "edge_ratio": edge_ratio,
    }


def compute_metrics(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """The 16-metric contract only (no NIQE extras): [N,H,W] → {16 × [N]}."""
    s = image_stats(x)
    return {k: s[k] for k in METRIC_KEYS}


def detect_issues(metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Threshold detection → per-issue bool masks [N]
    (ref pipeline/metrics.py:166-179)."""
    return {
        "noise": metrics["sigma"] > THRESHOLDS["noise_sigma"],
        "blur": metrics["lap_var"] < THRESHOLDS["blur_lap_var"],
        "low_contrast": metrics["std"] < THRESHOLDS["low_contrast_std"],
        "clipping_low": metrics["pct_low"] > THRESHOLDS["clip_pct"],
        "clipping_high": metrics["pct_high"] > THRESHOLDS["clip_pct"],
    }
