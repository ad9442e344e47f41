"""The metric and verdict formulas of the sharded path, written once.

Counterpart of ``mdx/parallel/_spmd_stats.py``.  A spatial layout builds a
:class:`SpatialPrims` from its halo and reduction primitives
(:func:`mdx_torch.parallel.spatial.prims`) and calls
:func:`image_stats_block` / :func:`qa_verdict` here, so the formulas (ref
pipeline/metrics.py:42-217, :274-286) live in one place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from mdx_torch.core.metrics import THRESHOLDS
from mdx_torch.ops.hist import entropy_from_hist
from mdx_torch.ops.wavelet import MAD_TO_SIGMA, _f32


@dataclass(frozen=True)
class SpatialPrims:
    """A layout's primitives on the local block [N, Hs, W], bound to this
    rank's mesh; reductions return global per-image [N] values.

    ``lap_sobel(x)`` halo'd (laplacian, sobel_h, sobel_v);
    ``local_variance(x, size)``; ``pmean(v)``; ``pvar(v)`` → (mean, var);
    ``phist(v, bins, hi)`` → [N, bins]; ``pq(v, qs)`` → [len(qs), N];
    ``pmax_img(v)``; ``psum_img(v)``; ``sigma(x)`` the wavelet-MAD noise;
    ``mad_source(x)`` → (|HH|, global valid count, weights);
    ``pq_multi(sources)`` fused percentiles of several arrays, sources
    ``(v, qs, total | None, weights)`` with None meaning the whole block."""

    lap_sobel: Callable
    local_variance: Callable
    pmean: Callable
    pvar: Callable
    phist: Callable
    pq: Callable
    pmax_img: Callable
    psum_img: Callable
    sigma: Callable
    mad_source: Callable
    pq_multi: Callable


def image_stats_block(x: torch.Tensor, p: SpatialPrims
                      ) -> dict[str, torch.Tensor]:
    """The 16 metrics + niqe + edge_ratio of the global images, from this
    rank's block: {name: [N]}, equal on every space rank."""
    lap, gh, gv = p.lap_sobel(x)
    grad = torch.hypot(gh, gv)

    # one fused order-statistic search for every quantile of the pass
    hh_abs, hh_total, hh_valid = p.mad_source(x)
    (p05, p25, p75, p95), (g90,), (mad_med,) = p.pq_multi([
        (x, [5.0, 25.0, 75.0, 95.0], None, None),
        (grad, [90.0], None, None),
        (hh_abs, [50.0], hh_total, hh_valid),
    ])
    sigma = mad_med * _f32(MAD_TO_SIGMA)

    _, lap_var = p.pvar(lap)
    lap_energy = p.pmean(lap * lap)
    mean, var = p.pvar(x)
    std = torch.sqrt(var)
    pct_low = p.pmean((x <= 0.01).to(x.dtype))
    pct_high = p.pmean((x >= 0.99).to(x.dtype))

    one = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    entropy = entropy_from_hist(p.phist(x, 256, one))

    gmax = p.pmax_img(grad)
    edge_thr = torch.where(gmax > 0, 0.1 * gmax, 0.0)
    edge_density = p.pmean((grad > edge_thr[:, None, None]).to(x.dtype))
    gmean, gvar = p.pvar(grad)
    gstd = torch.sqrt(gvar)

    sigma_safe = torch.clamp_min(sigma, 1e-8)
    snr = mean / sigma_safe
    cnr = (p95 - p05) / sigma_safe

    lv7 = torch.sqrt(p.local_variance(x, 7))
    _, lv7_var = p.pvar(lv7)
    local_contrast_std = torch.sqrt(lv7_var)

    strong = (grad >= g90[:, None, None]).to(x.dtype)
    cnt = p.psum_img(strong)
    ssum = p.psum_img(grad * strong)
    gradient_strength = torch.where(cnt > 0, ssum / torch.clamp_min(cnt, 1.0),
                                    0.0)

    gradient_entropy = entropy_from_hist(p.phist(grad, 128, gmax + 1e-8))

    lv16 = p.local_variance(x, 16)
    lv_mean, lv_var = p.pvar(lv16)
    var_of_var = torch.sqrt(lv_var) / (lv_mean + 1e-8)
    edge_ratio = p.pmean(lap.abs()) / (gmean + 1e-8)
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


def qa_verdict(before: dict, after: dict, ssim: torch.Tensor,
               psnr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(quality_improvement, passes) — the weighted gains and the
    three-way pass rule (ref pipeline/metrics.py:274-286)."""
    eps = 1e-8
    contrast_gain = ((after["std"] - before["std"])
                     / torch.clamp_min(before["std"], eps))
    sharpness_gain = ((after["lap_var"] - before["lap_var"])
                      / torch.clamp_min(before["lap_var"], eps))
    noise_reduction = ((before["sigma"] - after["sigma"])
                       / torch.clamp_min(before["sigma"], eps))
    qi = 0.35 * contrast_gain + 0.35 * sharpness_gain + 0.30 * noise_reduction
    meets_ssim = ssim >= THRESHOLDS["ssim"]
    meets_psnr = psnr >= THRESHOLDS["psnr"]
    meets_improvement = qi >= THRESHOLDS["quality_improvement"]
    niqe_ok = after["niqe"] <= before["niqe"]
    passes = ((meets_ssim & meets_psnr)
              | (meets_ssim & meets_improvement)
              | (meets_psnr & meets_improvement & niqe_ok))
    return qi, passes
