"""Batched full-reference validation (PyTorch) — ref pipeline/metrics.py:225-329.

Counterpart of ``mdx/core/validate.py``: before/after stats, SSIM, PSNR,
the three weighted gains, the three-way pass rule and all reported fields,
per image.
"""

from __future__ import annotations

import torch

from mdx_torch.core.metrics import THRESHOLDS, image_stats
from mdx_torch.ops.ssim import psnr, ssim


def validate(original: torch.Tensor, enhanced: torch.Tensor,
             stats_before: dict | None = None) -> dict[str, torch.Tensor]:
    """Per-image validation dict of [N] tensors (bools for the pass flags).

    ``stats_before`` may be supplied to reuse an already-computed stats
    pass on the originals."""
    mb = stats_before if stats_before is not None else image_stats(original)
    ma = image_stats(enhanced)
    s = ssim(original, enhanced, data_range=1.0)
    p = psnr(original, enhanced, data_range=1.0)
    return validation_from_stats(mb, ma, s, p)


def validation_from_stats(mb: dict, ma: dict, s: torch.Tensor,
                          p: torch.Tensor) -> dict[str, torch.Tensor]:
    """The validation dict from before/after stats + SSIM/PSNR — pure [N]
    arithmetic (ref pipeline/metrics.py:274-329)."""
    eps = 1e-8
    contrast_gain = (ma["std"] - mb["std"]) / torch.clamp_min(mb["std"], eps)
    sharpness_gain = ((ma["lap_var"] - mb["lap_var"])
                      / torch.clamp_min(mb["lap_var"], eps))
    noise_reduction = ((mb["sigma"] - ma["sigma"])
                       / torch.clamp_min(mb["sigma"], eps))
    qi = 0.35 * contrast_gain + 0.35 * sharpness_gain + 0.30 * noise_reduction

    meets_ssim = s >= THRESHOLDS["ssim"]
    meets_psnr = p >= THRESHOLDS["psnr"]
    meets_improvement = qi >= THRESHOLDS["quality_improvement"]
    niqe_improved = ma["niqe"] <= mb["niqe"]
    passes = (
        (meets_ssim & meets_psnr)
        | (meets_ssim & meets_improvement)
        | (meets_psnr & meets_improvement & niqe_improved)
    )

    return {
        "ssim": s,
        "psnr": p,
        "quality_improvement": qi,
        "meets_ssim": meets_ssim,
        "meets_psnr": meets_psnr,
        "meets_improvement": meets_improvement,
        "passes": passes,
        "niqe_before": mb["niqe"],
        "niqe_after": ma["niqe"],
        "niqe_improved": niqe_improved,
        "contrast_gain": contrast_gain,
        "sharpness_gain": sharpness_gain,
        "noise_change": -noise_reduction,
        "entropy_before": mb["entropy"], "entropy_after": ma["entropy"],
        "entropy_change": ma["entropy"] - mb["entropy"],
        "snr_before": mb["snr_proxy"], "snr_after": ma["snr_proxy"],
        "snr_change": ma["snr_proxy"] - mb["snr_proxy"],
        "cnr_before": mb["cnr_proxy"], "cnr_after": ma["cnr_proxy"],
        "cnr_change": ma["cnr_proxy"] - mb["cnr_proxy"],
        "edge_density_change": ma["edge_density"] - mb["edge_density"],
        "histogram_spread_change": ma["histogram_spread"] - mb["histogram_spread"],
        "laplacian_energy_before": mb["laplacian_energy"],
        "laplacian_energy_after": ma["laplacian_energy"],
        "edge_ratio": ma["edge_ratio"],
        "local_contrast_before": mb["local_contrast_std"],
        "local_contrast_after": ma["local_contrast_std"],
        "local_contrast_change": ma["local_contrast_std"] - mb["local_contrast_std"],
        "gradient_strength_before": mb["gradient_strength"],
        "gradient_strength_after": ma["gradient_strength"],
        "gradient_strength_change": ma["gradient_strength"] - mb["gradient_strength"],
        "gradient_entropy_before": mb["gradient_entropy"],
        "gradient_entropy_after": ma["gradient_entropy"],
        "gradient_entropy_change": ma["gradient_entropy"] - mb["gradient_entropy"],
        "metrics_before": mb,
        "metrics_after": ma,
    }
