"""Batched tuning objective (PyTorch) — ref pipeline/metrics.py:337-408."""

from __future__ import annotations

import torch


def objective_score(v: dict[str, torch.Tensor]
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Scalar score per image (higher = better) + breakdown, all [N]."""
    contrast_gain = v["contrast_gain"]
    sharpness_gain = v["sharpness_gain"]
    noise_pen = torch.clamp_min(v["noise_change"], 0.0)
    niqe_deg = torch.clamp_min(v["niqe_after"] - v["niqe_before"], 0.0)
    passes = v["passes"].to(torch.float32)
    halo_pen = torch.clamp_min(v["edge_ratio"] - 1.0, 0.0) * 5.0
    ent_pen = torch.clamp_min(v["entropy_change"].abs() - 0.5, 0.0) * 2.0
    snr_rwd = torch.clamp(v["snr_change"] * 0.1, 0.0, 0.5)
    hs_rwd = torch.clamp(v["histogram_spread_change"] * 0.5, 0.0, 0.3)
    lc_rwd = torch.clamp(v["local_contrast_change"] * 0.3, 0.0, 0.3)
    gs_rwd = torch.clamp(v["gradient_strength_change"] * 0.2, 0.0, 0.2)
    ge_pen = torch.clamp_min(
        v["gradient_entropy_change"].abs() - 0.3, 0.0) * 1.5

    score = (
        0.35 * contrast_gain + 0.35 * sharpness_gain - 0.30 * noise_pen
        - 5.0 * niqe_deg - 10.0 * (1.0 - passes) - halo_pen - ent_pen
        + snr_rwd + hs_rwd + lc_rwd + gs_rwd - ge_pen
    )
    breakdown = {
        "contrast_gain": contrast_gain,
        "sharpness_gain": sharpness_gain,
        "noise_penalty": noise_pen,
        "niqe_degradation": niqe_deg,
        "halo_penalty": halo_pen,
        "entropy_penalty": ent_pen,
        "snr_reward": snr_rwd,
        "hs_reward": hs_rwd,
        "local_contrast_reward": lc_rwd,
        "gradient_strength_reward": gs_rwd,
        "gradient_entropy_penalty": ge_pen,
        "passes": v["passes"],
    }
    return score, breakdown
