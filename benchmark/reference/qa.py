"""The QA pass in plain PyTorch: metrics, issues, the enhancement chains,
validation, the objective and the tuning grid.

Frozen copy at commit 3b08b1a of ``mdx_torch/core/metrics.py``
(``image_stats``, ``detect_issues``; the box statistics in float64, as the
program's kernel computes them, where ``_lv_box_stats_plain`` is float32),
``enhance.py`` (``apply_issue_driven``, ``apply_plan`` and their guards),
``validate.py``, ``score.py`` and ``tuning.py`` (``candidate_grid``), with
no kernel dispatch and no row groups.  Besides the program's outputs each
step returns ``margin``: per image, the smallest relative distance of a
quantity that decides a branch (an issue, a guard, the pass rule) from its
threshold, so that a comparison can tell a branch that rounding may flip
from one it may not.  Imports nothing of the program.
"""

from __future__ import annotations

import torch

from reference import ops as O

THRESHOLDS = {"noise_sigma": 0.08, "blur_lap_var": 0.001,
              "low_contrast_std": 0.12, "clip_pct": 0.01, "ssim": 0.70,
              "psnr": 22.0, "quality_improvement": 0.10}
ISSUE_ORDER = ("noise", "blur", "low_contrast", "clipping_low",
               "clipping_high")
METRIC_KEYS = (
    "sigma", "lap_var", "std", "pct_low", "pct_high",
    "entropy", "edge_density", "gradient_mag_mean", "gradient_mag_std",
    "snr_proxy", "cnr_proxy", "laplacian_energy", "histogram_spread",
    "local_contrast_std", "gradient_strength", "gradient_entropy",
)
OP_ORDER = ("denoise", "clahe", "gamma", "unsharp", "post_denoise")


def _flat(a):
    return a.reshape(a.shape[0], -1)


def _std(a):
    return torch.std(a, dim=-1, correction=0)


def _rel(a: torch.Tensor, b) -> torch.Tensor:
    """|a - b| / max(|b|, tiny): how far ``a`` lies from threshold ``b``."""
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    a = a.to(torch.float64)
    return (a - b).abs() / torch.clamp_min(b.abs(), 1e-12)


def image_stats(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """The 16 metrics, ``niqe`` and ``edge_ratio`` per image."""
    sigma = O.estimate_sigma(x)
    lap = O.laplace(x)
    grad = O.gradient_magnitude(x)
    lap_var = torch.var(_flat(lap), dim=-1, correction=0)
    lap_energy = _flat(lap * lap).mean(dim=-1)
    mean = _flat(x).mean(dim=-1)
    std = _std(_flat(x))
    pct_low = _flat(x <= 0.01).to(x.dtype).mean(dim=-1)
    pct_high = _flat(x >= 0.99).to(x.dtype).mean(dim=-1)
    p05, p25, p75, p95 = O.percentiles(x, [5.0, 25.0, 75.0, 95.0])
    entropy = O.entropy_from_hist(
        O.counts(O.bin_indices(_flat(x), 256), 256), x.dtype)
    gflat = _flat(grad)
    gmax = gflat.amax(dim=-1)
    edge_thr = torch.where(gmax > 0, 0.1 * gmax, 0.0)
    edge_density = (gflat > edge_thr[:, None]).to(x.dtype).mean(dim=-1)
    gmean = gflat.mean(dim=-1)
    gstd = _std(gflat)
    sigma_safe = torch.clamp_min(sigma, 1e-8)
    local_contrast_std, lv16_mean, lv16_std = box_stats(x)
    g90 = O.percentiles(grad, [90.0])[0]
    strong = gflat >= g90[:, None]
    cnt = strong.to(x.dtype).sum(dim=-1)
    gradient_strength = torch.where(
        cnt > 0, (gflat * strong).sum(dim=-1) / torch.clamp_min(cnt, 1.0),
        0.0)
    gradient_entropy = O.entropy_from_hist(
        O.counts(O.bin_indices(gflat, 128, gmax + 1e-8), 128), x.dtype)
    edge_ratio = _flat(lap.abs()).mean(dim=-1) / (gmean + 1e-8)
    niqe = (lv16_std / (lv16_mean + 1e-8)
            + torch.clamp_min(edge_ratio - 1.0, 0.0) * 10.0)
    return {
        "sigma": sigma, "lap_var": lap_var, "std": std,
        "pct_low": pct_low, "pct_high": pct_high, "entropy": entropy,
        "edge_density": edge_density, "gradient_mag_mean": gmean,
        "gradient_mag_std": gstd, "snr_proxy": mean / sigma_safe,
        "cnr_proxy": (p95 - p05) / sigma_safe, "laplacian_energy": lap_energy,
        "histogram_spread": p75 - p25, "local_contrast_std": local_contrast_std,
        "gradient_strength": gradient_strength,
        "gradient_entropy": gradient_entropy, "niqe": niqe,
        "edge_ratio": edge_ratio,
    }


def edge_ratio(x):
    lap = _flat(O.laplace(x)).abs().mean(dim=-1)
    return lap / (_flat(O.gradient_magnitude(x)).mean(dim=-1) + 1e-8)


def box_stats(x):
    """(std(sqrt(lv7)), mean(lv16), std(lv16)) per image, the local
    variances and their moments in float64, rounded once to ``x``'s dtype:
    E[x^2] - E[x]^2 in float32 loses most digits where the variance is
    small, and the program's box-statistics kernel sums in float64."""
    x64 = x.to(torch.float64)
    lv7s = _flat(torch.sqrt(O.local_variance(x64, 7)))
    lv16 = _flat(O.local_variance(x64, 16))
    return (_std(lv7s).to(x.dtype), lv16.mean(dim=-1).to(x.dtype),
            _std(lv16).to(x.dtype))


def niqe(x):
    _, m16, s16 = box_stats(x)
    cov = s16 / (m16 + 1e-8)
    return cov + torch.clamp_min(edge_ratio(x) - 1.0, 0.0) * 10.0


def detect_issues(m: dict) -> tuple[dict, torch.Tensor]:
    """Issue masks and each image's margin to the detection thresholds."""
    T = THRESHOLDS
    issues = {
        "noise": m["sigma"] > T["noise_sigma"],
        "blur": m["lap_var"] < T["blur_lap_var"],
        "low_contrast": m["std"] < T["low_contrast_std"],
        "clipping_low": m["pct_low"] > T["clip_pct"],
        "clipping_high": m["pct_high"] > T["clip_pct"],
    }
    margin = torch.stack([
        _rel(m["sigma"], T["noise_sigma"]), _rel(m["lap_var"],
                                                 T["blur_lap_var"]),
        _rel(m["std"], T["low_contrast_std"]),
        _rel(m["pct_low"], T["clip_pct"]), _rel(m["pct_high"],
                                                T["clip_pct"])]).amin(0)
    return issues, margin


def _sel(mask, a, b):
    return torch.where(mask[:, None, None], a, b)


def light_denoise(x, strength):
    strength = O.as_n(strength, x)
    sigma_est = O.estimate_sigma(x)
    den = O.denoise_wavelet(x, sigma=sigma_est * 0.5, mode="soft")
    blended = ((1.0 - strength)[:, None, None] * x
               + strength[:, None, None] * den)
    return _sel(sigma_est < 0.001, x, blended), _rel(sigma_est, 0.001)


def _run_chain(x, order, dyn: dict, masks: dict, amount):
    """The selected ops in ``order`` with per-image masks; returns the
    result and the margin of the light denoise's no-op test."""
    out = x
    margin = torch.full((x.shape[0],), float("inf"), dtype=torch.float64,
                        device=x.device)
    for op in order:
        m = masks[op]
        if op == "denoise":
            y = O.denoise_wavelet(out, soft_mask=O.as_n(
                dyn["denoise_soft"], x, torch.bool))
        elif op == "clahe":
            y = O.clahe(out, dyn["clahe_clip_limit"], 16)
        elif op == "gamma":
            g = O.as_n(dyn["gamma"], x)
            m = m & ((g - 1.0).abs() > 1e-4)
            y = O.adjust_gamma(out, g)
        elif op == "unsharp":
            y = O.unsharp_mask(out, dyn["unsharp_radius"], amount)
        elif op == "post_denoise":
            s = O.as_n(dyn["post_denoise_strength"], x)
            m = m & (s > 0)
            y, mg = light_denoise(out, s)
            margin = torch.minimum(margin, torch.where(m, mg, margin))
        else:
            raise ValueError(f"unknown op {op!r}")
        out = _sel(m, y, out)
    return out, margin


def _noise_amp(x, out):
    """Safeguard 2: noise amplification -> corrective light denoise."""
    sb, sa = O.estimate_sigma(x), O.estimate_sigma(out)
    amp = (sb >= 1e-8) & (sa > sb * 1.3)
    fixed, mg = light_denoise(out, 0.4)
    out = _sel(amp, torch.clamp(fixed, 0.0, 1.0), out)
    margin = torch.where(sb >= 1e-8, _rel(sa, sb * 1.3), _rel(sb, 1e-8))
    return out, amp, torch.minimum(margin, torch.where(amp, mg, margin))


DETERMINISTIC = dict(clahe_clip_limit=0.015, gamma_brighten=0.95,
                     gamma_darken=1.05, unsharp_radius=0.8,
                     unsharp_amount=0.5, post_denoise_strength=0.3)


def apply_issue_driven(x, issues):
    """The issue-driven chain (denoise, CLAHE, gamma, unsharp, light
    denoise) and the noise-amplification guard -> (out, margin)."""
    P = DETERMINISTIC
    contrast = (issues["low_contrast"] | issues["clipping_low"]
                | issues["clipping_high"])
    brighten = issues["clipping_low"] & ~issues["clipping_high"]
    darken = issues["clipping_high"] & ~issues["clipping_low"]
    gamma = torch.where(brighten, P["gamma_brighten"],
                        torch.where(darken, P["gamma_darken"], 1.0)
                        ).to(x.dtype)
    dyn = dict(clahe_clip_limit=P["clahe_clip_limit"], gamma=gamma,
               unsharp_radius=P["unsharp_radius"],
               post_denoise_strength=P["post_denoise_strength"],
               denoise_soft=True)
    masks = {"denoise": issues["noise"], "clahe": contrast,
             "gamma": brighten | darken, "unsharp": issues["blur"],
             "post_denoise": issues["blur"]}
    out, m1 = _run_chain(x, OP_ORDER, dyn, masks, P["unsharp_amount"])
    out, _amp, m2 = _noise_amp(x, torch.clamp(out, 0.0, 1.0))
    return out, torch.minimum(m1, m2)


def apply_plan(x, dyn: dict, niqe_before):
    """The plan chain over ``OP_ORDER`` (every op on, parameters per image)
    and its three guards: halo -> re-run with half the unsharp amount,
    noise amplification, over-processing -> blend back 40 %."""
    masks = {op: torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
             for op in OP_ORDER}
    u = OP_ORDER.index("unsharp")
    pre, m0 = _run_chain(x, OP_ORDER[:u], dyn, masks, dyn["unsharp_amount"])
    out, m1 = _run_chain(pre, OP_ORDER[u:], dyn, masks,
                         dyn["unsharp_amount"])
    out = torch.clamp(out, 0.0, 1.0)
    er = edge_ratio(out)
    halo = er > 1.5
    redo, m2 = _run_chain(pre, OP_ORDER[u:], dyn, masks,
                          O.as_n(dyn["unsharp_amount"], x) * 0.5)
    out = _sel(halo, torch.clamp(redo, 0.0, 1.0), out)
    margin = torch.minimum(torch.minimum(m0, m1), _rel(er, 1.5))
    margin = torch.minimum(margin, torch.where(halo, m2, margin))
    out, _amp, m3 = _noise_amp(x, out)
    d = niqe(out) - niqe_before
    over = d > 0.5
    out = _sel(over, torch.clamp(0.6 * out + 0.4 * x, 0.0, 1.0), out)
    return out, torch.minimum(torch.minimum(margin, m3), _rel(d, 0.5))


def validate(x, enhanced, mb):
    """Before/after stats, SSIM, PSNR, the gains, the pass rule -> (dict,
    margin of the pass rule's four tests)."""
    T = THRESHOLDS
    ma = image_stats(enhanced)
    s, p = O.ssim(x, enhanced), O.psnr(x, enhanced)
    eps = 1e-8
    cg = (ma["std"] - mb["std"]) / torch.clamp_min(mb["std"], eps)
    sg = (ma["lap_var"] - mb["lap_var"]) / torch.clamp_min(mb["lap_var"],
                                                            eps)
    nr = (mb["sigma"] - ma["sigma"]) / torch.clamp_min(mb["sigma"], eps)
    qi = 0.35 * cg + 0.35 * sg + 0.30 * nr
    ms, mp = s >= T["ssim"], p >= T["psnr"]
    mi = qi >= T["quality_improvement"]
    ni = ma["niqe"] <= mb["niqe"]
    passes = (ms & mp) | (ms & mi) | (mp & mi & ni)
    margin = torch.stack([_rel(s, T["ssim"]), _rel(p, T["psnr"]),
                          _rel(qi, T["quality_improvement"]),
                          _rel(ma["niqe"], mb["niqe"])]).amin(0)
    v = {"ssim": s, "psnr": p, "quality_improvement": qi, "passes": passes,
         "niqe_before": mb["niqe"], "niqe_after": ma["niqe"],
         "contrast_gain": cg, "sharpness_gain": sg, "noise_change": -nr,
         "entropy_change": ma["entropy"] - mb["entropy"],
         "snr_change": ma["snr_proxy"] - mb["snr_proxy"],
         "histogram_spread_change": (ma["histogram_spread"]
                                     - mb["histogram_spread"]),
         "edge_ratio": ma["edge_ratio"],
         "local_contrast_change": (ma["local_contrast_std"]
                                   - mb["local_contrast_std"]),
         "gradient_strength_change": (ma["gradient_strength"]
                                      - mb["gradient_strength"]),
         "gradient_entropy_change": (ma["gradient_entropy"]
                                     - mb["gradient_entropy"]),
         "metrics_after": ma}
    return v, margin


def objective_score(v):
    passes = v["passes"].to(v["ssim"].dtype)
    return (0.35 * v["contrast_gain"] + 0.35 * v["sharpness_gain"]
            - 0.30 * torch.clamp_min(v["noise_change"], 0.0)
            - 5.0 * torch.clamp_min(v["niqe_after"] - v["niqe_before"], 0.0)
            - 10.0 * (1.0 - passes)
            - torch.clamp_min(v["edge_ratio"] - 1.0, 0.0) * 5.0
            - torch.clamp_min(v["entropy_change"].abs() - 0.5, 0.0) * 2.0
            + torch.clamp(v["snr_change"] * 0.1, 0.0, 0.5)
            + torch.clamp(v["histogram_spread_change"] * 0.5, 0.0, 0.3)
            + torch.clamp(v["local_contrast_change"] * 0.3, 0.0, 0.3)
            + torch.clamp(v["gradient_strength_change"] * 0.2, 0.0, 0.2)
            - torch.clamp_min(v["gradient_entropy_change"].abs() - 0.3, 0.0)
            * 1.5)


def qa_deterministic(x):
    """detect -> issue-driven chain -> validate -> objective, per image:
    {stats, issues, enhanced, validation, score, margin}."""
    stats = image_stats(x)
    issues, m_det = detect_issues(stats)
    enhanced, m_chain = apply_issue_driven(x, issues)
    any_issue = torch.stack([issues[k] for k in ISSUE_ORDER]).any(dim=0)
    enhanced = _sel(any_issue, enhanced, x)
    v, m_val = validate(x, enhanced, stats)
    margin = torch.minimum(m_det, torch.where(any_issue, m_chain, m_det))
    return {"stats": stats, "issues": issues, "enhanced": enhanced,
            "validation": v, "score": objective_score(v),
            "margin": torch.minimum(margin, m_val)}


def candidate_grid(issues: list[str]) -> list[dict]:
    """The tuning loop's issue-aware candidates (at most 27)."""
    noisy, blur = "noise" in issues, "blur" in issues
    dark = "clipping_low" in issues and "clipping_high" not in issues
    bright = "clipping_high" in issues and "clipping_low" not in issues
    gammas = (0.9, 1.0, 1.1)
    if dark:
        gammas = (0.85, 0.95, 1.0)
    elif bright:
        gammas = (1.0, 1.05, 1.15)
    out = []
    for clip in (0.005, 0.015, 0.03):
        for amount in (0.3, 0.6, 1.0) if blur else (0.3,):
            for gamma in gammas:
                out.append(dict(clahe_clip_limit=clip, gamma=gamma,
                                unsharp_radius=1.0 if blur else 0.8,
                                unsharp_amount=amount,
                                post_denoise_strength=0.4 if noisy else 0.2,
                                denoise_soft=True))
    return out


def qa_plan(x, cands: list[dict], stats_one=None):
    """Every candidate of ``cands`` on its own lane of the one image ``x``
    [1, H, W]: plan chain, guards, validation, objective ->
    {enhanced [K, H, W], score [K], margin [K]}."""
    k = len(cands)
    xk = x.expand((k,) + tuple(x.shape[1:])).contiguous()
    dyn = {key: torch.tensor([c[key] for c in cands], device=x.device,
                             dtype=torch.bool if key == "denoise_soft"
                             else torch.float32).to(
        torch.bool if key == "denoise_soft" else x.dtype)
        for key in cands[0]}
    stats = image_stats(xk) if stats_one is None else {
        key: v.expand(k) for key, v in stats_one.items()}
    enhanced, m_plan = apply_plan(xk, dyn, stats["niqe"])
    v, m_val = validate(xk, enhanced, stats)
    return {"enhanced": enhanced, "score": objective_score(v),
            "margin": torch.minimum(m_plan, m_val)}
