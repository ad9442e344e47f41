"""Batched 7-op enhancement chain with safeguards (PyTorch).

Counterpart of ``mdx/core/enhance.py`` (reference contract:
``pipeline/enhancement.py`` — issue-driven chain :151-227, plan-driven
chain :235-369, safeguards :50-72,319-367, light denoise :80-94).

* ``PlanStatic`` holds which ops run, the CLAHE tile size, the bilateral
  diameter, the halo re-run order and the TV mode; ``PlanDynamic`` holds
  every continuous parameter as a scalar or a per-image ``[N]`` tensor.
* Each op takes a per-image bool mask and the result is selected per
  image, so one batch can carry different op subsets or candidate plans.
* The halo re-run and the noise-amplification fix run only when some
  image in the batch trips them.  That test reads the mask on the host
  (``bool(mask.any())``), one device sync per guard; capturing the pass
  in a CUDA graph would need it moved onto the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from mdx_torch.core.metrics import compute_edge_ratio as _edge_ratio
from mdx_torch.core.metrics import compute_niqe as _niqe
from mdx_torch.ops import filters as _f
from mdx_torch.ops import wavelet as _w
from mdx_torch.ops.bilateral import bilateral as _bilateral
from mdx_torch.ops.clahe import clahe as _clahe
from mdx_torch.ops.filters import as_n as _as_n
from mdx_torch.ops.tv import resolve_tv_mode, tv_mode_params
from mdx_torch.ops.tv import tv_chambolle as _tv_chambolle

OP_ORDER = ("denoise", "clahe", "gamma", "unsharp", "post_denoise",
            "bilateral", "tv_denoise")


@dataclass(frozen=True)
class PlanStatic:
    """Structural part of an enhancement plan."""
    ops: tuple[str, ...] = OP_ORDER
    tile_size: int = 16
    bilateral_d: int = 0
    # halo re-run order: the reference re-applies ops in *plan order*
    # (pipeline/enhancement.py:326-351)
    plan_order: tuple[str, ...] | None = None
    # TV solve mode: "ref" = reference parity, "fast" = capped iterations
    tv_mode: str = "ref"

    def order(self) -> tuple[str, ...]:
        return self.plan_order if self.plan_order is not None else tuple(
            o for o in OP_ORDER if o in self.ops)


class PlanDynamic(NamedTuple):
    """Continuous plan parameters; scalars or per-image [N] tensors."""
    clahe_clip_limit: torch.Tensor | float = 0.015
    gamma: torch.Tensor | float = 1.0
    unsharp_radius: torch.Tensor | float = 0.8
    unsharp_amount: torch.Tensor | float = 0.5
    post_denoise_strength: torch.Tensor | float = 0.3
    bilateral_sigma_color: torch.Tensor | float = 0.05
    bilateral_sigma_space: torch.Tensor | float = 0.05
    tv_denoise_weight: torch.Tensor | float = 0.0
    denoise_soft: torch.Tensor | bool = True  # per-image soft/hard select


def plan_from_numpy(static_fields: dict, dyn_fields: dict,
                    device: torch.device | str = "cuda"
                    ) -> tuple[PlanStatic, PlanDynamic]:
    """Build the port's plan from the JAX plan's fields.

    ``static_fields``: ``PlanStatic`` fields (e.g. ``dataclasses.asdict``
    of ``mdx.core.enhance.PlanStatic``).  ``dyn_fields``: ``PlanDynamic``
    fields as numpy arrays or Python scalars (e.g. ``{k: np.asarray(v)
    for k, v in dyn._asdict().items()}``).  Dynamic fields become tensors
    on ``device`` (the card unless the caller passes ``"cpu"``);
    ``denoise_soft`` becomes bool, the rest float32."""
    plan_order = static_fields.get("plan_order")
    static = PlanStatic(
        ops=tuple(static_fields.get("ops", OP_ORDER)),
        tile_size=int(static_fields.get("tile_size", 16)),
        bilateral_d=int(static_fields.get("bilateral_d", 0)),
        plan_order=None if plan_order is None else tuple(plan_order),
        tv_mode=resolve_tv_mode(static_fields.get("tv_mode", "ref")),
    )
    dyn = PlanDynamic(**{
        k: torch.as_tensor(np.array(v), device=device,
                           dtype=torch.bool if k == "denoise_soft"
                           else torch.float32)
        for k, v in dyn_fields.items()})
    return static, dyn


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None, None], a, b)


def light_denoise(x: torch.Tensor, strength) -> torch.Tensor:
    """(1−s)·x + s·wavelet_denoise(x, σ=σ̂/2); no-op where σ̂ < 1e-3
    (ref pipeline/enhancement.py:80-94)."""
    strength = _as_n(strength, x, x.dtype)
    sigma_est = _w.estimate_sigma(x)
    den = _w.denoise_wavelet(x, sigma=sigma_est * 0.5, mode="soft")
    blended = (1.0 - strength)[:, None, None] * x + strength[:, None, None] * den
    return _sel(sigma_est < 0.001, x, blended)


def _run_chain(x: torch.Tensor, order: tuple[str, ...], static: PlanStatic,
               dyn: PlanDynamic, masks: dict[str, torch.Tensor],
               unsharp_amount) -> torch.Tensor:
    """Apply the selected ops in ``order`` with per-image masks."""
    out = x
    for op in order:
        if op not in static.ops:
            continue
        m = masks[op]
        if op == "denoise":
            y = _w.denoise_wavelet(out, sigma=None,
                                   soft_mask=_as_n(dyn.denoise_soft, x, torch.bool))
        elif op == "clahe":
            y = _clahe(out, _as_n(dyn.clahe_clip_limit, x), static.tile_size)
        elif op == "gamma":
            g = _as_n(dyn.gamma, x)
            m = m & ((g - 1.0).abs() > 1e-4)
            y = _f.adjust_gamma(out, g)
        elif op == "unsharp":
            y = _f.unsharp_mask(out, _as_n(dyn.unsharp_radius, x),
                                _as_n(unsharp_amount, x))
        elif op == "post_denoise":
            s = _as_n(dyn.post_denoise_strength, x)
            m = m & (s > 0)
            y = light_denoise(out, s)
        elif op == "bilateral":
            if static.bilateral_d <= 0:
                continue
            y = _bilateral(out, static.bilateral_d,
                           _as_n(dyn.bilateral_sigma_color, x),
                           _as_n(dyn.bilateral_sigma_space, x))
        elif op == "tv_denoise":
            w = _as_n(dyn.tv_denoise_weight, x)
            m = m & (w > 0)
            tv_eps, tv_iter = tv_mode_params(static.tv_mode)
            y, _ = _tv_chambolle(out, torch.clamp_min(w, 1e-6),
                                 eps=tv_eps, max_iter=tv_iter)
        else:
            raise ValueError(f"unknown op {op!r}")
        out = _sel(m, y, out)
    return out


def _noise_amp(x: torch.Tensor, out: torch.Tensor):
    """Safeguard 2: noise amplification → corrective light denoise."""
    sigma_before = _w.estimate_sigma(x)
    sigma_after = _w.estimate_sigma(out)
    noise_amp = (sigma_before >= 1e-8) & (sigma_after > sigma_before * 1.3)
    # lax.cond in the JAX package; here a host sync (a CUDA graph of the
    # pass needs this decision moved onto the device)
    if bool(noise_amp.any()):
        out = _sel(noise_amp, torch.clamp(light_denoise(out, 0.4), 0.0, 1.0),
                   out)
    return out, noise_amp


def apply_plan(
    x: torch.Tensor,
    static: PlanStatic,
    dyn: PlanDynamic,
    masks: dict[str, torch.Tensor] | None = None,
    niqe_before: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Plan-driven chain + 3 safeguards (ref pipeline/enhancement.py:235-369).

    Returns (enhanced [N,H,W], guard flags {halo, noise_amp,
    over_processed} as [N] bools).  ``niqe_before``: precomputed
    ``compute_niqe(x)`` (e.g. ``stats["niqe"]`` from the metric pass)."""
    n = x.shape[0]
    masks = {} if masks is None else masks
    masks = {op: _as_n(masks.get(op, True), x, torch.bool) for op in OP_ORDER}
    fixed_order = tuple(o for o in OP_ORDER if o in static.ops)

    # Split the chain at 'unsharp': when the halo re-run order equals the
    # fixed order, the ops before unsharp are identical in both runs and
    # the re-run resumes from the cached prefix (bit-identical to the
    # reference's full re-run from x).
    rerun_order = static.order()
    u_at = fixed_order.index("unsharp") if "unsharp" in fixed_order else -1
    prefix_reusable = (u_at >= 0
                       and rerun_order[:u_at + 1] == fixed_order[:u_at + 1])

    if prefix_reusable:
        pre = _run_chain(x, fixed_order[:u_at], static, dyn, masks,
                         dyn.unsharp_amount)
        suffix = fixed_order[u_at:]
        out = torch.clamp(_run_chain(pre, suffix, static, dyn, masks,
                                     dyn.unsharp_amount), 0.0, 1.0)
    else:
        out = torch.clamp(_run_chain(x, fixed_order, static, dyn, masks,
                                     dyn.unsharp_amount), 0.0, 1.0)

    # Safeguard 1: halo → re-run the chain (in plan order) with halved amount
    if "unsharp" in static.ops:
        halo = (_edge_ratio(out) > 1.5) & masks["unsharp"]
        # host sync, as in _noise_amp
        if bool(halo.any()):
            half = _as_n(dyn.unsharp_amount, x) * 0.5
            if prefix_reusable:
                redo = _run_chain(pre, suffix, static, dyn, masks, half)
            else:
                redo = _run_chain(x, rerun_order, static, dyn, masks, half)
            out = _sel(halo, torch.clamp(redo, 0.0, 1.0), out)
    else:
        halo = torch.zeros(n, dtype=torch.bool, device=x.device)

    out, noise_amp = _noise_amp(x, out)

    # Safeguard 3: over-processing (NIQE degraded > 0.5) → blend back 40%
    if niqe_before is None:
        niqe_before = _niqe(x)
    over = (_niqe(out) - niqe_before) > 0.5
    out = _sel(over, torch.clamp(0.6 * out + 0.4 * x, 0.0, 1.0), out)

    return out, {"halo": halo, "noise_amp": noise_amp, "over_processed": over}


# Deterministic defaults (ref pipeline/enhancement.py:32-42)
DETERMINISTIC_DEFAULTS = dict(
    clahe_clip_limit=0.015, clahe_tile_size=16,
    gamma_brighten=0.95, gamma_darken=1.05,
    unsharp_radius=0.8, unsharp_amount=0.5,
    post_denoise_strength=0.3,
)


def apply_issue_driven(
    x: torch.Tensor, issues: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Issue-driven deterministic chain (ref pipeline/enhancement.py:151-227).

    ``issues`` are per-image bool masks from
    :func:`mdx_torch.core.metrics.detect_issues`.  Only the
    noise-amplification guard applies on this path (reference parity).
    Returns (enhanced, {op masks + guard flags})."""
    n = x.shape[0]
    P = DETERMINISTIC_DEFAULTS
    noise = issues["noise"]
    blur = issues["blur"]
    needs_contrast = (issues["low_contrast"] | issues["clipping_low"]
                      | issues["clipping_high"])
    brighten = issues["clipping_low"] & ~issues["clipping_high"]
    darken = issues["clipping_high"] & ~issues["clipping_low"]
    gamma = torch.where(brighten, P["gamma_brighten"],
                        torch.where(darken, P["gamma_darken"], 1.0)
                        ).to(x.dtype)

    static = PlanStatic(ops=("denoise", "clahe", "gamma", "unsharp",
                             "post_denoise"),
                        tile_size=P["clahe_tile_size"])
    dyn = PlanDynamic(
        clahe_clip_limit=P["clahe_clip_limit"],
        gamma=gamma,
        unsharp_radius=P["unsharp_radius"],
        unsharp_amount=P["unsharp_amount"],
        post_denoise_strength=P["post_denoise_strength"],
    )
    no = torch.zeros(n, dtype=torch.bool, device=x.device)
    masks = {
        "denoise": noise,
        "clahe": needs_contrast,
        "gamma": brighten | darken,
        "unsharp": blur,
        "post_denoise": blur,
        "bilateral": no,
        "tv_denoise": no,
    }
    out = torch.clamp(_run_chain(x, static.order(), static, dyn, masks,
                                 dyn.unsharp_amount), 0.0, 1.0)
    out, noise_amp = _noise_amp(x, out)
    flags = dict(masks)
    flags["noise_amp"] = noise_amp
    return out, flags
