"""The plan path, sharded: ``apply_plan`` with all three safeguards,
validation and the objective score on row blocks.

Counterpart of ``mdx/parallel/plan_sp.py`` (1-D row blocks and 2-D
tiles; the mesh decides, :func:`layout`): the dense plan chain (``mdx_torch.core.enhance.apply_plan`` = ref
pipeline/enhancement.py:235-369) with every op replaced by its sharded
counterpart and per-image masks selecting, then

1. halo — edge_ratio(out) > 1.5 where unsharp ran → the chain again with
   ``unsharp_amount × 0.5`` (from the cached pre-unsharp prefix when the
   re-run order allows),
2. noise amplification — σ_after > 1.3·σ_before → ``light_denoise(0.4)``,
3. over-processing — NIQE up by more than 0.5 → blend back 40 % of x,

then the full validation and the objective score.  A guard branch holds
collectives (the re-run chain, the corrective denoise), so every rank
takes it or none does: its predicate is reduced over all ranks first
(``comm.any_all``), as JAX psums it (``plan_sp.py:189,212``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch

from mdx_torch.core.enhance import OP_ORDER, PlanDynamic, PlanStatic
from mdx_torch.core.score import objective_score
from mdx_torch.core.tuning import DEFAULT_OPS, candidate_grid, plan_records
from mdx_torch.core.validate import validation_from_stats
from mdx_torch.ops import filters as F
from mdx_torch.ops.filters import as_n
from mdx_torch.ops.tv import resolve_tv_mode, tv_mode_params
from mdx_torch.parallel import _spmd_stats as S
from mdx_torch.parallel import comm, launch, spatial, spatial2d
from mdx_torch.parallel.clahe_sp import clahe_sharded
from mdx_torch.parallel.tv_sp import tv_sharded
from mdx_torch.parallel.wavelet_sp import (
    denoise_wavelet_sharded,
    light_denoise_sharded,
)


@dataclass(frozen=True)
class Layout:
    """A spatial layout's primitives bound to this rank's mesh (1-D row
    blocks or 2-D tiles)."""

    mesh: object
    prims: S.SpatialPrims
    blur: Callable        # (x, sigma) → Gaussian blur, skimage 'nearest'
    bilateral: Callable   # (x, d, sigma_color, sigma_space)
    ssim: Callable        # (x, y) → [N]
    psnr: Callable        # (x, y) → [N]


def _layout(mesh, prims, ssim) -> Layout:
    # the blur, the bilateral filter and PSNR serve both layouts
    return Layout(mesh, prims(mesh),
                  partial(spatial.gaussian_blur_halo, mesh=mesh),
                  partial(spatial.bilateral_halo, mesh=mesh),
                  partial(ssim, mesh=mesh),
                  partial(spatial.psnr_block, mesh=mesh))


def layout_1d(mesh) -> Layout:
    return _layout(mesh, spatial.prims, spatial.ssim_block)


def layout_2d(mesh) -> Layout:
    return _layout(mesh, spatial2d.prims, spatial2d.ssim_block)


def layout(mesh) -> Layout:
    """The layout of ``mesh``: 2-D tiles when it has more than one tile
    column, else row blocks (``mdx/parallel/plan_sp.py:246-249``)."""
    return layout_2d(mesh) if mesh.n_sx > 1 else layout_1d(mesh)


def edge_ratio_sp(x: torch.Tensor, p: S.SpatialPrims) -> torch.Tensor:
    """mean(|laplace|) / mean(grad_mag) → [N] (ref
    pipeline/metrics.py:213-217; the halo guard's input)."""
    lap, gh, gv = p.lap_sobel(x)
    return p.pmean(lap.abs()) / (p.pmean(torch.hypot(gh, gv)) + 1e-8)


def niqe_sp(x: torch.Tensor, p: S.SpatialPrims) -> torch.Tensor:
    """NIQE approximation → [N] (ref pipeline/metrics.py:187-210; the
    over-processing guard's input)."""
    m, v = p.pvar(p.local_variance(x, 16))
    cov = torch.sqrt(v) / (m + 1e-8)
    return cov + torch.clamp_min(edge_ratio_sp(x, p) - 1.0, 0.0) * 10.0


def run_chain_sp(x, order, static: PlanStatic, dyn: PlanDynamic, masks,
                 unsharp_amount, lay: Layout) -> torch.Tensor:
    """The dense ``_run_chain`` with every op sharded; masks select per
    image."""
    mesh = lay.mesh
    out = x
    for op in order:
        if op not in static.ops:
            continue
        m = masks[op]
        if op == "denoise":
            y = denoise_wavelet_sharded(
                out, mesh, soft_mask=as_n(dyn.denoise_soft, x, torch.bool))
        elif op == "clahe":
            y = clahe_sharded(out, as_n(dyn.clahe_clip_limit, x),
                              int(static.tile_size), mesh)
        elif op == "gamma":
            g = as_n(dyn.gamma, x)
            m = m & ((g - 1.0).abs() > 1e-4)
            y = F.adjust_gamma(out, g)
        elif op == "unsharp":
            y = spatial.unsharp_halo(out, dyn.unsharp_radius, unsharp_amount,
                                     mesh)
        elif op == "post_denoise":
            s = as_n(dyn.post_denoise_strength, x)
            m = m & (s > 0)
            y = light_denoise_sharded(out, s, lay.prims.sigma(out), mesh)
        elif op == "bilateral":
            if static.bilateral_d <= 0:
                continue
            y = lay.bilateral(out, static.bilateral_d,
                              as_n(dyn.bilateral_sigma_color, x),
                              as_n(dyn.bilateral_sigma_space, x))
        elif op == "tv_denoise":
            w = as_n(dyn.tv_denoise_weight, x)
            m = m & (w > 0)
            eps, max_iter = tv_mode_params(static.tv_mode)
            y, _ = tv_sharded(out, torch.clamp_min(w, 1e-6), mesh, eps,
                              max_iter)
        else:
            raise ValueError(f"unknown op {op!r}")
        out = torch.where(m[:, None, None], y, out)
    return out


def apply_plan_sp(x, static: PlanStatic, dyn: PlanDynamic, masks,
                  lay: Layout, niqe_before: torch.Tensor | None = None):
    """Sharded plan chain + 3 safeguards → (enhanced block, guard flags
    {halo, noise_amp, over_processed} as [N] bools).  ``niqe_before``:
    the metric pass's ``niqe`` of x, when the caller has it."""
    n = x.shape[0]
    mesh = lay.mesh
    fixed_order = tuple(o for o in OP_ORDER if o in static.ops)
    rerun_order = static.order()

    # when the halo re-run order equals the fixed order up to 'unsharp', the
    # ops before unsharp are the same in both runs: the re-run resumes from
    # that prefix (as the dense apply_plan does)
    u_at = fixed_order.index("unsharp") if "unsharp" in fixed_order else -1
    prefix_reusable = (u_at >= 0
                       and rerun_order[:u_at + 1] == fixed_order[:u_at + 1])
    if prefix_reusable:
        pre = run_chain_sp(x, fixed_order[:u_at], static, dyn, masks,
                           dyn.unsharp_amount, lay)
        suffix = fixed_order[u_at:]
    else:
        pre, suffix = x, fixed_order
    out = torch.clamp(run_chain_sp(pre, suffix, static, dyn, masks,
                                   dyn.unsharp_amount, lay), 0.0, 1.0)

    # Safeguard 1: halo → re-run with the halved amount
    if "unsharp" in static.ops:
        halo = (edge_ratio_sp(out, lay.prims) > 1.5) & masks["unsharp"]
        if comm.any_all(halo, mesh):
            half = as_n(dyn.unsharp_amount, x) * 0.5
            if prefix_reusable:
                redo = run_chain_sp(pre, suffix, static, dyn, masks, half,
                                    lay)
            else:
                redo = run_chain_sp(x, rerun_order, static, dyn, masks, half,
                                    lay)
            out = torch.where(halo[:, None, None],
                              torch.clamp(redo, 0.0, 1.0), out)
    else:
        halo = torch.zeros(n, dtype=torch.bool, device=x.device)

    # Safeguard 2: noise amplification → corrective light denoise
    sigma_before = lay.prims.sigma(x)
    sigma_after = lay.prims.sigma(out)
    noise_amp = (sigma_before >= 1e-8) & (sigma_after > sigma_before * 1.3)
    if comm.any_all(noise_amp, mesh):
        fixed = torch.clamp(light_denoise_sharded(out, 0.4, sigma_after,
                                                  mesh), 0.0, 1.0)
        out = torch.where(noise_amp[:, None, None], fixed, out)

    # Safeguard 3: over-processing → blend back 40 % of the original
    if niqe_before is None:
        niqe_before = niqe_sp(x, lay.prims)
    over = (niqe_sp(out, lay.prims) - niqe_before) > 0.5
    out = torch.where(over[:, None, None],
                      torch.clamp(0.6 * out + 0.4 * x, 0.0, 1.0), out)
    return out, {"halo": halo, "noise_amp": noise_amp,
                 "over_processed": over}


def _local(v, mesh, n: int):
    """A plan value for this rank's ``n`` images: a per-image vector of the
    whole batch is cut to this data row's slice; scalars stay."""
    if torch.is_tensor(v) and v.ndim == 1 and v.numel() == n * mesh.n_data \
            and mesh.n_data > 1:
        return v[mesh.data_index * n:(mesh.data_index + 1) * n]
    return v


def qa_plan_block(xb: torch.Tensor, static: PlanStatic, dyn: PlanDynamic,
                  masks: dict | None = None, *, mesh) -> dict:
    """Per-rank body of :func:`qa_plan_spatial`: metrics → sharded
    apply_plan → metrics, SSIM, PSNR → validation and score."""
    n = xb.shape[0]
    lay = layout(mesh)
    dyn = PlanDynamic(*(_local(v, mesh, n) for v in dyn))
    masks = masks or {}
    masks = {op: as_n(_local(torch.as_tensor(masks.get(op, True)), mesh, n),
                      xb, torch.bool) for op in OP_ORDER}
    before = S.image_stats_block(xb, lay.prims)
    enhanced, flags = apply_plan_sp(xb, static, dyn, masks, lay,
                                    niqe_before=before["niqe"])
    after = S.image_stats_block(enhanced, lay.prims)
    validation = validation_from_stats(before, after, lay.ssim(xb, enhanced),
                                       lay.psnr(xb, enhanced))
    score, _ = objective_score(validation)
    return {"enhanced": enhanced, "stats_before": before,
            "validation": validation, "score": score, "flags": flags}


def _check_plan_rows(h: int, k: int) -> None:
    if h % k or (h // k) % 2 or h // k < spatial.MIN_ROWS_PER_SHARD:
        raise ValueError(
            f"H={h} must split into even blocks of "
            f"≥{spatial.MIN_ROWS_PER_SHARD} rows over {k} 'space' shards")


def check_plan_shape(shape, n_space, static: PlanStatic) -> None:
    """``plan_sp.py:273-293``: row blocks even and at least
    ``MIN_ROWS_PER_SHARD`` rows, or tiles as ``spatial2d.check_tiles``
    wants them; whole CLAHE tiles in every block."""
    spatial.check_grid(shape, n_space,
                       int(static.tile_size) if "clahe" in static.ops else 0,
                       _check_plan_rows)


def qa_plan_spatial(x: np.ndarray, n_space, static: PlanStatic,
                    dyn: PlanDynamic, masks: dict | None = None, *,
                    n_data: int = 1, device: str = "cuda",
                    timeout_s: float = 600.0) -> dict:
    """One plan-driven QA/tuning iteration of [N, H, W] numpy on
    ``n_data × n_space`` ranks (``n_space``: row blocks, or ``(sy, sx)``
    tiles): sharded apply_plan (7 ops, 3 guards) →
    validation → score.  ``static``/``dyn`` as from
    ``mdx_torch.plan_from_numpy`` (scalars or per-image [N] values);
    ``masks``: {op: [N] bool}.  Returns JAX's fields as numpy
    (``enhanced``, ``stats_before``, ``validation``, ``score``, ``flags``)
    plus ``"launch"``."""
    check_plan_shape(x.shape, n_space, static)
    res = launch.run(qa_plan_block, x, static, dyn, masks, n_space=n_space,
                     n_data=n_data, device=device, timeout_s=timeout_s)
    out = launch.assemble(res.results, n_data, n_space)
    out["launch"] = res.info()
    return out


# ---------------------------------------------------------------------------
# The autotune sweep on the sharded plan path
# ---------------------------------------------------------------------------


def autotune_spatial_block(xb: torch.Tensor, issues, *, mesh,
                           ops: tuple[str, ...], tile_size: int,
                           tv_mode: str | None = None) -> dict:
    """Per-rank body of :func:`autotune_spatial`: the candidate grid of
    ``issues`` as sequential :func:`qa_plan_block` calls on one static plan;
    each candidate's score, SSIM, PSNR and quality improvement ([K], the
    same on every rank) and the first maximum of the scores (JAX's strict
    ``>``), agreed over the ranks (``comm.agree``) → ``best``; only the
    winner's enhanced block is kept (``enhanced``)."""
    ops = tuple(ops)
    static = PlanStatic(ops=ops, tile_size=int(tile_size), bilateral_d=0,
                        tv_mode=resolve_tv_mode(tv_mode), plan_order=ops)
    cols = {"score": [], "ssim": [], "psnr": [], "quality_improvement": []}
    best, best_score, enhanced = -1, -float("inf"), None
    for i, c in enumerate(candidate_grid(list(issues))):
        out = qa_plan_block(xb, static, PlanDynamic(**c), mesh=mesh)
        v = out["validation"]
        for key, val in (("score", out["score"]), ("ssim", v["ssim"]),
                         ("psnr", v["psnr"]),
                         ("quality_improvement", v["quality_improvement"])):
            cols[key].append(val[0])
        score = float(out["score"][0])
        if score > best_score:
            best, best_score, enhanced = i, score, out["enhanced"]
    agreed = comm.agree(best, mesh)
    if agreed != best:
        raise RuntimeError(f"rank {mesh.rank} picked candidate {best} of the "
                           f"sweep, rank 0 picked {agreed}")
    return {"enhanced": enhanced,
            "best": torch.tensor([best]),
            **{key: torch.stack(v) for key, v in cols.items()}}


def sweep_records(out: dict, issues, ops, tile_size: int):
    """An assembled :func:`autotune_spatial_block` result → (the winning
    EnhancementPlan, the IterationRecords) through
    ``core.tuning.plan_records`` (JAX's ``plan_sp.py:360-368``)."""
    cands = candidate_grid(list(issues))
    plans, records, best = plan_records(
        cands, tuple(ops), int(tile_size), out["score"], out["ssim"],
        out["psnr"], out["quality_improvement"],
        best_rationale=("best of spatially-sharded autotune sweep "
                        f"({len(cands)} candidates, one compiled program "
                        "reused)"))
    if best != int(out["best"][0]):
        raise RuntimeError(f"the sweep's winner {int(out['best'][0])} is not "
                           f"the first maximum {best} of its scores")
    return plans[best], records


def autotune_spatial(image: np.ndarray, issues, n_space, *,
                     ops: tuple[str, ...] = DEFAULT_OPS, tile_size: int = 16,
                     tv_mode: str | None = None, device: str = "cuda",
                     timeout_s: float = 600.0):
    """LLM-free autotune of ONE large [H, W] slice on ``n_space`` ranks (row
    blocks, or ``(sy, sx)`` tiles): the issue-aware candidate grid swept as
    sequential sharded plan calls, all in one launch (counterpart of
    ``mdx/parallel/plan_sp.py:312``; ``tv_mode`` as ``core.tuning.autotune``
    takes it).  Returns (the best EnhancementPlan, its enhanced [H, W],
    the IterationRecords), the contract of ``core.tuning.autotune``."""
    x = np.asarray(image, np.float32)[None]
    check_plan_shape(x.shape, n_space, PlanStatic(ops=tuple(ops),
                                                  tile_size=tile_size))
    res = launch.run(autotune_spatial_block, x, list(issues),
                     n_space=n_space, device=device, timeout_s=timeout_s,
                     ops=tuple(ops), tile_size=int(tile_size),
                     tv_mode=tv_mode)
    out = launch.assemble(res.results, 1, n_space)
    plan, records = sweep_records(out, issues, ops, tile_size)
    return plan, out["enhanced"][0], records
