"""Spatial-QA runner: one very large slice sharded over ranks
(``python -m mdx_torch --spatial``).

Counterpart of ``mdx/pipeline/spatial_runner.py``: a single huge slice
(2048² and up: a chest X-ray, a stitched pathology tile) is laid out over
the ranks — 2-D row × column tiles when the rank count and the extents
allow, 1-D row blocks otherwise (:func:`spatial_layout`) — and QA'd with
the reference's deterministic issue → op mapping
(:func:`issue_driven_kwargs`) or, with ``autotune=True``, the candidate
sweep on the sharded plan path and one more plan call with the winner.

The run's whole device part is one rank body (:func:`spatial_run_block`) in
one :func:`mdx_torch.parallel.launch.run`: sharded detect → the issue flags
→ the chain, or the sweep and the final call.  Every decision JAX takes on
the host between its calls is a function of values each rank already
holds (the all-reduced metrics, the replicated scores), so each rank takes
it itself, and ``comm.agree`` makes it rank 0's on every rank: the flags
(five bits) and the sweep's winner.  Decode, normalisation, the report and
the DB row stay on the host, as in JAX.

The run is on ``device`` (the card by default; ``launch.run`` raises
without one).  Each phase's wall time (decode, normalize, launch — the
launch until its results are on the host, rank start-up included —,
compute — rank 0's device work, from its block on the device to its
results —, report, db) is returned as ``context["phase_ms"]``, and rank
0's stages as ``context["rank_ms"]``.
"""

from __future__ import annotations

import os
import time
from typing import Any

import numpy as np
import torch

from mdx_torch.core.enhance import DETERMINISTIC_DEFAULTS as PD
from mdx_torch.core.enhance import PlanDynamic, PlanStatic
from mdx_torch.core.metrics import ISSUE_ORDER, METRIC_KEYS, detect_issues
from mdx_torch.core.tuning import DEFAULT_OPS, candidate_grid
from mdx_torch.io import load_dicom, normalize_image
from mdx_torch.ops.tv import resolve_tv_mode
from mdx_torch.parallel import _spmd_stats as S
from mdx_torch.parallel import comm, launch, plan_sp, spatial
from mdx_torch.parallel.mesh import choose_layout, grid
from mdx_torch.pipeline import storage
from mdx_torch.pipeline.runner import resolve_device

def spatial_layout(h: int, w: int, n_devices: int | None = None):
    """``n_space`` for an H×W slice on ``n_devices`` ranks (default: the
    visible cards): ``choose_layout``'s (sy, sx) as the pair, or as the int
    ``sy`` when it has one tile column (``build_spatial_mesh``,
    ``mdx/pipeline/spatial_runner.py:63-79``)."""
    if n_devices is None:
        n_devices = torch.cuda.device_count()
    sy, sx = choose_layout(h, w, n_devices)
    return sy if sx == 1 else (sy, sx)


def clahe_aligned(h: int, w: int, ky: int, kx: int) -> bool:
    """Whether every one of the ky × kx blocks of an H×W slice holds whole
    CLAHE tiles (the sharded CLAHE's condition)."""
    t = int(PD["clahe_tile_size"])
    return (h // ky) % t == 0 and (w // kx) % t == 0


def issue_driven_kwargs(
    flags: dict[str, bool], h: int, w: int, ky: int, kx: int,
) -> tuple[dict[str, Any], list[str]]:
    """The reference's deterministic issue→op mapping (ref
    pipeline/enhancement.py:151-227) lowered to the sharded QA chain's
    gates: (``spatial.qa_block_kwargs`` keywords, applied op names).  The
    port's copy of ``mdx/pipeline/spatial_runner.py:95-128``."""
    needs_contrast = (flags["low_contrast"] | flags["clipping_low"]
                      | flags["clipping_high"])
    brighten = flags["clipping_low"] and not flags["clipping_high"]
    darken = flags["clipping_high"] and not flags["clipping_low"]
    applied_ops: list[str] = []
    kw: dict[str, Any] = dict(
        bilateral_d=0, gamma=1.0, unsharp_amount=0.0,
        unsharp_radius=PD["unsharp_radius"], noise_guard=True)
    if flags["noise"]:
        kw["denoise"] = True
        applied_ops.append("denoise")
    if needs_contrast and clahe_aligned(h, w, ky, kx):
        kw["clahe_clip_limit"] = PD["clahe_clip_limit"]
        applied_ops.append("clahe")
    if brighten or darken:
        kw["gamma"] = PD["gamma_brighten"] if brighten else PD["gamma_darken"]
        applied_ops.append("gamma")
    if flags["blur"]:
        kw["unsharp_amount"] = PD["unsharp_amount"]
        kw["post_denoise_strength"] = PD["post_denoise_strength"]
        applied_ops += ["unsharp", "post_denoise"]
    return kw, applied_ops


def _flags(bits: int) -> dict[str, bool]:
    return {k: bool(bits >> i & 1) for i, k in enumerate(ISSUE_ORDER)}


def _sweep_ops(h: int, w: int, ky: int, kx: int) -> tuple[str, ...]:
    """The sweep's ops: CLAHE only where every block holds whole tiles."""
    aligned = clahe_aligned(h, w, ky, kx)
    return tuple(o for o in DEFAULT_OPS if o != "clahe" or aligned)


def spatial_run_block(xb: torch.Tensor, *, mesh, autotune: bool,
                      tv_mode: str | None = None) -> dict:
    """Per-rank body of :func:`run_pipeline_spatial`: sharded detect → the
    issue flags, agreed → either ``spatial.qa_block`` with
    :func:`issue_driven_kwargs`, or the sweep
    (``plan_sp.autotune_spatial_block``) and one ``qa_plan_block`` with the
    winner's parameters (``mdx/pipeline/spatial_runner.py:190-209``).
    Returns the QA step's fields, the agreed flags (``issue_bits``), the
    sweep's columns (``sweep``, with ``autotune``) and this rank's stage
    times (``rank_ms``)."""
    def now() -> float:
        if xb.is_cuda:
            torch.cuda.synchronize(xb.device)
        return time.perf_counter()

    t0 = now()
    ky, kx = mesh.n_sy, mesh.n_sx
    h, w = xb.shape[1] * ky, xb.shape[2] * kx
    masks = detect_issues(S.image_stats_block(xb, plan_sp.layout(mesh).prims))
    bits = comm.agree(sum(int(bool(masks[k][0])) << i
                          for i, k in enumerate(ISSUE_ORDER)), mesh)
    flags = _flags(bits)
    t1 = now()
    res: dict[str, Any] = {"issue_bits": torch.tensor([bits])}
    if not autotune:
        kw, _ = issue_driven_kwargs(flags, h, w, ky, kx)
        res.update(spatial.qa_block(xb, mesh=mesh,
                                    **spatial.qa_block_kwargs(**kw)))
        t2 = t3 = now()
        stages = {"chain": t2 - t1}
    else:
        issues = [k for k in ISSUE_ORDER if flags[k]]
        ops = _sweep_ops(h, w, ky, kx)
        t = int(PD["clahe_tile_size"])
        sweep = plan_sp.autotune_spatial_block(
            xb, issues, mesh=mesh, ops=ops, tile_size=t, tv_mode=tv_mode)
        del sweep["enhanced"]
        t2 = now()
        c = candidate_grid(issues)[int(sweep["best"][0])]
        static = PlanStatic(ops=ops, tile_size=t, bilateral_d=0,
                            tv_mode=resolve_tv_mode(tv_mode), plan_order=ops)
        dyn = PlanDynamic(
            clahe_clip_limit=c["clahe_clip_limit"], gamma=c["gamma"],
            unsharp_radius=c["unsharp_radius"],
            unsharp_amount=c["unsharp_amount"],
            post_denoise_strength=c["post_denoise_strength"],
            tv_denoise_weight=0.0)
        pout = plan_sp.qa_plan_block(xb, static, dyn, mesh=mesh)
        v = pout["validation"]
        res.update(stats_before=pout["stats_before"],
                   stats_after=v["metrics_after"], ssim=v["ssim"],
                   psnr=v["psnr"],
                   quality_improvement=v["quality_improvement"],
                   passes=v["passes"],
                   noise_amp_guard=pout["flags"]["noise_amp"],
                   enhanced=pout["enhanced"], sweep=sweep)
        t3 = now()
        stages = {"sweep": t2 - t1, "final": t3 - t2}
    stages.update(detect=t1 - t0, compute=t3 - t0)
    res["rank_ms"] = {k: torch.tensor([s * 1e3], dtype=torch.float64)
                      for k, s in stages.items()}
    return res


def _first(v) -> float:
    return float(np.asarray(v)[0])


def run_pipeline_spatial(
    input_path: str,
    output_dir: str = "outputs",
    *,
    save_artifacts: bool = True,
    n_space=None,
    window: bool = False,
    autotune: bool = False,
    device="cuda",
    tv_mode: str | None = None,
    timeout_s: float = 600.0,
) -> dict[str, Any]:
    """QA one (large) DICOM slice sharded over ranks, with the reference's
    deterministic issue-driven decisions or (``autotune``) the candidate
    sweep on the plan path (module doc).

    ``n_space=None`` lays the slice out over the visible cards
    (:func:`spatial_layout`; one rank on the CPU); an int (row blocks) or a
    pair ``(sy, sx)`` (tiles) pins the layout, as JAX's ``mesh=`` does.
    ``tv_mode``: the sweep's TV mode (JAX reads ``MDX_TV_MODE``).  Returns
    JAX's context keys plus ``launch`` (``Launched.info()``), ``phase_ms``
    and ``rank_ms``."""
    dev = resolve_device(device)
    storage.init_db()
    times: dict[str, float] = {}
    t = time.perf_counter()
    img, meta = load_dicom(input_path, window=window)
    times["decode"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    frame = (np.asarray(img, np.float32) if window
             else normalize_image(img))
    times["normalize"] = (time.perf_counter() - t) * 1e3
    h, w = frame.shape
    x = frame[None]

    if n_space is None:
        n_space = spatial_layout(
            h, w, torch.cuda.device_count() if dev.type == "cuda" else 1)
    ky, kx = grid(n_space)
    layout = {"sy": ky, "sx": kx} if kx > 1 else {"space": ky}
    spatial.check_grid(x.shape, n_space)

    t = time.perf_counter()
    launched = launch.run(spatial_run_block, x, n_space=n_space,
                          device=dev.type, timeout_s=timeout_s,
                          autotune=autotune, tv_mode=tv_mode)
    out = launch.assemble(launched.results, 1, n_space)
    times["launch"] = (time.perf_counter() - t) * 1e3
    rank_ms = {k: _first(v) for k, v in out["rank_ms"].items()}
    times["compute"] = rank_ms["compute"]

    t = time.perf_counter()
    flags = _flags(int(out["issue_bits"][0]))
    best_plan = None
    records = []
    if autotune:
        issues = [k for k in ISSUE_ORDER if flags[k]]
        ops = _sweep_ops(h, w, ky, kx)
        best_plan, records = plan_sp.sweep_records(
            out["sweep"], issues, ops, int(PD["clahe_tile_size"]))
        applied_ops = list(best_plan.recommended_ops)
        rank_ms["per_candidate"] = rank_ms["sweep"] / len(records)
    else:
        _, applied_ops = issue_driven_kwargs(flags, h, w, ky, kx)
        masks = detect_issues(out["stats_before"])
        issues = [k for k in ISSUE_ORDER if bool(masks[k][0])]

    stats = {k: _first(out["stats_before"][k]) for k in METRIC_KEYS}
    stats_after = {k: _first(out["stats_after"][k]) for k in METRIC_KEYS}
    validation = {
        "ssim": _first(out["ssim"]),
        "psnr": _first(out["psnr"]),
        "quality_improvement": _first(out["quality_improvement"]),
        "passes": bool(np.asarray(out["passes"])[0]),
    }
    noise_amp_tripped = bool(np.asarray(out["noise_amp_guard"])[0])

    label = os.path.basename(input_path)
    lines = [
        "# mdx spatial QA report", "",
        f"Input: **{label}** ({h}×{w})",
        f"Mesh layout: {layout} "
        f"({'2-D row×col tiles' if 'sx' in layout else '1-D row blocks'})",
        "",
        f"Issues detected: {', '.join(issues) or '—'}",
        (f"Applied (autotune sweep, {len(records)} candidates on one "
         f"reused program): {', '.join(applied_ops) or '—'}"
         if autotune else
         f"Applied (issue-driven, reference defaults): "
         f"{', '.join(applied_ops) or '— (pass-through)'}")
        + (" · noise-amp guard tripped" if noise_amp_tripped else ""),
        "",
        "| metric | before | after |", "|---|---|---|",
    ]
    for k in METRIC_KEYS:
        lines.append(f"| {k} | {stats[k]:.5f} | {stats_after[k]:.5f} |")
    lines += [
        "",
        f"SSIM {validation['ssim']:.4f} · PSNR {validation['psnr']:.2f} · "
        f"quality improvement {validation['quality_improvement']:.4f} → "
        f"**{'PASS' if validation['passes'] else 'FAIL'}**",
        "",
        ("_Every applied op ran spatially sharded "
         "(mdx_torch/parallel/{plan_sp,wavelet_sp,clahe_sp,tv_sp}.py) on "
         "the plan path with all three reference safeguards; the winning "
         "plan and per-candidate records are persisted._" if autotune else
         "_Every applied op ran spatially sharded "
         "(mdx_torch/parallel/{wavelet_sp,clahe_sp,tv_sp,spatial*}.py) with "
         "the reference's deterministic issue→op mapping and "
         "noise-amplification safeguard._"),
    ]
    report_md = "\n".join(lines)

    run_id = storage.generate_run_id()
    report_path = ""
    if save_artifacts:
        os.makedirs(output_dir, exist_ok=True)
        report_path = os.path.join(
            output_dir, f"{os.path.splitext(label)[0]}_spatial_report.md")
        with open(report_path, "w", encoding="utf-8") as f:
            f.write(report_md)
    times["report"] = (time.perf_counter() - t) * 1e3
    if save_artifacts:
        t = time.perf_counter()
        storage.save_run(
            run_id=run_id, input_filename=label,
            metadata_summary=meta, issues=issues,
            metrics_before=stats, metrics_after=stats_after,
            plan_json=(best_plan.model_dump_json()
                       if best_plan is not None else ""),
            validation=validation,
            applied_ops=applied_ops,
            explainability={}, report_path=report_path,
            before_after_path="", agent_logs=[], status="completed")
        times["db"] = (time.perf_counter() - t) * 1e3

    return {
        "spatial": True,
        "run_id": run_id,
        "shape": [h, w],
        "mesh": layout,
        "issues": issues,
        "applied_ops": applied_ops,
        "noise_amp_guard": noise_amp_tripped,
        "plan": best_plan,
        "iterations": records,
        "enhanced": np.asarray(out["enhanced"])[0],
        "metrics": stats,
        "metrics_after": stats_after,
        "validation": validation,
        "report_md": report_md,
        "report_path": report_path,
        "launch": launched.info(),
        "phase_ms": times,
        "rank_ms": rank_ms,
    }
